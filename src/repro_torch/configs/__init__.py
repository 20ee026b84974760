"""Architecture registry of the port: one module per arch, copies of the
reference package's config modules. ``get_spec(arch_id)`` returns the
full-size config; ``spec.smoke()`` returns the reduced same-family config
for CPU smoke tests.

The five LM archs, GraphSAGE-Reddit, the four recsys rankers (DIEN,
BERT4Rec, xDeepFM, BST) and the paper's own co-occurrence workload
(``cooc-wt10g``, which the dry run reads).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: ``kind`` selects which step gets lowered."""

    name: str
    kind: str  # "train" | "prefill" | "decode" | "serve" | "full_graph" | ...
    sizes: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys" | "cooc"
    model: Any
    shapes: dict[str, ShapeSpec]
    smoke: Callable[[], Any]  # reduced-config factory for CPU smoke tests
    notes: str = ""


_ARCH_MODULES = {
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "dien": "repro_torch.configs.dien",
    "bert4rec": "repro_torch.configs.bert4rec",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "bst": "repro_torch.configs.bst",
    "cooc-wt10g": "repro_torch.configs.cooc_wt10g",
}


def list_archs() -> list[str]:
    return sorted(_ARCH_MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).spec()


# the four LM input-shape cells (same set for all five LM archs)
def lm_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
        "decode_32k": ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
        "long_500k": ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
    }
