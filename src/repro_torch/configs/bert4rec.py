"""BERT4Rec [arXiv:1904.06690]: bidirectional 2-block transformer over item
sequences, masked-item training, weight-tied full-softmax head."""

import dataclasses

from repro_torch.configs import ArchSpec
from repro_torch.configs.dien import recsys_shapes
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="bert4rec",
    kind="bert4rec",
    n_items=54_546,   # Steam dataset scale (paper's largest item set)
    embed_dim=64,
    seq_len=200,
    n_blocks=2,
    n_heads=2,
    n_masked=20,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="bert4rec-smoke", n_items=500, seq_len=16, n_masked=4
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="bert4rec",
        family="recsys",
        model=CONFIG,
        shapes=recsys_shapes(),
        smoke=smoke,
        notes="Encoder-only (bidirectional) — serve shapes score full "
        "sequences; there is no KV-cache decode step (DESIGN.md §8).",
    )
