"""BST — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874]:
embed_dim=32, seq_len=20, 1 block, 8 heads, MLP 1024-512-256."""

import dataclasses

from repro_torch.configs import ArchSpec
from repro_torch.configs.dien import recsys_shapes
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="bst",
    kind="bst",
    n_items=4_000_000,
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp=(1024, 512, 256),
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="bst-smoke", n_items=800, seq_len=8, mlp=(32, 16, 8)
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="bst",
        family="recsys",
        model=CONFIG,
        shapes=recsys_shapes(),
        smoke=smoke,
        notes="Transformer over [history ⊕ target] then MLP; target-aware "
        "scoring (not two-tower) except the retrieval head projection.",
    )
