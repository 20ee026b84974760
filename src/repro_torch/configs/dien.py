"""DIEN — Deep Interest Evolution Network [arXiv:1809.03672].
embed_dim=18, seq_len=100, GRU/AUGRU dim 108, MLP 200-80."""

import dataclasses

from repro_torch.configs import ArchSpec, ShapeSpec
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="dien",
    kind="dien",
    n_items=10_000_000,
    n_cats=10_000,
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    mlp=(200, 80),
)


def recsys_shapes() -> dict:
    return {
        "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
        "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
        ),
    }


def smoke():
    return dataclasses.replace(
        CONFIG, name="dien-smoke", n_items=1000, n_cats=50, seq_len=12
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dien",
        family="recsys",
        model=CONFIG,
        shapes=recsys_shapes(),
        smoke=smoke,
        notes="GRU interest extraction + AUGRU interest evolution "
        "(lax.scan over the 100-step behaviour sequence).",
    )
