"""xDeepFM [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, DNN 400-400. Three fields are multi-hot bags (exercises the
EmbeddingBag = take + masked-segment-sum substrate)."""

import dataclasses

from repro_torch.configs import ArchSpec
from repro_torch.configs.dien import recsys_shapes
from repro_torch.models.recsys import RecsysConfig

# 30 small + 6 medium + 3 large (multi-hot) fields → 39M embedding rows
FIELD_VOCABS = tuple([100_000] * 30 + [1_000_000] * 6 + [10_000_000] * 3)

CONFIG = RecsysConfig(
    name="xdeepfm",
    kind="xdeepfm",
    embed_dim=10,
    field_vocabs=FIELD_VOCABS,
    n_multi_hot=3,
    max_bag=8,
    cin_layers=(200, 200, 200),
    mlp=(400, 400),
)


def smoke():
    return dataclasses.replace(
        CONFIG,
        name="xdeepfm-smoke",
        field_vocabs=tuple([50] * 6 + [100] * 2),
        n_multi_hot=2,
        max_bag=4,
        cin_layers=(8, 8),
        mlp=(16, 16),
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="xdeepfm",
        family="recsys",
        model=CONFIG,
        shapes=recsys_shapes(),
        smoke=smoke,
        notes="CIN = outer-product + field-compression einsum; single "
        "39M-row table with per-field offsets, row-sharded over 'model'.",
    )
