"""Nemotron-4-340B — dense GQA (96Q/8KV), squared-ReLU FFN
[arXiv:2402.16819; unverified]."""

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab_size=256000,
    attn="gqa",
    ffn_kind="squared_relu",
    dtype="bfloat16",
)


def smoke():
    return LMConfig(
        name="nemotron-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=256,
        vocab_size=256,
        attn="gqa",
        ffn_kind="squared_relu",
        dtype="float32",
        kv_chunk=16,
        remat=False,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="nemotron-4-340b",
        family="lm",
        model=CONFIG,
        shapes=lm_shapes(),
        smoke=smoke,
        notes="Largest dense arch (d_model=18432); squared-ReLU (Primer) "
        "FFN, no gate matrix.",
    )
