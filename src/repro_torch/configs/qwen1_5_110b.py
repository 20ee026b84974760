"""Qwen1.5-110B — dense GQA (64Q/8KV), QKV bias [hf:Qwen/Qwen1.5-110B]."""

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab_size=152064,
    attn="gqa",
    qkv_bias=True,
    ffn_kind="swiglu",
    dtype="bfloat16",
)


def smoke():
    return LMConfig(
        name="qwen-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=192,
        vocab_size=256,
        attn="gqa",
        qkv_bias=True,
        ffn_kind="swiglu",
        dtype="float32",
        kv_chunk=16,
        remat=False,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen1.5-110b",
        family="lm",
        model=CONFIG,
        shapes=lm_shapes(),
        smoke=smoke,
        notes="Dense GQA with QKV bias; d_ff=49152 makes this the most "
        "FFN-dominated of the dense archs.",
    )
