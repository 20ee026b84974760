"""MiniCPM3-4B — dense MLA [hf:openbmb/MiniCPM3-4B]."""

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab_size=73448,
    attn="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    ffn_kind="swiglu",
    dtype="bfloat16",
)


def smoke():
    return LMConfig(
        name="minicpm3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        attn="mla",
        q_lora_rank=32,
        kv_lora_rank=24,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        ffn_kind="swiglu",
        dtype="float32",
        kv_chunk=16,
        remat=False,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="minicpm3-4b",
        family="lm",
        model=CONFIG,
        shapes=lm_shapes(),
        smoke=smoke,
        notes="Small dense MLA — the latent cache (288 dims/token) makes "
        "long_500k decode trivially memory-feasible.",
    )
