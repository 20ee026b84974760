"""OLMoE-1B-7B — 64 experts top-8, QK-norm [arXiv:2409.02060; hf]."""

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50304,
    attn="gqa",
    qk_norm=True,
    ffn_kind="swiglu",
    n_experts=64,
    top_k=8,
    n_shared_experts=0,
    expert_d_ff=1024,
    dtype="bfloat16",
)


def smoke():
    return LMConfig(
        name="olmoe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab_size=256,
        attn="gqa",
        qk_norm=True,
        ffn_kind="swiglu",
        n_experts=8,
        top_k=2,
        capacity_factor=8.0,  # no drops → decode ≡ forward is exactly testable
        expert_d_ff=96,
        dtype="float32",
        kv_chunk=16,
        remat=False,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        model=CONFIG,
        shapes=lm_shapes(),
        smoke=smoke,
        notes="Fully-MHA MoE; 64 experts top-8; QK-norm.",
    )
