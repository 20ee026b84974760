"""DeepSeek-V3 671B — MLA, 1 shared + 256 routed experts (top-8), MTP.
[arXiv:2412.19437; hf]. Uniform MoE stack (the real model's first three
dense layers are folded into the MoE stack — noted in DESIGN.md)."""

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent-compressed, all heads share the latent
    d_head=128,
    d_ff=2048,               # MoE expert intermediate size
    vocab_size=129280,
    attn="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    ffn_kind="swiglu",
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    expert_d_ff=2048,
    mtp=True,
    dtype="bfloat16",
)


def smoke():
    return LMConfig(
        name="deepseek-v3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab_size=256,
        attn="mla",
        q_lora_rank=32,
        kv_lora_rank=24,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        ffn_kind="swiglu",
        n_experts=8,
        top_k=2,
        capacity_factor=8.0,  # no drops → decode ≡ forward is exactly testable
        n_shared_experts=1,
        expert_d_ff=96,
        mtp=True,
        dtype="float32",
        kv_chunk=16,
        remat=False,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="deepseek-v3-671b",
        family="lm",
        model=CONFIG,
        shapes=lm_shapes(),
        smoke=smoke,
        notes="MLA + fine-grained MoE + MTP; absorbed-MLA decode keeps the "
        "500k cache in latent space (576 dims/token vs 32768 for full KV).",
    )
