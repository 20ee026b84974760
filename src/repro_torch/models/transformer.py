"""LM transformer family: GQA/MLA attention, dense/MoE FFN, optional MTP.

The counterpart of the reference package's ``models/transformer.py``: the
five LM architectures (deepseek-v3-671b, olmoe-1b-7b, qwen1.5-110b,
minicpm3-4b, nemotron-4-340b) from one config dataclass, pre-RMSNorm
blocks, flash-style chunked attention for prefill and absorbed-MLA or
cached-GQA attention for decode.

:class:`TransformerLM` holds the parameters under the reference's leaf
names (``embed``, ``layers.<i>.wq``, ``final_ln``, ``out_head``,
``mtp.block.0.<name>``) in its ``(d_in, d_out)`` layout. The reference
stacks each layer leaf into one ``(L, ...)`` array and scans over it; here
the layers are an ``nn.ModuleList`` walked by a Python loop. The KV cache
keeps the reference's stacked ``(L, B, S, ...)`` leaves, and
:func:`decode_step` writes each new position into it in place.

Training: :func:`loss_fn` is the reference's next-token cross-entropy
plus the MoE aux loss and, for DeepSeek-V3, the MTP head's loss; its
gradients come from autograd (the parameters require grad; the serving
paths run under ``torch.inference_mode``), and ``cfg.remat`` recomputes
each block in the backward pass as ``jax.checkpoint`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    DATA_AXES,
    apply_rope,
    blocked_attention,
    decode_attention,
    embed_lookup,
    ffn,
    maybe_shard,
    merge_heads,
    moe_ffn_ep,
    rms_norm,
    shard_batch,
    split_heads,
    write_position,
)
from repro_torch.models.params import flat_leaves


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """One LM architecture. The fields are the reference's, less
    ``unroll_layers``: the port's layer loop is eager Python, so always
    unrolled, and the field would change nothing. ``remat`` recomputes each
    block's activations in the backward pass (:func:`forward` under
    autograd); serving ignores it. The three sharding knobs act under an
    active mesh on DTensor parameters (the dry run) and are no-ops
    otherwise, but for ``moe_combine_dtype``, which the expert-parallel
    combine reads.
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    attn: str = "gqa"               # "gqa" | "mla"
    qkv_bias: bool = False          # Qwen1.5
    qk_norm: bool = False           # OLMoE
    ffn_kind: str = "swiglu"        # "swiglu" | "squared_relu" | "gelu"
    # MoE (n_experts == 0 → dense FFN)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # MLA
    q_lora_rank: int = 0            # 0 → direct q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MTP (DeepSeek-V3)
    mtp: bool = False
    mtp_weight: float = 0.3
    rope_theta: float = 10_000.0
    dtype: str = "float32"          # params + activations
    kv_chunk: int = 1024            # flash-attention chunk
    remat: bool = True
    # d_model-sharded decode activations (2D tensor-parallel serving: keeps
    # the FSDP weight shards from being gathered per decoded token), and a
    # reduced-precision MoE combine
    shard_decode_dmodel: bool = False
    moe_combine_dtype: str = "float32"
    # ZeRO-3: lay each layer's weights out (replicated, model) at their use
    # point, so the FSDP shard is gathered once a layer instead of
    # (B, S, ff)-sized partial matmul outputs being all-reduced
    zero3_gather_weights: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def num_params(self) -> int:
        """Analytic parameter count, from :func:`param_shapes` (nothing is
        allocated)."""
        return sum(math.prod(s) for s in flat_leaves(param_shapes(self)).values())

    def num_active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        total = self.num_params()
        if not self.moe:
            return total
        layers = param_shapes(self)["layers"]
        expert = sum(
            math.prod(layers[k])
            for k in ("moe_w_in", "moe_w_out", "moe_w_gate")
            if k in layers
        )
        active = expert * (self.top_k / self.n_experts)
        return int(total - expert + active)


# --------------------------------------------------------------------------
# parameter shapes / init
# --------------------------------------------------------------------------
def _layer_shapes(cfg: LMConfig) -> dict:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s: dict = {"ln1": (d,), "ln2": (d,)}
    if cfg.attn == "gqa":
        s.update(
            wq=(d, H * Dh), wk=(d, K * Dh), wv=(d, K * Dh), wo=(H * Dh, d)
        )
        if cfg.qkv_bias:
            s.update(bq=(H * Dh,), bk=(K * Dh,), bv=(K * Dh,))
        if cfg.qk_norm:
            s.update(q_norm=(Dh,), k_norm=(Dh,))
    else:  # mla
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        if qr:
            s.update(w_dq=(d, qr), q_ln=(qr,), w_uq=(qr, H * (nope + rope)))
        else:
            s.update(w_uq=(d, H * (nope + rope)))
        s.update(
            w_dkv=(d, r),
            kv_ln=(r,),
            w_kr=(d, rope),
            w_uk=(r, H * nope),
            w_uv=(r, H * vd),
            wo=(H * vd, d),
        )
    if cfg.moe:
        e, eff = cfg.n_experts, cfg.expert_d_ff
        s.update(
            router=(d, e),
            moe_w_in=(e, d, eff),
            moe_w_out=(e, eff, d),
        )
        if cfg.ffn_kind == "swiglu":
            s["moe_w_gate"] = (e, d, eff)
        if cfg.n_shared_experts:
            sff = eff * cfg.n_shared_experts
            s.update(sh_w_in=(d, sff), sh_w_out=(sff, d))
            if cfg.ffn_kind == "swiglu":
                s["sh_w_gate"] = (d, sff)
    else:
        s.update(w_in=(d, cfg.d_ff), w_out=(cfg.d_ff, d))
        if cfg.ffn_kind == "swiglu":
            s["w_gate"] = (d, cfg.d_ff)
    return s


def param_shapes(cfg: LMConfig) -> dict:
    """The reference's parameter tree of shapes: layer leaves stacked as
    ``(L, ...)``, the MTP block's as ``(1, ...)``."""
    L = cfg.n_layers
    layer = {k: (L, *v) for k, v in _layer_shapes(cfg).items()}
    shapes = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "layers": layer,
        "final_ln": (cfg.d_model,),
        "out_head": (cfg.d_model, cfg.vocab_size),
    }
    if cfg.mtp:
        shapes["mtp"] = {
            "proj": (2 * cfg.d_model, cfg.d_model),
            "ln_h": (cfg.d_model,),
            "ln_e": (cfg.d_model,),
            "block": {k: (1, *v) for k, v in _layer_shapes(cfg).items()},
        }
    return shapes


def tree_path(name: str) -> str:
    """The reference tree's path of a :class:`TransformerLM` parameter:
    ``"layers.3.wq"`` → ``"layers.wq"`` (the leaf stacked over layers),
    ``"mtp.block.0.wq"`` → ``"mtp.block.wq"``."""
    return ".".join(part for part in name.split(".") if not part.isdigit())


def _add_params(module: nn.Module, shapes: dict, dtype: torch.dtype, device) -> None:
    """Register an uninitialised, trainable parameter per name → shape."""
    for name, shape in shapes.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)
        ))


class Block(nn.Module):
    """One transformer layer's parameters, named as the reference's layer
    leaves (``wq``, ``ln1``, ``moe_w_in``, …)."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        _add_params(self, _layer_shapes(cfg), cfg.torch_dtype, device)

    def tensors(self) -> dict[str, torch.Tensor]:
        """Name → tensor, the mapping the layer functions take."""
        return dict(self.named_parameters(recurse=False))


class MTPHead(nn.Module):
    """DeepSeek-V3's multi-token-prediction parameters (``proj``, ``ln_h``,
    ``ln_e`` and one block), run by :func:`loss_fn`."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        d = cfg.d_model
        _add_params(self, {"proj": (2 * d, d), "ln_h": (d,), "ln_e": (d,)},
                    cfg.torch_dtype, device)
        self.block = nn.ModuleList([Block(cfg, device)])


class TransformerLM(nn.Module):
    """The parameters of one LM, allocated uninitialised in ``cfg``'s dtype
    on ``device`` (the card unless the caller says so;
    ``repro_torch.device.DeviceError`` without one); :func:`init_params`
    or ``repro_torch.convert.lm_params_from_numpy`` fills them. Calling the
    module runs :func:`forward`."""

    def __init__(self, cfg: LMConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, V, dt = cfg.d_model, cfg.vocab_size, cfg.torch_dtype
        _add_params(self, {"embed": (V, d)}, dt, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        _add_params(self, {"final_ln": (d,), "out_head": (d, V)}, dt, device)
        self.mtp = MTPHead(cfg, device) if cfg.mtp else None

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens, self.cfg)

    def param_tree(self) -> dict:
        """The reference's parameter tree, flat: its dotted leaf path →
        the parameter, or for a leaf stacked over layers (``layers.wq``,
        ``mtp.block.wq``) the list of this model's per-layer slices, in
        layer order. The optimizers take trees of this form."""
        tree: dict = {}
        for name, t in self.named_parameters():
            path = tree_path(name)
            if path == name:
                tree[path] = t
            else:
                tree.setdefault(path, []).append(t)
        return tree


def _init_leaf(t: torch.Tensor, name: str, fan_in: int, generator: torch.Generator):
    """The reference's rule: norm scales to ones, QKV biases to zeros,
    everything else ``normal · fan_in^-½`` drawn in float32 and cast."""
    if "ln" in name or "norm" in name:
        t.fill_(1)
    elif name in ("bq", "bk", "bv"):
        t.zero_()
    else:
        scale = (1.0 / max(fan_in, 1)) ** 0.5
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * scale)


def init_params(cfg: LMConfig, generator: torch.Generator, device="cuda") -> TransformerLM:
    """A :class:`TransformerLM` with random weights drawn from ``generator``
    (which must live on ``device``), one leaf at a time so that no stacked
    float32 temporary is made. ``fan_in`` is the reference's
    ``shape[-2]`` of the stacked leaf. The random streams are torch's, not
    JAX's: weights equal to the reference's come through
    ``repro_torch.convert.lm_params_from_numpy``. ``device`` is the card
    unless the caller says so."""
    model = TransformerLM(cfg, device)
    stacked = flat_leaves(param_shapes(cfg))
    with torch.no_grad():
        for name, t in model.named_parameters():
            shape = stacked[tree_path(name)]
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            _init_leaf(t, name.rsplit(".", 1)[-1], fan_in, generator)
    return model


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _positions(pos: int, device) -> torch.Tensor:
    return torch.full((1,), pos, device=device)


def _gqa_qkv(p: dict, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, B, S, H, Dh)
    k = split_heads(k, B, S, K, Dh)
    v = split_heads(v, B, S, K, Dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(p: dict, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    o = blocked_attention(
        q, k, v, causal=True, q_chunk=cfg.kv_chunk, kv_chunk=cfg.kv_chunk
    )
    B, S = x.shape[:2]
    return merge_heads(o, B, S, -1) @ p["wo"], (k, v)


def gqa_decode(p: dict, x: torch.Tensor, cfg: LMConfig, cache: dict, pos: int):
    """x: (B, 1, d); cache: {"k": (B, S, K, Dh), "v": ...}, written in place
    at ``pos``; pos: the current cache length."""
    B = x.shape[0]
    q, k_new, v_new = _gqa_qkv(p, x, cfg, _positions(pos, x.device))
    k, v = cache["k"], cache["v"]
    write_position(k, pos, k_new[:, 0])
    write_position(v, pos, v_new[:, 0])
    o = decode_attention(q, k, v, pos)
    return merge_heads(o, B, 1, -1) @ p["wo"], {"k": k, "v": v}


def _mla_q(p: dict, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = rms_norm(p["q_ln"], x @ p["w_dq"])
        q = cq @ p["w_uq"]
    else:
        q = x @ p["w_uq"]
    q = split_heads(q, B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_attention(p: dict, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    """Prefill MLA: explicit up-projection, flash-chunked attention. Returns
    the output and the latent cache entries (ckv, kr)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv = rms_norm(p["kv_ln"], x @ p["w_dkv"])
    kr = apply_rope(x @ p["w_kr"], positions, cfg.rope_theta)
    k_nope = split_heads(ckv @ p["w_uk"], B, S, H, nope)
    v = split_heads(ckv @ p["w_uv"], B, S, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, rope)], dim=-1)
    o = blocked_attention(
        q, k, v, causal=True, q_chunk=cfg.kv_chunk, kv_chunk=cfg.kv_chunk,
        scale=(nope + rope) ** -0.5,
    )
    return merge_heads(o, B, S, -1) @ p["wo"], (ckv, kr)


def mla_decode(p: dict, x: torch.Tensor, cfg: LMConfig, cache: dict, pos: int):
    """Absorbed-MLA decode: attention in the compressed latent space over
    the whole padded cache (float32 scores and context, masked by
    ``arange(S_max) <= pos``), cast to the activation dtype before ``wo``.
    The new latent entries are written into ``cache`` in place."""
    B = x.shape[0]
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    positions = _positions(pos, x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)  # (B,1,H,·)
    ckv_new = rms_norm(p["kv_ln"], x @ p["w_dkv"])
    kr_new = apply_rope(x @ p["w_kr"], positions, cfg.rope_theta)
    ckv, kr = cache["ckv"], cache["kr"]
    write_position(ckv, pos, ckv_new[:, 0])
    write_position(kr, pos, kr_new[:, 0])
    # absorb W_uk into q: q_eff[b,h,r] = Σ_n q_nope[b,h,n] · W_uk[r, h, n]
    w_uk = split_heads(p["w_uk"], r, H, nope)
    q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    scale = (nope + rope) ** -0.5
    ckv_f = ckv.float()
    s = (
        torch.einsum("bqhr,bsr->bhqs", q_eff.float(), ckv_f)
        + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
    ) * scale
    mask = torch.arange(ckv.shape[1], device=x.device) <= pos
    s = s.masked_fill(~mask[None, None, None, :], -math.inf)
    pattn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", pattn, ckv_f)  # latent ctx
    w_uv = split_heads(p["w_uv"], r, H, vd)
    o = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.float()).to(x.dtype)
    return merge_heads(o, B, 1, -1) @ p["wo"], {"ckv": ckv, "kr": kr}


# --------------------------------------------------------------------------
# transformer blocks
# --------------------------------------------------------------------------
def _ffn_part(p: dict, h: torch.Tensor, cfg: LMConfig):
    if cfg.moe:
        moe_params = {
            "router": p["router"],
            "w_in": p["moe_w_in"],
            "w_out": p["moe_w_out"],
        }
        if "moe_w_gate" in p:
            moe_params["w_gate"] = p["moe_w_gate"]
        if "sh_w_in" in p:
            moe_params["shared"] = {
                k.replace("sh_", ""): p[k]
                for k in ("sh_w_in", "sh_w_out", "sh_w_gate")
                if k in p
            }
        return moe_ffn_ep(
            moe_params,
            h,
            n_experts=cfg.n_experts,
            top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            expert_kind=cfg.ffn_kind,
            combine_dtype=(
                None if cfg.moe_combine_dtype == "float32"
                else getattr(torch, cfg.moe_combine_dtype)
            ),
        )
    return ffn(p, h, cfg.ffn_kind), torch.zeros((), dtype=torch.float32, device=h.device)


# weight name → model-parallel dim position (for the ZeRO-3 use-point gather)
_Z3_IN = ("wq", "wk", "wv", "w_in", "w_gate", "w_uq", "w_uk", "w_uv",
          "sh_w_in", "sh_w_gate")  # (d_in, X·model)
_Z3_OUT = ("wo", "w_out", "sh_w_out")  # (X·model, d_out)
_Z3_REP = ("w_dq", "w_dkv", "w_kr")  # no model dim → fully gathered


def _zero3(p: dict, cfg: LMConfig) -> dict:
    """At the use point, lay this layer's FSDP-sharded weights out back to
    (replicated over data, model-sharded): one all-gather of the small
    weight shard a layer instead of all-reducing activation-sized partial
    contractions (the ZeRO-3 schedule)."""
    if not cfg.zero3_gather_weights:
        return p
    out = {}
    for k, v in p.items():
        if k in _Z3_IN:
            out[k] = maybe_shard(v, None, "model")
        elif k in _Z3_OUT:
            out[k] = maybe_shard(v, "model", None)
        elif k in _Z3_REP:
            out[k] = maybe_shard(v, None, None)
        else:
            out[k] = v
    return out


def block(p: dict, h: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    p = _zero3(p, cfg)
    attn_fn = mla_attention if cfg.attn == "mla" else gqa_attention
    a, _ = attn_fn(p, rms_norm(p["ln1"], h), cfg, positions)
    h = shard_batch(h + a)
    f, aux = _ffn_part(p, rms_norm(p["ln2"], h), cfg)
    return shard_batch(h + f), aux


def block_decode(p: dict, h: torch.Tensor, cfg: LMConfig, cache: dict, pos: int):
    p = _zero3(p, cfg)
    dec_fn = mla_decode if cfg.attn == "mla" else gqa_decode
    a, cache = dec_fn(p, rms_norm(p["ln1"], h), cfg, cache, pos)
    h = shard_batch(h + a)
    f, _ = _ffn_part(p, rms_norm(p["ln2"], h), cfg)
    return h + f, cache


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------
def _logits(hn: torch.Tensor, out_head: torch.Tensor) -> torch.Tensor:
    """Logits in float32 from the activation-dtype operands, as the
    reference's ``preferred_element_type=float32``: a bf16 product would
    round the logits to bf16 and change greedy tokens."""
    return hn.float() @ out_head.float()


def _embed(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    return shard_batch(embed_lookup(params.embed, tokens).to(cfg.torch_dtype))


def forward(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig):
    """tokens: (B, S) int → (logits f32 (B, S, V), h_pre_norm, aux_loss).
    Under autograd with ``cfg.remat``, each block keeps only its input
    and is recomputed in the backward pass (``jax.checkpoint(body)``)."""
    S = tokens.shape[1]
    h = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.layers:
        if remat:
            h, a = checkpoint(block, layer.tensors(), h, cfg, positions,
                              use_reentrant=False)
        else:
            h, a = block(layer.tensors(), h, cfg, positions)
        aux = aux + a
    hn = rms_norm(params.final_ln, h)
    return _logits(hn, params.out_head), h, aux


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy in float32. The reference picks the label's
    logit with a one-hot contraction (so that vocab-sharded logits are
    never gathered); for finite logits that equals this gather of it, and
    so does its gradient, without a (B, S, V) one-hot. Labels must lie in
    the vocabulary, as the embedding lookup already requires."""
    logits = logits.float()
    # log-sum-exp about the (constant) row max: on vocab-sharded logits
    # each reduction is a partial over the shards, never a gather of them
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)) + m
    # the pick keeps its trailing axis until the difference is taken: on
    # vocab-sharded DTensor logits (the dry run) the gather is a masked
    # partial, which DTensor resolves only in the gather's own shape
    picked = torch.gather(logits, -1, labels.long()[..., None])
    return (lse - picked)[..., 0]


def loss_fn(params: TransformerLM, batch: dict, cfg: LMConfig):
    """Next-token loss of ``batch["tokens"]`` (B, S): the mean
    cross-entropy plus ``aux_loss_weight`` times the MoE aux loss and, with
    ``cfg.mtp``, ``mtp_weight`` times the MTP head's cross-entropy on token
    t+2 from h_t and embed(token t+1) (DeepSeek-V3). Returns ``(loss,
    {"ce", "aux"[, "mtp_ce"]})``, all float32 0-dim tensors."""
    tokens = batch["tokens"]
    logits, h, aux = forward(params, tokens, cfg)
    ce = _ce(logits[:, :-1], tokens[:, 1:]).mean()
    loss = ce + cfg.aux_loss_weight * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mtp = params.mtp
        h_in = rms_norm(mtp.ln_h, h[:, :-1])
        e_in = rms_norm(mtp.ln_e, _embed(params, tokens[:, 1:], cfg))
        x = torch.cat([h_in, e_in], dim=-1) @ mtp.proj
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = block(mtp.block[0].tensors(), x, cfg, positions)
        mtp_logits = _logits(rms_norm(params.final_ln, x), params.out_head)
        mtp_ce = _ce(mtp_logits[:, :-1], tokens[:, 2:]).mean()
        loss = loss + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def cache_shapes(cfg: LMConfig, batch: int, max_seq: int) -> dict:
    L = cfg.n_layers
    if cfg.attn == "mla":
        return {
            "ckv": (L, batch, max_seq, cfg.kv_lora_rank),
            "kr": (L, batch, max_seq, cfg.qk_rope_dim),
        }
    return {
        "k": (L, batch, max_seq, cfg.n_kv_heads, cfg.d_head),
        "v": (L, batch, max_seq, cfg.n_kv_heads, cfg.d_head),
    }


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device="cuda") -> dict:
    """A zeroed cache in the config's dtype, on ``device`` (the card unless
    the caller says so)."""
    device = resolve_device(device)
    return {
        k: torch.zeros(s, dtype=cfg.torch_dtype, device=device)
        for k, s in cache_shapes(cfg, batch, max_seq).items()
    }


def prefill(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig):
    """Full-sequence forward that also returns the per-layer cache.
    Returns (last-position logits f32 (B, V), cache stacked (L, ...))."""
    S = tokens.shape[1]
    h = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=h.device)
    attn_fn = mla_attention if cfg.attn == "mla" else gqa_attention
    kvs = []
    for layer in params.layers:
        p = _zero3(layer.tensors(), cfg)
        a, kv = attn_fn(p, rms_norm(p["ln1"], h), cfg, positions)
        h = shard_batch(h + a)
        f, _ = _ffn_part(p, rms_norm(p["ln2"], h), cfg)
        h = shard_batch(h + f)
        kvs.append(kv)
    hn = rms_norm(params.final_ln, h[:, -1])
    logits = _logits(hn, params.out_head)
    names = ("ckv", "kr") if cfg.attn == "mla" else ("k", "v")
    cache = {n: torch.stack([kv[i] for kv in kvs]) for i, n in enumerate(names)}
    return logits, cache


def decode_step(
    params: TransformerLM, cache: dict, tokens: torch.Tensor, pos: int, cfg: LMConfig
):
    """One decode step. tokens: (B, 1) int; pos: the current position (the
    cache length so far). cache leaves are (L, B, S, ...); position ``pos``
    of every layer is written in place. Returns (logits f32 (B, V), cache)."""
    h = _embed(params, tokens, cfg)
    if cfg.shard_decode_dmodel:
        h = maybe_shard(h, None, None, DATA_AXES)
    for i, layer in enumerate(params.layers):
        layer_cache = {k: v[i] for k, v in cache.items()}
        h, _ = block_decode(layer.tensors(), h, cfg, layer_cache, pos)
        if cfg.shard_decode_dmodel:
            h = maybe_shard(h, None, None, DATA_AXES)
        else:
            h = shard_batch(h)
    hn = rms_norm(params.final_ln, h[:, -1])
    return _logits(hn, params.out_head), cache
