"""Shared neural layers, plain functions on tensors.

The counterpart of the reference package's ``models/layers.py``, with the
same names, rounding order and masking:

  * params are mappings of name → tensor; every layer fn is
    ``fn(params, x, ...) -> y`` with no global state;
  * activations run in the config's dtype, softmax / norms / the MoE
    combine accumulate in float32;
  * attention is chunked (online softmax, flash-style) and never
    materializes the full (S × S) score matrix, so memory at long prompts
    stays bounded by one (B, q_chunk, H, kv_chunk) float32 block.

Weights keep the reference's ``(d_in, d_out)`` layout: a projection is
``x @ w``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


# ----------------------------------------------------------------- norms
def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32, cast back to ``x``'s dtype and only
    then multiplied by ``scale`` (the order matters in bf16)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


# ----------------------------------------------------------------- rope
def rope_freqs(dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    """The (dim/2,) rotary frequencies, computed in float64 and cast to
    float32 as the reference does."""
    exps = torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim
    return (1.0 / theta ** exps).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, n_heads, dim) or
    (..., S, dim); positions: (..., S). Frequencies are :func:`rope_freqs`
    on ``x``'s device."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    if x.dim() - angles.dim() == 2:  # head axis present in x
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- blocked attn
def _expand_kv(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, K, D) → (B, S, H, D): repeat each kv head G = H/K times (q
    head h reads kv head h // G)."""
    K = x.shape[2]
    if K == H:
        return x
    return torch.repeat_interleave(x, H // K, dim=2)


def blocked_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, K, Dh)
    v: torch.Tensor,  # (B, Sk, K, Dv)
    *,
    causal: bool,
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash-style blocked attention with static Python loops over chunks.

    Causal blocks entirely in the future are skipped, only diagonal blocks
    are masked, and the online softmax keeps the live score block at
    (B, q_chunk, H, kv_chunk) float32. Fully masked rows are guarded
    (``m_safe``) and the normaliser is clamped at 1e-20, as in the
    reference. Returns (B, Sq, H, Dv) in ``q``'s dtype.
    """
    B, Sq, H, Dh = q.shape
    Sk, Dv = v.shape[1], v.shape[3]
    scale = Dh ** -0.5 if scale is None else scale
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    qf = q.float() * scale

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    n_q = (Sq + q_chunk - 1) // q_chunk
    n_kv = (Sk + kv_chunk - 1) // kv_chunk
    dev = q.device

    outs = []
    for qi in range(n_q):
        q_lo, q_hi = qi * q_chunk, min((qi + 1) * q_chunk, Sq)
        qb = qf[:, q_lo:q_hi]
        m = torch.full((B, q_hi - q_lo, H), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, q_hi - q_lo, H), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_hi - q_lo, H, Dv), dtype=torch.float32, device=dev)
        for ji in range(n_kv):
            kv_lo, kv_hi = ji * kv_chunk, min((ji + 1) * kv_chunk, Sk)
            if causal and kv_lo > q_hi - 1:
                continue  # block entirely in the future
            kb = k[:, kv_lo:kv_hi].float()
            vb = v[:, kv_lo:kv_hi].float()
            s = torch.einsum("bqhd,bshd->bqhs", qb, kb)
            if causal and kv_hi - 1 > q_lo:  # diagonal block: apply the mask
                mask = (kv_lo + torch.arange(kv_hi - kv_lo, device=dev))[None, :] <= (
                    q_lo + torch.arange(q_hi - q_lo, device=dev)
                )[:, None]
                s = s.masked_fill(~mask[None, :, None, :], -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            corr = torch.where(
                torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m)
            )
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqhs,bshd->bqhd", p, vb)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-20))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k: torch.Tensor,  # (B, S, K, Dh)  (full cache)
    v: torch.Tensor,  # (B, S, K, Dv)
    pos: int,  # current position (attend to [0, pos])
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention against the whole padded cache, positions
    past ``pos`` masked."""
    H, Dh = q.shape[2], q.shape[3]
    S = k.shape[1]
    scale = Dh ** -0.5 if scale is None else scale
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bqhd,bshd->bqhs", q.float() * scale, k.float())
    mask = torch.arange(S, device=q.device) <= pos
    s = s.masked_fill(~mask[None, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhs,bshd->bqhd", p, v.float())
    return out.to(q.dtype)


# ----------------------------------------------------------------- ffn
def ffn(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Dense FFN: ``swiglu``, ``squared_relu`` (Nemotron-4) or ``gelu``
    (the tanh approximation, as ``jax.nn.gelu``); activations in float32,
    cast back before the output projection."""
    if kind == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_in"]
        h = F.silu(g.float()).to(x.dtype) * u
    elif kind == "squared_relu":
        h = x @ params["w_in"]
        h = torch.square(F.relu(h.float())).to(x.dtype)
    elif kind == "gelu":
        h = x @ params["w_in"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(kind)
    return h @ params["w_out"]


def _normal(generator: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)


def init_ffn(
    generator: torch.Generator, d_model: int, d_ff: int, kind: str, dtype,
    device="cuda",
) -> dict:
    """He-initialised FFN weights on ``device`` (the card unless the caller
    says so), drawn from ``generator``, which lives there."""
    device = resolve_device(device)
    s_in = (2.0 / d_model) ** 0.5
    s_out = (2.0 / d_ff) ** 0.5
    p = {
        "w_in": _normal(generator, (d_model, d_ff), s_in, dtype, device),
        "w_out": _normal(generator, (d_ff, d_model), s_out, dtype, device),
    }
    if kind == "swiglu":
        p["w_gate"] = _normal(generator, (d_model, d_ff), s_in, dtype, device)
    return p


# ----------------------------------------------------------------- MoE
def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    by the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(
    params,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    expert_kind: str = "swiglu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based, capacity-limited top-k routing, dispatched per batch row.

    Each row's (token, choice) pairs are sorted by expert (a stable sort),
    ranked within their expert, and those ranked at or past the capacity
    ``ceil(S·k/E·capacity_factor)`` are dropped: they go to slot
    (E−1, cap−1) with a zero payload. Every expert's matmul runs over its
    (B, cap) slots; the weighted combine is a float32 scatter-add back to
    the tokens. Returns (y, aux_loss) with the Switch load-balancing loss.
    """
    B, S, d = x.shape
    E, k = n_experts, top_k
    dev = x.device

    logits = (x @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, k)  # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)  # renorm

    # ---- load-balancing aux loss (Switch): E * Σ_e f_e * p_e
    me = probs.mean(dim=(0, 1))  # (E,)
    flat_idx = idx.reshape(-1)
    ce = torch.zeros(E, device=dev).index_add_(
        0, flat_idx, torch.ones(flat_idx.shape, device=dev)
    ) / (B * S * k)
    aux = E * torch.sum(me * ce)

    # ---- per-row sorted dispatch with fixed per-expert capacity
    cap = math.ceil(S * k / E * capacity_factor)
    flat_e = idx.reshape(B, S * k)
    flat_t = torch.arange(S, device=dev)[:, None].expand(S, k).reshape(S * k)
    flat_g = gate.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # (B, S*k)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]  # (B, S*k) token index within the row
    sg = torch.gather(flat_g, 1, order)
    # rank within expert group (se sorted per row)
    pos = torch.arange(S * k, device=dev)[None, :] - torch.searchsorted(
        se, se, side="left"
    )
    keep = pos < cap
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S * k)
    tokens = torch.gather(x, 1, st[..., None].expand(B, S * k, d))
    # slot (e, b, c) of the (E, B, cap) buffer is row (e·B + b)·cap + c; a
    # row-wise index_add_ / index_select (whose gradients are each other)
    # in place of multi-index puts and gathers, which autograd sorts
    slot = (torch.where(keep, se, E - 1) * B + bidx) * cap + torch.where(keep, pos, cap - 1)
    xe = torch.zeros((E * B * cap, d), dtype=x.dtype, device=dev).index_add_(
        0, slot.reshape(-1), torch.where(keep[..., None], tokens, 0).reshape(-1, d)
    ).reshape(E, B * cap, d)

    # ---- expert computation: (E, B·C, d) × (E, d, f), one matmul an expert
    if expert_kind == "swiglu":
        g = torch.bmm(xe, params["w_gate"])
        u = torch.bmm(xe, params["w_in"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = torch.bmm(xe, params["w_in"])
        h = torch.square(F.relu(h.float())).to(x.dtype)
    y_buf = torch.bmm(h, params["w_out"]).reshape(E * B * cap, d)

    # ---- combine (weighted gather back to tokens; dropped slots add 0)
    slot = (se * B + bidx) * cap + torch.clamp(pos, max=cap - 1)
    gathered = torch.index_select(y_buf, 0, slot.reshape(-1)).reshape(B, S * k, d)
    contrib = torch.where(
        keep[..., None], gathered * sg[..., None].to(x.dtype),
        torch.zeros_like(gathered),
    )
    y = torch.zeros((B * S, d), dtype=torch.float32, device=dev).index_add_(
        0, (bidx * S + st).reshape(-1), contrib.float().reshape(-1, d))
    y = y.reshape(B, S, d).to(x.dtype)

    if "shared" in params:  # DeepSeek shared expert(s), always-on
        y = y + ffn(params["shared"], x, expert_kind)
    return y, aux


def moe_ffn_ep(
    params,
    x: torch.Tensor,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    expert_kind: str = "swiglu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE entry point. The reference runs :func:`moe_ffn`
    when no ``"model"`` mesh axis is active and an explicit-collective
    expert-parallel body otherwise. That body (experts sharded over
    ``"model"``, one psum of the combined output a layer) is not yet ported:
    the port has no mesh on the serving path, so this always runs
    :func:`moe_ffn`."""
    return moe_ffn(
        params, x, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, expert_kind=expert_kind,
    )


# -------------------------------------- gathers and scatters, JAX's rules
# The GNN and recsys modules index with caller-given ids. JAX never raises
# on an out-of-range index, where PyTorch raises on the host and asserts on
# the card (which ends the CUDA context); these give each call the
# reference's answer instead. A negative index counts from the end, as in
# numpy, before the range check.
def _from_end(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(idx < 0, idx + n, idx)


def rows_of(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for ids in range, shaped ``idx.shape + row shape``, by
    ``index_select``: its gradient is an ``index_add_``, where autograd
    would sort the ids of an advanced-index gather to accumulate them."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)``: rows out of range are NaN."""
    n = table.shape[0]
    i = _from_end(idx, n)
    ok = ((i >= 0) & (i < n)).reshape(i.shape + (1,) * (table.dim() - 1))
    return torch.where(ok, rows_of(table, i.clamp(0, n - 1)), math.nan)


def take_along(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx, dim)``, ``idx`` broadcast over the
    other axes: entries out of range are NaN."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = idx.shape[dim]
    i = _from_end(idx, n).expand(shape)
    ok = (i >= 0) & (i < n)
    return torch.where(ok, torch.gather(x, dim, i.clamp(0, n - 1).long()), math.nan)


def clip_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as JAX indexes: an index out of range reads the clamped
    row, and sends it no gradient (JAX's backward scatter drops it)."""
    n = x.shape[0]
    i = _from_end(idx, n)
    rows = rows_of(x, i.clamp(0, n - 1))
    if not rows.requires_grad:
        return rows
    ok = ((i >= 0) & (i < n)).reshape(i.shape + (1,) * (x.dim() - 1))
    return torch.where(ok, rows, rows.detach())


def segment_sum(data, seg: torch.Tensor, n: int, chunk: int | None = None) -> torch.Tensor:
    """``jax.ops.segment_sum(data, seg, num_segments=n)``: ``index_add_``
    into ``n`` rows, a segment id out of ``[0, n)`` dropped. ``data`` is
    the rows, or a function ``data(lo, hi)`` that makes rows ``lo:hi`` (a
    gather), called for ``chunk`` rows at a time so that all of them never
    exist at once; the sum is the same. On the card the float adds land in
    no fixed order."""
    rows = data if callable(data) else (lambda lo, hi: data[lo:hi])
    seg = torch.where((seg >= 0) & (seg < n), seg, n)  # to a spare row, cut off
    m = seg.shape[0]
    step = chunk or max(m, 1)
    out = None
    for lo in range(0, max(m, 1), step):
        part = rows(lo, lo + step)
        if out is None:
            out = part.new_zeros((n + 1,) + tuple(part.shape[1:]))
        out.index_add_(0, seg[lo:lo + step], part)
    return out[:n]
