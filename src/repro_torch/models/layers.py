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

import functools
import math
import sys

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.runtime.sharding import active_mesh, axis_names


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

    On DTensors the attention runs on each rank's own batch rows and heads
    (:func:`_attention_on_shards`).
    """
    if _is_dtensor(q):
        return _attention_on_shards(q, k, v, causal=causal, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk, scale=scale)
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
    past ``pos`` masked. On a DTensor cache each rank attends over its own
    positions (:func:`_decode_on_shards`)."""
    if _is_dtensor(k):
        return _decode_on_shards(q, k, v, pos, scale)
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


def _attention_on_shards(q, k, v, **kw):
    """:func:`blocked_attention` on DTensors as one region of local blocks
    (``local_map``): the batch keeps its shards, the heads shard over the
    mesh axis that shards q's heads evenly, sequences are whole. Where the
    KV heads do not split over that axis (8 over 16) each rank takes all of
    them and picks its q heads' own. No collective runs inside; DTensor's
    op-by-op propagation would gather the score blocks instead."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    q_pl, kv_pl, heads = [], [], None
    for i, (n, pl) in enumerate(zip(mesh.shape, q.placements)):
        if isinstance(pl, Shard) and pl.dim == 0:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        elif isinstance(pl, Shard) and pl.dim == 2 and heads is None and H % n == 0:
            heads = i
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2) if K % n == 0 else Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    m = mesh.get_local_rank(heads) if heads is not None else 0

    def region(ql, kl, vl):
        Hl = ql.shape[2]
        if kl.shape[2] == K and Hl < H:  # whole KV heads: this rank's q heads' own
            idx = (m * Hl + torch.arange(Hl, device=kl.device)) // (H // K)
            kl, vl = torch.index_select(kl, 2, idx), torch.index_select(vl, 2, idx)
        return blocked_attention(ql, kl, vl, **kw)

    return local_map(region, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _decode_on_shards(q, k, v, pos: int, scale):
    """:func:`decode_attention` over a DTensor cache whose positions shard
    over some mesh axes: each rank scores its own positions, and the
    softmax's max and sums and the weighted values are all-reduced over
    those axes (flash-decoding); the batch keeps its shards."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.runtime.sharding import axis_group

    mesh = k.device_mesh
    q_pl, kv_pl, seq = [], [], []
    for i, pl in enumerate(k.placements):
        if isinstance(pl, Shard) and pl.dim in (0, 1):
            q_pl.append(Shard(0) if pl.dim == 0 else Replicate())
            kv_pl.append(pl)
            if pl.dim == 1:
                seq.append(mesh.mesh_dim_names[i])
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    with unset_fake_temporarily():  # index arithmetic, also in the dry run
        _, offset = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    lo = offset[1]
    group = axis_group(mesh, seq) if seq else None

    def region(ql, kl, vl):
        import torch.distributed as dist

        H, Dh = ql.shape[2], ql.shape[3]
        sc = Dh ** -0.5 if scale is None else scale
        kl, vl = _expand_kv(kl, H), _expand_kv(vl, H)
        s = torch.einsum("bqhd,bshd->bqhs", ql.float() * sc, kl.float())
        mask = lo + torch.arange(kl.shape[1], device=ql.device) <= pos
        s = s.masked_fill(~mask[None, None, None, :], -math.inf)
        mx = _all_reduce(s.amax(dim=-1, keepdim=True), group, dist.ReduceOp.MAX)
        p = torch.exp(s - mx)
        den = _all_reduce(p.sum(dim=-1, keepdim=True), group)
        num = _all_reduce(torch.einsum("bqhs,bshd->bqhd", p, vl.float()), group)
        return (num / den).to(ql.dtype)

    return local_map(region, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


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


# ------------------------------------------------------- sharding helper
def maybe_shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` that degrades to a
    no-op: on a DTensor under an active mesh (``runtime.sharding.
    set_mesh_compat``) it redistributes ``x`` to the layout ``axes`` names,
    one entry a dimension (an axis name, a tuple of names, or None); names
    absent from the mesh are dropped. A plain tensor, or no active mesh,
    is returned as it is."""
    mesh = active_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    from repro_torch.runtime.sharding import P, placements

    avail = set(axis_names(mesh))

    def clean(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(n for n in a if n in avail)
            return kept if kept else None
        return a if a in avail else None

    want = placements(P(*[clean(a) for a in axes]), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


DATA_AXES = ("pod", "data")  # batch-sharding axes (whichever exist)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. On a DTensor table, a vocab-parallel lookup
    (``local_map``): each ``"model"`` rank looks up the ids in its own rows
    (the FSDP column shards gathered), zeros the others, and the rows are
    summed over ``"model"``; the table's gradient comes back partial over
    the data axes that shard the ids. DTensor's own rules for the gather
    and its backward fail on a vocab-sharded table."""
    if not _is_dtensor(table):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    sharded_ids = _is_dtensor(ids) and any(isinstance(p, Shard) and p.dim == 0
                                           for p in ids.placements)
    t_pl, g_pl, i_pl = [], [], []
    vocab = False
    for i, name in enumerate(names):
        rows = name == "model" and any(isinstance(p, Shard) and p.dim == 0
                                       for p in [table.placements[i]])
        vocab = vocab or rows
        t_pl.append(Shard(0) if rows else Replicate())
        batch = name != "model" and sharded_ids
        g_pl.append(Shard(0) if rows else (Partial() if batch else Replicate()))
        i_pl.append(Shard(0) if batch else Replicate())
    model_g = mesh.get_group("model") if vocab else None
    m = mesh.get_local_rank("model") if vocab else 0

    def region(tl, il):
        il = il.long()
        if model_g is None:
            return tl[il]
        n = tl.shape[0]
        local = il - m * n
        ok = (local >= 0) & (local < n)
        rows = tl[local.clamp(0, n - 1)] * ok[..., None].to(tl.dtype)
        return _psum(rows, model_g)

    return local_map(region, out_placements=i_pl, in_placements=(t_pl, i_pl),
                     in_grad_placements=(g_pl, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def write_position(cache: torch.Tensor, pos: int, value: torch.Tensor) -> None:
    """``cache[:, pos] = value`` in place (cache (B, S, ...), value
    (B, ...)). On a DTensor cache whose sequence dimension is sharded, the
    rank that holds position ``pos`` writes it into its own shard (DTensor
    would gather the cache, write the copy, and lose the write)."""
    value = value.to(cache.dtype)
    if not _is_dtensor(cache):
        cache[:, pos] = value
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh, pls = cache.device_mesh, list(cache.placements)
    # the value as the cache's rows are laid out, whole along the sequence
    vpl = [Replicate() if not isinstance(p, Shard) or p.dim == 1
           else Shard(p.dim - 1 if p.dim > 1 else 0) for p in pls]
    with unset_fake_temporarily():  # index arithmetic, also in the dry run
        shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pls)
    lo, n = offset[1], shape[1]

    def region(c, v):
        if lo <= pos < lo + n:
            c[:, pos - lo] = v
        return c

    local_map(region, out_placements=pls, in_placements=(pls, vpl), device_mesh=mesh,
              redistribute_inputs=True)(cache, value)


def split_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``, where the reshape splits ``x``'s last
    dimension into (heads, head dim). On a DTensor whose last dimension is
    sharded over more ranks than divide the heads (8 KV heads over a
    16-way ``"model"`` axis), that dimension is replicated first: GSPMD
    pads such a split, DTensor refuses it."""
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        sizes = x.device_mesh.shape
        last = x.dim() - 1
        ways = math.prod(n for n, pl in zip(sizes, x.placements)
                         if isinstance(pl, Shard) and pl.dim == last)
        if shape[-2] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
                for pl in x.placements])
    return x.reshape(*shape)


def merge_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``, where the reshape merges ``x``'s (heads, head
    dim) into one dimension. Where the heads do not split over a mesh axis
    that shards them, or holds partial sums (MiniCPM3's 40 heads over 16
    ranks), that axis is replicated first: DTensor refuses the uneven
    merge."""
    if _is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate, Shard

        hd = x.dim() - 2

        def uneven(n, pl):
            on_heads = isinstance(pl, Partial) or (isinstance(pl, Shard) and pl.dim == hd)
            return on_heads and x.shape[hd] % n

        want = [Replicate() if uneven(n, pl) else pl
                for n, pl in zip(x.device_mesh.shape, x.placements)]
        if want != list(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(*shape)


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """Activations laid out batch-sharded over the data axes when the
    batch splits over them, else replicated: the layout GSPMD propagates
    from the reference's batch-sharded inputs, which DTensor's op-by-op
    propagation does not find by itself (it would carry the residual
    stream as partial sums into the next matmul, and gather its weights
    whole to keep them so). A no-op as :func:`maybe_shard`."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from repro_torch.runtime.sharding import axis_sizes

    sizes = axis_sizes(mesh)
    n_dp = math.prod(sizes[a] for a in DATA_AXES if a in sizes)
    lead = DATA_AXES if x.shape[0] % n_dp == 0 else None
    return maybe_shard(x, lead, *(None,) * (x.dim() - 1))


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
    # reshard: row-sharded → expert-sharded (the EP all-to-all)
    xe = maybe_shard(xe, "model", DATA_AXES, None)

    # ---- expert computation: (E, B·C, d) × (E, d, f), one matmul an expert
    if expert_kind == "swiglu":
        g = torch.bmm(xe, params["w_gate"])
        u = torch.bmm(xe, params["w_in"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = torch.bmm(xe, params["w_in"])
        h = torch.square(F.relu(h.float())).to(x.dtype)
    # reshard back: expert-sharded → row-sharded (the return all-to-all)
    y_buf = maybe_shard(torch.bmm(h, params["w_out"]), None, DATA_AXES, None)
    y_buf = y_buf.reshape(E * B * cap, d)

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
    x: torch.Tensor,  # (B, S, d): batch over the data axes, or replicated
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    expert_kind: str = "swiglu",
    combine_dtype: torch.dtype | None = None,
    global_batch: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with explicit collectives.

    Layout: expert weights (E, d, f) laid out ``P("model", dp, None)`` —
    expert parallelism over ``"model"``, FSDP over the other axes ``dp``.
    Activations are replicated over ``"model"``, so every model rank routes
    every local token itself and runs only the ``E / n_model`` experts it
    owns; the one cross-``"model"`` collective is an all-reduce of the
    combined (B_loc, S, d) output a layer (plus the FSDP all-gather of the
    weights over ``dp``). No dispatch all-to-all.

    With no active mesh (``runtime.sharding.set_mesh_compat``), or one
    without a ``"model"`` axis, this is :func:`moe_ffn`. Under one it never
    is: the capacity is per local token count, ``ceil(T·k/E·cf)`` with
    ``T = B_loc·S``, where :func:`moe_ffn`'s is per batch row, so with
    drops the two differ. DTensor inputs run the region under ``local_map``
    (the dry run; inputs are redistributed to the region's layout). Plain
    tensors are this rank's shards on a world whose ranks all call it:
    ``x`` its batch block, or the whole batch when ``global_batch`` (default
    ``x``'s batch × the ``dp`` extent) does not split over ``dp``; the
    weights its ``(E_loc, d / n_dp, f)`` blocks; the router whole.
    Gradients are the unsharded function's, as ``shard_map``'s transposes
    give them: sharded weights get their block of it, the router and ``x``
    the whole (same on every rank). ``combine_dtype`` casts the combined
    output before the all-reduce (half the wire bytes in bf16)."""
    mesh = active_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return moe_ffn(
            params, x, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor, expert_kind=expert_kind,
        )
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.sharding import axis_sizes, fsdp_axes

    dp = fsdp_axes(mesh)
    sizes = axis_sizes(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    distributed = isinstance(x, DTensor)
    if global_batch is None:
        global_batch = x.shape[0] * (1 if distributed else n_dp)
    batch_sharded = global_batch % n_dp == 0 and global_batch >= n_dp
    gated = expert_kind == "swiglu"
    model_g, dp_g = _ep_groups(mesh, dp)
    region = functools.partial(
        _ep_region, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, gated=gated, combine_dtype=combine_dtype,
        rank=mesh.get_local_rank("model"), model_g=model_g,
        dp_g=dp_g if n_dp > 1 else None, n_dp=n_dp, batch_sharded=batch_sharded,
    )
    w_gate = params["w_gate"] if gated else params["w_in"][:, :, :0]
    args = (x, params["router"], params["w_in"], params["w_out"], w_gate)
    if distributed:
        from torch.distributed.tensor.experimental import local_map

        from repro_torch.runtime.sharding import P, placements

        bx = dp if batch_sharded else None
        specs = (P(bx, None, None), P(None, None), P("model", dp, None),
                 P("model", None, dp), P("model", dp, None))
        y, aux = local_map(
            region,
            out_placements=(placements(P(bx, None, None), mesh), placements(P(), mesh)),
            in_placements=tuple(placements(s, mesh) for s in specs),
            device_mesh=mesh, redistribute_inputs=True,
        )(*args)
    else:
        y, aux = region(*args)

    if "shared" in params:
        y = y + ffn(params["shared"], x, expert_kind)
    return y, aux


def _ep_groups(mesh, dp: tuple):
    """The ``"model"`` axis's process group and the one over all of
    ``dp`` (flattened in mesh order; ``None`` without dp axes)."""
    from repro_torch.runtime.sharding import axis_group

    return mesh.get_group("model"), (axis_group(mesh, dp) if dp else None)


# Collectives with the transposes JAX's ``shard_map`` gives them. A value
# the same on every rank of a group (invariant) that meets one that
# differs (varying) is made varying by ``pvary``, whose gradient sums over
# the group; ``psum`` makes a varying value invariant and passes the
# gradient through. ``None`` is a group of one rank. A gloo group takes
# host tensors: card tensors go through host copies.
def _via_host(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) != "nccl"


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """The reduction (a sum unless ``op`` says) over ``group`` of a fresh
    copy of ``t``."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    out = t.detach().contiguous().clone()
    if group is None:
        return out
    if _via_host(out, group):
        h = out.cpu()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, scale):
        ctx.scale = scale
        out = _all_reduce(t, group)
        return out * scale if scale != 1 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1 else g), None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` in group-rank order; its gradient is
    the reduce-scatter (a sum) of the same blocks."""

    @staticmethod
    def forward(ctx, t, dim, group):
        import torch.distributed as dist

        ctx.dim, ctx.group = dim, group
        src = t.detach().contiguous()
        host = _via_host(src, group)
        if host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(t.device) if host else out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = dist.get_world_size(ctx.group)
        host = _via_host(g, ctx.group)
        src = g.cpu() if host else g
        chunks = [c.contiguous() for c in torch.chunk(src, n, dim=ctx.dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=ctx.group)
        return (out.to(g.device) if host else out), None, None


def _psum(t, group):
    return _PSum.apply(t, group, 1)


def _pmean(t, group, n: int):
    return _PSum.apply(t, group, 1.0 / n)


def _pvary(t, *groups):
    for g in groups:
        if g is not None:
            t = _PVary.apply(t, g)
    return t


def _all_gather(t, dim: int, group):
    return t if group is None else _AllGather.apply(t, dim, group)


def _ep_region(x_loc, router, w_in_loc, w_out_loc, w_gate_loc, *, n_experts, top_k,
               capacity_factor, gated, combine_dtype, rank, model_g, dp_g, n_dp,
               batch_sharded):
    """One rank's share of :func:`moe_ffn_ep` on local blocks: x_loc
    (B_loc, S, d); w_in_loc (E_loc, d_loc, f); w_out_loc (E_loc, f, d_loc)."""
    Bl, S, d = x_loc.shape
    E_loc = w_in_loc.shape[0]
    dev = x_loc.device
    # FSDP gather of this layer's expert weights (transient, one layer live)
    w_in = _all_gather(w_in_loc, 1, dp_g)
    w_out = _all_gather(w_out_loc, 2, dp_g)
    w_gate = _all_gather(w_gate_loc, 1, dp_g) if gated else None
    # what the batch's layout makes varying: tokens over dp when sharded,
    # and the gathered weights over dp always
    tok_groups = (model_g,) if batch_sharded else (model_g, dp_g)

    T = Bl * S
    xt = x_loc.reshape(T, d)
    logits = (xt @ (_pvary(router, dp_g) if batch_sharded else router)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, top_k)  # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # aux loss over the global batch (mean over dp; model ranks identical)
    me = probs.mean(dim=0)
    flat_e = idx.reshape(-1)
    ce = torch.zeros(n_experts, device=dev).index_add_(
        0, flat_e, torch.ones(flat_e.shape, device=dev)) / (T * top_k)
    aux = n_experts * torch.sum(me * ce)
    if batch_sharded and dp_g is not None:
        aux = _pmean(aux, dp_g, n_dp)

    # sorted local dispatch, restricted to the experts this rank owns
    cap = math.ceil(T * top_k / n_experts * capacity_factor)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    pos = torch.arange(T * top_k, device=dev) - torch.searchsorted(se, se, side="left")
    se_loc = se - rank * E_loc
    keep = (pos < cap) & (se_loc >= 0) & (se_loc < E_loc)
    slot = torch.where(keep, se_loc, E_loc - 1) * cap + torch.where(keep, pos, cap - 1)
    tokens = torch.index_select(_pvary(xt, *tok_groups), 0, st)
    buf = torch.zeros((E_loc * cap, d), dtype=x_loc.dtype, device=dev).index_add_(
        0, slot, torch.where(keep[:, None], tokens, torch.zeros_like(tokens))
    ).reshape(E_loc, cap, d)

    if gated:
        g = torch.bmm(buf, w_gate)
        u = torch.bmm(buf, w_in)
        h = F.silu(g.float()).to(x_loc.dtype) * u
    else:
        h = torch.bmm(buf, w_in)
        h = torch.square(F.relu(h.float())).to(x_loc.dtype)
    y_buf = torch.bmm(h, w_out).reshape(E_loc * cap, d)

    # combine: map (expert, slot) back to (token, k) by the inverse
    # permutation and gather; the weighted k-sum accumulates in float32
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(T * top_k, device=dev))
    pos_tok = pos[inv].reshape(T, top_k)
    se_loc_tok = idx - rank * E_loc  # (T, k)
    keep_tok = (pos_tok < cap) & (se_loc_tok >= 0) & (se_loc_tok < E_loc)
    vals = torch.index_select(
        y_buf, 0,
        (se_loc_tok.clamp(0, E_loc - 1) * cap + pos_tok.clamp(0, cap - 1)).reshape(-1),
    ).reshape(T, top_k, d)
    gv = _pvary(gate, *tok_groups)
    w = torch.where(keep_tok, gv, torch.zeros_like(gv))
    y = torch.einsum("tkd,tk->td", vals.float(), w)
    if combine_dtype is not None:
        y = y.to(combine_dtype)  # halve the all-reduce's wire bytes
    # combine across expert owners: the one cross-"model" collective
    y = _psum(y, model_g)
    if not batch_sharded and dp_g is not None:
        # replicated batch (B < dp extent, e.g. B = 1 decode): y is the same
        # on every dp rank; the mean keeps the gathered weights' gradient
        # the unsharded one, as the reference's pmean does
        y = _pmean(y, dp_g, n_dp)
    return y.reshape(Bl, S, d).to(x_loc.dtype), aux


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
        if _is_dtensor(out):  # DTensor's in-place index_add_ can mislay its shards
            out = out.index_add(0, seg[lo:lo + step], part)
        else:
            out.index_add_(0, seg[lo:lo + step], part)
    return out[:n]


def _is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor: a dictionary read and an ``isinstance``
    (no import), as it runs several times a layer on the serving path. No
    DTensor exists before ``torch.distributed.tensor`` is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)
