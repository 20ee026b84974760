"""Recsys rankers: DIEN, BERT4Rec, xDeepFM, BST.

The counterpart of the reference package's ``models/recsys.py``. The hot
path is the sparse embedding lookup: single-hot fields are a row gather
(:func:`embedding_lookup`), multi-hot fields a masked bag reduction
(:func:`embedding_bag`). xDeepFM keeps ONE concatenated (total_rows, dim)
table with per-field offsets, as the reference does.

:class:`Ranker` holds a model's parameters under the reference's leaf
names, its lists under their index (``mlp.0.w``, ``blocks.1.wq``,
``cin.2.w``); the functions take it, as the LM's take a ``TransformerLM``.
Ids out of range give what the reference gives (``models/layers.py``'s
gathers): ``embedding_lookup`` turns ids < 0 into zero rows and ids past
the table into NaN rows, ``retrieval_scores`` clamps candidate ids to the
table. Gradients come from autograd through these functions
(``launch/train.py``'s ``make_recsys_train_step``); a caller that only serves
runs them under ``torch.inference_mode``, so that no graph is built.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    blocked_attention,
    rms_norm,
    rows_of,
    take_along,
    take_rows,
)
from repro_torch.models.params import ParamTree


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                     # "dien" | "bert4rec" | "xdeepfm" | "bst"
    n_items: int = 0
    n_cats: int = 0
    embed_dim: int = 32
    seq_len: int = 20
    # dien
    gru_dim: int = 0
    # bert4rec / bst
    n_blocks: int = 0
    n_heads: int = 0
    n_masked: int = 10            # masked positions per sequence (bert4rec)
    # xdeepfm
    field_vocabs: tuple = ()      # per-field vocab sizes (single-hot first)
    n_multi_hot: int = 0          # last n fields are multi-hot bags
    max_bag: int = 8
    cin_layers: tuple = ()
    mlp: tuple = ()
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_fields(self) -> int:
        return len(self.field_vocabs)


# --------------------------------------------------------------------------
# EmbeddingBag substrate
# --------------------------------------------------------------------------
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain row gather; ids < 0 return zeros, ids past the table NaN (the
    reference's ``jnp.take``): one gather at the clamped id and one
    ``where`` over the rows, its fill picked per id."""
    n = table.shape[0]
    ok = ((ids >= 0) & (ids < n))[..., None]
    fill = torch.where(ids < 0, 0.0, math.nan)[..., None].to(table.dtype)
    return torch.where(ok, rows_of(table, ids.clamp(0, n - 1)), fill)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ids (..., L) with -1 padding → (..., dim) reduction."""
    s = embedding_lookup(table, ids).sum(dim=-2)
    if mode == "sum":
        return s
    n = torch.clamp((ids >= 0).sum(dim=-1, keepdim=True), min=1)
    return s / n


def _mlp(params, x: torch.Tensor, final_linear: bool = True) -> torch.Tensor:
    n = len(params)
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < n - 1 or not final_linear:
            x = F.relu(x)
    return x


def _linear_shapes(dims) -> list:
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)} for i in range(len(dims) - 1)]


# --------------------------------------------------------------------------
# GRU / AUGRU (DIEN)
# --------------------------------------------------------------------------
def _gru_gates(p, x: torch.Tensor, h: torch.Tensor):
    gx = torch.addmm(p["b"], x, p["wx"])
    gh = h @ p["wh"]
    xz, xr, xn = torch.chunk(gx, 3, dim=-1)
    hz, hr, hn = torch.chunk(gh, 3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return z, n


def gru(p, xs: torch.Tensor) -> torch.Tensor:
    """xs: (B, T, d_in) → states (B, T, d_hidden). A Python loop over T
    (the reference's ``lax.scan``), the states stacked once at the end (a
    write into the output per step would copy its gradient per step)."""
    B, T, _ = xs.shape
    hs = []
    h = xs.new_zeros((B, p["wh"].shape[0]))
    for t in range(T):
        z, n = _gru_gates(p, xs[:, t], h)
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def augru(p, xs: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """Attentional-update GRU (DIEN): update gate scaled by attention score.
    xs: (B, T, d_in); att: (B, T) in [0,1]. Returns the final state (B, H).
    Its update mirrors :func:`gru`'s, as the reference's does."""
    B, T, _ = xs.shape
    h = xs.new_zeros((B, p["wh"].shape[0]))
    for t in range(T):
        z, n = _gru_gates(p, xs[:, t], h)
        z = z * att[:, t, None]
        h = (1 - z) * h + z * n
    return h


# --------------------------------------------------------------------------
# DIEN
# --------------------------------------------------------------------------
def dien_param_shapes(cfg: RecsysConfig) -> dict:
    e, g = cfg.embed_dim, cfg.gru_dim
    d_in = 2 * e  # item ⊕ category
    gru_shapes = {"wx": (d_in, 3 * g), "wh": (g, 3 * g), "b": (3 * g,)}
    return {
        "item_embed": (cfg.n_items, e),
        "cat_embed": (cfg.n_cats, e),
        "gru": dict(gru_shapes),
        "augru": dict(gru_shapes),
        "att_w": (g, d_in),
        "mlp": _linear_shapes((g + 3 * d_in,) + tuple(cfg.mlp) + (1,)),
        "user_proj": (g, e),  # retrieval tower head
    }


def _dien_history(params, batch) -> torch.Tensor:
    return torch.cat([
        embedding_lookup(params["item_embed"], batch["hist_items"]),
        embedding_lookup(params["cat_embed"], batch["hist_cats"]),
    ], dim=-1)  # (B, T, 2e)


def dien_forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """batch: hist_items/hist_cats (B, T) (−1 pad), target_item/target_cat (B,)."""
    hist = _dien_history(params, batch)
    tgt = torch.cat([
        embedding_lookup(params["item_embed"], batch["target_item"]),
        embedding_lookup(params["cat_embed"], batch["target_cat"]),
    ], dim=-1)  # (B, 2e)
    states = gru(params["gru"], hist)  # (B, T, g)
    att = torch.sigmoid(torch.einsum("btg,ge,be->bt", states, params["att_w"], tgt))
    att = att * (batch["hist_items"] >= 0)
    final = augru(params["augru"], hist, att)  # (B, g)
    hist_sum = torch.cat([
        embedding_bag(params["item_embed"], batch["hist_items"]),
        embedding_bag(params["cat_embed"], batch["hist_cats"]),
    ], dim=-1)
    x = torch.cat([final, tgt, hist_sum, tgt * hist_sum], dim=-1)
    return _mlp(params["mlp"], x)[:, 0]  # logits (B,)


def dien_user_vector(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """Two-tower retrieval head: AUGRU state → item-embedding space, with
    attention 1 at every item of the history. The reference also runs the
    interest GRU here but reads only its dtype (XLA drops the scan), so the
    port does not run it."""
    hist = _dien_history(params, batch)
    att = (batch["hist_items"] >= 0).to(hist.dtype)
    final = augru(params["augru"], hist, att)
    return final @ params["user_proj"]


# --------------------------------------------------------------------------
# BERT4Rec
# --------------------------------------------------------------------------
def _block_shapes(e: int) -> dict:
    return {
        "ln1": (e,), "ln2": (e,),
        "wq": (e, e), "wk": (e, e), "wv": (e, e), "wo": (e, e),
        "w_in": (e, 4 * e), "w_out": (4 * e, e),
        "b_in": (4 * e,), "b_out": (e,),
    }


def bert4rec_param_shapes(cfg: RecsysConfig) -> dict:
    e = cfg.embed_dim
    return {
        # +1 row: the [MASK] token
        "item_embed": (cfg.n_items + 1, e),
        "pos_embed": (cfg.seq_len, e),
        "blocks": [_block_shapes(e) for _ in range(cfg.n_blocks)],
        "final_ln": (e,),
    }


def _bert_block(p, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, S, e = h.shape
    dh = e // n_heads
    x = rms_norm(p["ln1"], h)
    q = (x @ p["wq"]).reshape(B, S, n_heads, dh)
    k = (x @ p["wk"]).reshape(B, S, n_heads, dh)
    v = (x @ p["wv"]).reshape(B, S, n_heads, dh)
    o = blocked_attention(q, k, v, causal=False, q_chunk=S, kv_chunk=S)
    h = h + o.reshape(B, S, e) @ p["wo"]
    x = rms_norm(p["ln2"], h)
    # jax.nn.gelu's default is the tanh approximation
    x = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h + x @ p["w_out"] + p["b_out"]


def bert4rec_encode(params, items: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """items: (B, S) with −1 pad; [MASK] = n_items. Bidirectional encoder."""
    h = embedding_lookup(params["item_embed"], items) + params["pos_embed"]
    for p in params["blocks"]:
        h = _bert_block(p, h, cfg.n_heads)
    return rms_norm(params["final_ln"], h)  # (B, S, e)


def bert4rec_logits(params, items, positions, cfg: RecsysConfig) -> torch.Tensor:
    """Scores over the full item vocab at the given (B, M) positions —
    weight-tied output head (h @ E^T), float32."""
    h = bert4rec_encode(params, items, cfg)
    hm = take_along(h, positions[..., None], 1)  # (B, M, e)
    return hm.float() @ params["item_embed"][: cfg.n_items].float().T


# --------------------------------------------------------------------------
# xDeepFM
# --------------------------------------------------------------------------
def xdeepfm_param_shapes(cfg: RecsysConfig) -> dict:
    total_rows = int(sum(cfg.field_vocabs))
    F_, D = cfg.n_fields, cfg.embed_dim
    cin = []
    h_prev = F_
    for h in cfg.cin_layers:
        cin.append({"w": (h_prev * F_, h)})
        h_prev = h
    return {
        "embed": (total_rows, D),
        "linear": (total_rows,),
        "cin": cin,
        "cin_head": (int(sum(cfg.cin_layers)), 1),
        "mlp": _linear_shapes((F_ * D,) + tuple(cfg.mlp) + (1,)),
    }


def _xdeepfm_field_offsets(cfg: RecsysConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.field_vocabs)[:-1]]).astype(np.int32)


def xdeepfm_embed(params, batch, cfg: RecsysConfig):
    """batch: single_ids (B, F_single), multi_ids (B, F_multi, max_bag).
    Returns (B, F, D) field embeddings + (B,) linear term."""
    offs = torch.from_numpy(_xdeepfm_field_offsets(cfg)).to(params["embed"].device)
    n_single = cfg.n_fields - cfg.n_multi_hot
    sid = batch["single_ids"] + offs[:n_single]
    e_single = embedding_lookup(params["embed"], sid)  # (B, Fs, D)
    linear = params["linear"][:, None]
    lin = embedding_lookup(linear, sid)[..., 0].sum(dim=-1)
    if not cfg.n_multi_hot:
        return e_single, lin
    mids = batch["multi_ids"]
    mid = torch.where(mids >= 0, mids + offs[n_single:, None], -1)
    e_multi = embedding_bag(params["embed"], mid, mode="mean")  # (B, Fm, D)
    lin = lin + embedding_bag(linear, mid, "sum")[..., 0].sum(dim=-1)
    return torch.cat([e_single, e_multi], dim=1), lin


def _cin(params, x0: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network: explicit vector-wise crosses.
    x0: (B, F, D) → concat of per-layer sum-pools (B, Σh). Each layer's
    outer product z[b, h, m, d] = x_k[b, h, d] · x0[b, m, d] is built
    with d leading, (B, D, H_k, F), so that the field compression is one
    (B·D, H_k·F) @ (H_k·F, H) matmul on it as it lies."""
    B, _, D = x0.shape
    x0t = x0.transpose(1, 2)  # (B, D, F)
    xkt = x0t
    pools = []
    for layer in params:
        # z is freed before the next layer builds its own: two layers'
        # outer products (20 GB each at B = 65,536) never coexist
        z = (xkt[:, :, :, None] * x0t[:, :, None, :]).reshape(B * D, -1)
        xkt = (z @ layer["w"]).reshape(B, D, -1)  # (B, D, H)
        del z
        pools.append(xkt.sum(dim=1))  # (B, H)
    return torch.cat(pools, dim=-1)


def xdeepfm_forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    e, lin = xdeepfm_embed(params, batch, cfg)  # (B, F, D)
    cin_out = _cin(params["cin"], e) @ params["cin_head"]  # (B, 1)
    dnn_out = _mlp(params["mlp"], e.reshape(e.shape[0], -1))  # (B, 1)
    return lin + cin_out[:, 0] + dnn_out[:, 0]  # logits (B,)


# --------------------------------------------------------------------------
# BST (Behavior Sequence Transformer)
# --------------------------------------------------------------------------
def bst_param_shapes(cfg: RecsysConfig) -> dict:
    e = cfg.embed_dim
    S = cfg.seq_len + 1  # history + target item
    return {
        "item_embed": (cfg.n_items, e),
        "pos_embed": (S, e),
        "blocks": [_block_shapes(e) for _ in range(cfg.n_blocks)],
        "mlp": _linear_shapes((S * e,) + tuple(cfg.mlp) + (1,)),
        "user_proj": (e, e),
    }


def bst_forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """batch: hist_items (B, S), target_item (B,) → logits (B,)."""
    seq = torch.cat([batch["hist_items"], batch["target_item"][:, None]], dim=1)
    h = embedding_lookup(params["item_embed"], seq) + params["pos_embed"]
    for p in params["blocks"]:
        h = _bert_block(p, h, cfg.n_heads)
    return _mlp(params["mlp"], h.reshape(h.shape[0], -1))[:, 0]


def bst_user_vector(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    h = embedding_lookup(params["item_embed"], batch["hist_items"]) \
        + params["pos_embed"][: cfg.seq_len]
    for p in params["blocks"]:
        h = _bert_block(p, h, cfg.n_heads)
    return h.mean(dim=1) @ params["user_proj"]


# --------------------------------------------------------------------------
# shared: parameters, losses, retrieval
# --------------------------------------------------------------------------
PARAM_SHAPE_FNS = {
    "dien": dien_param_shapes,
    "bert4rec": bert4rec_param_shapes,
    "xdeepfm": xdeepfm_param_shapes,
    "bst": bst_param_shapes,
}

FORWARD_FNS = {
    "dien": dien_forward,
    "xdeepfm": xdeepfm_forward,
    "bst": bst_forward,
}


def param_shapes(cfg: RecsysConfig) -> dict:
    return PARAM_SHAPE_FNS[cfg.kind](cfg)


class Ranker(ParamTree):
    """The parameters of one ranker (``cfg.kind``), allocated uninitialised
    in ``cfg``'s dtype on ``device`` (the card unless the caller says so;
    ``repro_torch.device.DeviceError`` without one). :func:`init_params`
    or ``repro_torch.convert.recsys_params_from_numpy`` fills them."""

    def __init__(self, cfg: RecsysConfig, device="cuda"):
        super().__init__(param_shapes(cfg), cfg.torch_dtype, resolve_device(device))
        self.cfg = cfg


def init_params(cfg: RecsysConfig, generator: torch.Generator, device="cuda") -> Ranker:
    """A :class:`Ranker` by the reference's rule, read off each leaf's name:
    norm scales (``ln1``, ``ln2``, ``final_ln``) ones; biases (``b``,
    ``b_in``, ``b_out``) and xDeepFM's ``linear`` zeros; everything else
    ``normal · min(fan_in^-½, 0.05)`` with ``fan_in = shape[0]``, drawn in
    float32 from ``generator`` (which must live on ``device``) and cast.
    The random streams are torch's, not JAX's."""
    model = Ranker(cfg, device)
    with torch.no_grad():
        for path, t in model.named_parameters():
            name = path.rsplit(".", 1)[-1]
            if "ln" in name:
                t.fill_(1)
            elif name in ("b", "b_in", "b_out", "linear"):
                t.zero_()
            else:
                scale = min((1.0 / max(t.shape[0], 1)) ** 0.5, 0.05)
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * scale)
    return model


def pointwise_loss(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """BCE-with-logits (dien / xdeepfm / bst click prediction)."""
    logits = FORWARD_FNS[cfg.kind](params, batch, cfg).float()
    y = batch["label"].float()
    return torch.mean(
        torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    )


def masked_item_loss(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """BERT4Rec masked-item cross-entropy over the full item softmax;
    labels < 0 are masked out."""
    logits = bert4rec_logits(params, batch["items"], batch["positions"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"]
    ce = -take_along(logp, labels[..., None], -1)[..., 0]
    mask = (labels >= 0).float()
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    if cfg.kind == "bert4rec":
        return masked_item_loss(params, batch, cfg)
    return pointwise_loss(params, batch, cfg)


def retrieval_scores(params, batch, cand_ids: torch.Tensor, cfg: RecsysConfig):
    """Score ONE user context against n_candidates items: batched dot of the
    user vector with gathered candidate embeddings (never a loop). xDeepFM is
    not a two-tower model — its retrieval IS the full forward with the
    candidate field varying (still one batched pass)."""
    if cfg.kind == "xdeepfm":
        C = cand_ids.shape[0]
        single = batch["single_ids"].expand((C,) + batch["single_ids"].shape[1:]).clone()
        single[:, 0] = cand_ids
        wide = {
            "single_ids": single,
            "multi_ids": batch["multi_ids"].expand((C,) + batch["multi_ids"].shape[1:]),
        }
        return xdeepfm_forward(params, wide, cfg)
    if cfg.kind == "bert4rec":
        u = bert4rec_encode(params, batch["items"], cfg)[0, -1]  # (e,)
    elif cfg.kind == "dien":
        u = dien_user_vector(params, batch, cfg)[0]
    else:  # bst
        u = bst_user_vector(params, batch, cfg)[0]
    table = params["item_embed"]
    cands = take_rows(table, torch.clamp(cand_ids, max=table.shape[0] - 1))
    return cands.float() @ u.float()
