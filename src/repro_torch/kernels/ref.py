"""Plain PyTorch versions of the hand-written kernels.

Each computes exactly what its kernel computes, in ordinary tensor ops: the
CPU path of ``kernels.ops`` and the yardstick ``chip_smoke.py`` holds each
kernel against on the card. They play the role the reference package's
``kernels/ref.py`` plays for its Pallas kernels.
"""

from __future__ import annotations

import torch

SCORES = ("count", "pmi", "dice")

# Gram calls contract over fewer documents than this: float32 holds every
# partial sum of 0/1 products exactly below 2^24
GRAM_MAX_DOCS = 1 << 24


def segment_hist_ref(
    ids: torch.Tensor,
    seg: torch.Tensor,
    num_rows: int,
    vocab: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched histogram (the LIST-SCAN accumulator): ``out[r, v] += #{l :
    seg[l] == r and ids[l] == v}`` into an int32 ``(num_rows, vocab)`` grid
    (zeros when ``out`` is None). Entries with ``seg < 0`` or ``ids < 0`` are
    padding; entries outside the grid are skipped, as the kernel skips them.

    Example::

        segment_hist_ref(torch.tensor([1, 1, -1]), torch.tensor([0, 0, 0]), 1, 3)
        # tensor([[0, 2, 0]], dtype=torch.int32)
    """
    if out is None:
        out = torch.zeros((num_rows, vocab), dtype=torch.int32, device=ids.device)
    valid = (seg >= 0) & (ids >= 0) & (seg < num_rows) & (ids < vocab)
    # padding adds 0 to cell 0: every shape is static (no boolean mask), so
    # the dry run can trace it on fake tensors
    flat = torch.where(valid, seg.to(torch.int64) * vocab + ids.to(torch.int64), 0)
    out.view(-1).index_put_((flat,), valid.to(torch.int32), accumulate=True)
    return out


def score_tile(
    ids: torch.Tensor,
    cnts: torch.Tensor,
    df_t: torch.Tensor,
    df_n: torch.Tensor,
    *,
    num_docs: int,
    score: str,
) -> torch.Tensor:
    """Score a padded ``(B, L)`` candidate tile, op for op as the reference
    scorer: count as int32 (0 in padding slots); PMI ``log(c·D / (df_t·df_n))``
    and Dice ``2c / (df_t + df_n)`` in float32 (-inf in padding slots)."""
    valid = ids >= 0
    if score == "count":
        return torch.where(valid, cnts, 0).to(torch.int32)
    c = cnts.to(torch.float32)
    if score == "pmi":
        d = torch.full((), num_docs, dtype=torch.float32, device=ids.device)
        s = torch.log(
            c * d / (df_t[:, None].to(torch.float32) * df_n.to(torch.float32))
        )
    elif score == "dice":
        s = 2.0 * c / (df_t[:, None] + df_n).to(torch.float32)
    else:
        raise ValueError(f"unknown score {score!r}; have {SCORES}")
    return torch.where(valid, s, float("-inf"))


def topk_gather_ref(
    ids: torch.Tensor,
    cnts: torch.Tensor,
    df_t: torch.Tensor,
    df_n: torch.Tensor,
    *,
    num_docs: int,
    score: str,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each scored row: ``(ids (B, k), scores (B, k))``, ties to the
    lowest column. A stable descending sort fixes that order; ``torch.topk``
    does not fix the order of ties."""
    s = score_tile(ids, cnts, df_t, df_n, num_docs=num_docs, score=score)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return ids.gather(1, order), s.gather(1, order)


def order_key(s: torch.Tensor) -> torch.Tensor:
    """The 32-bit order key ``topk_gather``'s kernel gives each score, as
    int64 in ``[0, 2^32)``: key order is score order, so a stable sort by
    key, descending, is ``topk_gather_ref``'s order. int32 counts flip
    their sign bit; float32 scores map negative values to their complement
    and positive ones past 2^31, with -0.0 and +0.0 one key and every NaN
    the largest key (where ``torch.sort`` puts NaN).

    Example::

        order_key(torch.tensor([-0.0, 0.0, float("-inf")]))
        # tensor([2147483648, 2147483648, 8388607])
    """
    if s.dtype == torch.int32:
        return s.to(torch.int64) + 2**31
    if s.dtype != torch.float32:
        raise ValueError(f"scores must be int32 or float32, got {s.dtype}")
    bits = torch.where(s == 0, 0.0, s).view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    key = torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits + 2**31)
    return torch.where(torch.isnan(s), 0xFFFFFFFF, key)


def cooc_gram_ref(b_i: torch.Tensor, b_j: torch.Tensor) -> torch.Tensor:
    """``C = b_iᵀ b_j`` over 0/1 incidence tiles ``(D, M)`` and ``(D, N)``
    (any dtype holding 0 and 1) → int32 ``(M, N)``.

    A float32 matrix product cast to int32. It is exact: every product is 0
    or 1 and every partial sum an integer below 2^24, which float32 holds.
    TF32, where a card would use it for float32 products, keeps 0 and 1
    exactly and accumulates in float32, so it cannot change the result
    either. Raises for D >= 2^24.

    Example::

        b = torch.tensor([[1, 1], [0, 1]], dtype=torch.uint8)
        cooc_gram_ref(b, b)   # tensor([[1, 1], [1, 2]], dtype=torch.int32)
    """
    if b_i.shape[0] >= GRAM_MAX_DOCS:
        raise ValueError(f"D = {b_i.shape[0]} documents: exact only below 2^24")
    return (b_i.to(torch.float32).t() @ b_j.to(torch.float32)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (the bits of an int32 tensor) as int64:
    the SWAR bit count on int64, since PyTorch has no popcount operator."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bitpair_popcount_ref(rows_i: torch.Tensor, rows_j: torch.Tensor) -> torch.Tensor:
    """Pair intersection sizes over bit-packed posting bitmaps.

    ``rows_i`` ``(M, W)``, ``rows_j`` ``(N, W)``: 32-bit words as int32 (bit
    d of word w set iff the term occurs in document 32 w + d). Returns int32
    ``(M, N)`` with ``out[m, n] = Σ_w popcount(rows_i[m, w] & rows_j[n, w])``.
    Rows of ``rows_i`` go in chunks, so the int64 intermediate stays near
    2^24 elements.

    Example::

        a = torch.tensor([[0b1011]], dtype=torch.int32)
        bitpair_popcount_ref(a, a)   # tensor([[3]], dtype=torch.int32)
    """
    M, W = rows_i.shape
    N = rows_j.shape[0]
    out = torch.empty((M, N), dtype=torch.int32, device=rows_i.device)
    step = max(1, (1 << 24) // max(1, N * W))
    for lo in range(0, M, step):
        both = rows_i[lo:lo + step, None, :] & rows_j[None, :, :]
        out[lo:lo + step] = popcount32(both).sum(dim=2)
    return out
