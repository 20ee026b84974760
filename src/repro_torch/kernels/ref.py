"""Plain PyTorch versions of the hand-written kernels.

Each computes exactly what its kernel computes, in ordinary tensor ops: the
CPU path of ``kernels.ops`` and the yardstick ``chip_smoke.py`` holds each
kernel against on the card. They play the role the reference package's
``kernels/ref.py`` plays for its Pallas kernels.
"""

from __future__ import annotations

import torch

SCORES = ("count", "pmi", "dice")


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
    flat = seg[valid].to(torch.int64) * vocab + ids[valid].to(torch.int64)
    ones = torch.ones(flat.shape, dtype=torch.int32, device=ids.device)
    out.view(-1).index_put_((flat,), ones, accumulate=True)
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
