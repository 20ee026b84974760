"""Kernel dispatch by device.

Each op takes tensors on one device. A CPU tensor goes to the plain PyTorch
version in ``kernels/ref.py``; a CUDA tensor goes to the hand-written kernel,
which raises if it fails to build or launch (there is no fallback). Each
kernel's ``launches`` counter (``KERNELS``) counts its launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitpair as _bitpair
from repro_torch.kernels import cooc_gram as _cooc_gram
from repro_torch.kernels import ref
from repro_torch.kernels import segment_hist as _segment_hist
from repro_torch.kernels import topk_gather as _topk_gather

KERNELS = (
    _segment_hist.KERNEL, _topk_gather.KERNEL, _cooc_gram.KERNEL, _bitpair.KERNEL,
)


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def segment_hist(
    ids: torch.Tensor,
    seg: torch.Tensor,
    *,
    num_rows: int,
    vocab: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched LIST-SCAN histogram: int32 ``(L,)`` ids and segment ids (-1 =
    padding) → int32 ``(num_rows, vocab)``, accumulated into ``out`` when
    given.

    Example::

        ops.segment_hist(ids, seg, num_rows=64, vocab=V)   # (64, V) int32
    """
    if _device_of(ids, seg).type == "cpu":
        return ref.segment_hist_ref(ids, seg, num_rows, vocab, out)
    return _segment_hist.segment_hist_cuda(
        ids, seg, num_rows=num_rows, vocab=vocab, out=out
    )


def topk_gather(
    ids: torch.Tensor,
    cnts: torch.Tensor,
    df_t: torch.Tensor,
    df_n: torch.Tensor,
    *,
    num_docs: int,
    score: str = "count",
    k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k neighbours of a padded int32 ``(B, L)`` candidate tile (id -1,
    count 0 and ``df_n`` 1 in padding slots; ``df_t`` is ``(B,)``). Returns
    ``(ids (B, k) int32, scores (B, k))``: int32 for count, float32 for PMI
    and Dice; padding surfaces as id -1 with score 0 (count) or -inf.

    Example::

        ids = torch.tensor([[4, 9, -1, -1]], dtype=torch.int32)
        cnts = torch.tensor([[3, 7, 0, 0]], dtype=torch.int32)
        ops.topk_gather(ids, cnts, torch.tensor([5], dtype=torch.int32),
                        ids.clamp(min=1), num_docs=100, k=2)
        # ids [[9, 4]], scores [[7, 3]]
    """
    if score not in ref.SCORES:
        raise ValueError(f"unknown score {score!r}; have {ref.SCORES}")
    if ids.dim() != 2 or not 1 <= k <= ids.shape[1]:
        raise ValueError(f"k={k} must be in [1, L={ids.shape[-1]}]")
    if _device_of(ids, cnts, df_t, df_n).type == "cpu":
        return ref.topk_gather_ref(
            ids, cnts, df_t, df_n, num_docs=num_docs, score=score, k=k
        )
    return _topk_gather.topk_gather_cuda(
        ids, cnts, df_t, df_n, num_docs=num_docs, score=score, k=k
    )


def cooc_gram(b_i: torch.Tensor, b_j: torch.Tensor) -> torch.Tensor:
    """Exact Gram of 0/1 incidence tiles: uint8 ``(D, M)`` and ``(D, N)`` →
    int32 ``(M, N)``, ``C = b_iᵀ b_j`` (pass one tensor twice for a
    diagonal tile).

    Example::

        tile = torch.from_numpy(incidence_dense(c, 0, 2048, 0, 1024, dtype=np.uint8))
        ops.cooc_gram(tile, tile)          # (1024, 1024) int32
    """
    if _device_of(b_i, b_j).type == "cpu":
        return ref.cooc_gram_ref(b_i, b_j)
    return _cooc_gram.cooc_gram_cuda(b_i, b_j)


def bitpair_popcount(rows_i: torch.Tensor, rows_j: torch.Tensor) -> torch.Tensor:
    """Intersection counts over bitmaps of 32-bit words carried as int32:
    ``(M, W)`` and ``(N, W)`` → int32 ``(M, N)``.

    Example::

        bits = torch.from_numpy(incidence_bitpacked(c).view(np.int32))
        ops.bitpair_popcount(bits[:256], bits[256:512])   # (256, 256) int32
    """
    if _device_of(rows_i, rows_j).type == "cpu":
        return ref.bitpair_popcount_ref(rows_i, rows_j)
    return _bitpair.bitpair_cuda(rows_i, rows_j)
