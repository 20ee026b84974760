"""LIST-PAIRS (paper §2): pair-order posting-list intersection.

Build the inverted index in a first pass, then consider every ordered term
pair (i < j) and compute |postings(i) ∩ postings(j)|. Each pair is touched
exactly once and needs a single scalar accumulator — but the approach is
quadratic in vocabulary and almost all intersections are empty (the paper's
stated disadvantage, visible in our Figure-1 benchmark).

The accelerator adaptation of this traversal is the bit-packed AND+popcount
kernel (kernels/csrc/bitpair.cu): 32 documents per 32-bit word,
intersection size = Σ popcount(w_i & w_j) — see count_list_pairs_bitpacked.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import PairSink, emit_dense_rows
from repro_torch.data.corpus import Collection
from repro_torch.data.index import build_inverted_index, incidence_bitpacked
from repro_torch.device import resolve_device


def _intersect_size_sorted(a: np.ndarray, b: np.ndarray) -> int:
    """|a ∩ b| for sorted unique int arrays (galloping-free linear merge)."""
    return int(np.intersect1d(a, b, assume_unique=True).size)


def count_list_pairs(c: Collection, sink: PairSink) -> dict:
    inv = build_inverted_index(c)
    V = c.vocab_size
    df = inv.df()
    live = np.nonzero(df)[0]
    intersections = 0
    for ii, i in enumerate(live):
        pi = inv.postings(i)
        sec, cnt = [], []
        for j in live[ii + 1:]:
            intersections += 1
            n = _intersect_size_sorted(pi, inv.postings(j))
            if n:
                sec.append(j)
                cnt.append(n)
        if sec:
            sink.emit_row(int(i), np.asarray(sec), np.asarray(cnt))
    return {"intersections": intersections, "live_terms": int(len(live))}


def count_list_pairs_bitpacked(
    c: Collection, sink: PairSink, *, block: int = 256, device: str = "cuda"
) -> dict:
    """LIST-PAIRS as blocked bit-packed intersection counting.

    The (V, ⌈D/32⌉) bitmaps go to ``device`` once, as int32 words with the
    same bits; each vocab block pair (I, J) with I <= J is one
    ``bitpair_popcount`` — the hand-written kernel on ``"cuda"`` (the
    default), its plain PyTorch version on ``"cpu"``. Still pair-order
    traversal — every pair computed exactly once — but 32 docs per word and
    (block × block) pairs per call.
    """
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    V = c.vocab_size
    bits_host = incidence_bitpacked(c)  # (V, W) uint32
    bits = torch.from_numpy(bits_host.view(np.int32)).to(dev)
    nblk = (V + block - 1) // block
    block_pairs = 0
    for bi in range(nblk):
        ilo, ihi = bi * block, min((bi + 1) * block, V)
        rows_i = bits[ilo:ihi]
        for bj in range(bi, nblk):
            jlo, jhi = bj * block, min((bj + 1) * block, V)
            tile = kops.bitpair_popcount(rows_i, bits[jlo:jhi])
            block_pairs += 1
            _emit_tile(tile.cpu().numpy().astype(np.int64), ilo, jlo, sink)
    return {"block_pairs": block_pairs, "bitmap_bytes": int(bits_host.nbytes)}


def _emit_tile(tile: np.ndarray, row_lo: int, col_lo: int, sink: PairSink) -> None:
    """One tile-level nonzero + per-row split (was a per-row Python loop)."""
    emit_dense_rows(tile, sink, row_lo=row_lo, col_lo=col_lo)
