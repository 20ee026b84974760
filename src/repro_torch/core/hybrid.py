"""FREQ-SPLIT (beyond paper): dense-head / sparse-tail hybrid.

Requires df-descending term IDs (data/preprocess.remap_df_descending). Split
the vocabulary at rank H:

* head × head  (both IDs < H): dense tiled Gram on the ``cooc_gram`` kernel
  — with Zipfian statistics the top-left of C is dense, so the product does
  almost no wasted work;
* everything else: tail-side LIST-SCAN — for each tail term t (df is small by
  construction), one histogram over the forward documents of postings(t)
  restricted to IDs < t yields the whole column C[:t, t]. Work is
  Σ_{t ≥ H} df_t · avg_len, i.e. proportional to actual postings; no empty
  intersections (LIST-PAIRS' waste) and no all-zero tiles (LIST-BLOCKS'
  waste at the tail).

The tail runs on the device as LIST-SCAN does: the strict-lower token
streams of a batch of tail terms are gathered from the ``DeviceIndex`` and
counted by the ``segment_hist`` kernel into one ``(terms, hi)`` grid whose
row r is the column C[:t, t] of tail term t = lo + r.

Exactness is preserved: both paths compute exact integer counts and cover a
disjoint partition of the strict upper triangle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.list_scan import LAUNCH_TOKENS, _device_chunks
from repro_torch.core.types import PairSink, emit_dense_rows, group_bounds
from repro_torch.data.corpus import Collection
from repro_torch.data.index import DeviceIndex, build_inverted_index, incidence_tile
from repro_torch.device import resolve_device

# cells of one tail batch's int32 grid (64 MiB): bounds its device memory
TAIL_GRID_CELLS = 1 << 24


def count_freq_split(
    c: Collection,
    sink: PairSink,
    *,
    head: int = 1024,
    doc_tile: int = 2048,
    device: str = "cuda",
) -> dict:
    """Count ``c`` as a dense head Gram plus tail column histograms, both on
    ``device`` — the hand-written ``cooc_gram`` and ``segment_hist``
    kernels on ``"cuda"`` (the default), their plain PyTorch versions on
    ``"cpu"``.

    ``sink`` must support ``emit_col`` (DenseSink / StatsSink do) or
    ``emit_keys`` (SpillSink). Head rows are emitted first, then the tail
    pairs in the reference's order: by tail term, then by primary.
    """
    dev = resolve_device(device)
    V = c.vocab_size
    H = min(head, V)

    # --- head × head: dense Gram over uint8 document tiles ---
    acc, matmuls = _head_gram(c, H, doc_tile, dev)
    emit_dense_rows(acc, sink, row_lo=0, col_lo=0)

    # --- tail columns: strict-lower histograms of batches of tail terms ---
    inv = build_inverted_index(c)
    if H < V:
        _count_tail(DeviceIndex.from_collection(c, dev, inv), H, sink)
    return {
        "head": H,
        "head_matmuls": matmuls,
        "tail_postings_scanned": int(inv.term_ptr[V] - inv.term_ptr[H]),
    }


def _head_gram(c: Collection, H: int, doc_tile: int, dev) -> tuple[np.ndarray, int]:
    """The int64 ``(H, H)`` Gram of the head terms, summed over document
    tiles of ``doc_tile`` (one ``cooc_gram`` call each), and the number of
    calls."""
    from repro_torch.kernels import ops as kops

    acc = np.zeros((H, H), dtype=np.int64)
    matmuls = 0
    for dlo in range(0, c.num_docs, doc_tile):
        dhi = min(dlo + doc_tile, c.num_docs)
        tile = incidence_tile(c, dlo, dhi, 0, H, dev)
        acc += kops.cooc_gram(tile, tile).cpu().numpy()
        matmuls += 1
    return acc, matmuls


def tail_batch_end(lo: int, V: int) -> int:
    """The end of the tail batch of terms that starts at ``lo``: the largest
    batch r with r · (lo + r) <= ``TAIL_GRID_CELLS``, at least one term."""
    r = max(1, (math.isqrt(lo * lo + 4 * TAIL_GRID_CELLS) - lo) // 2)
    return min(V, lo + r)


def _count_tail(idx: DeviceIndex, H: int, sink: PairSink) -> None:
    """Columns C[:t, t] of every tail term t >= H, by batches of terms
    [lo, hi): one ``segment_hist`` grid of ``(hi - lo, hi)`` cells each,
    sized so that it holds at most ``TAIL_GRID_CELLS``. A batch that holds
    a posting is timed in the spans of ``count_list_scan_segment``'s loop:
    ``ingest/count_launch``, ``ingest/count_select``, ``ingest/count_emit``."""
    from repro_torch.kernels import ops as kops

    V = idx.vocab_size
    dev = idx.terms.device
    emit_keys = getattr(sink, "emit_keys", None)
    reg = obs.get_registry()
    lo = H
    while lo < V:
        hi = tail_batch_end(lo, V)
        if idx.term_ptr_host[lo] == idx.term_ptr_host[hi]:
            lo = hi  # no postings: nothing to gather
            continue
        grid = None
        with reg.span("ingest/count_launch"):
            for tokens, seg in _device_chunks(idx, lo, hi, LAUNCH_TOKENS, lower=True):
                if grid is None:
                    grid = torch.zeros((hi - lo, hi), dtype=torch.int32, device=dev)
                kops.segment_hist(tokens, seg, num_rows=hi - lo, vocab=hi, out=grid)
        if grid is not None:
            with reg.span("ingest/count_select"):
                flat = grid.view(-1)
                nz = torch.nonzero(flat).squeeze(1)
                counts = flat[nz].cpu().numpy().astype(np.int64)
                nz = nz.cpu().numpy()
            with reg.span("ingest/count_emit"):
                terms, prims = nz // hi + lo, nz % hi  # row-major: by term, then primary
                if emit_keys is not None:
                    emit_keys(prims * V + terms, counts)
                else:
                    tb = group_bounds(terms)
                    for s, e in zip(tb[:-1], tb[1:]):
                        sink.emit_col(int(terms[s]), prims[s:e], counts[s:e])
        lo = hi
