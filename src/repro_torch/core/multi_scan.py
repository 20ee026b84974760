"""MULTI-SCAN (paper §2): repeated forward scans, a primary keys per pass.

Only the forward index is needed. Pass p claims the next ``a`` term IDs as
primary keys (the paper used a = 100) and scans all forward documents; for
each primary key found in a document, every term with a higher ID in that
document increments the primary's accumulator table. Because per-document
terms are sorted ascending and primaries are claimed in ascending ID order,
documents whose largest term ID is below the pass window are skipped entirely
("after just a few passes many of the documents will have been fully
processed") — we reproduce that skip.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import PairSink
from repro_torch.data.corpus import Collection
from repro_torch.data.index import incidence_tile
from repro_torch.device import resolve_device


def count_multi_scan(c: Collection, sink: PairSink, *, accumulators: int = 100) -> dict:
    V = c.vocab_size
    a = accumulators
    passes = 0
    docs_scanned = 0
    max_term = np.array([c.doc(d)[-1] if len(c.doc(d)) else -1 for d in range(c.num_docs)])
    live = np.arange(c.num_docs)[np.diff(c.doc_ptr) > 0]

    for lo in range(0, V, a):
        hi = min(lo + a, V)
        passes += 1
        acc = np.zeros((hi - lo, V), dtype=np.int64)
        touched = np.zeros(hi - lo, dtype=bool)
        # skip fully-processed documents: their max term is below the window
        live = live[max_term[live] >= lo]
        for d in live:
            ts = c.doc(int(d))
            docs_scanned += 1
            # primaries of this window present in the document
            s = np.searchsorted(ts, lo)
            e = np.searchsorted(ts, hi)
            if s == e:
                continue
            prims = ts[s:e]
            for p in prims:
                sec = ts[np.searchsorted(ts, p) + 1:]
                if len(sec):
                    acc[p - lo, sec] += 1
                    touched[p - lo] = True
        for slot in np.nonzero(touched)[0]:
            nz = np.nonzero(acc[slot])[0]
            sink.emit_row(lo + slot, nz, acc[slot][nz])
    return {"passes": passes, "docs_scanned": docs_scanned, "accumulators": a}


def count_multi_scan_matmul(
    c: Collection, sink: PairSink, *, accumulators: int = 128, doc_tile: int = 2048,
    device: str = "cuda",
) -> dict:
    """MULTI-SCAN with each pass as a skinny Gram C[P, :] = B[:, P]ᵀ B for
    the pass's primary slice P, streamed over uint8 document tiles through
    ``cooc_gram`` on ``device`` — the hand-written kernel on ``"cuda"`` (the
    default), its plain PyTorch version on ``"cpu"``. The pass structure
    (and its memory bound) is the paper's; the scan becomes a product.
    """
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    V, D = c.vocab_size, c.num_docs
    a = accumulators
    passes = 0
    for lo in range(0, V, a):
        hi = min(lo + a, V)
        passes += 1
        acc = np.zeros((hi - lo, V), dtype=np.int64)
        for dlo in range(0, D, doc_tile):
            dhi = min(dlo + doc_tile, D)
            prim = incidence_tile(c, dlo, dhi, lo, hi, dev)
            full = incidence_tile(c, dlo, dhi, 0, V, dev)
            acc += kops.cooc_gram(prim, full).cpu().numpy()
        for slot in range(hi - lo):
            row = acc[slot]
            nz = np.nonzero(row)[0]
            nz = nz[nz > lo + slot]
            if len(nz):
                sink.emit_row(lo + slot, nz, row[nz])
    return {"passes": passes, "accumulators": a}
