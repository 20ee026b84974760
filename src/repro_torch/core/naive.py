"""NAÏVE (paper §2): document-order dictionary accumulation with flushing.

For each document, all distinct term pairs are generated and their dictionary
counts incremented. When the dictionary exceeds ``flush_pairs`` distinct pairs
(the paper used 100M) it is flushed to a temporary sorted run; runs are merged
at the end, accelerated by in-memory offsets to the primary keys — we keep the
same structure (sorted runs + k-way merge by primary key).

Pairs are packed into int64 keys (i * V + j) for the dictionary, exactly the
"pair → count" hash-map shape of the paper's implementation.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import PairSink
from repro_torch.data.corpus import Collection


def _doc_pair_keys(ts: np.ndarray, V: int) -> np.ndarray:
    """All strict-upper pair keys of one (sorted, unique) document."""
    n = len(ts)
    i = np.repeat(ts, n)
    j = np.tile(ts, n)
    mask = i < j
    return i[mask].astype(np.int64) * V + j[mask].astype(np.int64)


def count_naive(
    c: Collection, sink: PairSink, *, flush_pairs: int = 2_000_000
) -> dict:
    """Returns run statistics (number of flushes, peak dict size) alongside
    emitting the final merged counts to ``sink``."""
    V = c.vocab_size
    acc: dict[int, int] = {}
    runs: list[tuple[np.ndarray, np.ndarray]] = []  # (sorted keys, counts)
    peak = 0

    def flush():
        nonlocal acc
        if not acc:
            return
        keys = np.fromiter(acc.keys(), dtype=np.int64, count=len(acc))
        cnts = np.fromiter(acc.values(), dtype=np.int64, count=len(acc))
        order = np.argsort(keys)
        runs.append((keys[order], cnts[order]))
        acc = {}

    for d in range(c.num_docs):
        keys = _doc_pair_keys(c.doc(d), V)
        for k in keys.tolist():
            acc[k] = acc.get(k, 0) + 1
        peak = max(peak, len(acc))
        if len(acc) >= flush_pairs:
            flush()
    flush()

    n_runs = len(runs)
    _merge_runs(runs, V, sink)
    return {"num_flushes": n_runs, "peak_dict_pairs": peak}


def _merge_runs(runs, V: int, sink: PairSink) -> None:
    """K-way merge of sorted (key, count) runs, emitting per-primary rows."""
    if not runs:
        return
    if len(runs) == 1:
        keys, cnts = runs[0]
    else:
        keys = np.concatenate([r[0] for r in runs])
        cnts = np.concatenate([r[1] for r in runs])
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
        # collapse duplicate keys (same pair in several runs)
        uniq, idx = np.unique(keys, return_index=True)
        sums = np.add.reduceat(cnts, idx)
        keys, cnts = uniq, sums
    primaries = (keys // V).astype(np.int64)
    secondaries = (keys % V).astype(np.int64)
    # rows are contiguous because keys are sorted by (primary, secondary)
    starts = np.concatenate([[0], np.nonzero(np.diff(primaries))[0] + 1, [len(keys)]])
    for s, e in zip(starts[:-1], starts[1:]):
        if e > s:
            sink.emit_row(int(primaries[s]), secondaries[s:e], cnts[s:e])
