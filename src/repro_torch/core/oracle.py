"""Brute-force oracle: the definition, with no cleverness.

Used by every test as ground truth. O(Σ len_d²) time, dense O(V²) memory —
fine for test-sized corpora only.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import Collection


def brute_force_counts(c: Collection) -> np.ndarray:
    """Dense strict-upper-triangular int64 (V, V) co-occurrence counts."""
    V = c.vocab_size
    out = np.zeros((V, V), dtype=np.int64)
    for d in range(c.num_docs):
        ts = c.doc(d)
        if len(ts) < 2:
            continue
        # ts is sorted ascending and unique: all (i<j) pairs are upper pairs
        out[np.repeat(ts, len(ts)), np.tile(ts, len(ts))] += 1
    # the loop added the full outer product incl. diagonal; keep strict upper
    return np.triu(out, k=1)
