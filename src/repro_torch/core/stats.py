"""Downstream statistics the paper motivates: PMI / PPMI / top-k pairs."""

from __future__ import annotations

import numpy as np


def pmi_matrix(counts: np.ndarray, df: np.ndarray, num_docs: int) -> np.ndarray:
    """PMI[i,j] = log( P(i,j) / (P(i)P(j)) ) over the strict upper triangle.

    counts: dense strict-upper co-occurrence matrix; df: document frequencies.
    Entries with zero co-occurrence are -inf (no smoothing — exact counts are
    the whole point of the paper).
    """
    D = float(num_docs)
    with np.errstate(divide="ignore", invalid="ignore"):
        p_ij = counts / D
        p_i = (df / D)[:, None]
        p_j = (df / D)[None, :]
        out = np.log(p_ij / (p_i * p_j))
    out[counts == 0] = -np.inf
    return np.triu(out, k=1)


def ppmi_matrix(counts: np.ndarray, df: np.ndarray, num_docs: int) -> np.ndarray:
    out = pmi_matrix(counts, df, num_docs)
    np.maximum(out, 0.0, out=out)
    out[~np.isfinite(out)] = 0.0
    return out


def top_k_pairs(counts: np.ndarray, k: int = 10):
    """Most frequent co-occurring pairs (paper §3: "to"–"the" at 1.3M docs)."""
    upper = np.triu(counts, k=1)
    flat = upper.ravel()
    k = min(k, int((flat > 0).sum()))
    if k == 0:
        return []
    idx = np.argpartition(flat, -k)[-k:]
    idx = idx[np.argsort(-flat[idx])]
    V = counts.shape[1]
    return [(int(i // V), int(i % V), int(flat[i])) for i in idx]
