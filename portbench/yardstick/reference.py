"""The plain reference: exact pair counts and PMI top-k in NumPy, worked
out from the collection the benchmark made and from nothing the program
built.

A pair is the unordered pair of distinct terms of one document, keyed
``lo * V + hi`` with ``lo < hi``. Its count is the number of documents that
hold both. PMI is ``log(c · D / (df_t · df_n))`` with the product and the
quotient in float32, in that order, as the configuration states; the log is
taken in float64 and rounded once to float32, so it is the correctly
rounded log of the float32 argument.
"""

from __future__ import annotations

import numpy as np


def pair_keys(doc_ptr: np.ndarray, terms: np.ndarray, vocab: int) -> np.ndarray:
    """Every pair occurrence of the collection as ``lo * vocab + hi``
    (int64), document by document: Σ l(l−1)/2 keys."""
    lens = np.diff(doc_ptr)
    pos = np.arange(len(terms), dtype=np.int64)
    end = np.repeat(doc_ptr[1:], lens)          # one past each posting's doc
    partners = end - pos - 1                    # later terms of its doc
    total = int(partners.sum())
    first = np.repeat(pos + 1, partners)        # index of its first partner
    starts = np.zeros(len(partners), dtype=np.int64)
    np.cumsum(partners[:-1], out=starts[1:])
    hi_idx = first + (np.arange(total, dtype=np.int64) - np.repeat(starts, partners))
    lo = np.repeat(terms.astype(np.int64), partners)
    return lo * vocab + terms[hi_idx].astype(np.int64)


def pair_counts(
    doc_ptr: np.ndarray, terms: np.ndarray, vocab: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """``(keys ascending, counts, pair occurrences)`` of the collection."""
    keys = pair_keys(doc_ptr, terms, vocab)
    keys.sort()
    if len(keys) == 0:
        return keys, np.zeros(0, np.int64), 0
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    counts = np.diff(np.append(starts, len(keys)))
    return keys[starts], counts.astype(np.int64), len(keys)


def symmetric(keys: np.ndarray, counts: np.ndarray, vocab: int):
    """Both directions of every pair, as ``(row * vocab + col)`` ascending
    and the counts in that order: the rows a neighbour lookup returns."""
    lo, hi = keys // vocab, keys % vocab
    both = np.concatenate([keys, hi * vocab + lo])
    order = np.argsort(both)  # no key repeats: lo < hi in one half, > in the other
    return both[order], np.concatenate([counts, counts])[order]


class Postings:
    """Documents of each term (an inverted index of the collection), for
    neighbour rows of single terms."""

    def __init__(self, doc_ptr: np.ndarray, terms: np.ndarray, vocab: int):
        self.doc_ptr, self.terms, self.vocab = doc_ptr, terms, vocab
        docs = np.repeat(np.arange(len(doc_ptr) - 1), np.diff(doc_ptr))
        order = np.argsort(terms, kind="stable")
        self.docs_of = docs[order]
        self.ptr = np.zeros(vocab + 1, dtype=np.int64)
        np.cumsum(np.bincount(terms, minlength=vocab), out=self.ptr[1:])
        self.df = np.diff(self.ptr)

    def row(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """``(neighbour ids ascending, counts)`` of term ``t``."""
        docs = self.docs_of[self.ptr[t]:self.ptr[t + 1]]
        if len(docs) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lo, hi = self.doc_ptr[docs], self.doc_ptr[docs + 1]
        n = hi - lo
        idx = np.repeat(lo - np.concatenate([[0], np.cumsum(n)[:-1]]), n)
        idx += np.arange(int(n.sum()), dtype=np.int64)
        ids, c = np.unique(self.terms[idx], return_counts=True)
        keep = ids != t
        return ids[keep].astype(np.int64), c[keep].astype(np.int64)


def pmi_args(cnts, df_t: int, df_n, num_docs: int, dtype=np.float32):
    """The argument ``c · D / (df_t · df_n)`` of the log, in ``dtype``."""
    c = np.asarray(cnts).astype(dtype)
    d = dtype(num_docs)
    return (c * d) / (dtype(df_t) * np.asarray(df_n).astype(dtype))


def pmi(cnts, df_t: int, df_n, num_docs: int) -> np.ndarray:
    """PMI scores in float32 (the argument in float32, the log rounded
    once)."""
    arg = pmi_args(cnts, df_t, df_n, num_docs)
    return np.log(arg.astype(np.float64)).astype(np.float32)


def topk_order(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` best scores, best first, ties to the lower
    index (the lower neighbour id: rows are in ascending id order)."""
    return np.argsort(-scores.astype(np.float64), kind="stable")[:k]
