"""Document collections.

The paper's preprocessing (§2): per-document duplicate terms removed, term IDs
are 32-bit ordinals, per-document term IDs sorted ascending. A collection is
stored as a CSR forward index — ``doc_ptr`` + ``terms`` — which *is* the
paper's "forward documents" structure.

The synthetic generator draws Zipf-distributed terms so that the collection
reproduces the statistical shape of WT10G in Table 1 (heavy-tailed df, mean
document length ~230 unique terms, vocabulary growing sublinearly in D).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Collection:
    """A preprocessed document collection (CSR forward index).

    Invariants (enforced by ``preprocess_documents``):
      * per-document term IDs are strictly ascending (deduplicated + sorted),
      * term IDs are dense ordinals in ``[0, vocab_size)``.
    """

    doc_ptr: np.ndarray  # int64[D+1]
    terms: np.ndarray    # int32[nnz] — per-doc sorted unique term IDs
    vocab_size: int

    @property
    def num_docs(self) -> int:
        return len(self.doc_ptr) - 1

    @property
    def num_postings(self) -> int:
        return int(self.doc_ptr[-1])

    def doc(self, d: int) -> np.ndarray:
        return self.terms[self.doc_ptr[d]:self.doc_ptr[d + 1]]

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.doc_ptr)

    def head(self, n_docs: int) -> "Collection":
        """Prefix sub-collection — the paper emulates smaller collections by
        taking the first encountered documents (Table 1 columns)."""
        n_docs = min(n_docs, self.num_docs)
        ptr = self.doc_ptr[: n_docs + 1].copy()
        return Collection(ptr, self.terms[: ptr[-1]].copy(), self.vocab_size)


def _zipf_probs(vocab: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def synthetic_zipf_collection(
    num_docs: int,
    *,
    vocab: int = 50_000,
    mean_len: float = 230.0,
    zipf_s: float = 1.07,
    min_len: int = 2,
    seed: int = 0,
) -> Collection:
    """Generate a Zipfian collection with WT10G-like shape (Table 1).

    Draw raw token counts per document from a lognormal (heavy upper tail like
    the paper's max-73.6K-term documents), then draw tokens i.i.d. Zipf and
    deduplicate — mirroring word-broken text with repetitions removed.
    """
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(vocab, zipf_s)
    # lognormal with heavy tail; clip to keep the quadratic pair blowup sane
    sigma = 0.9
    mu = np.log(mean_len) - 0.5 * sigma * sigma
    raw_lens = np.maximum(
        rng.lognormal(mean=mu, sigma=sigma, size=num_docs).astype(np.int64), min_len
    )

    docs = []
    # draw in chunks to bound memory
    for start in range(0, num_docs, 8192):
        stop = min(start + 8192, num_docs)
        lens = raw_lens[start:stop]
        flat = rng.choice(vocab, size=int(lens.sum()), p=probs)
        offs = np.concatenate([[0], np.cumsum(lens)])
        for i in range(len(lens)):
            uniq = np.unique(flat[offs[i]:offs[i + 1]])
            docs.append(uniq.astype(np.int32))

    ptr = np.zeros(num_docs + 1, dtype=np.int64)
    ptr[1:] = np.cumsum([len(d) for d in docs])
    terms = np.concatenate(docs) if docs else np.zeros(0, dtype=np.int32)
    return Collection(ptr, terms.astype(np.int32), vocab)


@dataclasses.dataclass(frozen=True)
class CollectionStats:
    """The collection statistics the planner's cost models consume (paper §3:
    asymptotics in documents, postings, df distribution, and vocabulary).

    ``df_rank_cum`` summarizes the df distribution compactly: entry k is the
    number of postings covered by the 2^k highest-df terms. That is all the
    FREQ-SPLIT cost model needs (head/tail postings split) without carrying
    the full df array around in a frozen plan.
    """

    num_docs: int
    num_postings: int
    vocab_size: int
    live_vocab: int          # terms with df > 0
    pair_occurrences: int    # Σ_d len_d·(len_d−1)/2
    max_doc_len: int
    df_rank_cum: tuple[int, ...]

    @property
    def avg_doc_len(self) -> float:
        return self.num_postings / self.num_docs if self.num_docs else 0.0

    @classmethod
    def from_collection(cls, c: "Collection") -> "CollectionStats":
        lens = c.doc_lengths()
        df = np.bincount(c.terms, minlength=c.vocab_size)
        df_desc = np.sort(df)[::-1]
        cum = np.cumsum(df_desc, dtype=np.int64)
        ranks = []
        r = 1
        while r < c.vocab_size:
            ranks.append(r)
            r *= 2
        ranks.append(c.vocab_size)
        return cls(
            num_docs=c.num_docs,
            num_postings=c.num_postings,
            vocab_size=c.vocab_size,
            live_vocab=int((df > 0).sum()),
            pair_occurrences=int(
                (lens.astype(np.int64) * (lens - 1) // 2).sum()
            ),
            max_doc_len=int(lens.max()) if len(lens) else 0,
            df_rank_cum=tuple(int(cum[r - 1]) for r in ranks),
        )

    def postings_in_top(self, h: int) -> int:
        """Postings covered by the ``h`` highest-df terms (log-interpolated
        from the rank samples)."""
        if h <= 0 or not self.df_rank_cum:
            return 0
        ranks = [min(1 << k, self.vocab_size) for k in range(len(self.df_rank_cum))]
        ranks[-1] = self.vocab_size
        if h >= self.vocab_size:
            return self.df_rank_cum[-1]
        for k in range(len(ranks)):
            if ranks[k] >= h:
                if ranks[k] == h or k == 0:
                    return self.df_rank_cum[k]
                lo_r, hi_r = ranks[k - 1], ranks[k]
                lo_c, hi_c = self.df_rank_cum[k - 1], self.df_rank_cum[k]
                frac = (h - lo_r) / (hi_r - lo_r)
                return int(lo_c + frac * (hi_c - lo_c))
        return self.df_rank_cum[-1]


def collection_stats(c: Collection) -> dict:
    """Table 1 statistics (exact pair count done by the core methods; here we
    report the closed-form per-document pair total = Σ len·(len−1)/2 which is
    the number of *pair occurrences*; distinct-pair counts come from the
    counting methods themselves)."""
    lens = c.doc_lengths()
    df = np.bincount(c.terms, minlength=c.vocab_size)
    return {
        "num_docs": c.num_docs,
        "avg_doc_len": float(lens.mean()) if len(lens) else 0.0,
        "min_doc_len": int(lens.min()) if len(lens) else 0,
        "max_doc_len": int(lens.max()) if len(lens) else 0,
        "std_doc_len": float(lens.std()) if len(lens) else 0.0,
        "num_postings": c.num_postings,
        "vocab_observed": int((df > 0).sum()),
        "pair_occurrences": int((lens.astype(np.int64) * (lens - 1) // 2).sum()),
    }
