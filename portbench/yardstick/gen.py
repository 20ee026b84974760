"""Input and traffic generators, frozen here so that no later change to the
program can move the yardstick.

* :func:`zipf_collection` is ``synthetic_zipf_collection`` of
  ``src/repro_torch/data/corpus.py`` (itself a copy of
  ``src/repro/data/corpus.py``): lognormal raw lengths, i.i.d. Zipf terms,
  duplicates removed. One change: the raw lengths are a pool drawn once
  from a seed of the configuration (``length_seed``), repeated for every
  block of documents and shuffled within each block by the run's seed, so
  every seed, and every block (a build job), has the same multiset of
  lengths.
* :func:`remap_df_descending` is ``remap_df_descending`` of
  ``src/repro_torch/data/preprocess.py``.
* :func:`zipf_term_sampler` is ``_zipf_sampler`` of
  ``src/repro_torch/launch/cooc_serve.py``, fed the benchmark's own document
  frequencies instead of the store's and ranking only the terms that occur;
  :func:`uniform_term_sampler` draws uniformly over the terms that occur.

A collection is ``(doc_ptr int64[D+1], terms int32[nnz])``: per document
strictly ascending term ids (the paper's preprocessed forward index).
"""

from __future__ import annotations

import numpy as np


def zipf_probs(vocab: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def zipf_collection(
    num_docs: int,
    *,
    vocab: int,
    mean_len: float,
    zipf_s: float,
    sigma: float,
    length_seed: int,
    seed: int,
    block: int | None = None,
    min_len: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """A WT10G-shaped collection: ``num_docs`` documents whose raw lengths
    are a pool of ``block`` (default ``num_docs``) lognormal lengths (mean
    ``mean_len``, shape ``sigma``) drawn from ``length_seed``, shuffled by
    ``seed`` within each block of ``block`` documents, each document filled
    with i.i.d. Zipf(``zipf_s``) term ids drawn from ``seed`` and
    deduplicated."""
    block = block or num_docs
    mu = np.log(mean_len) - 0.5 * sigma * sigma
    pool = np.maximum(
        np.random.default_rng(length_seed)
        .lognormal(mean=mu, sigma=sigma, size=block)
        .astype(np.int64),
        min_len,
    )
    rng = np.random.default_rng(seed)
    raw_lens = np.concatenate([pool[rng.permutation(block)]
                               for _ in range(-(-num_docs // block))])[:num_docs]
    probs = zipf_probs(vocab, zipf_s)
    docs = []
    for start in range(0, num_docs, 8192):
        lens = raw_lens[start:start + 8192]
        flat = rng.choice(vocab, size=int(lens.sum()), p=probs)
        offs = np.concatenate([[0], np.cumsum(lens)])
        for i in range(len(lens)):
            docs.append(np.unique(flat[offs[i]:offs[i + 1]]).astype(np.int32))
    ptr = np.zeros(num_docs + 1, dtype=np.int64)
    ptr[1:] = np.cumsum([len(d) for d in docs])
    terms = np.concatenate(docs) if docs else np.zeros(0, dtype=np.int32)
    return ptr, terms.astype(np.int32)


def remap_df_descending(
    doc_ptr: np.ndarray, terms: np.ndarray, vocab: int
) -> np.ndarray:
    """The terms renumbered by descending document frequency (ties by old
    id), re-sorted within each document; ``doc_ptr`` is unchanged."""
    df = np.bincount(terms, minlength=vocab)
    order = np.argsort(-df, kind="stable").astype(np.int32)  # new -> old
    new_of_old = np.empty_like(order)
    new_of_old[order] = np.arange(vocab, dtype=np.int32)
    new_terms = new_of_old[terms]
    out = np.empty_like(new_terms)
    for d in range(len(doc_ptr) - 1):
        lo, hi = doc_ptr[d], doc_ptr[d + 1]
        out[lo:hi] = np.sort(new_terms[lo:hi])
    return out


def zipf_term_sampler(df: np.ndarray, s: float):
    """``draw(rng, n)``: term ids drawn Zipf(``s``) over the df order of the
    terms that occur, so the highest-df terms get most of the traffic. (The
    original ranks every id of the vocabulary; a store of a slice of the
    collection holds few of the published vocabulary's terms, and a query
    goes to a term the store holds.)"""
    live = int(np.count_nonzero(df))
    probs = zipf_probs(live, s)
    df_order = np.argsort(-df, kind="stable")[:live]

    def draw(rng, n):
        return df_order[rng.choice(live, size=n, p=probs)]

    return draw


def uniform_term_sampler(df: np.ndarray):
    """``draw(rng, n)``: term ids drawn uniformly over the terms with
    df > 0."""
    live = np.flatnonzero(df > 0)

    def draw(rng, n):
        return live[rng.integers(0, len(live), size=n)]

    return draw


SAMPLERS = {
    "zipf": lambda df, mix: zipf_term_sampler(df, mix["zipf_s"]),
    "uniform": lambda df, mix: uniform_term_sampler(df),
}


def collection(cfg: dict, docs: int, seed: int):
    """``(doc_ptr, terms)`` of ``docs`` documents of the configuration for
    ``seed``: lengths from the pool of ``cfg["num_docs"]``, ids as drawn or,
    with ``df_descending``, renumbered by df."""
    ptr, terms = zipf_collection(
        docs, vocab=cfg["vocab_size"], mean_len=cfg["mean_len"],
        zipf_s=cfg["zipf_s"], sigma=cfg["sigma"],
        length_seed=cfg["length_seed"], seed=seed, block=cfg["num_docs"],
    )
    if cfg["df_descending"]:
        terms = remap_df_descending(ptr, terms, cfg["vocab_size"])
    return ptr, terms


def to_program(cfg: dict, ptr: np.ndarray, terms: np.ndarray):
    """The program's input type over copies of the benchmark's arrays."""
    from repro_torch.data.corpus import Collection

    return Collection(ptr.copy(), terms.copy(), cfg["vocab_size"])


def count(cfg: dict, coll, path: str, device: str, method: str | None = None):
    """The program's ``count_to_store`` of ``coll`` into a store at
    ``path``, as the configuration states it."""
    from repro_torch.core import cooc

    return cooc.count_to_store(
        method or cfg["method"], coll, path,
        memory_budget_pairs=cfg["memory_budget_pairs"],
        df_descending=cfg["df_descending"], device=device,
    )
