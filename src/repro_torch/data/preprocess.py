"""Preprocessing — the step the paper calls "critical to good performance".

* ``preprocess_documents``: raw token-ID documents → deduplicated, sorted,
  densely re-numbered collection (the paper's §2 preprocessing).
* ``remap_df_descending``: beyond-paper — reassign term IDs by descending
  document frequency. The paper assigns IDs by first encounter; df-descending
  IDs concentrate the dense part of C = BᵀB in the top-left corner, which the
  FREQ-SPLIT hybrid (core/hybrid.py) exploits. Counting results are invariant
  to the renumbering (we keep the permutation to translate back).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.data.corpus import Collection


def preprocess_documents(docs: Iterable[Sequence[int]], vocab_size: int | None = None) -> Collection:
    """Dedup + sort each document, build CSR. Token IDs must be >= 0."""
    uniq_docs = []
    max_id = -1
    for d in docs:
        arr = np.asarray(d, dtype=np.int64)
        if arr.size:
            u = np.unique(arr)
            max_id = max(max_id, int(u[-1]))
        else:
            u = arr
        uniq_docs.append(u.astype(np.int32))
    if vocab_size is None:
        vocab_size = max_id + 1
    ptr = np.zeros(len(uniq_docs) + 1, dtype=np.int64)
    ptr[1:] = np.cumsum([len(d) for d in uniq_docs])
    terms = (
        np.concatenate(uniq_docs).astype(np.int32)
        if uniq_docs
        else np.zeros(0, dtype=np.int32)
    )
    return Collection(ptr, terms, vocab_size)


def remap_df_descending(c: Collection) -> tuple[Collection, np.ndarray]:
    """Renumber term IDs by descending df (ties by old ID for determinism).

    Returns (new_collection, old_id_of_new_id) such that
    ``old_id_of_new_id[new_id] == old_id``.
    """
    df = np.bincount(c.terms, minlength=c.vocab_size)
    # stable sort on -df keeps old-ID order within ties
    order = np.argsort(-df, kind="stable").astype(np.int32)  # new_id -> old_id
    new_of_old = np.empty_like(order)
    new_of_old[order] = np.arange(c.vocab_size, dtype=np.int32)
    new_terms = new_of_old[c.terms]
    # re-sort within each document (renumbering breaks per-doc ascending order)
    out = np.empty_like(new_terms)
    for d in range(c.num_docs):
        lo, hi = c.doc_ptr[d], c.doc_ptr[d + 1]
        out[lo:hi] = np.sort(new_terms[lo:hi])
    return Collection(c.doc_ptr.copy(), out, c.vocab_size), order


def shard_documents(c: Collection, num_shards: int) -> list[Collection]:
    """Contiguous row-shards of B for distributed Gram accumulation.

    C = Σ_s B_sᵀ B_s — each shard's contribution is independent and additive,
    which is what makes the distributed accumulation fault-tolerant (a lost
    shard is simply recomputed and re-added; see runtime/fault.py).
    """
    bounds = np.linspace(0, c.num_docs, num_shards + 1).astype(np.int64)
    shards = []
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        plo, phi = c.doc_ptr[lo], c.doc_ptr[hi]
        ptr = (c.doc_ptr[lo:hi + 1] - plo).astype(np.int64)
        shards.append(Collection(ptr, c.terms[plo:phi].copy(), c.vocab_size))
    return shards
