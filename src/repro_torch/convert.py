"""Inputs from the reference package's plain arrays.

The reference package's ``Collection`` is plain numpy (``doc_ptr``,
``terms``, ``vocab_size``): :func:`collection_from_numpy` takes those arrays
as they are, without importing the reference. Stores need no conversion —
both packages read and write the same on-disk format (docs/formats.md).
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import Collection


def collection_from_numpy(doc_ptr, terms, vocab_size: int) -> Collection:
    """A port :class:`Collection` over the reference's ``doc_ptr`` (int64
    ``(D+1,)``) and ``terms`` (int32, per-document sorted unique term ids).

    Example::

        c = collection_from_numpy(ref_c.doc_ptr, ref_c.terms, ref_c.vocab_size)
    """
    doc_ptr = np.asarray(doc_ptr, dtype=np.int64)
    terms = np.asarray(terms, dtype=np.int32)
    if doc_ptr.ndim != 1 or len(doc_ptr) < 1 or doc_ptr[0] != 0:
        raise ValueError("doc_ptr must be a 1-D offset array starting at 0")
    if doc_ptr[-1] != len(terms):
        raise ValueError(f"doc_ptr ends at {doc_ptr[-1]}, terms has {len(terms)}")
    if len(terms) and (terms.min() < 0 or terms.max() >= vocab_size):
        raise ValueError(f"term ids must lie in [0, {vocab_size})")
    return Collection(doc_ptr, terms, int(vocab_size))
