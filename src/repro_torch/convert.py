"""Inputs from the reference package's plain arrays.

The reference package's ``Collection`` is plain numpy (``doc_ptr``,
``terms``, ``vocab_size``): :func:`collection_from_numpy` takes those arrays
as they are, without importing the reference. Stores need no conversion —
both packages read and write the same on-disk format (docs/formats.md).
An LM's parameter tree, as numpy arrays, becomes a ``TransformerLM`` through
:func:`lm_params_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.corpus import Collection
from repro_torch.models.transformer import (
    LMConfig,
    TransformerLM,
    flat_leaves,
    param_shapes,
    tree_path,
)


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


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (numpy's ``bfloat16``
    extension type, which torch cannot read) travel as their bits."""
    a = np.array(a)  # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(tree: dict, cfg: LMConfig, device="cpu") -> TransformerLM:
    """A :class:`TransformerLM` holding the reference's parameter tree.

    ``tree`` is the reference's nested dict (``embed``, ``layers`` with each
    leaf stacked ``(L, ...)``, ``final_ln``, ``out_head``, and ``mtp`` with
    its ``(1, ...)`` block) as numpy arrays. Every leaf's shape is checked
    against ``param_shapes(cfg)``; a missing, extra or misshaped leaf
    raises ``ValueError``. Leaves are cast to ``cfg``'s dtype and the
    stacked layer leaves unstacked into ``layers.<i>``.

    Example::

        tree = jax.tree.map(np.asarray, T.init_params(key, cfg))
        model = lm_params_from_numpy(tree, cfg, "cpu")
    """
    want = flat_leaves(param_shapes(cfg))
    got = flat_leaves(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, extra {extra}")
    for name, shape in want.items():
        if tuple(np.shape(got[name])) != tuple(shape):
            raise ValueError(
                f"leaf {name!r} has shape {tuple(np.shape(got[name]))}, "
                f"expected {tuple(shape)}"
            )
    leaves = {path: _tensor(a) for path, a in got.items()}
    model = TransformerLM(cfg, device)
    with torch.no_grad():
        for name, t in model.named_parameters():
            leaf = leaves[tree_path(name)]
            index = [int(part) for part in name.split(".") if part.isdigit()]
            t.copy_(leaf[index[0]] if index else leaf)
    return model
