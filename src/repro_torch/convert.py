"""Inputs from the reference package's plain arrays.

The reference package's ``Collection`` is plain numpy (``doc_ptr``,
``terms``, ``vocab_size``): :func:`collection_from_numpy` takes those arrays
as they are, without importing the reference. Stores need no conversion —
both packages read and write the same on-disk format (docs/formats.md).
An LM's parameter tree, as numpy arrays, becomes a ``TransformerLM`` through
:func:`lm_params_from_numpy`, a GraphSAGE tree a ``GraphSAGE`` through
:func:`gnn_params_from_numpy`, and a ranker's a ``Ranker`` through
:func:`recsys_params_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.corpus import Collection
from repro_torch.models import gnn, recsys
from repro_torch.models.params import ParamTree, check_leaves, flat_leaves
from repro_torch.models.transformer import (
    LMConfig,
    TransformerLM,
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
    got = flat_leaves(tree)
    check_leaves(flat_leaves(param_shapes(cfg)), got)
    leaves = {path: _tensor(a) for path, a in got.items()}
    model = TransformerLM(cfg, device)
    with torch.no_grad():
        for name, t in model.named_parameters():
            leaf = leaves[tree_path(name)]
            index = [int(part) for part in name.split(".") if part.isdigit()]
            t.copy_(leaf[index[0]] if index else leaf)
    return model


def _filled(model_cls, cfg, shapes: dict, tree: dict, device) -> ParamTree:
    """Check ``tree`` against ``shapes``, then allocate ``model_cls(cfg,
    device)`` and copy every leaf into the parameter of its path (cast to
    the parameter's dtype)."""
    got = flat_leaves(tree)
    check_leaves(flat_leaves(shapes), got)
    model = model_cls(cfg, device)
    with torch.no_grad():
        for name, t in model.named_parameters():
            t.copy_(_tensor(got[name]))
    return model


def gnn_params_from_numpy(tree: dict, cfg: gnn.GNNConfig, device="cuda") -> gnn.GraphSAGE:
    """A :class:`~repro_torch.models.gnn.GraphSAGE` holding the reference's
    parameter tree (``layer<i>`` with ``w_self``, ``w_neigh``, ``b``;
    ``head`` with ``w``, ``b``) as numpy arrays, on ``device`` (the card
    unless the caller says so). A missing, extra or misshaped leaf raises
    ``ValueError``.

    Example::

        tree = jax.tree.map(np.asarray, G.init_params(key, cfg))
        model = gnn_params_from_numpy(tree, cfg, "cpu")
    """
    return _filled(gnn.GraphSAGE, cfg, gnn.param_shapes(cfg), tree, device)


def recsys_params_from_numpy(tree: dict, cfg: recsys.RecsysConfig,
                             device="cuda") -> recsys.Ranker:
    """A :class:`~repro_torch.models.recsys.Ranker` holding the reference's
    parameter tree for ``cfg.kind`` as numpy arrays, on ``device`` (the
    card unless the caller says so). The tree's lists (``mlp``, ``blocks``,
    ``cin``) map to ``mlp.<i>.w``, ``blocks.<i>.wq``, ``cin.<i>.w``. A
    missing, extra or misshaped leaf, or a list of the wrong length,
    raises ``ValueError``.

    Example::

        tree = jax.tree.map(np.asarray, R.init_params(key, cfg))
        model = recsys_params_from_numpy(tree, cfg, "cpu")
    """
    return _filled(recsys.Ranker, cfg, recsys.param_shapes(cfg), tree, device)
