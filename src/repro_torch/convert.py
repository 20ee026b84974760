"""Inputs from the reference package's plain arrays.

The reference package's ``Collection`` is plain numpy (``doc_ptr``,
``terms``, ``vocab_size``): :func:`collection_from_numpy` takes those arrays
as they are, without importing the reference. Stores need no conversion —
both packages read and write the same on-disk format (docs/formats.md).
An LM's parameter tree, as numpy arrays, becomes a ``TransformerLM`` through
:func:`lm_params_from_numpy`, a GraphSAGE tree a ``GraphSAGE`` through
:func:`gnn_params_from_numpy`, and a ranker's a ``Ranker`` through
:func:`recsys_params_from_numpy`; :func:`params_to_numpy` goes back, with
the LM's layers stacked. An optimizer state (``repro_torch.optim``) goes
to the reference's tree and back through :func:`opt_state_to_numpy` and
:func:`opt_state_from_numpy`, and :func:`train_state_tree` gives a
training state as the reference's ``(params, opt_state)`` tree for
``repro_torch.checkpoint``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import Stacked
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


def lm_params_from_numpy(tree: dict, cfg: LMConfig, device="cuda") -> TransformerLM:
    """A :class:`TransformerLM` holding the reference's parameter tree.

    ``tree`` is the reference's nested dict (``embed``, ``layers`` with each
    leaf stacked ``(L, ...)``, ``final_ln``, ``out_head``, and ``mtp`` with
    its ``(1, ...)`` block) as numpy arrays. Every leaf's shape is checked
    against ``param_shapes(cfg)``; a missing, extra or misshaped leaf
    raises ``ValueError``. Leaves are cast to ``cfg``'s dtype and the
    stacked layer leaves unstacked into ``layers.<i>``, on ``device`` (the
    card unless the caller says so).

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


# ---------------------------------------------------------- back to the reference
def _shapes(model) -> dict:
    """The reference's tree of shapes for ``model``."""
    if isinstance(model, TransformerLM):
        return param_shapes(model.cfg)
    if isinstance(model, gnn.GraphSAGE):
        return gnn.param_shapes(model.cfg)
    return recsys.param_shapes(model.cfg)


def _nest(flat: dict, shapes, path: str = ""):
    """The reference's nested tree (dicts and lists as in ``shapes``) of a
    flat tree keyed by dotted path; a list of per-layer slices becomes a
    :class:`~repro_torch.checkpoint.Stacked` leaf."""
    if isinstance(shapes, dict):
        return {k: _nest(flat, v, f"{path}.{k}" if path else k) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_nest(flat, v, f"{path}.{i}") for i, v in enumerate(shapes)]
    v = flat[path]
    return Stacked(v) if isinstance(v, list) else v


def _opt_nest(opt_state: dict, shapes) -> dict:
    """An optimizer state with each per-parameter tree (``m``, ``v``,
    ``mu``, ``stats``) nested as the reference's."""
    return {k: v if k == "count" else _nest(v, shapes) for k, v in opt_state.items()}


def train_state_tree(model, opt_state: dict) -> tuple:
    """``(params, opt_state)`` as the reference's tree of this state's own
    tensors (no copy; the LM's layer leaves as ``Stacked`` slices): what
    ``repro_torch.checkpoint`` saves, in the reference's leaf order and
    names, and the ``tree_like`` it restores into."""
    shapes = _shapes(model)
    return _nest(model.param_tree(), shapes), _opt_nest(opt_state, shapes)


def _numpy(tree):
    """A tree of tensors as numpy arrays (``Stacked`` leaves stacked).
    bfloat16 needs numpy's bfloat16 type, ``ml_dtypes`` (which JAX
    brings), imported only for such a leaf."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, Stacked):
        return np.stack([_numpy(t) for t in tree])
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(model) -> dict:
    """The reference's parameter tree of a ``TransformerLM`` (layer leaves
    stacked ``(L, ...)``, the MTP block's ``(1, ...)``), ``GraphSAGE`` or
    ``Ranker`` (lists as lists), as numpy arrays: the reverse of
    :func:`lm_params_from_numpy`, :func:`gnn_params_from_numpy` and
    :func:`recsys_params_from_numpy`.

    Example::

        tree = params_to_numpy(model)
        ref_params = jax.tree.map(jnp.asarray, tree)
    """
    return _numpy(_nest(model.param_tree(), _shapes(model)))


def opt_state_to_numpy(opt_state: dict, model) -> dict:
    """An optimizer state of ``model``'s parameters (AdamW's ``m``, ``v``,
    ``count``; SGD's ``mu``, ``count``; Adafactor's ``stats``, ``count``)
    as the reference's tree of numpy arrays, the moments in their own
    dtype and the LM's stacked."""
    return _numpy(_opt_nest(opt_state, _shapes(model)))


def opt_state_from_numpy(tree: dict, model) -> dict:
    """The reference's optimizer state tree (numpy arrays, as
    :func:`opt_state_to_numpy` gives) as the port's, on ``model``'s
    device, keyed as ``model.param_tree()``: stacked moments split into
    the per-layer slices of the port's LM; Adafactor's statistics, which
    span a stacked leaf, kept whole. A missing, extra or misshaped moment
    raises ``ValueError``."""
    shapes = _shapes(model)
    params = model.param_tree()
    dev = next(model.parameters()).device

    def at(sub, path: str):
        for key in path.split("."):
            sub = sub[int(key)] if isinstance(sub, list) else sub[key]
        return sub

    out = {"count": _tensor(tree["count"]).to(device=dev, dtype=torch.int32)}
    for name, sub in tree.items():
        if name == "stats":
            out[name] = {path: {k: _tensor(a).to(dev) for k, a in at(sub, path).items()}
                         for path in params}
        elif name != "count":
            check_leaves(flat_leaves(shapes), flat_leaves(sub))
            out[name] = {}
            for path, p in params.items():
                t = _tensor(at(sub, path)).to(dev)
                out[name][path] = list(t.unbind(0)) if isinstance(p, list) else t
    return out
