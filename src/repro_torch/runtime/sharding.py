"""Sharding rules: parameter path → spec, and specs onto a ``DeviceMesh``.

The counterpart of the reference package's ``runtime/sharding.py``, with
its layout policy:

  * ``"model"`` axis: tensor parallel (attention heads / FFN width / expert
    axis / vocab / embedding rows);
  * the remaining axes (``"data"``, and ``"pod"`` when multi-pod): FSDP —
    weights are additionally sliced along their d_model-adjacent dimension
    and gathered per layer;
  * norms and biases replicate (tiny).

A spec (:class:`P`) is a tuple with one entry a dimension: an axis name, a
tuple of names (sharded over their product, major to minor), or ``None``.
:func:`placements` maps it onto DTensor placements of a mesh; the dry run
(``launch/specs.py``) lays its fake parameters out by it.

The reference stacks an LM's layers, so its layer leaves carry a leading
``L`` axis. The port keeps one module a layer: its per-layer spec is the
reference's without that leading ``None`` (the rule reads the same either
way, from the leaf's number of dimensions).

:func:`set_mesh_compat` makes a mesh the active one (thread-local), which
``models.layers.maybe_shard`` and ``moe_ffn_ep`` read.
"""

from __future__ import annotations

import contextlib
import threading


class P(tuple):
    """A partition spec: ``P("model", ("data",))`` shards dimension 0 over
    ``model`` and dimension 1 over ``data``; missing trailing entries are
    ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def padded(self, ndim: int) -> tuple:
        """The entries padded with ``None`` to ``ndim`` dimensions."""
        return tuple(self) + (None,) * (ndim - len(self))


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of any object that has them."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name → extent."""
    shape = getattr(mesh, "shape", None)
    if shape is None or callable(shape):
        shape = mesh.devices.shape
    return dict(zip(axis_names(mesh), tuple(shape)))


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry: ``None`` → (), a name → (name,)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def fsdp_axes(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a != "model")


def _lm_rule(name: str, ndim: int, fsdp, model="model") -> P:
    # layer leaves of the reference carry a leading L axis (ndim one higher
    # than the logical matrix); the port's per-layer leaves do not
    lead = (None,) * (ndim - 2)
    if name in ("embed",):
        return P(model, fsdp)
    if name in ("out_head",):
        return P(fsdp, model)
    if name in ("proj",):  # MTP projection (2d, d)
        return P(fsdp, None)
    if name in ("wq", "wk", "wv", "w_in", "w_gate", "w_uq", "sh_w_in", "sh_w_gate"):
        return P(*lead, fsdp, model)
    if name in ("wo", "w_out", "sh_w_out"):
        return P(*lead, model, fsdp)
    if name in ("w_dq", "w_dkv", "w_kr"):
        return P(*lead, fsdp, None)
    if name in ("w_uk", "w_uv"):
        return P(*lead, None, model)
    if name == "router":
        return P(*((None,) * ndim))  # small; replicated (the EP region's in-spec)
    if name in ("moe_w_in", "moe_w_gate"):  # ([L,] E, d, f)
        return P(*lead[:-1], model, fsdp, None)
    if name == "moe_w_out":  # ([L,] E, f, d)
        return P(*lead[:-1], model, None, fsdp)
    if name in ("bq", "bk", "bv"):
        return P(*lead, model)
    # norms, small vectors
    return P(*((None,) * ndim))


def lm_param_specs(shapes_tree, mesh) -> dict:
    """shapes_tree: a tree of shape tuples (``models.transformer.
    param_shapes``, stacked, or per layer)."""
    fsdp = fsdp_axes(mesh)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else _lm_rule(k, len(v), fsdp)
                for k, v in tree.items()}

    return walk(shapes_tree)


def gnn_param_specs(shapes_tree, mesh) -> dict:
    """GraphSAGE weights are small → replicate everything."""

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return P(*((None,) * len(tree)))

    return walk(shapes_tree)


def recsys_param_specs(shapes_tree, mesh) -> dict:
    """Embedding tables row-shard over "model" (embedding parallelism — the
    recsys analogue of expert parallelism); dense towers replicate (they are
    ≤ a few MB and used by every example)."""

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        if key in ("item_embed", "cat_embed", "embed", "linear"):
            return P("model", *((None,) * (len(tree) - 1)))
        return P(*((None,) * len(tree)))

    return walk(shapes_tree)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh axis,
    ``Shard(dim)`` for the dimension whose entry names the axis, else
    ``Replicate()``. A dimension over several axes shards over them in the
    entry's order (major to minor), which needs that order to be the mesh's.

    Example::

        placements(P("model", ("data",)), mesh_data_model)   # [Shard(1), Shard(0)]
    """
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"axis {names[i]!r} shards two dimensions in {spec}")
            out[i] = Shard(dim)
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """One rank's block of a tensor of ``shape`` laid out by ``spec``: each
    dimension divided by the product of its axes' extents, which must
    divide it."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, P(*spec).padded(len(shape))):
        ways = 1
        for a in entry_axes(entry):
            ways *= sizes[a]
        if dim % ways:
            raise ValueError(f"dimension {dim} does not split {ways} ways ({spec})")
        out.append(dim // ways)
    return tuple(out)


def fake_dtensor(shape, dtype, spec, mesh, *, requires_grad: bool = False):
    """A DTensor of global ``shape`` laid out by ``spec`` whose local block
    is made under the active ``FakeTensorMode`` (or on the meta device
    when none is active): nothing is allocated."""
    import torch
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype)
    t = DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                           shape=torch.Size(shape), stride=_contiguous_stride(shape))
    return t.requires_grad_(requires_grad) if requires_grad else t


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def attach(mesh, specs_tree, shapes_tree, dtype_tree=None, default_dtype="float32"):
    """A shape tree and its spec tree → a tree of fake DTensors laid out by
    the specs (nothing allocated; run under ``FakeTensorMode``)."""
    import torch

    def leaf(shape, spec, dtype):
        return fake_dtensor(shape, getattr(torch, dtype), spec, mesh)

    def walk(shapes, specs, dtypes):
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], specs[k], dtypes[k] if isinstance(dtypes, dict) else dtypes)
                    for k in shapes}
        if isinstance(shapes, list):
            return [walk(s, p, dtypes[i] if isinstance(dtypes, list) else dtypes)
                    for i, (s, p) in enumerate(zip(shapes, specs))]
        return leaf(shapes, specs, dtypes)

    return walk(shapes_tree, specs_tree, dtype_tree if dtype_tree is not None else default_dtype)


def axis_group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` (one axis, or several
    flattened in mesh order), made outside any ``FakeTensorMode`` (the
    mesh's rank grid is a real tensor). Every rank of the mesh must take
    part in the first call for a set of axes; the mesh keeps the result."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    with unset_fake_temporarily():
        return mesh[axes]._flatten().get_group()


# ------------------------------------------------------------ active mesh
class _Active(threading.local):
    mesh = None  # each thread starts with none (read on every layer)


_ACTIVE = _Active()


def active_mesh():
    """The mesh made active by :func:`set_mesh_compat` on this thread, or
    ``None``."""
    return _ACTIVE.mesh


@contextlib.contextmanager
def set_mesh_compat(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh of this thread for
    the block; ``maybe_shard`` and ``moe_ffn_ep`` read it. Nests."""
    prev = active_mesh()
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev
