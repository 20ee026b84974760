"""Atomic, async checkpointing of trees of arrays and tensors.

Layout:  <dir>/step_<N>/manifest.json + one .npy per leaf — the reference
package's layout and leaf order, so either package restores the other's
checkpoints. A tree is the reference's pytree: dicts (keys sorted), lists
and tuples (in order), and leaves; a leaf's name joins its keys and
indices with ``/`` (``0/layers/wq``, ``1/m/embed``, ``1/count``).

* leaves — numpy arrays or torch tensors (from any device). A bfloat16
  leaf, which ``np.save`` cannot write, goes to disk as its ``uint16``
  bits with ``"dtype": "bfloat16"`` in the manifest, and comes back by
  view, as in the reference. A :class:`Stacked` leaf (a list of equal
  tensors) is written as their stack along a new first axis: the port's
  LM keeps its layers unstacked, the reference stacks them;
* atomicity — writes go to ``step_N.tmp`` and are renamed only after fsync;
  a crashed writer never leaves a ``step_N`` directory half-written, and a
  restart picks the newest complete step;
* async — ``CheckpointManager.save_async`` copies every leaf to host memory
  before it returns (the train step rewrites its tensors in place) and
  writes in a background thread; a writer's error surfaces on the next
  ``wait()`` or ``save_async``;
* self-describing — the manifest stores each leaf's name, shape and dtype,
  and the caller's JSON ``extra``.

The reference's resharding restore (``shardings=``) comes with the
sharding slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Mapping

import numpy as np
import torch


class Stacked(list):
    """A leaf given as its slices along a new first axis (tensors of one
    shape and dtype): saved as their stack, restored as a ``Stacked`` of
    slices."""


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(name, leaf)`` pairs of a tree in the reference's leaf order: dict
    keys sorted, list and tuple entries in order, names joined by ``/``."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, v in items:
        out += flatten(v, f"{prefix}/{key}" if prefix else key)
    return out


def _unflatten(tree_like, leaves):
    """A tree shaped like ``tree_like`` with its leaves taken in order from
    the iterator ``leaves``."""
    if isinstance(tree_like, Mapping):
        return {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
    if isinstance(tree_like, (list, tuple)) and not isinstance(tree_like, Stacked):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def _host(leaf):
    """A leaf as a host copy that no later write to ``leaf`` reaches: a CPU
    tensor for a tensor or a ``Stacked`` (stacked here), else a numpy
    array."""
    if isinstance(leaf, Stacked):
        return torch.stack([_host(t) for t in leaf])
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_disk(leaf) -> tuple[np.ndarray, str]:
    """``(array np.save can write, logical dtype name)``."""
    if isinstance(leaf, Stacked) or torch.is_tensor(leaf):
        t = _host(leaf)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # numpy's bfloat16 extension type
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic save of ``tree`` and the JSON-serializable
    ``extra``. Returns the final step directory.

    Example::

        save_checkpoint("/run/ckpt", 4, {"acc": acc}, extra={"done": 4})
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(flatten(tree)):
        arr, logical_dtype = _to_disk(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": logical_dtype}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> int | None:
    """The newest complete step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _restored(arr: np.ndarray, rec: dict, like):
    """The loaded ``arr`` as ``like``'s kind of leaf, in its dtype (and, for
    a tensor, on its device); bfloat16 bits are read by view first."""
    bf16 = rec["dtype"] == "bfloat16"
    if isinstance(like, Stacked) or torch.is_tensor(like):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if bf16 \
            else torch.from_numpy(arr)
        if isinstance(like, Stacked):
            return Stacked(s.to(device=l.device, dtype=l.dtype)
                           for s, l in zip(t.unbind(0), like))
        return t.to(device=like.device, dtype=like.dtype)
    like = np.asarray(like)
    if bf16:
        if like.dtype.name == "bfloat16":
            return arr.view(like.dtype)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).float() \
            .numpy().astype(like.dtype)
    return arr.astype(like.dtype, copy=False)


def _shape(like) -> tuple:
    if isinstance(like, Stacked):
        return (len(like), *like[0].shape)
    return tuple(like.shape) if torch.is_tensor(like) else np.shape(like)


def restore_checkpoint(directory: str, step: int, tree_like) -> tuple:
    """Restore step ``step`` into the structure of ``tree_like``: each leaf
    as its counterpart's kind (numpy array, tensor on its device, or
    ``Stacked`` slices) and dtype. Returns ``(tree, extra)``; raises
    ``ValueError`` if the leaf count or a shape differs.

    Example::

        tree, extra = restore_checkpoint("/run/ckpt", latest_step("/run/ckpt"),
                                         {"acc": np.zeros((V, V), np.int64)})
    """
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = flatten(tree_like)
    if len(manifest["leaves"]) != len(like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target structure has {len(like)}"
        )
    leaves = []
    for rec, (_, leaf) in zip(manifest["leaves"], like):
        arr = np.load(os.path.join(path, rec["file"]))
        if tuple(arr.shape) != _shape(leaf):
            raise ValueError(f"{rec['name']}: shape {arr.shape} != {_shape(leaf)}")
        leaves.append(_restored(arr, rec, leaf))
    return _unflatten(tree_like, iter(leaves)), manifest["extra"]


class CheckpointManager:
    """Async writer + retention policy: keeps the newest ``keep_last``
    steps.

    Example::

        mgr = CheckpointManager("/run/ckpt", keep_last=2)
        mgr.save_async(50, (params, opt_state), extra={"step": 50})
        ...                    # the next steps may rewrite those tensors
        mgr.wait()             # raises a writer's error, if any
    """

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree, extra: dict | None = None):
        # snapshot to host memory synchronously: the caller's next step
        # rewrites the tensors in place
        host_tree = _unflatten(tree, iter(_host(leaf) for _, leaf in flatten(tree)))
        self.wait()

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
