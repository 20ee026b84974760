"""Atomic checkpointing of nested dicts of numpy arrays.

Layout:  <dir>/step_<N>/manifest.json + one .npy per leaf — the reference
package's layout, leaves in its order (dict keys sorted, nested names
joined by ``/``), so either package restores the other's checkpoints.

* atomicity — writes go to ``step_N.tmp`` and are renamed only after fsync;
  a crashed writer never leaves a ``step_N`` directory half-written, and a
  restart picks the newest complete step;
* self-describing — the manifest stores each leaf's name, shape and dtype,
  and the caller's JSON ``extra``.

The reference's asynchronous ``CheckpointManager`` and its resharding
restore serve the LM stack and are not ported.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping

import numpy as np


def _flatten(tree: Mapping, prefix: str = "") -> list[tuple[str, object]]:
    """``(name, leaf)`` pairs of a nested dict, keys sorted at every level."""
    out = []
    for key in sorted(tree):
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            out += _flatten(tree[key], name)
        else:
            out.append((name, tree[key]))
    return out


def _unflatten(tree_like: Mapping, leaves) -> dict:
    """A dict shaped like ``tree_like`` with its leaves taken in order from
    the iterator ``leaves``."""
    return {
        key: _unflatten(tree_like[key], leaves)
        if isinstance(tree_like[key], Mapping) else next(leaves)
        for key in sorted(tree_like)
    }


def save_checkpoint(directory: str, step: int, tree: Mapping, extra: dict | None = None) -> str:
    """Synchronous atomic save of ``tree`` (a nested dict of arrays) and the
    JSON-serializable ``extra``. Returns the final step directory.

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
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = np.asarray(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
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


def restore_checkpoint(directory: str, step: int, tree_like: Mapping) -> tuple[dict, dict]:
    """Restore step ``step`` into the structure of ``tree_like`` (a nested
    dict of arrays), each leaf cast to its counterpart's dtype. Returns
    ``(tree, extra)``; raises ``ValueError`` if the leaf count or a shape
    differs.

    Example::

        tree, extra = restore_checkpoint("/run/ckpt", latest_step("/run/ckpt"),
                                         {"acc": np.zeros((V, V), np.int64)})
    """
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = _flatten(tree_like)
    if len(manifest["leaves"]) != len(like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target structure has {len(like)}"
        )
    arrays = []
    for rec, (_, leaf) in zip(manifest["leaves"], like):
        arr = np.load(os.path.join(path, rec["file"]))
        leaf = np.asarray(leaf)
        if arr.shape != leaf.shape:
            raise ValueError(f"{rec['name']}: shape {arr.shape} != {leaf.shape}")
        arrays.append(arr.astype(leaf.dtype, copy=False))
    return _unflatten(tree_like, iter(arrays)), manifest["extra"]
