"""Production mesh: 16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.

FUNCTIONS, not module-level constants — importing this module touches no
process group. Each builds a ``torch.distributed`` :class:`DeviceMesh` over
the first ranks of the initialized default group, of the group's kind: a
``cuda`` mesh on an NCCL world (a card for each rank), a ``cpu`` mesh on
gloo, whose collectives take host tensors (so several ranks may share one
card)."""

from __future__ import annotations

import numpy as np
import torch


def _mesh(shape: tuple, axes: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {have} — start a world of at "
            f"least {n} ranks (torch.distributed.init_process_group) first"
        )
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")):
    """Small mesh for the multi-process tests (8 ranks by default)."""
    return _mesh(tuple(shape), tuple(axes))
