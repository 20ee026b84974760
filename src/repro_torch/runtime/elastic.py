"""Elastic re-meshing: rebuild the device mesh after node loss/gain.

Policy: keep the tensor-parallel ("model") extent fixed if possible (its
sharding is baked into weight layouts and collectives are latency-critical),
shrink the data/pod extents to the largest grid that fits the surviving
device count, park the remainder as hot spares. Restart = restore the last
checkpoint with the new mesh's shardings and rebalance the data shards
(runtime/fault.WorkTracker).

The mesh is a ``torch.distributed`` :class:`DeviceMesh` over ranks of the
default process group, of the group's kind (``cuda`` on NCCL, ``cpu`` on
gloo); building one needs that group initialized.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axis_names: tuple
    spares: int

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_mesh(
    n_devices: int,
    model_parallel: int = 16,
    axis_names: tuple = ("data", "model"),
) -> MeshPlan:
    """Largest (data, model) grid with the requested model extent; if fewer
    than ``model_parallel`` devices survive, degrade model parallelism to the
    largest power of two that fits."""
    mp = model_parallel
    while mp > 1 and n_devices < mp:
        mp //= 2
    data = max(n_devices // mp, 1)
    return MeshPlan((data, mp), axis_names, spares=n_devices - data * mp)


def build_mesh(plan: MeshPlan, ranks=None):
    """A :class:`DeviceMesh` of ``plan.shape`` over the first
    ``plan.num_devices`` of ``ranks`` (default: the world's ranks in order),
    with ``plan.axis_names`` as its dimension names: a ``cuda`` mesh on an
    NCCL world, a ``cpu`` one (host tensors; ranks may share one card) on
    gloo. Raises when fewer ranks survive than the plan needs.

    Example::

        mesh = build_mesh(plan_mesh(dist.get_world_size(), model_parallel=2))
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if len(ranks) < plan.num_devices:
        raise RuntimeError(
            f"mesh {plan.shape} needs {plan.num_devices} ranks, have {len(ranks)}"
        )
    grid = torch.tensor(ranks[: plan.num_devices]).reshape(plan.shape)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, grid, mesh_dim_names=tuple(plan.axis_names))


def rebalance_shards(num_shards: int, old_workers: list, new_workers: list) -> dict:
    """Deterministic shard → worker assignment that minimizes movement:
    shards whose old owner survived stay put; orphaned shards round-robin
    onto the least-loaded survivors."""
    old_assign = {s: old_workers[s % len(old_workers)] for s in range(num_shards)}
    load: dict = {w: 0 for w in new_workers}
    assign = {}
    orphans = []
    for s, w in old_assign.items():
        if w in load:
            assign[s] = w
            load[w] += 1
        else:
            orphans.append(s)
    for s in orphans:
        w = min(load, key=lambda k: (load[k], str(k)))
        assign[s] = w
        load[w] += 1
    return assign
