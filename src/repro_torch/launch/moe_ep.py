"""The expert-parallel MoE on a world of ranks on this host.

:func:`moe_ep_on_world` spawns a world of ``prod(shape)`` ranks, hands
each its shards of one MoE layer's weights and of the batch as the
reference's ``moe_ffn_ep`` lays them out (experts over ``"model"``, the
d_model dimension of the expert weights and the batch over the other axes),
runs ``models.layers.moe_ffn_ep`` under the mesh on every rank, backpropagates
``sum(y²) + aux_weight · aux`` and gathers the global output, aux loss and
gradients. Ranks talk gloo over loopback: on the card (the default) they
share ``cuda:0`` and their collectives go through host copies, as the
distributed Gram's do when ranks outnumber cards.
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

WORLD_TIMEOUT_S = 600.0
_WEIGHTS = ("router", "w_in", "w_out", "w_gate")


def _blocks(dp_idx: int, m: int, n_dp: int, n_model: int, E: int, d: int):
    """Index tuples of this rank's block of each expert weight."""
    e = slice(m * (E // n_model), (m + 1) * (E // n_model))
    dd = slice(dp_idx * (d // n_dp), (dp_idx + 1) * (d // n_dp))
    return {"w_in": (e, dd), "w_gate": (e, dd), "w_out": (e, slice(None), dd),
            "router": ()}


def _rank_main(rank, world, port, shape, axes, device, workdir, kw) -> None:
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import moe_ffn_ep
    from repro_torch.runtime.sharding import axis_group, set_mesh_compat

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = resolve_device(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S),
    )
    try:
        mesh = make_test_mesh(shape, axes)
        dp = [a for a in axes if a != "model"]
        n_model = shape[axes.index("model")]
        n_dp = world // n_model
        dp_idx = 0
        for a in dp:
            dp_idx = dp_idx * shape[axes.index(a)] + mesh.get_local_rank(a)
        m = mesh.get_local_rank("model")
        # each input a memory-mapped .npy: a rank reads its own blocks only
        z = {f[:-4]: np.load(os.path.join(workdir, f), mmap_mode="r")
             for f in os.listdir(workdir) if f.endswith(".npy")}
        x = z.pop("x")
        E, d = z["w_in"].shape[:2]
        B = x.shape[0]
        sharded = B % n_dp == 0 and B >= n_dp
        if sharded:
            x = x[dp_idx * (B // n_dp):(dp_idx + 1) * (B // n_dp)]
        blocks = _blocks(dp_idx, m, n_dp, n_model, E, d)

        def leaf(a, idx=()):
            return torch.from_numpy(np.array(a[idx])).to(dev, torch.float32).requires_grad_()

        params = {k: leaf(z[k], blocks[k]) for k in _WEIGHTS if k in z}
        shared = {k[3:]: leaf(z[k]) for k in z if k.startswith("sh_")}
        if shared:
            params["shared"] = shared
        names = [k for k in _WEIGHTS if k in params] + [f"sh_{k}" for k in shared]
        leaves = [params[k] for k in _WEIGHTS if k in params] + list(shared.values())
        xt = torch.from_numpy(np.array(x)).to(dev, torch.float32)
        for i, cf in enumerate(kw["capacity_factors"]):
            dist.barrier()
            t0 = time.perf_counter()
            with set_mesh_compat(mesh):
                y, aux = moe_ffn_ep(
                    params, xt, n_experts=E, top_k=kw["top_k"], capacity_factor=cf,
                    expert_kind="swiglu",
                    combine_dtype=getattr(torch, kw["combine_dtype"]) if kw["combine_dtype"] else None,
                    global_batch=B,
                )
                loss = (y.float() ** 2).sum() + kw["aux_weight"] * aux
                grads = torch.autograd.grad(loss, leaves) if kw["grads"] else []
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            out = {"y": y.detach().float().cpu().numpy(), "aux": aux.detach().cpu().numpy()}
            for name, g in zip(names, grads):
                if name.startswith("sh_") and sharded:
                    # data-parallel sync of the replicated shared expert
                    g = g.detach().cpu().clone()
                    dist.all_reduce(g, group=axis_group(mesh, dp))
                out[f"g_{name}"] = g.detach().float().cpu().numpy()
            out["meta"] = np.array([dp_idx, m, wall])
            np.savez(os.path.join(workdir, f"rank_{rank}_{i}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def moe_ep_on_world(
    params: dict,
    x: np.ndarray,
    shape=(2, 4),
    axes=("data", "model"),
    *,
    top_k: int,
    capacity_factor: float | tuple = 1.25,
    combine_dtype: str | None = None,
    aux_weight: float = 0.0,
    grads: bool = True,
    device: str = "cuda",
):
    """Run one SwiGLU MoE layer expert-parallel, in float32, on a spawned
    world of ``prod(shape)`` ranks. ``params``: numpy ``router`` (d, E), ``w_in``,
    ``w_gate`` (E, d, f), ``w_out`` (E, f, d), and optionally the shared
    expert as ``sh_w_in``/``sh_w_gate``/``sh_w_out``; ``x`` (B, S, d). E
    must split over ``"model"`` and d over the other axes; the batch
    splits over them when it can (else every rank takes all of it, the
    reference's replicated-batch path). Raises ``DeviceError`` for the card
    on a host without one, ``RuntimeError`` if a rank fails.

    Returns ``{"y": (B, S, d), "aux": float, "grads": {name: global
    gradient of sum(y²) + aux_weight·aux}, "wall_s": [per rank]}``; for a
    tuple of capacity factors, run one after another by the same world, a
    list of such results.
    """
    from repro_torch.core.distributed import _free_port
    from repro_torch.device import resolve_device
    from repro_torch.store.spawn import spawn_friendly_env

    resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    world = math.prod(shape)
    n_model = shape[axes.index("model")]
    n_dp = world // n_model
    E, d = params["w_in"].shape[:2]
    if E % n_model or d % n_dp:
        raise ValueError(f"{E} experts / d_model {d} do not split over {shape} {axes}")
    cfs = tuple(capacity_factor) if isinstance(capacity_factor, (tuple, list)) else (capacity_factor,)
    kw = dict(top_k=top_k, capacity_factors=cfs, combine_dtype=combine_dtype,
              aux_weight=aux_weight, grads=grads)
    workdir = tempfile.mkdtemp(prefix="moe_ep_world_")
    try:
        for name, a in dict(params, x=x).items():
            np.save(os.path.join(workdir, f"{name}.npy"), a)
        port = _free_port()
        with spawn_friendly_env() as ctx:
            procs = [ctx.Process(target=_rank_main, daemon=True,
                                 args=(r, world, port, shape, axes, device, workdir, kw))
                     for r in range(world)]
            for p in procs:
                p.start()
        deadline = time.time() + WORLD_TIMEOUT_S
        while (any(p.is_alive() for p in procs) and time.time() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"expert-parallel MoE ranks failed: exit codes {codes}")
        results = [_gather(workdir, i, params, x, shape, axes, world, n_dp, n_model, E, d, grads)
                   for i in range(len(cfs))]
        return results if isinstance(capacity_factor, (tuple, list)) else results[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _gather(workdir, i, params, x, shape, axes, world, n_dp, n_model, E, d, grads) -> dict:
    """The global output, aux and gradients of run ``i`` from the ranks'
    files."""
    B = x.shape[0]
    sharded = B % n_dp == 0 and B >= n_dp
    y = np.zeros(x.shape, np.float32)
    g = {k: np.zeros(v.shape, np.float32) for k, v in params.items()}
    aux, walls = None, []
    for r in range(world):
        z = np.load(os.path.join(workdir, f"rank_{r}_{i}.npz"))
        dp_idx, m, wall = z["meta"]
        dp_idx, m = int(dp_idx), int(m)
        walls.append(float(wall))
        bl = B // n_dp if sharded else B
        y[dp_idx * bl:(dp_idx + 1) * bl if sharded else B] = z["y"]
        aux = float(z["aux"])
        blocks = _blocks(dp_idx, m, n_dp, n_model, E, d)
        for k in g:
            if f"g_{k}" in z.files:
                g[k][blocks.get(k, ())] = z[f"g_{k}"]
    return {"y": y, "aux": aux, "grads": g if grads else {}, "wall_s": walls}
