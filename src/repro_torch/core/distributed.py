"""Distributed Gram accumulation: C = Σ_s B_sᵀ B_s over document shards, on
``torch.distributed``.

Layout (launch/mesh.py), as the reference package's ``shard_map`` version:
  * documents shard over every mesh axis but ``model`` (``pod``, ``data``,
    flattened in mesh order) — rows of B,
  * vocabulary shards over ``model`` — columns of B and the rows of C.

The port is SPMD: every rank of the mesh calls :func:`distributed_gram` with
its block ``B_local`` (D_local, V_local) and gets its strip of the global
Gram: rows sharded model-major, ``P((model,) + doc_axes, None)``, so the
rank at doc index d and model index m holds row block ``m · n_doc + d`` of
``V / (n_model · n_doc)`` rows, every column. Two schedules:

* ``allgather`` — paper-faithful LIST-BLOCKS schedule: ``all_gather`` the
  column blocks over the model group, one local product (V_local, V), then a
  reduce-scatter of its rows over the doc group;
* ``ring`` — rotate column blocks one hop around the model group with
  point-to-point sends and receives (``batch_isend_irecv``), one
  (V_local × V_local) product per step into column block ``(my + k) % n``
  while the next block is in flight; then the same reduce-scatter. Peak
  memory per rank drops from O(V) to O(V_local) columns of B; the bytes
  moved are the same.

The local product is ``ops.cooc_gram`` on uint8 0/1 blocks: exact int32
(the reference gives float32), the hand-written kernel when ``B_local`` is
on the card, its plain version on the CPU. Collectives run over the mesh's
process groups on the world's backend (:func:`world_backend`): NCCL on the
device blocks when every rank owns a card; gloo otherwise, which takes host
tensors — NCCL puts no two ranks on one card, so ranks sharing a card copy
their blocks to the host for every collective and back for every product.
Each rank counts what it issued in the obs registry — ``dist.all_gather``,
``dist.p2p`` (blocks sent), ``dist.reduce_scatter``, ``dist.host_copies``,
``dist.d2h_bytes``, ``dist.h2d_bytes`` — and times ``dist/product``,
``dist/collective`` and ``dist/host_copy`` spans.

:func:`gram_on_world` is the host-side entry point: it spawns a world of
ranks on this host, hands each its block of a global B, runs both
schedules and gathers the global C.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs

SCHEDULES = ("allgather", "ring")
# a rank that waits longer than this in a collective fails, and so the world
WORLD_TIMEOUT_S = 600.0


def world_backend(device_type: str, world: int, cards: int) -> str:
    """The backend of a world of ``world`` ranks whose blocks live on
    ``device_type``, on a host with ``cards`` CUDA devices: ``"nccl"`` when
    every rank can own a card, else ``"gloo"`` (host tensors).

    Example::

        world_backend("cuda", 4, torch.cuda.device_count())   # "gloo" on one card
    """
    return "nccl" if device_type == "cuda" and cards >= world else "gloo"


def mesh_layout(mesh, model_axis: str = "model") -> np.ndarray:
    """The mesh's global ranks as ``(n_doc, n_model)``: row ``d`` holds the
    ranks at flattened doc index ``d`` (every axis but ``model``, in mesh
    order), column ``m`` those at model index ``m``."""
    names = tuple(mesh.mesh_dim_names)
    if model_axis not in names:
        raise ValueError(f"mesh axes {names} have no {model_axis!r} axis")
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the dry run traces under FakeTensorMode
        grid = np.moveaxis(mesh.mesh.cpu().numpy(), names.index(model_axis), -1)
    return grid.reshape(-1, grid.shape[-1])


def _groups(mesh, layout: np.ndarray, model_axis: str, d: int, m: int):
    """This rank's model group (its doc row) and doc group (its model
    column; one group flattened over several doc axes). Every rank of the
    mesh takes part in creating them; a group of one rank is ``None``."""
    import torch.distributed as dist

    n_doc, n_model = layout.shape
    model_g = mesh.get_group(model_axis) if n_model > 1 else None
    doc_axes = [a for a in mesh.mesh_dim_names if a != model_axis]
    if n_doc == 1:
        doc_g = None
    elif len(doc_axes) == 1:
        doc_g = mesh.get_group(doc_axes[0])
    else:
        doc_g, _ = dist.new_subgroups_by_enumeration(
            [layout[:, j].tolist() for j in range(n_model)]
        )
    return model_g, doc_g


class _Moves:
    """Host copies, products and collectives of one call, counted and timed
    in the registry; on the card each timed step waits for the device.
    ``via_host``: the collectives take host tensors (gloo), so device blocks
    are copied out for them and back for the products."""

    def __init__(self, reg, dev: torch.device, via_host: bool):
        self.reg = reg
        self.dev = dev
        self.via_host = via_host

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.via_host or t.device.type == "cpu":
            return t
        with self.reg.span("dist/host_copy", direction="d2h"):
            out = t.cpu()
        self.reg.counter("dist.host_copies").inc()
        self.reg.counter("dist.d2h_bytes").inc(out.numel() * out.element_size())
        return out

    def to_dev(self, t: torch.Tensor) -> torch.Tensor:
        if not self.via_host or self.dev.type == "cpu":
            return t
        with self.reg.span("dist/host_copy", direction="h2d"):
            out = t.to(self.dev)
            self._sync()
        self.reg.counter("dist.host_copies").inc()
        self.reg.counter("dist.h2d_bytes").inc(t.numel() * t.element_size())
        return out

    def product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        with self.reg.span("dist/product"):
            out = ops.cooc_gram(a, b)
            self._sync()
        return out


def _gram_allgather(B_local, moves, layout, d, m, model_g) -> torch.Tensor:
    import torch.distributed as dist

    n_model = layout.shape[1]
    B_host = moves.to_host(B_local)
    if model_g is None:
        B_all = B_local
    else:
        parts = [torch.empty_like(B_host) for _ in range(n_model)]
        with moves.reg.span("dist/collective", op="all_gather"):
            dist.all_gather(parts, B_host, group=model_g)
        moves.reg.counter("dist.all_gather").inc()
        # group rank order → model index order along the columns
        by_model = [None] * n_model
        row = layout[d].tolist()
        for j, t in enumerate(parts):
            by_model[row.index(dist.get_global_rank(model_g, j))] = t
        B_all = moves.to_dev(torch.cat(by_model, dim=1))
    return moves.product(B_local, B_all)  # (V_local, V)


def _gram_ring(B_local, moves, layout, d, m, model_g) -> torch.Tensor:
    import torch.distributed as dist

    n = layout.shape[1]
    v_loc = B_local.shape[1]
    acc = torch.zeros((v_loc, v_loc * n), dtype=torch.int32, device=B_local.device)
    left, right = int(layout[d, (m - 1) % n]), int(layout[d, (m + 1) % n])
    buf_host = moves.to_host(B_local) if n > 1 else None
    buf = B_local
    for k in range(n):
        src = (m + k) % n  # global block id currently held in buf
        reqs, nxt = [], None
        if k + 1 < n:
            # pass buf one hop left so rank m receives block (m + k + 1)
            # next; it travels while this step's product runs
            nxt = torch.empty_like(buf_host)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf_host, left, group=model_g),
                dist.P2POp(dist.irecv, nxt, right, group=model_g),
            ])
            moves.reg.counter("dist.p2p").inc()
        acc[:, src * v_loc:(src + 1) * v_loc] = moves.product(B_local, buf)
        if reqs:
            with moves.reg.span("dist/collective", op="p2p"):
                for r in reqs:
                    r.wait()
            buf_host = nxt
            buf = moves.to_dev(nxt)
    return acc  # (V_local, V)


def distributed_gram(
    B_local: torch.Tensor,
    mesh,
    *,
    schedule: str = "ring",
    model_axis: str = "model",
    registry=None,
) -> torch.Tensor:
    """This rank's strip of ``C = Bᵀ B``: int32 ``(V / (n_model · n_doc),
    V)`` on ``B_local``'s device, row block ``m · n_doc + d`` of the global
    Gram. Every rank of ``mesh`` (a ``DeviceMesh`` naming a ``model_axis``)
    calls it with its uint8 0/1 block ``B_local`` (D_local, V_local): rows
    of B sharded over the doc axes, columns over ``model``. ``registry``
    receives the counters and spans (default: the global one). On an
    NCCL world the collectives take the device blocks as they are; on gloo
    a card's blocks go through host copies.

    Example::

        strip = distributed_gram(B_local, make_test_mesh((2, 2)), schedule="ring")
    """
    import torch.distributed as dist

    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; have {SCHEDULES}")
    if B_local.dim() != 2 or B_local.dtype != torch.uint8:
        raise ValueError("B_local must be a 2-D uint8 tensor of 0/1 incidence")
    B_local = B_local.contiguous()
    layout = mesh_layout(mesh, model_axis)
    n_doc, n_model = layout.shape
    where = np.argwhere(layout == dist.get_rank())
    if len(where) != 1:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    d, m = (int(x) for x in where[0])
    v_loc = B_local.shape[1]
    if v_loc % n_doc:
        raise ValueError(
            f"V_local = {v_loc} rows of the strip do not split over {n_doc} doc ranks"
        )
    reg = registry if registry is not None else obs.get_registry()
    via_host = B_local.device.type == "cuda" and dist.get_backend() != "nccl"
    moves = _Moves(reg, B_local.device, via_host)
    model_g, doc_g = _groups(mesh, layout, model_axis, d, m)
    fn = _gram_allgather if schedule == "allgather" else _gram_ring
    partial = fn(B_local, moves, layout, d, m, model_g)  # (V_local, V)
    if doc_g is None:
        return partial
    # reduce-scatter the rows over the doc group: chunk j of the input list
    # goes to group rank j, which must get the rows of its own doc index
    host = moves.to_host(partial)
    chunk = v_loc // n_doc
    col = layout[:, m].tolist()
    inputs = []
    for j in range(n_doc):
        dj = col.index(dist.get_global_rank(doc_g, j))
        inputs.append(host[dj * chunk:(dj + 1) * chunk].contiguous())
    out = torch.empty((chunk, host.shape[1]), dtype=torch.int32, device=host.device)
    with reg.span("dist/collective", op="reduce_scatter"):
        dist.reduce_scatter(out, inputs, op=dist.ReduceOp.SUM, group=doc_g)
    reg.counter("dist.reduce_scatter").inc()
    return moves.to_dev(out)


def gram_reference(B: torch.Tensor) -> torch.Tensor:
    """Single-device oracle for the distributed schedules: ``Bᵀ B`` as
    exact int32, by the plain (float32 matmul) version of ``cooc_gram``."""
    from repro_torch.kernels import ref

    return ref.cooc_gram_ref(B, B)


# ---------------------------------------------------------------------------
# host-side entry point: a world of ranks on this host
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, shape, axes, device, workdir) -> None:
    """Spawn entry point of one rank: join the world (NCCL on a card of its
    own, else gloo), take this rank's block of ``workdir/B.npy``, run each
    schedule (a barrier before each) and write its strip and its counters
    and seconds to ``workdir``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_test_mesh

    # every rank is on this host: gloo talks over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = resolve_device(device)
    backend = world_backend(dev.type, world, torch.cuda.device_count())
    if backend == "nccl":  # a card for each rank
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    if dev.type == "cuda":
        from repro_torch.kernels import _build, cooc_gram

        torch.zeros(1, device=dev)
        _build.build_all([cooc_gram.KERNEL])  # built by the parent: a load
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S),
        device_id=dev if backend == "nccl" else None,
    )
    try:
        mesh = make_test_mesh(shape, axes)
        layout = mesh_layout(mesh)
        n_doc, n_model = layout.shape
        d, m = (int(x) for x in np.argwhere(layout == rank)[0])
        B = np.load(os.path.join(workdir, "B.npy"), mmap_mode="r")
        D, V = B.shape
        rows, cols = D // n_doc, V // n_model
        block = np.array(B[d * rows:(d + 1) * rows, m * cols:(m + 1) * cols])
        B_local = torch.from_numpy(block).to(dev)
        report = {"rank": rank, "doc": d, "model": m, "device": str(dev),
                  "backend": backend, "schedules": {}}
        for sched in SCHEDULES:
            reg = obs.Registry(enabled=True)
            dist.barrier()
            t0 = time.perf_counter()
            strip = distributed_gram(B_local, mesh, schedule=sched, registry=reg)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            np.save(os.path.join(workdir, f"strip_{sched}_{rank}.npy"),
                    strip.cpu().numpy())
            report["schedules"][sched] = {
                "wall_s": wall,
                "counters": reg.snapshot()["counters"],
                "seconds": {k.split("/", 1)[1]: v
                            for k, v in reg.stage_totals("dist/").items()},
            }
        dist.barrier()
        # launch counters are per process: the parent reads this rank's here
        from repro_torch.kernels import ops

        report["kernel_launches"] = {k.name: k.launches for k in ops.KERNELS}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank_{rank}.json"), "w") as f:
        json.dump(report, f)


def gram_on_world(
    B: np.ndarray,
    shape=(2, 2),
    axes=("data", "model"),
    *,
    device: str = "cuda",
) -> dict:
    """Spawn a world of ``prod(shape)`` ranks on this host, give each its
    block of the uint8 0/1 incidence ``B`` (D, V) as the mesh lays it out,
    run :func:`distributed_gram` with each schedule, and gather the global
    int32 Gram of each. On the card (the default) every rank's products run
    ``cooc_gram``, built here once before the spawn: with a card for each
    rank the world is NCCL, rank r on ``cuda:r``; with fewer cards it is
    gloo and the ranks share ``cuda:0``, their blocks through host copies.
    ``device="cpu"`` runs a gloo world on the plain version. D must split
    evenly over the doc ranks and V over every rank. Raises
    :class:`~repro_torch.device.DeviceError` without a card, and
    ``RuntimeError`` if a rank fails or the world outlasts
    ``WORLD_TIMEOUT_S``.

    Returns ``{"C": {schedule: (V, V) int32}, "ranks": [per-rank report:
    doc/model index, device, backend, its own kernel launches, and per
    schedule its wall seconds, counters and product/collective/host-copy
    seconds], "wall_s": seconds from spawn to the last rank's exit}``.

    Example::

        out = gram_on_world(B, (2, 2), ("data", "model"), device="cpu")
        np.array_equal(out["C"]["ring"], B.T.astype(np.int64) @ B)   # True
    """
    from repro_torch.device import resolve_device
    from repro_torch.store.spawn import spawn_friendly_env

    B = np.ascontiguousarray(B, dtype=np.uint8)
    shape, axes = tuple(shape), tuple(axes)
    world = int(np.prod(shape))
    n_model = shape[axes.index("model")]
    n_doc = world // n_model
    D, V = B.shape
    if D % n_doc or V % (n_model * n_doc):
        raise ValueError(
            f"B {B.shape} does not split over {n_doc} doc x {n_model} model ranks"
        )
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import _build, cooc_gram

        _build.build_all([cooc_gram.KERNEL])
    workdir = tempfile.mkdtemp(prefix="cooc_gram_world_")
    try:
        np.save(os.path.join(workdir, "B.npy"), B)
        port = _free_port()
        t0 = time.perf_counter()
        with spawn_friendly_env() as ctx:
            procs = [
                ctx.Process(
                    target=_rank_main,
                    args=(r, world, port, shape, axes, device, workdir),
                    daemon=True,
                )
                for r in range(world)
            ]
            for p in procs:
                p.start()
        deadline = time.time() + WORLD_TIMEOUT_S
        # a failed rank ends the world: the others would wait for it
        while (any(p.is_alive() for p in procs) and time.time() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"distributed Gram ranks failed: exit codes {codes}")
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
        chunk = V // (n_model * n_doc)
        C = {}
        for s in SCHEDULES:
            out = np.empty((V, V), dtype=np.int32)
            for rep in ranks:
                blk = rep["model"] * n_doc + rep["doc"]
                out[blk * chunk:(blk + 1) * chunk] = np.load(
                    os.path.join(workdir, f"strip_{s}_{rep['rank']}.npy")
                )
            C[s] = out
        return {"C": C, "ranks": ranks, "wall_s": wall}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
