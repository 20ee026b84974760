"""Multi-pod dry run: run every (arch × input shape) cell once on the
production meshes of a fake world and record per-rank cost, memory and
collective evidence.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
        --shape train_4k --mesh single          # 16×16 (256 ranks)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell with GSPMD over 256 or 512 host devices. Here the
process joins torch's fake process group (``"fake"``: collectives return
at once) as rank 0 of a world of 256 or 512 ranks, builds each cell's
arguments as fake DTensors (``launch/specs.py``) and runs its step once
under ``FakeTensorMode`` inside ``roofline.Trace``, which counts this
rank's FLOPs, bytes, collectives and live memory. Nothing is allocated and
no card is touched. Without the fake backend the dry run fails; it never
runs on a smaller world in its place.

The multi-pod mesh is laid out as its (pod·data, model) flattening
(:func:`dtensor_mesh`): the same layouts and groups. An LM step is run at 1 and 2 layers and extrapolated to the full depth,
cost(L) = cost(1) + (L − 1)·(cost(2) − cost(1)), for FLOPs, bytes,
collectives and memory alike (``layer_extrapolated``); the other cells run
whole. Results append as JSON lines to ``--out`` (default
``experiments/dryrun_torch.jsonl``), with the reference's keys, but
``fits_80gb`` (one H100) for its ``fits_16gb``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

WORLD = 512  # ranks of the fake world: room for the multi-pod mesh


def init_fake_world(world_size: int = WORLD) -> None:
    """Join torch's fake process group as rank 0 of ``world_size`` ranks
    (once a process). Raises if the backend cannot be set up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= world_size:
            return
        raise RuntimeError(
            f"a {dist.get_backend()} world of {dist.get_world_size()} ranks is "
            f"already set up; the dry run needs a fake one of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def trace_cell(cell, mesh):
    """Run ``cell.fn`` once on its fake arguments under the mesh and return
    the :class:`~repro_torch.launch.roofline.Trace`."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.roofline import Trace
    from repro_torch.runtime.sharding import set_mesh_compat

    with set_mesh_compat(mesh), implicit_replication(), Trace(cell.args) as tr:
        out = cell.fn(*cell.args)
    tr.finish(cell.args, out)
    return tr


def dtensor_mesh(mesh):
    """The mesh the cells are laid out on: a 2-D mesh as it is, the
    multi-pod ``(pod, data, model)`` mesh as its ``(pod·data, model)``
    flattening, named ``("data", "model")``. The layouts are the same
    (the batch and FSDP dimensions shard over pod and data together, in
    mesh order) and so are the ranks of every group; DTensor's search for
    the cheapest redistribution grows with the mesh's dimensions, and on
    three it takes minutes an operation."""
    if mesh.ndim <= 2:
        return mesh
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh

    with unset_fake_temporarily():
        grid = mesh.mesh.reshape(-1, mesh.shape[-1])
        return DeviceMesh(mesh.device_type, grid, mesh_dim_names=("data", "model"))


def _lerp(a, b, L):
    return max(a + (L - 1) * (b - a), a)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_path: str, extra=None,
             cell_kw=None, *, mesh=None) -> dict:
    """Dry-run one cell on the production mesh (``multi_pod``: 2×16×16,
    else 16×16), or on ``mesh`` when given (the tests' small meshes), and
    append its record to ``out_path``. A failure is a record with
    ``ok: False`` and its error, not an exception."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_spec
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell, sharded_arg_bytes

    cell_kw = cell_kw or {}
    init_fake_world()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "n_chips": int(n_chips),
    }
    mesh = dtensor_mesh(mesh)
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            cell = build_cell(arch, shape_name, mesh, **cell_kw)
            if extra:
                rec.update(extra)
            t_lower = time.time()
            fallback = set()
            if get_spec(arch).family == "lm":
                L = get_spec(arch).model.n_layers
                runs = []
                for n in (1, 2):
                    tr = trace_cell(build_cell(arch, shape_name, mesh, n_layers=n, unroll=True,
                                               **cell_kw), mesh)
                    fallback |= tr.fallback_ops
                    runs.append((rl.analyze(tr, n_chips, cell.model_flops, cell.peak_flops),
                                 rl.memory_stats(tr)))
                (r1, m1), (r2, m2) = runs
                roof = rl.Roofline(
                    flops=_lerp(r1.flops, r2.flops, L),
                    bytes_accessed=_lerp(r1.bytes_accessed, r2.bytes_accessed, L),
                    coll_bytes=_lerp(r1.coll_bytes, r2.coll_bytes, L),
                    coll_breakdown={k: _lerp(r1.coll_breakdown[k], r2.coll_breakdown[k], L)
                                    for k in r1.coll_breakdown},
                    n_chips=n_chips,
                    model_flops=cell.model_flops,
                    hbm_resident_bytes=_lerp(r1.hbm_resident_bytes, r2.hbm_resident_bytes, L),
                    coll_seconds=_lerp(r1.t_collective, r2.t_collective, L),
                    peak_flops=cell.peak_flops,
                )
                mem = {k: int(_lerp(m1[k], m2[k], L)) for k in m1}
                rec["layer_extrapolated"] = True
            else:
                tr = trace_cell(cell, mesh)
                fallback |= tr.fallback_ops
                mem = rl.memory_stats(tr)
                roof = rl.analyze(tr, n_chips, cell.model_flops, cell.peak_flops)
                rec["layer_extrapolated"] = False
            t_compile = time.time()
            args_pc = sharded_arg_bytes(cell.args, mesh)
        act_pc = cell.act_bytes / n_chips
        rec["analytic"] = {
            "args_gb_per_chip": round(args_pc / 2**30, 3),
            "act_gb_per_chip": round(act_pc / 2**30, 3),
            "fits_80gb": bool((args_pc + act_pc) < rl.HBM_BYTES),
        }
        notes = cell.notes
        if fallback:
            notes = "; ".join(filter(None, [notes, "replicated (no sharding rule): "
                                            + ", ".join(sorted(fallback))]))
        rec.update(
            kind=cell.kind,
            notes=notes,
            ok=True,
            lower_s=round(t_lower - t0, 2),
            compile_s=round(t_compile - t_lower, 2),
            memory=mem,
            roofline=roof.to_dict(),
        )
        print(
            f"[OK] {arch}/{shape_name} mesh={rec['mesh']} "
            f"hbm={mem.get('total_hbm_bytes', 0)/2**30:.2f}GiB "
            f"t_comp={roof.t_compute*1e3:.2f}ms t_mem={roof.t_memory*1e3:.2f}ms "
            f"t_coll={roof.t_collective*1e3:.2f}ms bound={roof.bottleneck} "
            f"(build {rec['lower_s']}s trace {rec['compile_s']}s)", flush=True,
        )
    except Exception as e:  # a failed cell is a record, and the run goes on
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        print(f"[FAIL] {arch}/{shape_name} mesh={rec['mesh']}: {rec['error']}", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default="experiments/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch.specs import all_cells

    init_fake_world()
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            key = (arch, shape, "2x16x16" if mp else "16x16")
            if key in done:
                continue
            rec = run_cell(arch, shape, mp, args.out)
            failures += 0 if rec.get("ok") else 1
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
