"""The build traffic: back-to-back jobs through the program's
``count_to_store``, each counting the next slice of one seeded collection
into a fresh store.

Job ``i`` counts documents ``[n·i, n·(i+1))`` of a collection of
``n · jobs`` documents (``n`` is the configuration's ``num_docs``). Jobs
start until the window's seconds have passed or all have committed; a job
in flight finishes and counts. ``jobs`` is a cap set above what a window
holds, so that the window ends by its seconds; the log says which ended it.
The stores live under ``TMPDIR`` and are compared with the reference after
the window, then deleted.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np

from yardstick import control as C, gen, judge, reference as R, trace as T


def doc_slice(ptr, terms, lo: int, hi: int):
    return ptr[lo:hi + 1] - ptr[lo], terms[ptr[lo]:ptr[hi]]


def planned(cfg: dict, coll, device: str):
    """``(method, head)`` the program's planner picks for one job."""
    from repro_torch.core.plan import CountJob, Planner

    plan = Planner().plan(CountJob(
        collection=coll, output="store", method=cfg["method"],
        out_path="unused", memory_budget_pairs=cfg["memory_budget_pairs"],
        df_descending=cfg["df_descending"], device=device,
    ))
    return plan.method, plan.method_kwargs.get("head")


def run(cell, seed: int, seconds: float, trace: bool, device: str, clock) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.store.segments import Store

    cfg, n, jobs = cell.config, cell.config["num_docs"], cell.mix["jobs"]
    ptr, terms = gen.collection(cfg, n * jobs, seed)
    slices = [doc_slice(ptr, terms, n * i, n * (i + 1)) for i in range(jobs)]
    colls = [gen.to_program(cfg, *s) for s in slices]
    method, head = planned(cfg, colls[0], device)
    if cfg.get("expect_method") and method != cfg["expect_method"]:
        raise RuntimeError(
            f"the planner picked {method}, the configuration states "
            f"{cfg['expect_method']}")
    work = tempfile.mkdtemp(prefix="portbench-", dir=tempfile.gettempdir())
    cuda = device.startswith("cuda")
    try:
        if cuda:
            from repro_torch.kernels import _build, ops

            _build.build_all(ops.KERNELS)
        # warm-up: a job of the first 8 documents by the planned method
        gen.count(cfg, gen.to_program(cfg, *doc_slice(*slices[0], 0, min(8, n))),
              os.path.join(work, "warmup"), device, method)
        shutil.rmtree(os.path.join(work, "warmup"), ignore_errors=True)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        reg_cm = obs.scoped() if trace else contextlib.nullcontext(None)
        prof = None
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
        setup_s = clock()
        with reg_cm as reg:
            if prof is not None:
                prof.start()
            cpu0 = T.process_cpu_s()
            t0, t0_unix = time.perf_counter(), time.time()
            commits = []
            for i in range(jobs):
                if i and time.perf_counter() - t0 >= seconds:
                    break
                gen.count(cfg, colls[i], os.path.join(work, f"job{i}"), device)
                commits.append(time.perf_counter())
            if cuda:
                torch.cuda.synchronize()
            t1_unix = t0_unix + (commits[-1] - t0)
            cpu1 = T.process_cpu_s()
            if prof is not None:
                prof.stop()
        window_s = commits[-1] - t0
        done = len(commits)
        ended = (f"by seconds, {jobs - done} jobs uncommitted" if done < jobs
                 else "by the cap: every job committed")
        out = {
            "setup_s": setup_s,
            "window_s": window_s,
            "e2e": {"build_docs_per_hour": n * done / window_s * 3600},
            "attempted": done,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved()) if cuda else 0,
            "log": [f"jobs committed {done} in {window_s:.4f} s, each "
                    + ", ".join(f"{b - a:.3f}" for a, b in zip([t0] + commits, commits))
                    + f" s; the window ended {ended}",
                    f"this process used {cpu1 - cpu0:.2f} s of CPU in the window",
                    f"stores held under TMPDIR until the comparison {_tree_bytes(work)} bytes"],
        }
        ops_ = []
        if prof is not None:
            tf = os.path.join(work, "trace.json")
            prof.export_chrome_trace(tf)
            ops_ = T.clip(T.read_chrome_trace(tf), t0_unix, t1_unix)
            os.remove(tf)

        # the comparison, job by job, once the window has closed
        t_cmp = time.perf_counter()
        numbers, job_work = {}, []
        for i in range(done):
            path = os.path.join(work, f"job{i}")
            keys, counts, occ = R.pair_counts(*slices[i], cfg["vocab_size"])
            df = np.bincount(slices[i][1], minlength=cfg["vocab_size"])
            got = judge.store_arrays(path, df) if Store.exists(path) else None
            for k, v in judge.judge_store(got, (keys, counts, df, n)).items():
                numbers[k] = numbers.get(k, 0) + v
            shutil.rmtree(path, ignore_errors=True)
            tail = keys % cfg["vocab_size"] >= (head or 0)
            job_work.append({
                "docs": n, "pair_occurrences": occ, "distinct_pairs": len(keys),
                "head": head or 0,
                "tail_occurrences": int(counts[tail].sum()),
                "tail_distinct": int(tail.sum()),
            })
        out["numbers"] = numbers
        out["compare_s"] = time.perf_counter() - t_cmp
        out["ctx"] = {
            "jobs": job_work, "ops": ops_,
            "window": (t0_unix, t1_unix),
            "spans": reg.span_events() if reg is not None else [],
            "counters": reg.snapshot()["counters"] if reg is not None else {},
            "epoch_unix": reg.epoch_unix if reg is not None else 0.0,
        }
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def breakdown(out: dict) -> dict:
    """The device operations with most time, and the longest idle gaps by
    the innermost program span open in each."""
    ctx = out["ctx"]
    label = T.innermost_span(ctx["spans"], ctx["epoch_unix"])
    return {"device_ops": T.top_ops(ctx["ops"]),
            "idle_gaps": T.idle_gaps(ctx["ops"], *ctx["window"], label)}


def control(cell, seed: int) -> dict:
    """The comparison's numbers, summed over the jobs of ``seed``, when the
    reference's counts held in bfloat16 stand in the program's stores."""
    cfg, n, jobs = cell.config, cell.config["num_docs"], cell.mix["jobs"]
    ptr, terms = gen.collection(cfg, n * jobs, seed)
    out: dict = {}
    for i in range(jobs):
        nums = C.build_numbers(*doc_slice(ptr, terms, n * i, n * (i + 1)),
                               cfg["vocab_size"])
        for k, v in nums.items():
            out[k] = out.get(k, 0) + v
    return out
