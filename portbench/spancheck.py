"""Checks of the program's spans on the card: what they cost, whether they
add a sync, whether they share the device trace's clock, and whether the
finer spans account for the coarser ones. The benchmark does not run it.

    python3 portbench/spancheck.py traced --workload wt10g.build --seed 7 --seconds 51
    python3 portbench/spancheck.py clock
    python3 portbench/spancheck.py syncdebug --docs 40
    python3 portbench/spancheck.py build-cost --seed 7 --rounds 2
    python3 portbench/spancheck.py serve-cost --seed 7 --batches 400

* ``traced``: one ``--trace 1`` run of the cell, as ``run.py`` makes it,
  with its metrics and breakdown, the events each registry dropped, the
  sums the spans must account for (build: ``ingest_count_s`` and the three
  row-batch self times; serving: the windowed sums of ``query/tile_s``,
  ``query/h2d_s`` and ``query/topk_s`` against ``serving/execute_s``), and
  how far each device copy lies outside the span that waits for it (build:
  ``Memcpy DtoH`` in ``ingest/count_select`` or ``ingest/count_launch``;
  serving: ``Memcpy HtoD`` in a worker's ``query/h2d``).
* ``clock``: brackets of a synchronous copy read on the host's unix and
  monotonic clocks against the profiler's times for the copy: the range of
  offsets each clock allows, early and late in a minute-long trace.
* ``syncdebug``: one build job of the first ``--docs`` documents under
  ``torch.cuda.set_sync_debug_mode("warn")``, with telemetry off and on:
  the synchronising calls it warns of.
* ``build-cost``: the build cell's jobs timed with telemetry off and on,
  the profiler off, alternating, in one process.
* ``serve-cost``: one in-process ``QueryEngine`` of the serving cell's
  store, its batches of Zipf terms timed with an enabled and a disabled
  registry, alternating.

Each prints one JSON line last.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402

run.setup_env()

WITHIN_S = 50e-6  # the span may miss a copy it waits for by this much


def outside_s(ops, spans) -> list[float]:
    """For each operation ``(name, start, seconds)``, how far it lies outside
    the nearest of the sorted span intervals: 0 when inside."""
    starts = [a for a, _ in spans]
    out = []
    for _, s, d in ops:
        i = bisect.bisect_right(starts, s)
        best = float("inf")
        for j in (i - 2, i - 1, i):
            if 0 <= j < len(spans):
                a, b = spans[j]
                best = min(best, max(a - s, (s + d) - b, 0.0))
        out.append(best)
    return out


def containment(ops, spans) -> dict:
    miss = outside_s(ops, spans)
    return {
        "ops": len(ops),
        "share_within_50us": (sum(m <= WITHIN_S for m in miss) / len(miss)) if miss else None,
        "share_inside": (sum(m == 0 for m in miss) / len(miss)) if miss else None,
        "worst_outside_us": max(miss) * 1e6 if miss else None,
    }


def _hist_total(ctx, name):
    def total(snap):
        h = snap["metrics"].get("histograms", {}).get(name)
        return (h["total"], h["count"]) if h else (0.0, 0)

    (f, fc), (b, bc) = total(ctx["final"]), total(ctx["base"])
    return f - b, fc - bc


def traced(args) -> dict:
    from repro_torch import obs
    from yardstick import cells, telemetry as S, trace as T

    made = []
    scoped = obs.scoped

    def keep(reg=None):
        made.append(reg or obs.Registry(enabled=True))
        return scoped(made[-1])

    obs.scoped = keep
    cell = cells.load_cell(args.workload)
    t = time.perf_counter()
    try:
        out = run.run_cell(cell, args.seed, args.seconds, True, args.device)
    finally:
        obs.scoped = scoped
    res = {
        "mode": "traced", "workload": args.workload, "seed": args.seed,
        "correct": bool(out["correct"]), "attempted": out["attempted"],
        "window_s": out["window_s"], "setup_s": out["setup_s"],
        "wall_s": time.perf_counter() - t,
        "metrics": {k: v["value"] for k, v in run.metrics_of(cell, out, True).items()},
        "breakdown": cells.kind_module(cell.mix["kind"]).breakdown(out),
        "log": out["log"],
    }
    ctx = out["ctx"]
    t0, t1 = ctx["window"]
    res["busy_s"] = T.busy_s(ctx["ops"])
    res["window_trace_s"] = t1 - t0
    if "spans" in ctx:
        spans, m = ctx["spans"], res["metrics"]
        res["harness_dropped_events"] = [r.dropped_events for r in made]
        res["span_events"] = len(spans)
        parts = ("ingest_count_s", "count_launch_s", "count_select_s", "count_emit_s")
        if all(p in m for p in parts):
            res["count_sum_s"] = sum(m[p] for p in parts)
        res["row_batches"] = sum(e["name"] == "ingest/count_select" for e in spans)
        d2h = [o for o in ctx["ops"] if "DtoH" in o[0]]
        sel = S.span_intervals(spans, ctx["epoch_unix"], ("ingest/count_select",))
        both = S.span_intervals(spans, ctx["epoch_unix"],
                                ("ingest/count_select", "ingest/count_launch"))
        res["d2h_in_select"] = containment(d2h, sel)
        res["d2h_in_select_or_launch"] = containment(d2h, both)
        busy = T.busy_intervals(ctx["ops"])
        res["device_busy_in_span_s"] = {
            n: S.overlap_s(S.union(S.span_intervals(spans, ctx["epoch_unix"], (n,))), busy)
            for n in ("ingest/count_launch", "ingest/count_select", "ingest/count_emit",
                      "ingest/spill", "ingest/segment_write")}
    else:
        metrics = ctx["final"]["metrics"]
        res["workers_dropped_events"] = metrics.get("dropped_events")
        events = metrics.get("events", [])
        res["worker_span_events"] = len(events)
        sums = {n: _hist_total(ctx, n) for n in
                ("query/tile_s", "query/h2d_s", "query/topk_s", "serving/execute_s")}
        res["window_sums_s"] = {n: v[0] for n, v in sums.items()}
        res["window_counts"] = {n: v[1] for n, v in sums.items()}
        ex = sums["serving/execute_s"][0]
        res["topk_steps_share_of_execute"] = (
            sum(sums[n][0] for n in ("query/tile_s", "query/h2d_s", "query/topk_s")) / ex
            if ex else None)
        if events:
            ep = metrics["epoch_unix"]
            h2d = [o for o in ctx["ops"] if "HtoD" in o[0]]
            res["h2d_in_query_h2d"] = containment(
                h2d, S.union(S.span_intervals(events, ep, ("query/h2d",))))
            idle = S.idle_intervals(ctx["ops"], t0, t1)
            idle_s = sum(b - a for a, b in idle)
            inside = {n: S.union(S.span_intervals(events, ep, (n,)))
                      for n in ("query/tile", "query/h2d", "query/topk")}
            anyq = S.union([iv for v in inside.values() for iv in v])
            res["idle_s"] = idle_s
            res["idle_share_with_a_worker_in"] = {
                **{n: S.overlap_s(v, idle) / idle_s for n, v in inside.items()},
                "none of them": 1 - S.overlap_s(anyq, idle) / idle_s}
    return res


def _read_events(path: str, cat: str, needle: str) -> list[tuple[float, float]]:
    """``(start, end)`` unix seconds of the trace's events of category
    ``cat`` whose name holds ``needle``, sorted."""
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    return sorted(((e["ts"] + base_us) / 1e6, (e["ts"] + base_us + e["dur"]) / 1e6)
                  for e in doc.get("traceEvents", [])
                  if e.get("cat") == cat and e.get("ph") == "X" and needle in e["name"])


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q / 100 * len(xs)))]


def clock(args) -> dict:
    """``n`` synchronous 4-byte copies back from the card, each bracketed by
    unix and monotonic readings, spread over ``seconds``, against the
    profiler's times for the copy on the card and for its runtime call on
    the host. Per clock and part of the run: how far each lies outside its
    bracket, and the offset of its middle from the bracket's middle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1, device="cuda")
    y = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    brackets = []
    gap = args.seconds / args.n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.n):
            y.mul_(1.0)
            a_u, a_m = time.time_ns(), time.monotonic_ns()
            x.cpu()
            b_m, b_u = time.monotonic_ns(), time.time_ns()
            brackets.append((a_u, b_u, a_m, b_m))
            time.sleep(gap)
    work = tempfile.mkdtemp(prefix="spancheck-")
    try:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        seen = {"device copy": _read_events(path, "gpu_memcpy", "DtoH"),
                "runtime call": _read_events(path, "cuda_runtime", "Memcpy")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"mode": "clock", "copies": args.n, "seconds": args.seconds}
    if any(len(v) != args.n for v in seen.values()):
        out["error"] = {k: len(v) for k, v in seen.items()}
        return out
    # monotonic readings, put on unix time by the first bracket's pair
    shift = brackets[0][0] - brackets[0][2]
    q = args.n // 4
    for what, evs in seen.items():
        for clock_name, ia, ib, off in (("unix", 0, 1, 0), ("monotonic", 2, 3, shift)):
            for part, sl in (("first_quarter", slice(0, q)), ("last_quarter", slice(-q, None))):
                miss, mid = [], []
                for (s, e), br in zip(evs[sl], brackets[sl]):
                    a, b = (br[ia] + off) / 1e9, (br[ib] + off) / 1e9
                    miss.append(max(a - s, e - b, 0.0) * 1e6)
                    mid.append(((s + e) - (a + b)) / 2 * 1e6)
                out[f"{what}, {clock_name}, {part}"] = {
                    "outside_us_p50_p99_max": [_pct(miss, 50), _pct(miss, 99), max(miss)],
                    "share_within_50us": sum(m <= 50 for m in miss) / len(miss),
                    "mid_offset_us_p1_p50_p99": [_pct(mid, 1), _pct(mid, 50), _pct(mid, 99)],
                }
    out["bracket_us_median"] = statistics.median((b[1] - b[0]) / 1e3 for b in brackets)
    return out


def _job_collection(workload: str, seed: int, docs: int | None = None):
    from yardstick import cells, gen

    cell = cells.load_cell(workload)
    cfg = cell.config
    n = docs or cfg["num_docs"]
    ptr, terms = gen.collection(cfg, cfg["num_docs"], seed)
    ptr, terms = ptr[:n + 1], terms[:ptr[n]]
    return cfg, gen.to_program(cfg, ptr, terms)


def syncdebug(args) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.kernels import _build, ops
    from yardstick import gen

    cfg, coll = _job_collection("wt10g.build", args.seed, args.docs)
    _build.build_all(ops.KERNELS)
    work = tempfile.mkdtemp(prefix="spancheck-")
    out = {"mode": "syncdebug", "docs": args.docs}
    try:
        gen.count(cfg, coll, os.path.join(work, "warm"), "cuda")
        for label in ("on", "off", "off", "on", "on", "off"):
            path = os.path.join(work, label)
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    if label == "on":
                        with obs.scoped() as reg:
                            gen.count(cfg, coll, path, "cuda")
                        out["row_batches"] = sum(
                            e["name"] == "ingest/count_select" for e in reg.span_events())
                    else:
                        gen.count(cfg, coll, path, "cuda")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sync = [w for w in got if "synchroniz" in str(w.message)]
            out.setdefault(f"warnings_{label}", []).append(len(sync))
            shutil.rmtree(path, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["same"] = out["warnings_on"] == out["warnings_off"]
    return out


def build_cost(args) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.kernels import _build, ops
    from yardstick import gen

    cfg, coll = _job_collection("wt10g.build", args.seed)
    _build.build_all(ops.KERNELS)
    work = tempfile.mkdtemp(prefix="spancheck-")
    out = {"mode": "build-cost", "seed": args.seed, "job_s": {"off": [], "on": []}}
    try:
        gen.count(cfg, gen.to_program(cfg, coll.doc_ptr[:9], coll.terms[:coll.doc_ptr[8]]),
                  os.path.join(work, "warm"), "cuda")
        order = ["off", "on", "on", "off"] * args.rounds
        for i, label in enumerate(order):
            path = os.path.join(work, f"job{i}")
            torch.cuda.synchronize()
            t = time.perf_counter()
            if label == "on":
                with obs.scoped() as reg:
                    gen.count(cfg, coll, path, "cuda")
                out["span_events"] = len(reg.span_events())
            else:
                gen.count(cfg, coll, path, "cuda")
            torch.cuda.synchronize()
            out["job_s"][label].append(time.perf_counter() - t)
            shutil.rmtree(path, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = (statistics.median(out["job_s"][k]) for k in ("on", "off"))
    out["cost_pct"] = 100.0 * (on - off) / off
    out["per_span_us"] = _span_cost_us()
    return out


def _span_cost_us() -> dict:
    """Host microseconds of one empty span, enabled and disabled."""
    from repro_torch import obs

    res = {}
    for label, reg in (("enabled", obs.Registry(max_events=10**7)),
                       ("disabled", obs.Registry(enabled=False))):
        n = 200_000
        t = time.perf_counter()
        for _ in range(n):
            with reg.span("ingest/count_launch"):
                pass
        res[label] = (time.perf_counter() - t) / n * 1e6
    return res


def serve_cost(args) -> dict:
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels import _build, ops
    from repro_torch.store.query import QueryEngine
    from repro_torch.store.segments import Store
    from yardstick import cells, gen

    cell = cells.load_cell("wt10g-dfdesc.serve-zipf")
    cfg, mix = cell.config, cell.mix
    ptr, terms = gen.collection(cfg, cfg["serve_docs"], args.seed)
    draw = gen.SAMPLERS[mix["terms"]](np.bincount(terms, minlength=cfg["vocab_size"]), mix)
    batches = draw(np.random.default_rng([args.seed, 1, 0]),
                   args.batches * mix["batch"]).reshape(args.batches, mix["batch"])
    _build.build_all(ops.KERNELS)
    work = tempfile.mkdtemp(prefix="spancheck-")
    out = {"mode": "serve-cost", "seed": args.seed, "batches": args.batches,
           "batch_ms": {"disabled": [], "enabled": []}}
    try:
        path = os.path.join(work, "store")
        gen.count(cfg, gen.to_program(cfg, ptr, terms), path, "cuda")
        engines = {label: QueryEngine(Store.open(path), cache_rows=cfg["cache_rows"],
                                      device="cuda", registry=obs.Registry(enabled=on))
                   for label, on in (("disabled", False), ("enabled", True))}
        for eng in engines.values():  # warm each cache on the same batches
            for q in batches:
                eng.topk(q, k=mix["k"], score=mix["score"])
        for label in ["disabled", "enabled", "enabled", "disabled"] * args.rounds:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for q in batches:
                engines[label].topk(q, k=mix["k"], score=mix["score"])
            out["batch_ms"][label].append((time.perf_counter() - t) / len(batches) * 1e3)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = (statistics.median(out["batch_ms"][k]) for k in ("enabled", "disabled"))
    out["cost_pct"] = 100.0 * (on - off) / off
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("traced", "clock", "syncdebug", "build-cost",
                                     "serve-cost"))
    ap.add_argument("--workload", default="wt10g.build")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--docs", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--batches", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="traced: where the cell runs")
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    fn = {"traced": traced, "clock": clock, "syncdebug": syncdebug,
          "build-cost": build_cost, "serve-cost": serve_cost}[args.mode]
    res = fn(args)
    line = json.dumps(res, default=float)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
