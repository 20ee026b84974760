#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on the card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper:
the kernels build for sm_90a). It fails (exit code != 0, no result line)
without a card, without the repository beside it, or if any phase fails:

1. Device: print the card's name and power limit, build every kernel of
   the path from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, all at
   once) and print the build times and the compiler's register report.
2. Main path at full width: a WT10G-shaped Zipf collection (20,000
   documents, V = 65,536) is counted into a store with ``count_to_store(
   "list-scan-segment", ...)`` on the card, then served through
   ``launch.cooc_serve.serve`` for count, PMI and Dice. Every kernel's launch
   count is set to 0 just before and read just after; each must be > 0.
   The store's total count must equal sum_d len_d (len_d - 1) / 2, and its
   six CSR arrays must be byte-identical to a build of the same collection
   with the host ``list-scan``.
3. Kernels against their plain PyTorch versions on the card, with
   ``torch.equal`` (tolerance 0): ``segment_hist`` on the head batch of the
   main path plus ragged, all-padding and V-1 inputs; ``topk_gather`` for
   count, PMI and Dice at k in {1, 10, 1000} on a query tile of the main
   path's store, plus all-empty rows, tied rows and k = L. Each kernel is
   timed with CUDA events beside its plain version, the least time the card
   could take (bytes over 3.35 TB/s), and one PyTorch library call
   (``torch.bincount`` / ``torch.topk``) as a yardstick only.
4. Summary: build docs/hour, top-k QPS and p50/p99 for each score, each
   kernel's launches and times; then the ``nvidia-smi`` line, the kernels'
   JSON line, and as the last line ``{"ok": true, "device": ...}``.

Stores and scratch go to ``.smoke_work/`` in the checkout, removed at exit.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, ".smoke_work")

DOCS, VOCAB, SEED = 20_000, 65_536, 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SEGMENT_ARRAYS = (
    "row_ptr.bin", "cols.bin", "counts.bin",
    "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin",
)
SCORES = ("count", "pmi", "dice")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two equal-shaped tensors (equal infinities
    count 0)."""
    import torch

    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


# --------------------------------------------------------------- phase 2
def main_path(c, kernels) -> dict:
    import numpy as np

    from repro_torch import obs
    from repro_torch.core.cooc import count_to_store
    from repro_torch.launch.cooc_serve import serve

    dev_path = os.path.join(WORK, "store_cuda")
    host_path = os.path.join(WORK, "store_host")
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with obs.scoped() as reg:  # ingest stage spans, for the breakdown
        store, seg = count_to_store("list-scan-segment", c, dev_path)
    build_s = time.perf_counter() - t0
    served = {
        score: serve(store_path=dev_path, queries=2000, batch=64, topk=10,
                     score=score)
        for score in SCORES
    }
    launches = {k.name: k.launches for k in kernels}
    for name, n in launches.items():
        check(n > 0, f"main path launched {name} no time")

    lens = np.diff(c.doc_ptr)
    pair_occ = int((lens * (lens - 1) // 2).sum())
    total = int(np.fromfile(os.path.join(seg.path, "counts.bin"), np.int64).sum())
    check(total == pair_occ, f"store total count {total} != {pair_occ} pair occurrences")

    t0 = time.perf_counter()
    _, host_seg = count_to_store("list-scan", c, host_path, device="cpu")
    host_s = time.perf_counter() - t0
    for name in SEGMENT_ARRAYS:
        check(
            filecmp.cmp(os.path.join(seg.path, name),
                        os.path.join(host_seg.path, name), shallow=False),
            f"{name} differs between the cuda and the host list-scan builds",
        )
    return {
        "store": store, "build_s": build_s, "host_build_s": host_s,
        "nnz": int(seg.nnz), "pair_occurrences": pair_occ,
        "served": served, "launches": launches,
        "stages": reg.stage_totals("ingest/"),
    }


# --------------------------------------------------------------- phase 3
def check_segment_hist(c) -> dict:
    import torch

    from repro_torch.core.list_scan import LAUNCH_TOKENS, _device_chunks
    from repro_torch.data.index import DeviceIndex
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_hist import segment_hist_cuda

    dev = torch.device("cuda")
    idx = DeviceIndex.from_collection(c, dev)
    rows = 64
    ids, seg = next(_device_chunks(idx, 0, rows, LAUNCH_TOKENS))  # head batch
    g = torch.Generator(device=dev).manual_seed(SEED)
    L = 1_000_003
    cases = {
        "head batch": (ids, seg, rows, VOCAB),
        "ragged L": (
            torch.randint(-1, VOCAB, (L,), device=dev, generator=g, dtype=torch.int32),
            torch.randint(-1, rows, (L,), device=dev, generator=g, dtype=torch.int32),
            rows, VOCAB,
        ),
        "all padding": (
            torch.full((4097,), -1, dtype=torch.int32, device=dev),
            torch.full((4097,), -1, dtype=torch.int32, device=dev), rows, VOCAB,
        ),
        "ids at V-1": (
            torch.full((5000,), VOCAB - 1, dtype=torch.int32, device=dev),
            torch.arange(5000, dtype=torch.int32, device=dev) % rows, rows, VOCAB,
        ),
    }
    err = 0.0
    for name, (i, s, r, v) in cases.items():
        got = segment_hist_cuda(i, s, num_rows=r, vocab=v)
        want = ref.segment_hist_ref(i, s, r, v)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"segment_hist != plain version on {name}")
        err = max(err, max_abs_err(got, want))

    grid = torch.zeros((rows, VOCAB), dtype=torch.int32, device=dev)
    keys = seg.to(torch.int64) * VOCAB + ids.to(torch.int64)
    n = ids.numel()
    return {
        "tokens": n,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: segment_hist_cuda(
            ids, seg, num_rows=rows, vocab=VOCAB, out=grid), reps=20),
        "plain_ms": cuda_ms(lambda: ref.segment_hist_ref(
            ids, seg, rows, VOCAB, out=grid), reps=5),
        "library_ms": cuda_ms(lambda: torch.bincount(
            keys, minlength=rows * VOCAB), reps=5),
        "bound_ms": (8 * n + 4 * rows * VOCAB) / HBM_BYTES_PER_S * 1e3,
    }


def check_topk_gather(store) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_gather import topk_gather_cuda
    from repro_torch.store import QueryEngine

    dev = torch.device("cuda")
    eng = QueryEngine(store)
    # a fixed query batch the way serving draws it: the 64 highest-df terms
    # and a sweep down the df order (long and short rows in one tile)
    order = np.argsort(-store.df(), kind="stable")
    terms = np.concatenate([order[:32], order[32::2048][:32]])
    tile = [torch.from_numpy(a).to(dev) for a in eng.tile(terms)]
    B, L = tile[0].shape

    def small(ids, cnts, df_t, df_n):
        return [torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
                for a in (ids, cnts, df_t, df_n)]

    empty = small(np.full((3, 8), -1), np.zeros((3, 8)), np.ones(3), np.ones((3, 8)))
    tied = small(np.tile(np.arange(10, 26), (2, 1)), np.full((2, 16), 7),
                 np.full(2, 3), np.full((2, 16), 5))
    rng = np.random.default_rng(SEED)
    full_ids = np.sort(rng.choice(4096, size=(4, 128)), axis=1)
    k_eq_l = small(full_ids, rng.integers(1, 4, size=(4, 128)),
                   rng.integers(1, 50, size=4), rng.integers(1, 50, size=(4, 128)))
    cases = [(f"main tile k={k}", tile, min(k, L)) for k in (1, 10, 1000)]
    cases += [("all-empty rows", empty, 4), ("tied rows", tied, 16),
              ("k = L", k_eq_l, 128)]
    err = 0.0
    num_docs = max(store.num_docs, 1)
    for score in SCORES:
        for name, args, k in cases:
            gi, gs = topk_gather_cuda(*args, num_docs=num_docs, score=score, k=k)
            wi, ws = ref.topk_gather_ref(*args, num_docs=num_docs, score=score, k=k)
            torch.cuda.synchronize()
            check(torch.equal(gi, wi) and torch.equal(gs, ws),
                  f"topk_gather != plain version ({score}, {name})")
            err = max(err, max_abs_err(gs, ws))
    ti, _ = topk_gather_cuda(*tied, num_docs=num_docs, score="count", k=16)
    check(ti[0].tolist() == list(range(10, 26)), "tied row not in slot order")

    out = {"B": B, "L": L, "k": 10, "max_abs_err": err, "per_score": {}}
    for score in SCORES:
        scored = ref.score_tile(*tile, num_docs=num_docs, score=score)
        out["per_score"][score] = {
            "ms": cuda_ms(lambda: topk_gather_cuda(
                *tile, num_docs=num_docs, score=score, k=10), reps=20),
            "ms_k1000": cuda_ms(lambda: topk_gather_cuda(
                *tile, num_docs=num_docs, score=score, k=min(1000, L)), reps=3),
            "plain_ms": cuda_ms(lambda: ref.topk_gather_ref(
                *tile, num_docs=num_docs, score=score, k=10), reps=5),
            "library_ms": cuda_ms(lambda: torch.topk(scored, 10, dim=1), reps=20),
        }
    out["bound_ms"] = (12 * B * L + 4 * B + 8 * B * 10) / HBM_BYTES_PER_S * 1e3
    return out


# --------------------------------------------------------------- phase 4
def device_busy(fn) -> tuple[float, float, list]:
    """``(wall seconds, device seconds, top three device ops)`` of ``fn()``
    under the profiler; device seconds sum the self time of every operation
    on the card, and the top ops are ``(name, seconds)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops = sorted(
        ((e.key, e.self_device_time_total / 1e6) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        key=lambda kv: -kv[1],
    )
    return wall, sum(t for _, t in ops), ops[:3]


def where_time_goes(c, store) -> dict:
    """Device busy share of the counting stage and of serving, and the
    host time of building a serving batch's padded tile beside the time of
    the whole top-k call (which builds it too)."""
    import numpy as np

    from repro_torch.core.list_scan import count_list_scan_segment
    from repro_torch.launch.cooc_serve import _zipf_sampler
    from repro_torch.store import QueryEngine, SpillSink

    def count():
        with SpillSink(VOCAB, spill_dir=os.path.join(WORK, "spill")) as sink:
            count_list_scan_segment(c, sink)

    out = {"count": device_busy(count)}
    eng = QueryEngine(store)
    draw = _zipf_sampler(store, SEED)
    rng = np.random.default_rng(SEED + 1)
    batches = [draw(rng, 64) for _ in range(12)]
    for terms in batches[:2]:
        eng.topk(terms, k=10, score="pmi")  # warm-up
    out["serve"] = device_busy(
        lambda: [eng.topk(t, k=10, score="pmi") for t in batches[2:]]
    )
    tile_s = total_s = 0.0
    for terms in batches[2:]:
        t0 = time.perf_counter()
        eng.tile(terms)
        t1 = time.perf_counter()
        eng.topk(terms, k=10, score="pmi")
        t2 = time.perf_counter()
        tile_s += t1 - t0
        total_s += t2 - t1
    out["tile_ms"] = tile_s / len(batches[2:]) * 1e3
    out["batch_ms"] = total_s / len(batches[2:]) * 1e3
    return out


# ------------------------------------------------------------------ main
def run() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from repro_torch.data.corpus import synthetic_zipf_collection
    from repro_torch.kernels import _build, ops

    # phase 1: device and kernel builds
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = _build.build_all(ops.KERNELS)
    print(f"[build] kernels in {time.perf_counter() - t0:.2f}s: "
          + ", ".join(f"{k} {s:.2f}s" for k, s in build_s.items()))
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {k.name}: {line.strip()}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        # phase 2: the main path at full width
        t0 = time.perf_counter()
        c = synthetic_zipf_collection(DOCS, vocab=VOCAB, seed=SEED)
        print(f"[data] {DOCS} docs, V={VOCAB}, {c.num_postings} postings "
              f"in {time.perf_counter() - t0:.2f}s")
        mp = main_path(c, ops.KERNELS)
        print(f"[main] cuda build {mp['build_s']:.2f}s "
              f"({DOCS / mp['build_s'] * 3600:.0f} docs/hour), "
              f"{mp['nnz']} distinct pairs, total count = "
              f"{mp['pair_occurrences']} pair occurrences; host list-scan "
              f"build {mp['host_build_s']:.2f}s "
              f"({DOCS / mp['host_build_s'] * 3600:.0f} docs/hour); segment "
              f"arrays identical")
        for score, st in mp["served"].items():
            print(f"[serve] {score}: {st['topk_qps']} top-k QPS, p50 "
                  f"{st['topk_p50_ms']} ms, p99 {st['topk_p99_ms']} ms | {smi}")
        print(f"[launches] main path: {json.dumps(mp['launches'])}")

        # phase 3: kernels against their plain versions, and their times
        sh = check_segment_hist(c)
        tk = check_topk_gather(mp["store"])
        wt = where_time_goes(c, mp["store"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(f"[segment_hist] equal to plain on all cases; head batch "
          f"{sh['tokens']} tokens: kernel {sh['ms']:.4f} ms, plain "
          f"{sh['plain_ms']:.4f} ms, bincount {sh['library_ms']:.4f} ms, "
          f"bound {sh['bound_ms']:.4f} ms ({sh['bound_ms'] / sh['ms']:.1%} of "
          f"bound) | {smi}")
    for score, t in tk["per_score"].items():
        print(f"[topk_gather] {score} B={tk['B']} L={tk['L']} k=10: kernel "
              f"{t['ms']:.4f} ms (k=1000: {t['ms_k1000']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, torch.topk {t['library_ms']:.4f} ms, "
              f"bound {tk['bound_ms']:.4f} ms ({tk['bound_ms'] / t['ms']:.1%} "
              f"of bound) | {smi}")
    stages = ", ".join(f"{n.split('/', 1)[1]} {s:.2f}s"
                       for n, s in sorted(mp["stages"].items()))
    print(f"[where] cuda build stages (inclusive): {stages}")
    for what, (wall, dev, top) in (("counting stage", wt["count"]),
                                   ("serving 10 pmi batches", wt["serve"])):
        tops = "; ".join(f"{n[:48]} {t:.4f} s" for n, t in top)
        print(f"[where] {what} under the profiler: wall {wall:.3f} s, device "
              f"busy {dev:.4f} s ({dev / wall:.2%}); top device ops: {tops} "
              f"| {smi}")
    print(f"[where] serving batch of 64 (pmi, k=10, rows cached): top-k call "
          f"{wt['batch_ms']:.2f} ms; building its padded tile alone on the "
          f"host {wt['tile_ms']:.2f} ms")
    pmi = tk["per_score"]["pmi"]
    kernels = [
        {
            "name": "segment_hist", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_hist.cu",
            "replaces": "src/repro/kernels/segment_cooc.py:72",
            "launches": mp["launches"]["segment_hist"],
            "max_abs_err": sh["max_abs_err"], "ms": sh["ms"],
            "plain_ms": sh["plain_ms"], "bound_ms": sh["bound_ms"],
            "bound_by": "bytes", "library_ms": sh["library_ms"],
        },
        {
            "name": "topk_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_gather.cu",
            "replaces": "src/repro/kernels/topk_gather.py:132",
            "launches": mp["launches"]["topk_gather"],
            "max_abs_err": tk["max_abs_err"], "ms": pmi["ms"],
            "plain_ms": pmi["plain_ms"], "bound_ms": tk["bound_ms"],
            "bound_by": "bytes", "library_ms": pmi["library_ms"],
        },
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
