"""Time ``segment_hist`` and ``bitpair`` of two checkouts of the port on one card.

Run from the repo root on a machine with a CUDA card, with unpacked
checkouts of other commits in a directory that ``.gitignore`` lists::

    mkdir -p .ab_other/parent && git archive <commit> | tar -x -C .ab_other/parent
    python3 tools/kernel_ab.py --tree parent=.ab_other/parent \
        --order parent,this,this,parent --json kernel_ab.json

The inputs are built once, with this checkout's code, at the shapes that
``chip_smoke.py`` times: ``segment_hist`` at path 1's head batch, at three
of its later batches (primaries from 6,400, 19,200 and 44,800: 216,879,
32,754 and 3,841 tokens) and at the first FREQ-SPLIT tail batches of path
2 and of ``cooc_run``'s first shard; ``bitpair`` on LIST-PAIRS blocks
0 x 1 and 0 x 0 at W = 625 and W = 63. Then one process per entry of
``--order`` imports the port from its checkout's ``src/`` (``this`` is
this checkout; an entry ``NAME:KERNEL.ATTR=INT`` first sets that constant
of ``repro_torch.kernels.KERNEL``, e.g. ``this:segment_hist.MIN_WINDOW_TOKENS=0``),
builds that checkout's kernels, checks each result ``torch.equal`` to the
plain version, and times each call by CUDA events and as profiler device
time (``chip_smoke.cuda_ms`` / ``device_ms``). It also sums each kernel's
device seconds in path 1's and path 2's counting stages, in a
``cooc_run`` at its defaults and in ``list-pairs-bitpacked`` on the
opt-in collection. With ``--sweep``, the plain entry ``this`` also times
``bitpair`` at forced slice counts (``SLICES``), to check
``kernels.bitpair.plan``. Every process prints one JSON object; the
parent process gathers them, prints them with the card's name and power
limit, and writes them to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (stdlib at import; torch inside calls)

WORK = os.path.join(HERE, ".smoke_work", "ab")
SLICES = (1, 2, 4, 8, 17, 20, 23, 27, 32)


def build_inputs(path: str) -> None:
    """Collections and kernel inputs, made with this checkout's code, saved
    as CPU tensors (``b`` is ``None`` where one tensor goes in twice)."""
    import inspect

    import numpy as np
    import torch

    from repro_torch.core.list_scan import LAUNCH_TOKENS, _device_chunks
    from repro_torch.data.corpus import synthetic_zipf_collection
    from repro_torch.data.index import DeviceIndex, incidence_bitpacked
    from repro_torch.data.preprocess import remap_df_descending, shard_documents
    from repro_torch.launch import cooc_run

    dev = torch.device("cuda")
    c = synthetic_zipf_collection(cs.DOCS, vocab=cs.VOCAB, seed=cs.SEED)
    cd, _ = remap_df_descending(c)
    d = inspect.signature(cooc_run.run).parameters
    run_c = synthetic_zipf_collection(d["num_docs"].default, vocab=d["vocab"].default,
                                      mean_len=60, seed=0)
    run_cd, _ = remap_df_descending(run_c)
    opt_c = synthetic_zipf_collection(cs.OPT_DOCS, vocab=cs.OPT_VOCAB,
                                      mean_len=cs.OPT_MEAN_LEN, seed=cs.SEED)
    idx = DeviceIndex.from_collection(c, dev)
    hist = {"path 1 head batch": (*next(_device_chunks(idx, 0, 64, LAUNCH_TOKENS)),
                                  64, cs.VOCAB)}
    for lo in (6_400, 19_200, 44_800):
        hist[f"path 1 batch at {lo}"] = (
            *next(_device_chunks(idx, lo, lo + 64, LAUNCH_TOKENS)), 64, cs.VOCAB)
    hist.update({
        "path 2 first tail batch": cs.first_tail_batch(cd, dev),
        "cooc_run first tail batch": cs.first_tail_batch(
            shard_documents(run_cd, 16)[0], dev),
    })
    bits = torch.from_numpy(incidence_bitpacked(cd).view(np.int32))
    opt = torch.from_numpy(incidence_bitpacked(opt_c).view(np.int32))
    pairs = {
        "W = 625 block 0 x 1": (bits[:256], bits[256:512]),
        "W = 625 block 0 x 0": (bits[:256], None),
        "W = 63 block 0 x 1": (opt[:256], opt[256:512]),
        "W = 63 block 0 x 0": (opt[:256], None),
    }  # cloned below: a saved view would carry its whole bitmap
    torch.save({
        "c": c, "cd": cd, "opt_c": opt_c,
        "hist": {k: (i.cpu(), s.cpu(), r, v) for k, (i, s, r, v) in hist.items()},
        "pairs": {k: (a.clone(), None if b is None else b.clone())
                  for k, (a, b) in pairs.items()},
    }, path)


def child(src: str, inputs: str, sets: list, sweep: bool) -> dict:
    """Everything timed in one checkout: see the module docstring."""
    import importlib

    sys.path.insert(0, src)
    import torch

    for s in sets:  # "KERNEL.ATTR=INT"
        name, value = s.split("=")
        mod, attr = name.split(".")
        setattr(importlib.import_module(f"repro_torch.kernels.{mod}"), attr, int(value))
    from repro_torch.core import hybrid
    from repro_torch.core.cooc import dense_counts
    from repro_torch.core.list_scan import count_list_scan_segment
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.bitpair import bitpair_cuda
    from repro_torch.kernels.segment_hist import segment_hist_cuda
    from repro_torch.launch import cooc_run
    from repro_torch.store import SpillSink

    t0 = time.perf_counter()
    _build.build_all(ops.KERNELS)
    out = {"src": src, "build_s": time.perf_counter() - t0, "ptxas": [
        f"{k.name}: {ln.strip()}" for k in ops.KERNELS
        for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]}
    data = torch.load(inputs, weights_only=False)
    dev = torch.device("cuda")

    out["segment_hist"] = {}
    for name, (i, s, r, v) in data["hist"].items():
        i, s = i.to(dev), s.to(dev)
        grid = segment_hist_cuda(i, s, num_rows=r, vocab=v)
        cs.check(torch.equal(grid, ref.segment_hist_ref(i, s, r, v)),
                 f"segment_hist != plain version on {name}")
        out["segment_hist"][name] = cs.both_ms(
            lambda: segment_hist_cuda(i, s, num_rows=r, vocab=v, out=grid), reps=20)
        del i, s, grid

    out["bitpair"] = {}
    for name, (a, b) in data["pairs"].items():
        a = a.to(dev)
        b = a if b is None else b.to(dev)
        cs.check(torch.equal(bitpair_cuda(a, b), ref.bitpair_popcount_ref(a, b)),
                 f"bitpair != plain version on {name}")
        t = {"plan": cs.both_ms(lambda: bitpair_cuda(a, b), reps=50)}
        if sweep:
            for S in SLICES:
                if S <= a.shape[1]:
                    t[f"S={S}"] = cs.both_ms(forced_slices(a, b, S), reps=50)
        out["bitpair"][name] = t

    os.makedirs(WORK, exist_ok=True)

    def path1():
        with SpillSink(cs.VOCAB, spill_dir=os.path.join(WORK, "spill1")) as sink:
            count_list_scan_segment(data["c"], sink)

    def path2():
        with SpillSink(cs.VOCAB, spill_dir=os.path.join(WORK, "spill2")) as sink:
            hybrid.count_freq_split(data["cd"], sink)

    out["path_device_s"] = {}
    for name, fn in (("path 1 counting stage", path1),
                     ("path 2 counting stage", path2),
                     ("cooc_run at its defaults", lambda: cooc_run.run(
                         out_dir=os.path.join(WORK, f"cooc_run_{time.time_ns()}"))),
                     ("list-pairs, opt-in collection",
                      lambda: dense_counts("list-pairs-bitpacked", data["opt_c"]))):
        wall, busy, ops_ = cs.device_busy(fn)
        out["path_device_s"][name] = {"wall_s": wall, "busy_s": busy,
                                      **cs.kernel_s(ops_)}
    return out


def forced_slices(a, b, S: int):
    """``bitpair_cuda(a, b)`` with the plan's tiles but S word slices:
    checked against the plain version once, then returned as a callable."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpair import KERNEL, plan

    M, W = a.shape
    N = b.shape[0]
    p = plan(M, N, W, a is b)

    def call():
        out = torch.zeros((M, N), dtype=torch.int32, device=a.device)
        KERNEL.launch(a.data_ptr(), b.data_ptr(), M, N, W, out.data_ptr(),
                      int(a is b), p.tiles, p.tiles_n, S,
                      torch.cuda.current_stream(a.device).cuda_stream)
        return out

    cs.check(torch.equal(call(), ref.bitpair_popcount_ref(a, b)),
             f"bitpair at S={S} != plain version")
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=ROOT of another checkout (repeatable)")
    ap.add_argument("--order", default="this")
    ap.add_argument("--sweep", action="store_true",
                    help="time bitpair at forced slice counts in the entry 'this'")
    ap.add_argument("--json", help="write every process's results here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--set", action="append", default=[], help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.inputs, args.set, args.sweep)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    trees = {"this": os.path.join(HERE, "src")}
    for t in args.tree:
        name, root = t.split("=", 1)
        trees[name] = os.path.join(os.path.abspath(root), "src")
    for entry in args.order.split(","):
        if not os.path.isdir(os.path.join(trees.get(entry.split(":")[0], ""),
                                          "repro_torch")):
            print(f"kernel_ab: no checkout holding src/repro_torch for {entry}",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    os.makedirs(WORK, exist_ok=True)
    inputs = os.path.join(WORK, "inputs.pt")
    t0 = time.perf_counter()
    build_inputs(inputs)
    print(f"[inputs] built in {time.perf_counter() - t0:.2f}s", flush=True)
    smi = cs.smi_line()
    runs = []
    try:
        for n, label in enumerate(args.order.split(",")):
            tree, *sets = label.split(":")
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   trees[tree], "--inputs", inputs]
            cmd += [f"--set={s}" for s in sets]
            if args.sweep and label == "this":
                cmd.append("--sweep")
            t0 = time.perf_counter()
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            res = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                                 env=env)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
                return 1
            r = json.loads(res.stdout.strip().splitlines()[-1])
            r.update(run=n + 1, label=label, secs=time.perf_counter() - t0)
            runs.append(r)
            print(f"[run {n + 1}] {label} ({r['src']}), {r['secs']:.1f}s, "
                  f"kernels built in {r['build_s']:.2f}s | {smi}")
            for ln in r["ptxas"]:
                print(f"  [ptxas] {ln}")
            for name, t in r["segment_hist"].items():
                print(f"  [segment_hist] {name}: {cs.show(t)}")
            for name, ts in r["bitpair"].items():
                print(f"  [bitpair] {name}: " + ", ".join(
                    f"{k} {cs.show(t)}" for k, t in ts.items()))
            for name, t in r["path_device_s"].items():
                print(f"  [path] {name}: wall {t['wall_s']:.3f}s, device busy "
                      f"{t['busy_s']:.4f}s, segment_hist {t['segment_hist']:.4f}s, "
                      f"bitpair {t['bitpair']:.4f}s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"smi": smi, "runs": runs}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
