"""Cells on several cards: device traces filed by card and reduced to each
card's busy seconds and their mean, the fullest card's memory peak, spawned
ranks traced by the worker hook; and what a one-card cell reads, unchanged.
Also the build window that ends by its seconds, the serving idle gaps named
by the workers' spans, and the count loop's grid counter."""

import glob
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import run
from yardstick import cells, spawned, trace as T

BASE_NS = 1_700_000_000 * 10**9  # the traces' baseTimeNanoseconds
T0 = BASE_NS / 1e9


def _event(cat, name, t, dur, card):
    """A device operation ``t`` seconds after the trace's base, on ``card``."""
    return {"ph": "X", "cat": cat, "name": name, "pid": card, "tid": 7,
            "ts": t * 1e6, "dur": dur * 1e6, "args": {"device": card, "stream": 7}}


def _write_trace(path, events):
    host = {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 4242, "tid": 1,
            "ts": 0.0, "dur": 9e6, "args": {}}
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": BASE_NS, "traceEvents": [host] + events}, f)


def _old_read_chrome_trace(path):
    """``trace.read_chrome_trace`` as it was before traces were read by
    card, kept here to hold the new reader to it."""
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("cat") in T.DEVICE_CATS and e.get("ph") == "X":
            out.append((e["name"], (e["ts"] + base_us) / 1e6, e["dur"] / 1e6))
    return out


@pytest.fixture
def four_cards(tmp_path):
    """One trace a rank, rank ``c`` on card ``c``: two overlapping kernels
    (busy 1 to 2.5 s) and a copy of 0.25·(c + 1) s at 5 s."""
    for c in range(4):
        _write_trace(tmp_path / f"worker-{100 + c}.json", [
            _event("kernel", "cooc_gram", 1.0, 1.0, c),
            _event("kernel", "ncclAllGather", 1.5, 1.0, c),
            _event("gpu_memcpy", "Memcpy HtoD", 5.0, 0.25 * (c + 1), c),
        ])
    return str(tmp_path)


def test_four_card_traces_reduce_to_each_cards_busy_seconds_and_their_mean(four_cards):
    by_card = T.clip_by_card(T.ops_by_card(four_cards), T0, T0 + 10)
    assert sorted(by_card) == [0, 1, 2, 3] and all(len(o) == 3 for o in by_card.values())
    busy = T.busy_s_by_card(by_card, 4)
    for c in range(4):
        assert busy[c] == pytest.approx(1.5 + 0.25 * (c + 1), abs=1e-6)
    dev = run.traced_device(SimpleNamespace(chips=4),
                            {"ops_by_card": by_card, "window": (T0, T0 + 10)})
    assert dev["busy_s"] == pytest.approx(1.5 + 0.25 * 2.5, abs=1e-6)
    assert dev["window_s"] == pytest.approx(10.0)
    assert dev["busy_s_by_card"] == {str(c): busy[c] for c in range(4)}
    # one timeline for all four cards counts a moment busy when any card is
    flat = T.clip(T.read_trace_dir(four_cards), T0, T0 + 10)
    assert T.busy_s(flat) == pytest.approx(1.5 + 1.0, abs=1e-6)


def test_a_card_without_operations_counts_idle(four_cards):
    os.remove(os.path.join(four_cards, "worker-103.json"))
    busy = T.busy_s_by_card(T.ops_by_card(four_cards), 4)
    assert busy[3] == 0.0 and len(busy) == 4
    dev = run.traced_device(SimpleNamespace(chips=4), {
        "ops_by_card": T.ops_by_card(four_cards), "window": (T0, T0 + 10)})
    assert dev["busy_s"] == pytest.approx((1.75 + 2.0 + 2.25) / 4, abs=1e-6)


def test_one_card_reads_as_before(tmp_path):
    """A one-card trace through the old reader and the new one: the same
    operations, and bit-equal busy seconds, idle gaps and idle share."""
    rng = np.random.default_rng(5)
    starts = np.sort(rng.uniform(0, 20, 300))
    events = [_event("kernel" if i % 3 else "gpu_memset", f"op{i % 7}", float(t),
                     float(rng.uniform(0.001, 0.2)), 0) for i, t in enumerate(starts)]
    _write_trace(tmp_path / "trace.json", events)
    t0, t1 = T0 + 2.0, T0 + 18.0
    old = T.clip(_old_read_chrome_trace(str(tmp_path / "trace.json")), t0, t1)
    assert T.clip(T.read_chrome_trace(str(tmp_path / "trace.json")), t0, t1) == old
    new = T.clip_by_card(T.ops_by_card(str(tmp_path)), t0, t1)
    assert list(new) == [0] and new[0] == old
    dev = run.traced_device(SimpleNamespace(chips=1), {"ops": new[0], "window": (t0, t1)})
    assert dev == {"busy_s": T.busy_s(old), "window_s": t1 - t0}
    label = T.innermost_span([], 0.0)
    assert T.idle_gaps(new[0], t0, t1, label) == T.idle_gaps(old, t0, t1, label)
    read = cells.metric_reader("device_idle_pct.build")
    assert read({"ops": new[0], "window": (t0, t1)}) == read({"ops": old, "window": (t0, t1)})


@pytest.mark.parametrize("peak,want", [(5, 5), ([3, 9, 4, 1], 9), ({0: 2, 1: 7}, 7)])
def test_memory_peak_is_the_fullest_cards(peak, want):
    assert run.memory_peak(peak) == want


def test_memory_by_card_sums_the_processes_on_each_card(tmp_path):
    for pid, peaks in ((1, {"0": 100}), (2, {"0": 50, "1": 70}), (3, {})):
        (tmp_path / f"memory-{pid}.json").write_text(json.dumps(peaks))
    assert spawned.memory_by_card(str(tmp_path)) == {0: 150, 1: 70}


def _hook_dirs(tmp_path):
    t, m = tmp_path / "traces", tmp_path / "memory"
    t.mkdir()
    m.mkdir()
    return str(t), str(m)


def test_the_programs_ranks_are_traced(tmp_path):
    """The distributed Gram's world (here four gloo ranks on the host),
    started under the hook: each rank writes a trace and its memory peaks."""
    from repro_torch.core.distributed import gram_on_world

    B = (np.random.default_rng(0).random((8, 16)) < 0.4).astype(np.uint8)
    tdir, mdir = _hook_dirs(tmp_path)
    before = {k: os.environ.get(k) for k in spawned.KEYS}
    with spawned.WorkerHook(tdir, mdir):
        out = gram_on_world(B, (2, 2), ("data", "model"), device="cpu")
    assert {k: os.environ.get(k) for k in spawned.KEYS} == before
    want = B.T.astype(np.int64) @ B
    assert all(np.array_equal(c, want) for c in out["C"].values())
    traces = glob.glob(os.path.join(tdir, "worker-*.json"))
    assert len(traces) == 4
    for f in traces:
        with open(f) as fh:
            assert "traceEvents" in json.load(fh)
    assert T.ops_by_card(tdir) == {}  # no card here: no device operation
    assert spawned.memory_by_card(mdir) == {}
    assert len(glob.glob(os.path.join(mdir, "memory-*.json"))) == 4


def test_torch_multiprocessing_spawn_children_are_traced(tmp_path):
    import torch.multiprocessing as tmp

    tdir, mdir = _hook_dirs(tmp_path)
    with spawned.WorkerHook(tdir, mdir):
        tmp.spawn(time.sleep, nprocs=2)  # rank i sleeps i seconds
    assert len(glob.glob(os.path.join(tdir, "worker-*.json"))) == 2
    assert len(glob.glob(os.path.join(mdir, "memory-*.json"))) == 2


def test_no_hook_without_a_directory(tmp_path):
    before = dict(os.environ)
    with spawned.WorkerHook(None, None):
        assert dict(os.environ) == before


@pytest.mark.parametrize("jobs,seconds,ended", [(24, 1.0, "by seconds"),
                                                (2, 60.0, "by the cap")])
def test_build_window_ends_by_seconds_under_a_cap_above_what_fits(tiny, jobs, seconds, ended):
    cell = tiny("wt10g.build")
    cell.mix.update(jobs=jobs)
    out = run.run_cell(cell, 2**31 + 3, seconds, False, "cpu")
    assert out["correct"], out["numbers"]
    assert f"the window ended {ended}" in out["log"][0]
    if ended == "by seconds":
        assert 1 < out["attempted"] < jobs and out["window_s"] >= seconds
        assert f"{jobs - out['attempted']} jobs uncommitted" in out["log"][0]
    else:
        assert out["attempted"] == jobs and out["window_s"] < seconds


def _ev(name, t0, t1, depth, tid=1):
    return {"name": name, "ts_us": t0 * 1e6, "dur_us": (t1 - t0) * 1e6,
            "tid": tid, "depth": depth, "args": {}}


def test_serving_idle_gaps_are_named_by_the_workers_spans():
    serve = cells.kind_module("serve")
    epoch = 1_000.0
    events = [_ev("serving/execute", 0, 6, 0, tid=7), _ev("query/tile", 0.5, 4, 1, tid=7),
              _ev("query/h2d", 4, 5, 1, tid=7), _ev("serving/execute", 7, 9.5, 0, tid=8)]
    ops = [("Memcpy HtoD", epoch + 4, 1.0), ("topk", epoch + 5, 0.5),
           ("topk", epoch + 9.5, 0.5)]
    out = {"ctx": {"ops": ops, "window": (epoch, epoch + 10),
                   "final": {"metrics": {"events": events, "epoch_unix": epoch}}}}
    gaps = serve.breakdown(out)["idle_gaps"]
    # idle 0-4 (a tile at its middle), 5.5-9.5 (at 7.5 the second
    # worker's execute, nothing deeper)
    assert [g[0] for g in gaps] == ["query/tile", "serving/execute"]
    assert [g[1] for g in gaps] == pytest.approx([4.0, 4.0])
    # a tree whose workers ship no events
    out["ctx"]["final"] = {"metrics": {}}
    assert [g[0] for g in serve.breakdown(out)["idle_gaps"]] == ["outside any span"] * 2


def test_count_grid_mcells_reads_the_counter_a_job():
    read = cells.metric_reader("count_grid_mcells")
    ctx = {"jobs": [{}, {}], "counters": {"ingest.count_grid_cells": 6_400_000}}
    assert read(ctx) == pytest.approx(3.2)
    assert read({}) is None
    assert read({"jobs": [{}], "counters": {"ingest.rows_written": 5}}) is None


def test_traced_build_run_reports_the_grid_counter(tiny):
    """A tiny build counted by ``list-scan-segment`` on the host records
    the counter in the window, and the reader finds it."""
    cell = tiny("wt10g.build")
    cell.config.update(method="list-scan-segment", expect_method="list-scan-segment")
    out = run.run_cell(cell, 9, 0.0, True, "cpu")
    assert out["correct"] and out["ctx"]["counters"]["ingest.count_grid_cells"] > 0
    assert run.metrics_of(cell, out, True)["count_grid_mcells"]["value"] > 0
