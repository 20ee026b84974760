"""The port's telemetry (``repro_torch.obs``) where the work happens.

* the count loop of ``list-scan-segment`` and of FREQ-SPLIT's tail records
  one ``ingest/count_launch``, ``ingest/count_select`` and
  ``ingest/count_emit`` span per row batch, directly under
  ``ingest/count``, and its stores are the bytes of a run with telemetry
  off;
* a disabled registry records nothing;
* the top-k tile's counters and spans, and the row cache's counters, count
  what the tile holds;
* serving workers ship their span events and counters to the parent;
* spans share the clock of ``torch.profiler``'s traces.

All on the host (``device="cpu"``).
"""

import filecmp
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.cooc import count_to_store  # noqa: E402
from repro_torch.core import hybrid  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.data.preprocess import remap_df_descending  # noqa: E402
from repro_torch.store import CoocServer, QueryEngine, Store  # noqa: E402

COUNT_SPANS = ("ingest/count_launch", "ingest/count_select", "ingest/count_emit")
SEGMENT_ARRAYS = (
    "row_ptr.bin", "cols.bin", "counts.bin", "df.bin",
    "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin",
)
HEAD = 16  # FREQ-SPLIT's head: the rest of the vocabulary is its tail


@pytest.fixture(scope="module")
def coll():
    c = synthetic_zipf_collection(120, vocab=300, mean_len=14, seed=5)
    return remap_df_descending(c)[0]


def _docs(c):
    return [c.terms[c.doc_ptr[d]:c.doc_ptr[d + 1]] for d in range(c.num_docs)]


def _batches(c, method):
    """``(batches holding a posting, batches holding a token)``, counted from
    the documents: a posting of term t brings the terms after t in its
    document (``list-scan-segment``), or those before it (the tail)."""
    V = c.vocab_size
    if method == "list-scan-segment":
        bounds = list(range(0, V, 64)) + [V]
    else:
        bounds, lo = [HEAD], HEAD
        while lo < V:
            lo = hybrid.tail_batch_end(lo, V)
            bounds.append(lo)
    postings, tokens = np.zeros(V, np.int64), np.zeros(V, np.int64)
    for d in _docs(c):
        for pos, t in enumerate(d):
            postings[t] += 1
            tokens[t] += len(d) - 1 - pos if method == "list-scan-segment" else pos
    spans = list(zip(bounds[:-1], bounds[1:]))
    return (sum(postings[a:b].sum() > 0 for a, b in spans),
            sum(tokens[a:b].sum() > 0 for a, b in spans))


def _count(method, c, path, budget):
    kw = {"head": HEAD, "df_descending": True} if method == "freq-split" else {}
    count_to_store(method, c, path, memory_budget_pairs=budget, device="cpu", **kw)


def _segment_files(path):
    seg = sorted(d for d in os.listdir(path) if d.startswith("seg-"))
    assert len(seg) == 1
    return [os.path.join(path, seg[0], f) for f in SEGMENT_ARRAYS]


@pytest.mark.parametrize("budget", [64, 1 << 22], ids=["spill", "dense"])
@pytest.mark.parametrize("method", ["list-scan-segment", "freq-split"])
def test_count_loop_spans_one_per_row_batch(coll, tmp_path, monkeypatch, method, budget):
    """Each batch with a posting opens ``ingest/count_launch``; each with a
    token also ``ingest/count_select`` and ``ingest/count_emit``; all three
    sit directly under ``ingest/count``, and a spill the sink makes mid-count
    nests in ``ingest/count_emit``. The store is the one telemetry off
    writes, byte for byte."""
    monkeypatch.setattr(hybrid, "TAIL_GRID_CELLS", 4096)  # several tail batches
    _count(method, coll, str(tmp_path / "off"), budget)
    with obs.scoped() as reg:
        _count(method, coll, str(tmp_path / "on"), budget)
    ev = reg.span_events()
    names = [e["name"] for e in ev]
    with_postings, with_tokens = _batches(coll, method)
    assert with_tokens > 3
    assert names.count("ingest/count_launch") == with_postings
    assert names.count("ingest/count_select") == with_tokens
    assert names.count("ingest/count_emit") == with_tokens
    (count,) = [e for e in ev if e["name"] == "ingest/count"]
    c0, c1 = count["ts_us"], count["ts_us"] + count["dur_us"]
    for e in ev:
        if e["name"] in COUNT_SPANS:
            assert e["depth"] == count["depth"] + 1
            assert c0 <= e["ts_us"] and e["ts_us"] + e["dur_us"] <= c1
    spills = [e for e in ev if e["name"] == "ingest/spill"]
    emits = [e for e in ev if e["name"] == "ingest/count_emit"]
    if budget == 64:
        # the loop's spills nest in an emit; the last comes from the
        # count's closing flush, directly under ingest/count
        inner = [s for s in spills if s["depth"] == count["depth"] + 2]
        assert inner and all(
            any(m["ts_us"] <= s["ts_us"] <= m["ts_us"] + m["dur_us"] for m in emits)
            for s in inner)
    for a, b in zip(_segment_files(str(tmp_path / "off")),
                    _segment_files(str(tmp_path / "on"))):
        assert filecmp.cmp(a, b, shallow=False), os.path.basename(a)


def test_disabled_registry_records_nothing(coll, tmp_path):
    reg = obs.Registry(enabled=False)
    assert reg.span("ingest/count_launch") is obs.NULL_SPAN
    assert reg.timed("query/tile", "query/tile_s") is obs.NULL_SPAN
    assert reg.counter("query.tile_cells") is obs.NULL_METRIC
    with obs.scoped(reg):
        _count("list-scan-segment", coll, str(tmp_path / "s"), 64)
        eng = QueryEngine(Store.open(str(tmp_path / "s")), device="cpu")
        eng.topk([1, 2, 3], k=4, score="pmi")
    assert reg.span_events() == []
    snap = reg.snapshot()
    assert snap["counters"] == snap["gauges"] == snap["histograms"] == {}
    assert eng.stats["cache_misses"] == 3  # the engine's own dict still counts


def test_the_event_log_adds_no_work_to_the_collector():
    """Events are kept as plain tuples, which the collector stops tracking:
    a log of ~57,000 spans a build job triggers no full collections."""
    import gc

    reg = obs.Registry()
    with reg.span("ingest/count", shard=0):
        for _ in range(100):
            with reg.span("ingest/count_launch"):
                pass
    gc.collect()
    attrs_free = [e for e in reg._events if e[-1] is None]
    assert len(attrs_free) == 100 and not any(gc.is_tracked(e) for e in attrs_free)
    (count,) = [e for e in reg.span_events() if e["name"] == "ingest/count"]
    assert count["args"] == {"shard": 0} and count["depth"] == 0


def test_absorbed_events_keep_their_unix_times():
    """A worker's snapshot with events, absorbed by a parent registry made
    at another moment, lands on the parent's timeline at the same unix
    times, tagged with its source."""
    child = obs.Registry()
    with child.span("ingest/count", shard=3):
        with child.span("ingest/count_launch"):
            time.sleep(0.002)
    time.sleep(0.002)
    parent = obs.Registry()
    parent.absorb(child.snapshot(include_events=True), source="w0")

    def unix(reg):
        return sorted((reg.epoch_unix + e["ts_us"] / 1e6, e["dur_us"], e["name"],
                       e["args"].get("shard")) for e in reg.span_events())

    for (a, da, na, sa), (b, db, nb, sb) in zip(unix(child), unix(parent)):
        assert (na, sa, da) == (nb, sb, pytest.approx(db, abs=1e-3))
        assert a == pytest.approx(b, abs=2e-6)
    assert {e["args"]["proc"] for e in parent.span_events()} == {"w0"}


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    c = synthetic_zipf_collection(150, vocab=128, mean_len=12, seed=7)
    path = str(tmp_path_factory.mktemp("obs") / "store")
    count_to_store("list-scan", c, path, device="cpu")
    return path


def test_tile_counters_count_the_tile_and_the_cache(store_path):
    """``query.tile_cells`` is the padded B·L of each tile, and
    ``query.tile_cells_valid`` the candidates its rows hold, both counted
    here from ``eng.tile`` itself; the cache counters follow each lookup;
    each top-k launch times its three steps once."""
    reg = obs.Registry()
    eng = QueryEngine(Store.open(store_path), device="cpu", registry=reg)
    batches = [np.array([1, 2, 3, 40]), np.array([2, 3, 90]), np.array([5])]
    cells = valid = 0
    for terms in batches:
        eng.topk(terms, k=5, score="pmi")
        ids = QueryEngine(Store.open(store_path), device="cpu").tile(terms)[0]
        cells += ids.size
        valid += int((ids >= 0).sum())
    snap = reg.snapshot()
    ctr = snap["counters"]
    assert ctr["query.tile_cells"] == cells and ctr["query.tile_cells_valid"] == valid
    assert 0 < valid < cells
    assert ctr["query.cache_misses"] == eng.stats["cache_misses"] == 6
    assert ctr["query.cache_hits"] == eng.stats["cache_hits"] == 2
    ev = reg.span_events()
    for name in ("query/tile", "query/h2d", "query/topk"):
        durs = [e["dur_us"] / 1e6 for e in ev if e["name"] == name]
        h = snap["histograms"][name + "_s"]
        assert len(durs) == h["count"] == len(batches)
        assert h["total"] == pytest.approx(sum(durs), rel=1e-9)
    (execute,) = {e["depth"] for e in ev if e["name"] == "query/execute"}
    assert {e["depth"] for e in ev if e["name"].startswith("query/")} == {execute, execute + 1}


def test_server_ships_worker_spans_and_cache_counters(store_path):
    """After ``stop()``, ``stats()["metrics"]`` holds each worker's span
    events on one unix timeline and the row cache's counters, which the
    workers count although they bypass ``QueryEngine.execute``."""
    t0 = time.time()
    with CoocServer(store_path, device="cpu", workers=2, batch_window_ms=1.0) as server:
        client = server.client()
        for _ in range(6):
            client.topk([1, 2, 3], k=5, score="pmi")
    t1 = time.time()
    stats = server.stats()
    m = stats["metrics"]
    assert m["counters"]["query.cache_hits"] > 0
    assert m["counters"]["query.cache_hits"] == stats["cache_hits"]
    assert m["counters"]["query.cache_misses"] == stats["cache_misses"]
    assert "serving/batch_window_occupancy" not in m["gauges"]
    assert m["dropped_events"] == 0
    tiles = [e for e in m["events"] if e["name"] == "query/tile"]
    assert len(tiles) == m["histograms"]["query/tile_s"]["count"] == stats["topk_launches"]
    for e in m["events"]:
        start = m["epoch_unix"] + e["ts_us"] / 1e6
        assert t0 <= start and start + e["dur_us"] / 1e6 <= t1
    assert {e["name"] for e in m["events"]} == {"query/tile", "query/h2d", "query/topk"}


def test_a_span_holds_the_profiled_op_it_wraps(tmp_path):
    """A CPU-only ``torch.profiler`` trace, read as the benchmark reads a
    device trace (``ts`` plus ``baseTimeNanoseconds`` is unix time), puts
    the op inside the registry span that wrapped it, to within 0.5 ms."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    reg = obs.Registry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with reg.span("mm"):
                torch.mm(a, a)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_us = doc["baseTimeNanoseconds"] / 1e3
    ops = sorted((e["ts"] + base_us, e["ts"] + base_us + e["dur"])
                 for e in doc["traceEvents"]
                 if e.get("name") == "aten::mm" and e.get("ph") == "X")
    spans = sorted((reg.epoch_unix * 1e6 + e["ts_us"],
                    reg.epoch_unix * 1e6 + e["ts_us"] + e["dur_us"])
                   for e in reg.span_events())
    assert len(ops) == len(spans) == 5
    for (o0, o1), (s0, s1) in zip(ops, spans):
        assert s0 - 500 <= o0 and o1 <= s1 + 500
