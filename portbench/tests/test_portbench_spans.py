"""The readers of the count loop's and the serving worker's spans and
counters, on hand-made result contexts: each reads what it should, and
returns ``None`` where the program recorded none of it (a tree without
these spans)."""

from types import SimpleNamespace

import pytest

from yardstick import cells, telemetry as S

BUILD = ("count_launch_s", "count_select_s", "count_emit_s", "count_idle_s")
SERVE = ("serve_tile_ms", "serve_h2d_ms", "serve_topk_ms",
         "serve_tile_fill_pct", "serve_tile_idle_pct")
EPOCH = 1_000.0


def ev(name, t0, t1, depth, tid=1):
    """A span event from ``t0`` to ``t1`` seconds after ``EPOCH``."""
    return {"name": name, "ts_us": t0 * 1e6, "dur_us": (t1 - t0) * 1e6,
            "tid": tid, "depth": depth, "args": {}}


def build_ctx():
    """Two jobs: each an ``ingest/count`` with two row batches, a spill in
    one emit, and a segment write; the card busy in each select and in
    the first launch."""
    spans = []
    for base in (0.0, 20.0):
        spans += [
            ev("ingest/execute", base, base + 20, 0),
            ev("ingest/count", base, base + 15, 1),
            ev("ingest/count_launch", base + 1, base + 2, 2),
            ev("ingest/count_select", base + 2, base + 4, 2),
            ev("ingest/count_emit", base + 4, base + 7, 2),
            ev("ingest/spill", base + 5, base + 6, 3),
            ev("ingest/count_launch", base + 8, base + 9, 2),
            ev("ingest/count_select", base + 9, base + 10, 2),
            ev("ingest/count_emit", base + 10, base + 11, 2),
            ev("ingest/segment_write", base + 15, base + 20, 1),
        ]
    ops = []
    for base in (0.0, 20.0):
        ops += [("fill", EPOCH + base + 1.5, 0.5), ("select", EPOCH + base + 2, 2.0),
                ("select", EPOCH + base + 9, 1.0)]
    return {"jobs": [{}, {}], "spans": spans, "epoch_unix": EPOCH, "ops": ops,
            "window": (EPOCH, EPOCH + 40)}


def test_build_readers():
    ctx = build_ctx()
    read = {n: cells.metric_reader(n) for n in BUILD}
    assert read["count_launch_s"](ctx) == pytest.approx(2.0)
    assert read["count_select_s"](ctx) == pytest.approx(3.0)
    assert read["count_emit_s"](ctx) == pytest.approx(3.0)  # the spill is not the emit's
    # idle while the count loop is innermost, a job: ingest/count's own
    # 0-1, 7-8, 11-15 (6 s), the launches' 1-1.5 and 8-9 (1.5 s), the
    # emits' 4-5, 6-7, 10-11 (3 s); not the spill's 5-6, nor the selects
    assert read["count_idle_s"](ctx) == pytest.approx(10.5)
    # the old reader now reads the remainder
    assert cells.metric_reader("ingest_count_s")(ctx) == pytest.approx(6.0)


def serve_ctx():
    def snap(n_tile, counters, events=None):
        buckets = {"-80": n_tile}  # about 1 ms each
        hists = {h: {"buckets": buckets, "count": n_tile, "total": 1e-3 * n_tile,
                     "vmin": 1e-3, "vmax": 1e-3}
                 for h in ("query/tile_s", "query/h2d_s", "query/topk_s")}
        m = {"counters": counters, "gauges": {}, "histograms": hists,
             "dropped_events": 0}
        if events is not None:
            m.update(events=events, epoch_unix=EPOCH)
        return {"metrics": m}

    events = [ev("query/tile", 1, 3, 0, tid=7), ev("query/tile", 2, 4, 0, tid=8),
              ev("query/h2d", 4, 5, 0, tid=7), ev("query/tile", 11, 12, 0, tid=7)]
    return {
        "base": snap(5, {"query.tile_cells": 1000, "query.tile_cells_valid": 100}),
        "final": snap(15, {"query.tile_cells": 5000, "query.tile_cells_valid": 1100},
                      events),
        "latency_s": [], "window": (EPOCH, EPOCH + 10),
        "ops": [("Memcpy HtoD", EPOCH + 4, 1.0), ("topk", EPOCH + 5, 1.0)],
    }


def test_serve_readers():
    from repro_torch.obs.metrics import bucket_index, bucket_mid

    ctx = serve_ctx()
    assert bucket_index(1e-3) == -80
    for n in ("serve_tile_ms", "serve_h2d_ms", "serve_topk_ms"):
        assert cells.metric_reader(n)(ctx) == pytest.approx(bucket_mid(-80) * 1e3)
    assert cells.metric_reader("serve_tile_fill_pct")(ctx) == pytest.approx(25.0)
    # idle: 0-4 and 6-10 (8 s); a tile open in 1-4 (the two overlap); the
    # tile at 11-12 lies past the window
    assert cells.metric_reader("serve_tile_idle_pct")(ctx) == pytest.approx(100 * 3 / 8)


@pytest.mark.parametrize("name", BUILD + SERVE)
def test_readers_read_nothing_where_nothing_was_recorded(name):
    read = cells.metric_reader(name)
    assert read({}) is None
    if name in BUILD:
        # a tree without the row-batch spans: ingest/count alone
        ctx = build_ctx()
        ctx["spans"] = [e for e in ctx["spans"] if not e["name"].startswith("ingest/count_")]
        assert read(ctx) is None
    else:
        # a tree whose workers neither time the tile nor ship their events
        ctx = serve_ctx()
        for snap in (ctx["base"], ctx["final"]):
            snap["metrics"]["histograms"] = {}
            snap["metrics"]["counters"] = {}
            snap["metrics"].pop("events", None)
        assert read(ctx) is None


def test_innermost_intervals_are_per_thread():
    spans = [ev("a", 0, 10, 0, tid=1), ev("b", 2, 4, 1, tid=1), ev("b", 1, 3, 0, tid=2)]
    assert S.innermost_intervals(spans, 0.0, ("a",)) == [(0.0, 2.0), (4.0, 10.0)]
    assert S.innermost_intervals(spans, 0.0, ("b",)) == [(1.0, 3.0), (2.0, 4.0)]
    assert S.overlap_s([(0, 2), (4, 10)], [(1, 5), (9, 12)]) == pytest.approx(3.0)


def test_spancheck_reads_a_traced_run(tiny, monkeypatch):
    """``spancheck.py traced`` on a tiny build counted by
    ``list-scan-segment`` on the host: the row-batch metrics and their sum,
    and nothing dropped."""
    import spancheck

    cell = tiny("wt10g.build")
    cell.config.update(method="list-scan-segment", expect_method="list-scan-segment")
    monkeypatch.setattr(cells, "load_cell", lambda name, manifest=None: cell)
    res = spancheck.traced(SimpleNamespace(workload="wt10g.build", seed=4, seconds=0.0,
                                           device="cpu"))
    m = res["metrics"]
    assert res["correct"] and res["harness_dropped_events"] == [0]
    parts = ("ingest_count_s", "count_launch_s", "count_select_s", "count_emit_s")
    assert res["count_sum_s"] == pytest.approx(sum(m[p] for p in parts))
    assert res["row_batches"] > 0 and "count_idle_s" not in m  # no device trace here
