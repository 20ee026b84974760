"""Co-occurrence query serving driver (the statistic's serving side).

    PYTHONPATH=src python -m repro_torch.launch.cooc_serve --docs 5000 \
        --vocab 4096 --method auto --queries 2000 --batch 64 --topk 10 \
        --score pmi --workers 4 --clients 4 --batch-window-ms 2

Builds (or opens, with --store) a persistent co-occurrence store, then
replays a Zipf-skewed query workload — the access pattern of real serving
traffic, where popular terms dominate — and reports build throughput plus
per-request latency percentiles (p50/p95/p99) and QPS as JSON.

Two serving topologies:

* ``--workers 0`` (default) — in-process: one QueryEngine, batched calls
  from a single thread.
* ``--workers N`` — the multi-process layer (store/serving.py): N spawned
  workers share the store's mmap'd segments, each on its own CUDA context,
  ``--clients`` concurrent client threads submit typed requests
  (store/requests.py — the wire protocol), and each worker coalesces
  concurrent requests into batched kernel launches within
  ``--batch-window-ms``.

``--routing`` enables hot-term routing: the client-side QueryPlanner hashes
each term to the worker that owns its cache row, so per-worker LRU caches
partition the vocabulary instead of duplicating the Zipf head (the stats
JSON reports the aggregate and per-worker ``cache_hit_rate``).

``--store-format v2`` builds block-compressed segments (codecs + bloom
filter, docs/formats.md) instead of the raw v1 arrays; query results are
byte-identical either way. ``--build-segments N`` shards the build into N
segments, and ``--compact`` launches a background size-tiered compaction
(``Store.compact_background``) once serving is up, merging those segments
in a separate process *while the workers answer queries* — the stats JSON
gains a ``compaction`` key with the merge result, and multi-worker stats
include the ``storage`` codec counters (blocks decoded, block-cache hit
rate, bloom negatives).

``--follow FEED`` tails a feed file (repro_torch.stream: one document per line
of space-separated term IDs) into the store *while the workload runs*,
sealing micro-segments under the ``--max-lag-ms`` visibility budget, and
``--refresh-interval-ms`` makes idle workers refresh the manifest
periodically so a server with no traffic still surfaces each seal — the
stats JSON gains a ``stream`` key (cursor position, visibility-lag
percentiles) and multi-worker stats a ``freshness`` block (manifest
generation, segment census, seconds since last append).

``--max-inflight`` bounds each worker's request queue (overflow is shed
as typed ``ServerOverloaded`` and reported under ``"shed"`` instead of
queueing without limit), ``--deadline-ms`` propagates the client timeout
in the request envelope so workers skip expired requests
(``"deadline_timeouts"``), and ``--max-respawns`` sets the supervisor's
replacement budget for dead workers — the fault-tolerance layer of
docs/serving.md#degradation--recovery, surfaced in the stats JSON's
``serving.resilience`` block.

``--device`` is where the kernels run, for either topology and for the
build and the ``--follow`` seals: ``cuda`` (the default; the hand-written
``topk_gather`` and ``segment_hist`` kernels, raising without a card) or
``cpu`` (their plain PyTorch versions). The one part of the reference's
pipeline still missing from the port is parallel ingest (the reference's
``ParallelExecutor``): builds here run the serial executor.

Latency is reported from **both sides of the queue**: the ``topk_p*_ms`` /
``pair_p*_ms`` keys are client-side wall percentiles (submit → response,
including queue transport), while ``server_timing`` (multi-process runs)
breaks the same traffic down server-side — queue-wait vs execute vs total
request latency, from worker histograms merged across processes (see
docs/observability.md). ``--trace-out`` writes the driver-side span trace
(the store build's ingest stages and in-process query spans);
``--metrics-interval S`` dumps Prometheus-text metrics to stderr every S
seconds and sets the workers' snapshot cadence.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.cooc import count_to_store
from repro_torch.data.corpus import _zipf_probs, synthetic_zipf_collection
from repro_torch.device import resolve_device
from repro_torch.store import CoocServer, QueryEngine, ServerOverloaded, Store


def _percentiles(lat_s: list[float]) -> dict:
    """Client-side wall percentiles (queue transport included) — compare
    with the server-side ``server_timing`` histograms."""
    if not lat_s:  # everything shed/expired: no admitted latencies
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    a = np.asarray(lat_s) * 1e3
    return {
        "p50_ms": round(float(np.percentile(a, 50)), 3),
        "p95_ms": round(float(np.percentile(a, 95)), 3),
        "p99_ms": round(float(np.percentile(a, 99)), 3),
    }


def _build_or_open(
    docs: int,
    vocab: int,
    method: str,
    store_path: str | None,
    budget_pairs: int,
    seed: int,
    device: str,
    *,
    segment_version: int | None = None,
    build_segments: int = 1,
) -> tuple[Store, str, float]:
    if store_path and Store.exists(store_path):
        return Store.open(store_path), store_path, 0.0
    store_path = store_path or os.path.join(
        tempfile.mkdtemp(prefix="cooc_store_"), "store"
    )
    c = synthetic_zipf_collection(docs, vocab=vocab, mean_len=40, seed=seed)
    t0 = time.perf_counter()
    if segment_version is not None or build_segments > 1:
        # pre-create so the manifest pins the segment format; every append
        # (count_to_store opens an existing store) inherits it
        store = Store.create(
            store_path, c.vocab_size, segment_version=segment_version
        )
    # several shards: several appends (count_to_store appends to an
    # existing store). A multi-segment store is what --compact merges while
    # serving runs against it
    from repro_torch.data.preprocess import shard_documents

    shards = shard_documents(c, build_segments) if build_segments > 1 else [c]
    for shard in shards:
        store, seg = count_to_store(
            method, shard, store_path, memory_budget_pairs=budget_pairs,
            device=device,
        )
    build_s = time.perf_counter() - t0
    print(
        f"[build] {seg.nnz} pairs from {docs} docs via "
        f"{seg.meta.get('source', method)} in {build_s:.2f}s "
        f"({docs / build_s * 3600:.0f} docs/hour) -> {store_path} "
        f"(format v{store.segment_version}, "
        f"{len(store.segment_names)} segment(s))"
    )
    return store, store_path, build_s


def _zipf_sampler(store: Store, seed: int):
    """Zipf-skewed term draws: hot (high-df) terms get most of the traffic."""
    V = store.vocab_size
    probs = _zipf_probs(V, 1.0)
    df_order = np.argsort(-store.df(), kind="stable")

    def draw(rng, n):
        return df_order[rng.choice(V, size=n, p=probs)]

    return draw


# ---------------------------------------------------------------- topologies
def _serve_inprocess(
    store: Store, draw, queries, batch, topk, score, device, seed,
    cache_rows=4096,
) -> dict:
    engine = QueryEngine(store, device=device, cache_rows=cache_rows)
    rng = np.random.default_rng(seed + 1)
    n_batches = max(queries // batch, 1)
    engine.topk(draw(rng, batch), k=topk, score=score)  # kernel build warm-up
    lat = []
    for _ in range(n_batches):
        terms = draw(rng, batch)
        t0 = time.perf_counter()
        engine.topk(terms, k=topk, score=score)
        lat.append(time.perf_counter() - t0)
    topk_stats = _percentiles(lat)
    topk_qps = round(n_batches * batch / sum(lat))

    lat_pc = []
    for _ in range(n_batches):
        pairs = np.stack([draw(rng, batch), draw(rng, batch)], axis=1)
        t0 = time.perf_counter()
        engine.pair_counts(pairs)
        lat_pc.append(time.perf_counter() - t0)
    return {
        "topk_qps": topk_qps,
        **{f"topk_{k}": v for k, v in topk_stats.items()},
        "pair_qps": round(n_batches * batch / sum(lat_pc)),
        **{f"pair_{k}": v for k, v in _percentiles(lat_pc).items()},
        "row_cache": dict(engine.stats),
    }


def _start_compaction(store: Store):
    """Kick off the background merge ``--compact`` asks for: every current
    segment when several exist (None when there is nothing to merge)."""
    names = store.segment_names
    return store.compact_background(names=names) if len(names) > 1 else None


def _serve_multiprocess(
    store_path, draw, queries, batch, topk, score,
    workers, clients, batch_window_ms, device, seed,
    routing=False, cache_rows=4096, metrics_interval=0.0,
    keep_metrics=False, compact_store=None, refresh_interval_ms=0.0,
    max_inflight=0, max_respawns=2, deadline_ms=0.0,
) -> dict:
    """Two phases (all-clients top-k, then all-clients pair lookups),
    barrier-aligned so each workload's QPS is measured against its own
    wall-clock — directly comparable to the in-process numbers.

    ``compact_store`` (from ``--compact``) starts a background compaction
    right after the workers spawn: the merge commits mid-workload and the
    workers pick the new manifest up via their between-batch refresh().

    ``max_inflight`` / ``deadline_ms`` turn on admission control: a
    request shed at a full queue (typed ``ServerOverloaded``) or expired
    past its deadline (``TimeoutError``) is counted — under ``shed`` /
    ``deadline_timeouts`` — instead of aborting the workload, and drops
    out of the latency percentiles (they cover admitted requests)."""
    per_client = max(queries // (batch * clients), 1)
    timeout_s = deadline_ms / 1e3 if deadline_ms > 0 else 60.0
    lat_topk: list[float] = []
    lat_pair: list[float] = []
    rejected = {"shed": 0, "deadline_timeouts": 0}
    spans: dict[str, list[tuple[float, float]]] = {"topk": [], "pair": []}
    errors: list[Exception] = []
    lock = threading.Lock()
    barrier = threading.Barrier(clients)

    server = CoocServer(
        store_path, workers=workers, batch_window_ms=batch_window_ms,
        device=device, routing=routing, cache_rows=cache_rows,
        stats_interval_s=metrics_interval,
        refresh_interval_ms=refresh_interval_ms,
        max_inflight=max_inflight, max_respawns=max_respawns,
    ).start()
    compact_handle = _start_compaction(compact_store) if compact_store else None

    stop_dump = threading.Event()
    dumper = None
    if metrics_interval > 0:
        def _dump():
            # Live fleet view: workers publish registry snapshots every
            # stats_interval_s; stats() merges the freshest per worker.
            while not stop_dump.wait(metrics_interval):
                snap = server.stats().get("metrics")
                if snap:
                    print(obs.prometheus_text(snap), file=sys.stderr, flush=True)
        dumper = threading.Thread(target=_dump, daemon=True)
        dumper.start()

    def client_loop(idx: int):
        try:
            client = server.client()
            rng = np.random.default_rng(seed + 1 + idx)
            rej = {"shed": 0, "deadline_timeouts": 0}

            def call(fn, *a, **kw):
                try:
                    t0 = time.perf_counter()
                    fn(*a, timeout=timeout_s, **kw)
                    return time.perf_counter() - t0
                except ServerOverloaded:
                    rej["shed"] += 1
                except TimeoutError:
                    rej["deadline_timeouts"] += 1
                return None

            call(client.topk, draw(rng, batch), k=topk, score=score)  # warm-up
            call(client.pair_counts,
                 np.stack([draw(rng, batch), draw(rng, batch)], axis=1))

            barrier.wait()
            phase0 = time.perf_counter()
            ltk = []
            for _ in range(per_client):
                dt = call(client.topk, draw(rng, batch), k=topk, score=score)
                if dt is not None:
                    ltk.append(dt)
            topk_span = (phase0, time.perf_counter())

            barrier.wait()
            phase0 = time.perf_counter()
            lpc = []
            for _ in range(per_client):
                pairs = np.stack([draw(rng, batch), draw(rng, batch)], axis=1)
                dt = call(client.pair_counts, pairs)
                if dt is not None:
                    lpc.append(dt)
            pair_span = (phase0, time.perf_counter())

            with lock:
                lat_topk.extend(ltk)
                lat_pair.extend(lpc)
                rejected["shed"] += rej["shed"]
                rejected["deadline_timeouts"] += rej["deadline_timeouts"]
                spans["topk"].append(topk_span)
                spans["pair"].append(pair_span)
        except Exception as e:  # pragma: no cover - surfaced below
            barrier.abort()
            with lock:
                errors.append(e)

    threads = [
        threading.Thread(target=client_loop, args=(i,)) for i in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop_dump.set()
    if dumper is not None:
        dumper.join(timeout=5)
    sstats = server.stop()
    if errors:
        raise errors[0]

    def phase_wall(name: str) -> float:
        starts, ends = zip(*spans[name])
        return max(ends) - min(starts)

    # ``server_timing`` is hoisted to the top of the result; the raw merged
    # metrics snapshot is bulky, so it only stays when telemetry was asked for.
    serving = {
        k: v for k, v in sstats.items()
        if k != "server_timing" and (keep_metrics or k != "metrics")
    }
    total_topk = len(lat_topk) * batch
    total_pair = len(lat_pair) * batch
    out = {
        "clients": clients,
        "topk_qps": round(total_topk / phase_wall("topk")),
        **{f"topk_{k}": v for k, v in _percentiles(lat_topk).items()},
        "pair_qps": round(total_pair / phase_wall("pair")),
        **{f"pair_{k}": v for k, v in _percentiles(lat_pair).items()},
        "server_timing": sstats.get("server_timing", {}),
        "workers_lost": sstats.get("workers_lost", 0),
        "shed": rejected["shed"],
        "deadline_timeouts": rejected["deadline_timeouts"],
        "serving": serving,
    }
    if compact_handle is not None:
        out["compaction"] = compact_handle.join(timeout=300)
    return out


def serve(
    docs: int = 5_000,
    vocab: int = 4_096,
    method: str = "auto",
    store_path: str | None = None,
    budget_pairs: int = 1 << 20,
    queries: int = 2_000,
    batch: int = 64,
    topk: int = 10,
    score: str = "count",
    seed: int = 0,
    workers: int = 0,
    clients: int = 2,
    batch_window_ms: float = 2.0,
    device: str = "cuda",
    routing: bool = False,
    cache_rows: int = 4096,
    json_out: str | None = None,
    trace_out: str | None = None,
    metrics_interval: float = 0.0,
    store_format: str | None = None,
    build_segments: int = 1,
    compact: bool = False,
    follow: str | None = None,
    refresh_interval_ms: float = 0.0,
    max_lag_ms: float = 2_000.0,
    max_inflight: int = 0,
    max_respawns: int = 2,
    deadline_ms: float = 0.0,
) -> dict:
    """Build/open a store and replay a Zipf workload with the kernels on
    ``device``; returns the stats dict (and writes it as JSON to
    ``json_out`` if given).

    ``store_format`` ("v1" raw / "v2" compressed) pins the segment format of
    a freshly built store; ``build_segments`` shards the corpus into that
    many appended segments; ``compact`` merges them in a background process
    **while the workload runs** (the serving workers pick up the swap via
    refresh()) and reports the result under ``"compaction"``.

    ``follow`` tails a feed file (repro_torch.stream format: one document per
    line of space-separated term IDs) into the store **while serving**,
    sealing micro-segments under a ``max_lag_ms`` visibility budget —
    pair ``--workers N`` with ``refresh_interval_ms`` so even idle workers
    see each seal; the ingest summary lands under ``"stream"``.

    ``max_inflight`` bounds each worker's request queue (overflow is shed
    as typed ``ServerOverloaded`` and reported under ``"shed"``);
    ``deadline_ms`` makes the client timeout travel in the request
    envelope so workers skip expired requests; ``max_respawns`` is the
    supervisor's replacement budget per dead worker (multi-process
    topology only — docs/serving.md#degradation--recovery).

    Example::

        stats = serve(store_path="/data/store", workers=4, clients=4,
                      score="pmi", follow="/data/feed.txt", compact=True)
        stats["topk_qps"], stats["stream"]["cursor"]
    """
    resolve_device(device)
    telemetry = bool(trace_out) or metrics_interval > 0
    reg = obs.configure(enabled=True) if telemetry else obs.get_registry()
    segment_version = (
        None if store_format is None else int(store_format.lstrip("v"))
    )
    store, store_path, build_s = _build_or_open(
        docs, vocab, method, store_path, budget_pairs, seed, device,
        segment_version=segment_version, build_segments=build_segments,
    )
    draw = _zipf_sampler(store, seed)

    ingestor = None
    if follow:
        from repro_torch.stream import FileTailSource, StreamConfig, StreamIngestor

        # tail the feed into the serving store while the workload runs;
        # the cursor lives in the store manifest, so re-running with the
        # same feed resumes instead of re-ingesting
        ingestor = StreamIngestor(
            store,
            FileTailSource(follow),
            StreamConfig(max_visibility_lag_ms=max_lag_ms, device=device),
            source_id=os.path.abspath(follow),
        ).start()

    if workers <= 0:
        compact_handle = _start_compaction(store) if compact else None
        stop_dump = threading.Event()
        dumper = None
        if metrics_interval > 0:
            def _dump():
                while not stop_dump.wait(metrics_interval):
                    print(reg.prometheus_text(), file=sys.stderr, flush=True)
            dumper = threading.Thread(target=_dump, daemon=True)
            dumper.start()
        try:
            served = _serve_inprocess(
                store, draw, queries, batch, topk, score, device, seed,
                cache_rows=cache_rows,
            )
        finally:
            stop_dump.set()
            if dumper is not None:
                dumper.join(timeout=5)
        if compact_handle is not None:
            served["compaction"] = compact_handle.join(timeout=300)
    else:
        served = _serve_multiprocess(
            store_path, draw, queries, batch, topk, score,
            workers, clients, batch_window_ms, device, seed,
            routing=routing, cache_rows=cache_rows,
            metrics_interval=metrics_interval, keep_metrics=telemetry,
            compact_store=store if compact else None,
            refresh_interval_ms=refresh_interval_ms,
            max_inflight=max_inflight, max_respawns=max_respawns,
            deadline_ms=deadline_ms,
        )

    if ingestor is not None:
        # don't raise: serving stats are still valid even if ingest died —
        # but the failure must be loud, not a silently stale cursor
        ingestor.stop(raise_on_error=False)
        served["stream"] = ingestor.summary()
        if not ingestor.healthy:
            print(
                f"[stream] ingest FAILED, feed tailing stopped early: "
                f"{served['stream']['error']}",
                file=sys.stderr,
            )

    store.refresh()  # a background compaction may have swapped segments
    stats = {
        "store": store_path,
        "store_format": f"v{store.segment_version}",
        "segments": len(store.segment_names),
        "num_docs": store.num_docs,
        "build_s": round(build_s, 2),
        "score": score,
        "batch": batch,
        "workers": workers,
        "device": str(device),
        "routing": bool(routing and workers > 1),
        **served,
    }
    if telemetry:
        build_stages = reg.stage_totals("ingest/")
        if build_stages:
            stats["build_stage_seconds"] = {
                name.split("/", 1)[1]: round(secs, 4)
                for name, secs in sorted(build_stages.items())
            }
        if trace_out:
            reg.write_trace(trace_out)
            print(f"[trace] {len(reg.span_events())} spans -> {trace_out}")
    print(json.dumps(stats))
    if json_out:
        with open(json_out, "w") as f:
            json.dump(stats, f, indent=2)
    return stats


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=5_000)
    ap.add_argument("--vocab", type=int, default=4_096)
    ap.add_argument(
        "--method", default="auto",
        help='counting method for the build ("auto": the planner picks among '
             'the methods of --device, list-scan-segment on cuda)',
    )
    ap.add_argument("--store", default=None, help="reuse/persist a store dir")
    ap.add_argument("--budget-pairs", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=2_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--score", default="count", choices=["count", "pmi", "dice"])
    ap.add_argument(
        "--workers", type=int, default=0,
        help="shared-mmap worker processes (0 = in-process engine)",
    )
    ap.add_argument(
        "--clients", type=int, default=2,
        help="concurrent client threads (only with --workers >= 1)",
    )
    ap.add_argument(
        "--batch-window-ms", type=float, default=2.0,
        help="micro-batch latency budget per worker",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where kernels run: cuda (hand-written kernels) or cpu (their "
             "plain PyTorch versions)",
    )
    ap.add_argument(
        "--routing", action="store_true",
        help="hot-term routing: hash terms to workers so per-worker LRU "
             "caches partition the vocabulary (only with --workers >= 2)",
    )
    ap.add_argument(
        "--cache-rows", type=int, default=4096,
        help="per-engine/per-worker LRU row-cache capacity",
    )
    ap.add_argument("--json", default=None, help="also write stats JSON here")
    ap.add_argument(
        "--trace-out", default=None,
        help="write a Chrome trace_event JSON of driver-side spans here "
             "(enables telemetry)",
    )
    ap.add_argument(
        "--metrics-interval", type=float, default=0.0,
        help="dump Prometheus-text metrics to stderr every S seconds; also "
             "the workers' stats-snapshot cadence (enables telemetry)",
    )
    ap.add_argument(
        "--store-format", default=None, choices=["v1", "v2"],
        help="segment format for a freshly built store: v1 raw arrays, "
             "v2 block-compressed + bloom (byte-identical queries)",
    )
    ap.add_argument(
        "--build-segments", type=int, default=1,
        help="shard the corpus into N appended segments (gives --compact "
             "something to merge)",
    )
    ap.add_argument(
        "--compact", action="store_true",
        help="merge segments in a background process while the workload "
             "runs; serving picks the swap up live via refresh()",
    )
    ap.add_argument(
        "--follow", default=None, metavar="FEED",
        help="tail this feed file (one doc per line of term IDs) into the "
             "store while serving; resumes from the manifest stream cursor",
    )
    ap.add_argument(
        "--refresh-interval-ms", type=float, default=0.0,
        help="serving workers refresh the manifest this often even with no "
             "traffic, so an idle server still sees streamed segments "
             "(0 = refresh only between micro-batches)",
    )
    ap.add_argument(
        "--max-lag-ms", type=float, default=2_000.0,
        help="visibility-lag budget for --follow: every tailed doc should "
             "be queryable within this long of arriving",
    )
    ap.add_argument(
        "--max-inflight", type=int, default=0,
        help="admission control: bound each worker's request queue; "
             "overflow is shed as typed ServerOverloaded and counted "
             "(0 = unbounded)",
    )
    ap.add_argument(
        "--deadline-ms", type=float, default=0.0,
        help="per-request deadline: the client timeout travels in the "
             "request envelope, so workers skip requests that expired in "
             "the queue (0 = the 60s client default)",
    )
    ap.add_argument(
        "--max-respawns", type=int, default=2,
        help="how many times the supervisor replaces a dead worker before "
             "routing around its slot permanently",
    )
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    serve(
        args.docs,
        args.vocab,
        args.method,
        args.store,
        args.budget_pairs,
        args.queries,
        args.batch,
        args.topk,
        args.score,
        workers=args.workers,
        clients=args.clients,
        batch_window_ms=args.batch_window_ms,
        device=args.device,
        routing=args.routing,
        cache_rows=args.cache_rows,
        json_out=args.json,
        trace_out=args.trace_out,
        metrics_interval=args.metrics_interval,
        store_format=args.store_format,
        build_segments=args.build_segments,
        compact=args.compact,
        follow=args.follow,
        refresh_interval_ms=args.refresh_interval_ms,
        max_lag_ms=args.max_lag_ms,
        max_inflight=args.max_inflight,
        max_respawns=args.max_respawns,
        deadline_ms=args.deadline_ms,
    )


if __name__ == "__main__":
    main()
