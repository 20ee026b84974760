"""Continuous-ingest driver: tail a feed into a store, bounded lag.

    PYTHONPATH=src python -m repro_torch.launch.cooc_stream \
        --feed /tmp/feed.txt --store /tmp/store --vocab 4096 \
        --max-lag-ms 2000 --seal-docs 512 --compact --idle-timeout-s 5

Runs a :class:`repro_torch.stream.StreamIngestor` against ``--feed`` (one
document per line of space-separated term IDs; see
repro_torch.stream.source):
documents are buffered and sealed into micro-segments so each is queryable
within the ``--max-lag-ms`` visibility budget, committed through the same
flock'd manifest path every other writer uses. The stream cursor lives in
the store manifest and advances atomically with each seal, so re-running
this driver after *any* crash (including SIGKILL mid-seal) resumes
exactly-once — no document is ever counted twice or dropped.

``--compact`` runs the tier-pressure :class:`repro_torch.store.CompactionDaemon`
alongside, folding the micro-segment tail back down (fanout ``--fanout``)
while ingest continues; the final summary reports its merge count.

``--gen-docs N`` spawns a paced synthetic producer thread appending N
Zipf documents to the feed at ``--gen-rate`` docs/s (0 = all at once) —
a self-contained way to exercise the tailer without an external producer.

``--device`` is where each seal counts: ``cuda`` (the default; raising
without a card) runs ``list-scan-segment`` on the ``segment_hist`` kernel
unless ``--method`` names another method, ``cpu`` the host ``list-scan``.

The run summary (docs/seals committed, cursor position, visibility-lag
and seal-cost percentiles, compaction merges, final segment count) prints
as JSON; ``--json`` also writes it to a file. ``--trace-out`` /
``--metrics-interval`` enable ``stream/*`` span + counter telemetry
exactly like the other launch drivers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.store import CompactionDaemon, CompactionPolicy, Store
from repro_torch.stream import (
    FileTailSource,
    StreamConfig,
    StreamIngestor,
    write_feed,
)


def _producer(feed: str, docs: int, vocab: int, rate: float, seed: int,
              mean_len: float) -> threading.Thread:
    """Append ``docs`` synthetic Zipf documents to ``feed``, paced at
    ``rate`` docs/s (0 = one burst), from a daemon thread."""
    from repro_torch.data.corpus import synthetic_zipf_collection

    c = synthetic_zipf_collection(docs, vocab=vocab, mean_len=mean_len,
                                  seed=seed)

    def run():
        if rate <= 0:
            write_feed(feed, (c.doc(d) for d in range(c.num_docs)))
            return
        t0 = time.monotonic()
        written = 0
        while written < c.num_docs:
            # how many docs the pace says should exist by now
            due = min(int((time.monotonic() - t0) * rate) + 1, c.num_docs)
            if due > written:
                write_feed(feed, (c.doc(d) for d in range(written, due)))
                written = due
            else:
                time.sleep(min(0.01, 1.0 / rate))

    t = threading.Thread(target=run, name="stream-producer", daemon=True)
    t.start()
    return t


def stream(
    feed: str,
    store_path: str,
    *,
    vocab: int | None = None,
    method: str | None = None,
    seal_docs: int = 512,
    max_lag_ms: float = 2_000.0,
    max_docs: int | None = None,
    idle_timeout_s: float | None = None,
    budget_pairs: int = 1 << 20,
    source_id: str | None = None,
    compact: bool = False,
    fanout: int = 4,
    gen_docs: int = 0,
    gen_rate: float = 0.0,
    gen_mean_len: float = 12.0,
    seed: int = 0,
    json_out: str | None = None,
    trace_out: str | None = None,
    metrics_interval: float = 0.0,
    device: str = "cuda",
) -> dict:
    """Tail ``feed`` into ``store_path`` until done (max_docs reached, or
    idle for idle_timeout_s), each seal counted on ``device`` (``method``
    None: the device's own, ``stream.daemon.DEVICE_METHODS``); returns the
    run summary dict.

    Example::

        summary = stream("/data/feed.txt", "/data/live", vocab=65_536,
                         seal_docs=2048, max_docs=10_000, compact=True)
        summary["docs_per_hour"], summary["visibility_lag_ms"]["p99"]
    """
    resolve_device(device)
    telemetry = bool(trace_out) or metrics_interval > 0
    reg = obs.configure(enabled=True) if telemetry else obs.get_registry()

    if Store.exists(store_path):
        store = Store.open(store_path, registry=reg)
    else:
        if vocab is None:
            raise SystemExit("--vocab is required to create a new store")
        store = Store.create(store_path, vocab, registry=reg)

    producer = None
    if gen_docs > 0:
        producer = _producer(feed, gen_docs, store.vocab_size, gen_rate,
                             seed, gen_mean_len)

    ingestor = StreamIngestor(
        store,
        FileTailSource(feed),
        StreamConfig(
            method=method,
            seal_docs=seal_docs,
            max_visibility_lag_ms=max_lag_ms,
            memory_budget_pairs=budget_pairs,
            max_docs=max_docs,
            idle_timeout_s=idle_timeout_s,
            device=device,
        ),
        source_id=source_id or os.path.abspath(feed),
        registry=reg,
    )

    daemon = None
    if compact:
        daemon = CompactionDaemon(
            store, CompactionPolicy(fanout=fanout), registry=reg
        ).start()

    stop_dump = threading.Event()
    dumper = None
    if metrics_interval > 0:
        def _dump():
            while not stop_dump.wait(metrics_interval):
                print(reg.prometheus_text(), file=sys.stderr, flush=True)
        dumper = threading.Thread(target=_dump, daemon=True)
        dumper.start()

    t0 = time.perf_counter()
    try:
        summary = ingestor.run()
    finally:
        stop_dump.set()
        if dumper is not None:
            dumper.join(timeout=5)
        if daemon is not None:
            daemon.stop()
    wall_s = time.perf_counter() - t0
    if producer is not None:
        producer.join(timeout=30)

    store.refresh()
    summary.update(
        store=store_path,
        wall_s=round(wall_s, 3),
        docs_per_hour=round(summary["docs_this_run"] / wall_s * 3600)
        if wall_s > 0 else 0,
        segments=len(store.segment_names),
        num_docs=store.num_docs,
    )
    if daemon is not None:
        summary["compaction"] = daemon.summary()
    if telemetry and trace_out:
        reg.write_trace(trace_out)
        print(f"[trace] {len(reg.span_events())} spans -> {trace_out}")
    print(json.dumps(summary))
    if json_out:
        with open(json_out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--feed", required=True,
                    help="feed file to tail (one doc per line of term IDs)")
    ap.add_argument("--store", required=True, help="store dir (created if new)")
    ap.add_argument("--vocab", type=int, default=None,
                    help="vocab size when creating a new store")
    ap.add_argument("--method", default=None,
                    help="counting method for each seal (default: the "
                         "device's own, list-scan-segment on cuda)")
    ap.add_argument("--seal-docs", type=int, default=512,
                    help="seal a micro-segment after this many docs")
    ap.add_argument("--max-lag-ms", type=float, default=2_000.0,
                    help="visibility-lag budget: docs should be queryable "
                         "within this long of arriving")
    ap.add_argument("--max-docs", type=int, default=None,
                    help="stop after committing this many docs")
    ap.add_argument("--idle-timeout-s", type=float, default=None,
                    help="stop after the feed is idle this long")
    ap.add_argument("--budget-pairs", type=int, default=1 << 20)
    ap.add_argument("--source-id", default=None,
                    help="cursor key in the manifest (default: feed abspath)")
    ap.add_argument("--compact", action="store_true",
                    help="run the tier-pressure compaction daemon alongside")
    ap.add_argument("--fanout", type=int, default=4,
                    help="compaction tier fanout (with --compact)")
    ap.add_argument("--gen-docs", type=int, default=0,
                    help="spawn a producer thread appending this many "
                         "synthetic Zipf docs to the feed")
    ap.add_argument("--gen-rate", type=float, default=0.0,
                    help="producer pace in docs/s (0 = one burst)")
    ap.add_argument("--gen-mean-len", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write summary JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON (enables telemetry)")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="dump Prometheus-text metrics to stderr every S "
                         "seconds (enables telemetry)")
    ap.add_argument("--device", default="cuda",
                    help="where each seal counts: cuda (the segment_hist "
                         "kernel) or cpu (the host)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    stream(
        args.feed,
        args.store,
        vocab=args.vocab,
        method=args.method,
        seal_docs=args.seal_docs,
        max_lag_ms=args.max_lag_ms,
        max_docs=args.max_docs,
        idle_timeout_s=args.idle_timeout_s,
        budget_pairs=args.budget_pairs,
        source_id=args.source_id,
        compact=args.compact,
        fanout=args.fanout,
        gen_docs=args.gen_docs,
        gen_rate=args.gen_rate,
        gen_mean_len=args.gen_mean_len,
        seed=args.seed,
        json_out=args.json,
        trace_out=args.trace_out,
        metrics_interval=args.metrics_interval,
        device=args.device,
    )


if __name__ == "__main__":
    main()
