"""Co-occurrence query serving driver (the statistic's serving side).

    PYTHONPATH=src python -m repro_torch.launch.cooc_serve --docs 5000 \\
        --vocab 4096 --method list-scan-segment --queries 2000 --batch 64 \\
        --topk 10 --score pmi

Builds (or opens, with --store) a persistent co-occurrence store, then
replays a Zipf-skewed query workload — the access pattern of real serving
traffic, where popular terms dominate — and reports build throughput plus
per-request latency percentiles (p50/p95/p99) and QPS as JSON.

The topology is in-process (``--workers 0``): one QueryEngine, batched
calls from a single thread, top-k on ``--device`` (``cuda`` by default: the
``topk_gather`` kernel; ``cpu``: its plain PyTorch version). The
multi-process workers (``--workers N``), live feed tailing (``--follow``)
and background compaction (``--compact``) are not ported yet; the flags are
rejected. ``--store-format v2`` builds block-compressed segments
(docs/formats.md) instead of the raw v1 arrays; query results are identical
either way. ``--trace-out`` writes the driver-side span trace (the store
build's ingest stages and query spans).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.cooc import count_to_store
from repro_torch.data.corpus import _zipf_probs, synthetic_zipf_collection
from repro_torch.device import resolve_device
from repro_torch.store import QueryEngine, Store

# flags of the reference driver that belong to slices not ported yet
_LATER_SLICES = {
    "--workers": "multi-process serving (store/serving.py)",
    "--follow": "streaming ingest (repro_torch.stream)",
    "--compact": "background compaction (store/compaction.py)",
}


def _percentiles(lat_s: list[float]) -> dict:
    """Client-side wall percentiles of the per-batch latencies."""
    if not lat_s:
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
) -> tuple[Store, str, float]:
    if store_path and Store.exists(store_path):
        return Store.open(store_path), store_path, 0.0
    store_path = store_path or os.path.join(
        tempfile.mkdtemp(prefix="cooc_store_"), "store"
    )
    c = synthetic_zipf_collection(docs, vocab=vocab, mean_len=40, seed=seed)
    t0 = time.perf_counter()
    if segment_version is not None:
        # pre-create so the manifest pins the segment format
        Store.create(store_path, c.vocab_size, segment_version=segment_version)
    store, seg = count_to_store(
        method, c, store_path, memory_budget_pairs=budget_pairs, device=device
    )
    build_s = time.perf_counter() - t0
    print(
        f"[build] {seg.nnz} pairs from {docs} docs via "
        f"{seg.meta.get('source', method)} in {build_s:.2f}s "
        f"({docs / build_s * 3600:.0f} docs/hour) -> {store_path} "
        f"(format v{store.segment_version})"
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
    device: str = "cuda",
    cache_rows: int = 4096,
    json_out: str | None = None,
    trace_out: str | None = None,
    store_format: str | None = None,
) -> dict:
    """Build/open a store and replay a Zipf workload through the in-process
    engine on ``device``; returns the stats dict (and writes it as JSON to
    ``json_out`` if given). ``store_format`` ("v1" raw / "v2" compressed)
    pins the segment format of a freshly built store.

    Example::

        stats = serve(store_path="/data/store", queries=2000, score="pmi")
        stats["topk_qps"], stats["topk_p99_ms"]
    """
    resolve_device(device)
    reg = obs.configure(enabled=True) if trace_out else obs.get_registry()
    segment_version = (
        None if store_format is None else int(store_format.lstrip("v"))
    )
    store, store_path, build_s = _build_or_open(
        docs, vocab, method, store_path, budget_pairs, seed, device,
        segment_version=segment_version,
    )
    served = _serve_inprocess(
        store, _zipf_sampler(store, seed), queries, batch, topk, score,
        device, seed, cache_rows=cache_rows,
    )
    stats = {
        "store": store_path,
        "store_format": f"v{store.segment_version}",
        "segments": len(store.segment_names),
        "num_docs": store.num_docs,
        "build_s": round(build_s, 2),
        "score": score,
        "batch": batch,
        "workers": 0,
        "device": str(device),
        **served,
    }
    if trace_out:
        build_stages = reg.stage_totals("ingest/")
        if build_stages:
            stats["build_stage_seconds"] = {
                name.split("/", 1)[1]: round(secs, 4)
                for name, secs in sorted(build_stages.items())
            }
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
        "--device", default="cuda",
        help="where kernels run: cuda (hand-written kernels) or cpu (their "
             "plain PyTorch versions)",
    )
    ap.add_argument(
        "--workers", type=int, default=0,
        help="must be 0 (in-process engine): multi-process serving is not "
             "ported yet",
    )
    ap.add_argument("--follow", default=None, metavar="FEED",
                    help="not ported yet (streaming ingest)")
    ap.add_argument("--compact", action="store_true",
                    help="not ported yet (background compaction)")
    ap.add_argument(
        "--cache-rows", type=int, default=4096,
        help="LRU row-cache capacity",
    )
    ap.add_argument("--json", default=None, help="also write stats JSON here")
    ap.add_argument(
        "--trace-out", default=None,
        help="write a Chrome trace_event JSON of driver-side spans here "
             "(enables telemetry)",
    )
    ap.add_argument(
        "--store-format", default=None, choices=["v1", "v2"],
        help="segment format for a freshly built store: v1 raw arrays, "
             "v2 block-compressed + bloom (identical queries)",
    )
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, used in (
        ("--workers", args.workers != 0),
        ("--follow", args.follow is not None),
        ("--compact", args.compact),
    ):
        if used:
            ap.error(
                f"{flag} is not ported to repro_torch yet: it comes with the "
                f"slice that ports {_LATER_SLICES[flag]}"
            )
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
        device=args.device,
        cache_rows=args.cache_rows,
        json_out=args.json,
        trace_out=args.trace_out,
        store_format=args.store_format,
    )


if __name__ == "__main__":
    main()
