"""End-to-end co-occurrence driver (the paper's pipeline, production shape).

    PYTHONPATH=src python -m repro_torch.launch.cooc_run --docs 20000 \\
        --vocab 50000 --method auto --out /tmp/cooc_out

Pipeline: synthetic corpus → preprocess (dedup/sort, df-descending IDs) →
CountJob → Planner (cost-model method selection with ``--method auto``,
sink policy) → PlanExecutor (document shards as independent work units
behind a WorkTracker: leases, straggler re-enqueue, idempotent completion;
per-shard exact counting; additive merge) → paper-format output + Table-1
stats.

Kernel methods run on ``--device``: ``cuda`` by default, where ``auto``
ranks ``list-scan-segment`` and, the IDs being df-descending,
``freq-split`` (its head Gram on the ``cooc_gram`` kernel, its tail on
``segment_hist``); ``cpu`` ranks the paper methods and ``freq-split``, as
the reference package's driver does, and runs kernel methods through the
plain PyTorch versions of their kernels.

Every run is **exact**, whatever the vocabulary size: small vocabularies
merge through a dense accumulator, larger ones spill per-shard sorted runs
and k-way-merge them within the memory budget (the result dict's
``"exact"`` field records the guarantee).

Checkpoint/restart: tracker + accumulator state are checkpointed every 4
completed shards (spill runs persist on disk per shard); ``--resume``
continues a killed run without recounting finished shards.

Telemetry (off by default; see docs/observability.md): ``--trace-out FILE``
enables the obs registry and writes the run's span tree as a Chrome
``trace_event`` JSON — with ``--output store`` the trace holds all five
ingest stages (count, spill, bucket_merge, segment_write, refresh).
``--metrics-interval S`` dumps a Prometheus-text metrics snapshot to stderr
every S seconds while the run executes. Either flag also adds a per-stage
``stage_seconds`` breakdown to result.json.

``--ingest-workers N > 1`` counts the spill shards in N spawned worker
processes (``ParallelExecutor``): byte-identical to the serial run. On the
card the kernels are built once here; each worker counts in its own CUDA
context, and the result carries each worker's device, start-up seconds and
kernel launches (``per_worker``) beside ``ready_wait_s``, ``count_s`` and
``finalize_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

from repro_torch import obs
from repro_torch.core.plan import CountJob, ParallelExecutor, Planner
from repro_torch.data.corpus import collection_stats, synthetic_zipf_collection
from repro_torch.data.preprocess import remap_df_descending
from repro_torch.device import resolve_device


def run(
    num_docs: int = 20_000,
    vocab: int = 50_000,
    method: str = "auto",
    num_shards: int = 16,
    out_dir: str = "/tmp/cooc_out",
    ckpt_every: int = 4,
    resume: bool = False,
    dense_vocab_cap: int = 4096,
    memory_budget_pairs: int = 4 << 20,
    output: str = "pairs-file",
    trace_out: str | None = None,
    metrics_interval: float = 0.0,
    device: str = "cuda",
    ingest_workers: int = 1,
) -> dict:
    """Count a Zipf collection of ``num_docs`` documents over ``vocab`` terms
    (``mean_len=60``, seed 0), remapped to df-descending IDs, into
    ``out_dir`` (``pairs.bin`` or ``store/``, plus ``result.json``). Returns
    the run's summary dict.

    Example::

        run(2000, 4096, out_dir="/tmp/cooc_out", device="cpu")
    """
    resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    telemetry = bool(trace_out) or metrics_interval > 0
    reg = obs.configure(enabled=True) if telemetry else obs.get_registry()
    c = synthetic_zipf_collection(num_docs, vocab=vocab, mean_len=60, seed=0)
    cd, _ = remap_df_descending(c)
    print(f"[corpus] {collection_stats(cd)}")

    out_path = os.path.join(
        out_dir, "store" if output == "store" else "pairs.bin"
    )
    job = CountJob(
        collection=cd,
        output=output,
        method=method,
        out_path=out_path,
        num_shards=num_shards,
        dense_vocab_cap=dense_vocab_cap,
        memory_budget_pairs=memory_budget_pairs,
        df_descending=True,   # remap_df_descending above
        device=device,
    )
    plan = Planner().plan(job)
    print(
        f"[plan] method={plan.method} sink={plan.sink_policy} "
        f"exact={plan.exact} ranking={plan.describe()['ranking']}"
    )

    stop_metrics = threading.Event()

    def _dump_metrics():
        while not stop_metrics.wait(metrics_interval):
            print(reg.prometheus_text(), file=sys.stderr, flush=True)

    dumper = None
    if metrics_interval > 0:
        dumper = threading.Thread(target=_dump_metrics, daemon=True)
        dumper.start()
    try:
        if ingest_workers > 1:
            # spawned spill-shard workers behind a shared lease tracker;
            # byte-identical output to the serial path
            res = ParallelExecutor(num_workers=ingest_workers).execute(
                plan, out_dir=out_dir, resume=resume
            )
        else:
            res = plan.execute(
                out_dir=out_dir, ckpt_every=ckpt_every, resume=resume
            )
    finally:
        stop_metrics.set()
        if dumper is not None:
            dumper.join(timeout=5)

    result = res.summary
    result["device"] = str(device)
    if telemetry:
        result["stage_seconds"] = {
            name.split("/", 1)[1]: round(secs, 4)
            for name, secs in sorted(reg.stage_totals("ingest/").items())
        }
        if trace_out:
            reg.write_trace(trace_out)
            print(f"[trace] {len(reg.span_events())} spans -> {trace_out}")
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(f"[done] {result}")
    return result


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--out", default="/tmp/cooc_out")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--budget-pairs", type=int, default=4 << 20)
    ap.add_argument(
        "--output", default="pairs-file", choices=["pairs-file", "store"],
        help="paper-format pairs file, or a queryable CSR store "
             "(store runs exercise all five ingest stages)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where kernel methods run: cuda (hand-written kernels) or cpu "
             "(their plain PyTorch versions); also what --method auto ranks",
    )
    ap.add_argument(
        "--trace-out", default=None,
        help="write a Chrome trace_event JSON of the run's spans here "
             "(enables telemetry)",
    )
    ap.add_argument(
        "--metrics-interval", type=float, default=0.0,
        help="dump Prometheus-text metrics to stderr every S seconds "
             "(enables telemetry)",
    )
    ap.add_argument(
        "--ingest-workers", type=int, default=1,
        help="count spill shards across N spawned worker processes "
             "(byte-identical to serial; each worker on --device)",
    )
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ingest_workers < 1:
        ap.error("--ingest-workers must be at least 1")
    run(
        args.docs,
        args.vocab,
        args.method,
        args.shards,
        args.out,
        resume=args.resume,
        memory_budget_pairs=args.budget_pairs,
        output=args.output,
        trace_out=args.trace_out,
        metrics_interval=args.metrics_interval,
        device=args.device,
        ingest_workers=args.ingest_workers,
    )


if __name__ == "__main__":
    main()
