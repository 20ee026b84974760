"""Counting plans: typed jobs → cost-model planning → one execution path.

This is the single entry point every driver and the store builder share:

    job  = CountJob(collection=c, output="pairs-file", out_path=...,
                    method="auto", num_shards=16)
    plan = Planner().plan(job)        # cost models pick the method + sinks
    res  = plan.execute(out_dir=...)  # sharded, checkpointed, exact

``Planner`` selects the counting method with the §3 cost models over
:class:`CollectionStats` (``method="auto"``), and selects the merge policy:

* **dense**  — vocab ≤ ``dense_vocab_cap``: per-shard DenseSink, additive
  dense accumulator (exact);
* **spill**  — larger vocabularies: per-shard SpillSink runs on disk,
  k-way-merged exactly at finalization within O(memory budget) — replacing
  the old lossy "StatsSink upper bound across shards" fallback of
  ``launch/cooc_run``;
* **stats**  — only when the job explicitly opts out of exactness
  (``exact=False`` with ``output="stats"``): per-shard aggregate statistics,
  ``distinct_pairs`` becomes an upper bound.

``PlanExecutor`` owns the shard/merge orchestration: WorkTracker leases
with straggler re-enqueue, idempotent completion, and the final merge into
the requested output target (``dense`` | ``stats`` | ``pairs-file`` |
``store``). This package has the serial executor only; checkpoint/resume
(``ckpt_every``, ``resume``) and the multi-process ``ParallelExecutor`` are
not ported yet and raise ``NotImplementedError``.

``CountJob.device`` is where methods with a ``device`` parameter (the
``gpu`` kind, e.g. ``list-scan-segment``) run their kernels: ``"cuda"`` by
default, ``"cpu"`` for the plain PyTorch path. It also picks what
``method="auto"`` ranks: the ``gpu`` kind on a CUDA device, the host kind
on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.specs import REGISTRY, MethodSpec, get_spec
from repro_torch.core.types import DenseSink, FileSink, StatsSink
from repro_torch.data.corpus import Collection, CollectionStats

OUTPUTS = ("dense", "stats", "pairs-file", "store")
SINK_POLICIES = ("dense", "spill", "stats")


# ---------------------------------------------------------------------------
# CountJob
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CountJob:
    """A validated counting request (what to count, how exact, where to).

    Validation happens at construction: unknown outputs, missing paths,
    ill-typed method kwargs, and df-order prerequisites all raise here, not
    halfway through a multi-hour run.

    Example::

        job = CountJob(collection=c, output="store", out_path="/data/store",
                       method="auto", num_shards=8)
        res = Planner().plan(job).execute()
    """

    collection: Collection
    output: str = "stats"                  # dense | stats | pairs-file | store
    method: str = "auto"                   # registry name or "auto"
    out_path: str | None = None            # pairs-file path / store directory
    exact: bool = True                     # False permits the stats fast path
    memory_budget_pairs: int = 4 << 20     # spill budget (buffered pairs)
    num_shards: int = 1
    dense_vocab_cap: int = 4096            # dense-merge threshold
    device: str = "cuda"                   # where gpu-kind methods run
    method_kwargs: Mapping = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.collection, Collection):
            raise ValueError(
                f"collection must be a Collection, got {type(self.collection).__name__}"
            )
        if self.output not in OUTPUTS:
            raise ValueError(f"unknown output {self.output!r}; have {OUTPUTS}")
        if self.output in ("pairs-file", "store") and not self.out_path:
            raise ValueError(f"output={self.output!r} requires out_path")
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.memory_budget_pairs < 1:
            raise ValueError("memory_budget_pairs must be >= 1")
        if self.dense_vocab_cap < 1:
            raise ValueError("dense_vocab_cap must be >= 1")
        if self.method == "auto":
            if self.method_kwargs:
                raise ValueError(
                    "method_kwargs requires an explicit method "
                    "(auto-selected methods run with planner-resolved params)"
                )
        else:
            try:
                spec = get_spec(self.method)
            except KeyError as e:
                raise ValueError(str(e)) from None
            try:
                spec.validate_kwargs(self.method_kwargs)
            except (TypeError, ValueError) as e:
                raise ValueError(f"invalid method_kwargs: {e}") from None


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable counting plan (what the Planner decided, and why).

    Carries full provenance: the chosen method and kwargs, the sink/merge
    policy, cost estimates, and the complete candidate ranking — so a
    driver can log *why* this method ran (``describe()``) and a benchmark
    can compare the model against measured time.

    Example::

        plan = Planner().plan(job)
        plan.method, plan.sink_policy       # ('list-scan', 'spill')
        plan.describe()["ranking"]          # best-first (method, cost) pairs
        res = plan.execute(out_dir="/tmp/run")
    """

    job: CountJob
    method: str
    method_kwargs: Mapping
    sink_policy: str                       # dense | spill | stats
    exact: bool
    estimated_cost: float                  # cost-model work units
    estimated_method_bytes: float          # method working-set estimate
    collection_stats: CollectionStats
    ranking: tuple = ()                    # ((method, cost), ...) best-first

    @property
    def spec(self) -> MethodSpec:
        return REGISTRY[self.method]

    def describe(self) -> dict:
        """JSON-serializable provenance, embedded in driver results."""
        return {
            "method": self.method,
            "method_kwargs": {k: v for k, v in self.method_kwargs.items()},
            "sink_policy": self.sink_policy,
            "exact": self.exact,
            "estimated_cost": round(float(self.estimated_cost), 1),
            "estimated_method_mb": round(self.estimated_method_bytes / 2**20, 2),
            "ranking": [(m, round(float(c), 1)) for m, c in self.ranking],
        }

    def execute(self, **kwargs) -> "ExecutionResult":
        return PlanExecutor().execute(self, **kwargs)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


class Planner:
    """Turns a CountJob into a Plan using the MethodSpec cost models.

    ``method="auto"`` ranks, by their §3 cost models over the collection's
    statistics, the methods that run where the job runs: the ``gpu`` kind
    on a CUDA device (the default), the host (``paper``) kind with
    ``device="cpu"``. An explicit method skips ranking but still gets
    validated kwargs and a merge policy.

    Example::

        plan = Planner().plan(CountJob(collection=c, output="stats"))
        plan.method                         # 'list-scan-segment' (on cuda)
        plan.ranking[0][0] == plan.method   # best-ranked method won
    """

    def __init__(self, registry: Mapping[str, MethodSpec] = REGISTRY):
        self.registry = registry

    def candidates(self, job: CountJob) -> list[MethodSpec]:
        if job.method != "auto":
            return [self.registry[job.method]]
        kind = "paper" if torch.device(job.device).type == "cpu" else "gpu"
        return [spec for spec in self.registry.values() if spec.kind == kind]

    def resolve_kwargs(
        self, spec: MethodSpec, job: CountJob, stats: CollectionStats
    ) -> dict:
        """Spec defaults + job overrides + planner-tuned knobs."""
        kw = spec.resolve_kwargs(job.method_kwargs if job.method != "auto" else None)
        if "device" in kw and "device" not in job.method_kwargs:
            kw["device"] = job.device
        return kw

    def rank(
        self, job: CountJob, stats: CollectionStats | None = None
    ) -> list[tuple[float, str, dict]]:
        """All candidate methods as (cost, name, resolved_kwargs), best first."""
        stats = stats or CollectionStats.from_collection(job.collection)
        ranked = []
        for spec in self.candidates(job):
            kw = self.resolve_kwargs(spec, job, stats)
            ranked.append((float(spec.cost(stats, kw)), spec.name, kw))
        ranked.sort(key=lambda t: (t[0], t[1]))
        return ranked

    def sink_policy(self, job: CountJob) -> str:
        if job.output == "dense":
            return "dense"
        V = job.collection.vocab_size
        # dense merge only if the V×V int64 accumulator fits the declared
        # memory budget (~16 bytes per buffered spill pair)
        if V <= job.dense_vocab_cap and 8 * V * V <= 16 * job.memory_budget_pairs:
            return "dense"
        if job.output == "stats" and not job.exact:
            return "stats"
        return "spill"

    def plan(self, job: CountJob) -> Plan:
        stats = CollectionStats.from_collection(job.collection)
        ranked = self.rank(job, stats)
        cost, name, kwargs = ranked[0]
        policy = self.sink_policy(job)
        spec = self.registry[name]
        return Plan(
            job=job,
            method=name,
            method_kwargs=kwargs,
            sink_policy=policy,
            exact=policy != "stats",
            estimated_cost=cost,
            estimated_method_bytes=float(spec.memory_bytes(stats, kwargs)),
            collection_stats=stats,
            ranking=tuple((n, c) for c, n, _ in ranked),
        )


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecutionResult:
    """What a plan produced. ``summary`` is JSON-serializable; the heavier
    artifacts ride alongside depending on the job's output target.

    Example::

        res = plan.execute()
        res.summary["exact"], res.summary["distinct_pairs"]
        res.store     # output="store": an open repro_torch.store.Store
        res.counts    # output="dense": strict-upper int64 matrix
    """

    summary: dict
    counts: np.ndarray | None = None       # output="dense" (strict upper)
    pairs_path: str | None = None          # output="pairs-file"
    store: object | None = None            # output="store" (repro_torch.store.Store)
    segment: object | None = None          # output="store" (CSRSegment)


class PlanExecutor:
    """Shard/merge orchestration shared by every driver.

    Work units are document shards behind a WorkTracker (leases, straggler
    re-enqueue, idempotent completion). The merge strategy follows the plan's
    sink policy. Checkpoint/resume is not ported yet: ``ckpt_every > 0`` or
    ``resume=True`` raises ``NotImplementedError``.

    Example::

        res = PlanExecutor().execute(plan, out_dir="/tmp/run")
    """

    def __init__(self, worker: str = "worker0"):
        self.worker = worker

    # ------------------------------------------------------------------
    def execute(
        self,
        plan: Plan,
        *,
        out_dir: str | None = None,
        ckpt_every: int = 0,
        resume: bool = False,
    ) -> ExecutionResult:
        if ckpt_every > 0 or resume:
            raise NotImplementedError(
                "checkpoint/resume is not ported to repro_torch yet "
                "(ckpt_every > 0 or resume=True)"
            )
        # warm the lazy imports before the root span opens: first-use import
        # cost (sharding, sinks) is process setup, not ingest stage time —
        # with it inside the span, a fresh process's stage spans could not
        # tile the root span's wall time
        from repro_torch.data import preprocess  # noqa: F401
        from repro_torch.runtime import fault  # noqa: F401
        from repro_torch.store import builder  # noqa: F401

        # the root ingest span: every stage span (count/spill/bucket_merge/
        # segment_write/refresh — see docs/observability.md) nests under it,
        # so a trace shows where one run's wall time went
        with obs.get_registry().span(
            "ingest/execute",
            method=plan.method,
            sink=plan.sink_policy,
            output=plan.job.output,
            shards=plan.job.num_shards,
            docs=plan.job.collection.num_docs,
        ):
            return self._execute(plan, out_dir=out_dir)

    def _execute(self, plan: Plan, *, out_dir: str | None) -> ExecutionResult:
        from repro_torch.data.preprocess import shard_documents
        from repro_torch.runtime.fault import WorkTracker
        from repro_torch.store.builder import SpillSink

        job = plan.job
        c = job.collection
        V = c.vocab_size
        own_workdir = out_dir is None
        workdir = out_dir or tempfile.mkdtemp(prefix="cooc_plan_")
        os.makedirs(workdir, exist_ok=True)
        spill_root = os.path.join(workdir, "spill")
        t0 = time.time()

        dense = plan.sink_policy == "dense"
        spill = plan.sink_policy == "spill"
        shards = shard_documents(c, job.num_shards)
        tracker = WorkTracker([(s,) for s in range(job.num_shards)])
        acc = np.zeros((V, V), dtype=np.int64) if dense else None
        agg = {"distinct_pairs": 0, "total_count": 0, "output_bytes": 0}

        if spill:
            # only this run's shards may contribute run files
            shutil.rmtree(spill_root, ignore_errors=True)

        reg = obs.get_registry()
        while not tracker.finished:
            unit = tracker.claim(self.worker, time.monotonic())
            if unit is None:
                tracker.expire(time.monotonic())
                continue
            (s,) = unit
            # per-shard count span: covers sink setup (the spill buffers are
            # a real allocation), produce, AND the completion flush, with
            # nested ingest/spill spans (mid-count and flush-time) — its
            # inclusive time is the shard's whole cost before merging
            with reg.span(
                "ingest/count", shard=s, method=plan.method,
                docs=shards[s].num_docs,
            ):
                if dense:
                    sink = DenseSink(V)
                elif spill:
                    shard_dir = os.path.join(spill_root, f"shard_{s:05d}")
                    if os.path.isdir(shard_dir):
                        shutil.rmtree(shard_dir)  # partials from a dead lease
                    sink = SpillSink(
                        V,
                        memory_budget_pairs=job.memory_budget_pairs,
                        spill_dir=shard_dir,
                    )
                else:
                    sink = StatsSink()
                plan.spec.fn(shards[s], sink, **plan.method_kwargs)
                if tracker.complete(unit, self.worker):
                    if dense:
                        acc += sink.mat
                    elif spill:
                        sink.flush()  # run files persist: the checkpoint
                    else:
                        agg["distinct_pairs"] += sink.distinct_pairs  # upper
                        agg["total_count"] += sink.total_count
                        agg["output_bytes"] += sink.output_bytes
            reg.counter("ingest.docs_counted").inc(shards[s].num_docs)
            reg.counter("ingest.shards_done").inc()

        elapsed = time.time() - t0
        summary = {
            "num_docs": c.num_docs,
            "vocab_size": V,
            "method": plan.method,
            "output": job.output,
            "num_shards": job.num_shards,
            "exact": plan.exact,
            "elapsed_s": round(elapsed, 2),
            "docs_per_hour": round(c.num_docs / max(elapsed, 1e-9) * 3600),
            "plan": plan.describe(),
        }
        result = ExecutionResult(summary=summary)

        if dense:
            self._finalize_dense(plan, np.triu(acc, 1), workdir, result)
        elif spill:
            self._finalize_spill(plan, spill_root, result)
        else:
            summary["total_count"] = agg["total_count"]  # additive → exact
            summary["distinct_pairs_upper_bound"] = agg["distinct_pairs"]
            summary["output_bytes_upper_bound"] = agg["output_bytes"]

        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return result

    # ------------------------------------------------------------------
    def _finalize_dense(
        self, plan: Plan, upper: np.ndarray, workdir: str, result: ExecutionResult
    ) -> None:
        from repro_torch.core.stats import top_k_pairs

        job = plan.job
        summary = result.summary
        summary["distinct_pairs"] = int((upper > 0).sum())
        summary["total_count"] = int(upper.sum())
        summary["top_pairs"] = top_k_pairs(upper, 5)
        if job.output == "dense" or job.output == "stats":
            result.counts = upper
        if job.output == "pairs-file":
            with obs.get_registry().span("ingest/pairs_write"), FileSink(
                job.out_path
            ) as sink:
                for primary, secs, cnts in _dense_rows(upper):
                    sink.emit_row(primary, secs, cnts)
            result.pairs_path = job.out_path
        elif job.output == "store":
            _write_store(plan, _dense_rows(upper), result)

    def _finalize_spill(
        self, plan: Plan, spill_root: str, result: ExecutionResult
    ) -> None:
        from repro_torch.store.builder import (
            _iter_run,
            discover_bucket_runs,
            merge_bucket_runs,
            merge_row_streams,
        )

        job = plan.job
        # bucket runs (run_<spill>_b<bucket>.bin) cover disjoint ascending
        # primary ranges: merge bucket by bucket — in memory when the bucket
        # fits the merge cap, via a heap spanning only that bucket's runs
        # across shards otherwise — never a global k-way over every run file
        by_bucket, legacy = discover_bucket_runs(spill_root)
        if legacy:
            # unbucketed runs span the whole primary range: only a global
            # k-way merge is order-correct for them
            merged = merge_row_streams([_iter_run(p) for p in by_bucket[-1]])
        else:
            merged = merge_bucket_runs(
                by_bucket, plan.job.collection.vocab_size,
                cap_pairs=4 * job.memory_budget_pairs,
            )
        _emit_merged_rows(plan, merged, result)
        # run files are kept in user-provided out_dirs; temp workdirs are
        # removed wholesale by execute()


def _dense_rows(upper: np.ndarray):
    """(primary, secondaries, counts) rows of a strict-upper dense matrix."""
    for i in range(upper.shape[0]):
        nz = np.nonzero(upper[i])[0]
        if len(nz):
            yield i, nz, upper[i][nz]


def _emit_merged_rows(plan: Plan, merged, result: ExecutionResult) -> None:
    """Drive the fully merged row stream into the job's output target,
    tallying exact distinct-pair/total counts on the way through."""
    job = plan.job
    tally = {"distinct_pairs": 0, "total_count": 0}

    def tallied(rows):
        for primary, secs, cnts in rows:
            tally["distinct_pairs"] += len(secs)
            tally["total_count"] += int(cnts.sum())
            yield primary, secs, cnts

    if job.output == "pairs-file":
        with obs.get_registry().span("ingest/pairs_write"), FileSink(
            job.out_path
        ) as sink:
            for primary, secs, cnts in tallied(merged):
                sink.emit_row(primary, secs, cnts)
        result.pairs_path = job.out_path
    elif job.output == "store":
        _write_store(plan, tallied(merged), result)
    else:  # exact stats via the same merge, no materialization
        for _ in tallied(merged):
            pass
    result.summary["distinct_pairs"] = tally["distinct_pairs"]
    result.summary["total_count"] = tally["total_count"]


def _write_store(plan: Plan, rows, result: ExecutionResult) -> None:
    from repro_torch.store import Store

    job = plan.job
    c = job.collection
    if Store.exists(job.out_path):
        store = Store.open(job.out_path)
        if store.vocab_size != c.vocab_size:
            raise ValueError(
                f"store vocab {store.vocab_size} != collection vocab "
                f"{c.vocab_size}"
            )
    else:
        store = Store.create(job.out_path, c.vocab_size)
    # a second handle opened before the commit: the refresh span below
    # measures visibility — the time until an independent (serving-side)
    # reader observes the new segment, exactly what ingest_bench gates
    reader = Store.open(job.out_path)
    df = np.bincount(c.terms, minlength=c.vocab_size).astype(np.int64)
    seg = store.add_segment_from_rows(
        rows, df=df, num_docs=c.num_docs, source=f"plan:{plan.method}",
    )
    with obs.get_registry().span("ingest/refresh") as sp:
        sp.set(visible=reader.refresh())
    result.store = store
    result.segment = seg
    result.summary.setdefault("distinct_pairs", int(seg.nnz))
    result.summary["segment"] = os.path.basename(seg.path)


# ---------------------------------------------------------------------------
# one-call convenience
# ---------------------------------------------------------------------------


def execute_job(job: CountJob, **execute_kwargs) -> ExecutionResult:
    """Plan + execute in one call (drivers that don't inspect the plan).

    Example::

        res = execute_job(CountJob(collection=c, output="dense"))
        res.counts.sum()    # total co-occurrence mass, exactly
    """
    return Planner().plan(job).execute(**execute_kwargs)
