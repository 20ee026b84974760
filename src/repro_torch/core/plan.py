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
with straggler re-enqueue, idempotent completion, checkpoint/resume every
``ckpt_every`` shards (for the spill policy the on-disk run files double as
checkpoint state), and the final merge into the requested output target
(``dense`` | ``stats`` | ``pairs-file`` | ``store``). ``ParallelExecutor``
counts the spill policy's shards across spawned worker processes behind a
shared lease table and merges the buckets in a process pool, to the same
bytes as the serial executor; on the card each worker counts in its own
CUDA context with the kernels the parent built.

``CountJob.device`` is where methods with a ``device`` parameter (every kind
but ``paper``) run their kernels: ``"cuda"`` by default, ``"cpu"`` for the
plain PyTorch path. It also picks what ``method="auto"`` ranks
(:meth:`Planner.candidates`): on the CPU the paper methods, as the
reference package does; on a CUDA device ``list-scan-segment``; on either,
``freq-split`` as well when ``df_descending``.
"""

from __future__ import annotations

import dataclasses
import glob
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
    df_descending: bool = False            # term IDs are df-descending
    device: str = "cuda"                   # where kernel methods run
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
        if torch.device(self.device).type not in RANKED_KINDS:
            raise ValueError(f"unsupported device {self.device!r}; have 'cuda', 'cpu'")
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
            if spec.needs_df_descending and not self.df_descending:
                raise ValueError(
                    f"method {self.method!r} requires df-descending term IDs "
                    "(remap with data.preprocess.remap_df_descending and set "
                    "df_descending=True)"
                )


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
        res = plan.execute(out_dir="/tmp/run", ckpt_every=4)
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

# the kinds ``method="auto"`` ranks, by device type (``opt-in`` never)
RANKED_KINDS = {"cpu": ("paper", "hybrid"), "cuda": ("gpu", "hybrid")}


class Planner:
    """Turns a CountJob into a Plan using the MethodSpec cost models.

    ``method="auto"`` ranks, by their §3 cost models over the collection's
    statistics, the methods of the job's device (``RANKED_KINDS``): the
    paper methods with ``device="cpu"`` (the reference package's own
    candidates), ``list-scan-segment`` on a CUDA device (the default), and
    on either ``freq-split`` when the job's term IDs are df-descending. The
    ``opt-in`` kernel adaptations are never ranked. An explicit method skips
    ranking but still gets validated kwargs and a merge policy.

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
        kinds = RANKED_KINDS[torch.device(job.device).type]
        return [
            spec for spec in self.registry.values()
            if spec.kind in kinds
            and (job.df_descending or not spec.needs_df_descending)
        ]

    def resolve_kwargs(
        self, spec: MethodSpec, job: CountJob, stats: CollectionStats
    ) -> dict:
        """Spec defaults + job overrides + planner-tuned knobs."""
        kw = spec.resolve_kwargs(job.method_kwargs if job.method != "auto" else None)
        if "head" in kw and job.method == "auto":
            kw["head"] = min(kw["head"], stats.vocab_size)
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
    sink policy; checkpoint/resume works for all of them — under the spill
    policy, completed shards' sorted run files in ``out_dir/spill/`` *are*
    the bulk checkpoint state, so only tracker + aggregate dicts go through
    the checkpointer (``repro_torch.checkpoint``).

    Example::

        res = PlanExecutor().execute(plan, out_dir="/tmp/run", ckpt_every=4)
        # later, after a crash:
        res = PlanExecutor().execute(plan, out_dir="/tmp/run", resume=True)
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
        # warm the lazy imports before the root span opens: first-use import
        # cost (checkpoint machinery, sharding, sinks) is process setup, not
        # ingest stage time — with it inside the span, a fresh process's
        # stage spans could not tile the root span's wall time
        from repro_torch import checkpoint  # noqa: F401
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
            resume=resume,
        ):
            return self._execute(
                plan, out_dir=out_dir, ckpt_every=ckpt_every, resume=resume
            )

    def _execute(
        self,
        plan: Plan,
        *,
        out_dir: str | None,
        ckpt_every: int,
        resume: bool,
    ) -> ExecutionResult:
        from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
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
        ckpt_dir = os.path.join(workdir, "ckpt")
        t0 = time.time()

        dense = plan.sink_policy == "dense"
        spill = plan.sink_policy == "spill"
        shards = shard_documents(c, job.num_shards)
        tracker = WorkTracker([(s,) for s in range(job.num_shards)])
        acc = np.zeros((V, V), dtype=np.int64) if dense else None
        agg = {"distinct_pairs": 0, "total_count": 0, "output_bytes": 0}

        step0 = latest_step(ckpt_dir) if resume else None
        if step0 is not None:
            like = {"acc": acc} if dense else {"acc": np.zeros(1)}
            restored, extra = restore_checkpoint(ckpt_dir, step0, like)
            if dense:
                acc = np.array(restored["acc"])  # writable copy
            agg = extra["agg"]
            tracker = WorkTracker.from_state(extra["tracker"])
        if spill:
            # Only completed shards of THIS run may contribute run files: a
            # fresh run wipes the spill root; a resumed run prunes directories
            # that don't correspond to a completed shard (e.g. left by an
            # earlier run with different sharding in the same out_dir).
            if step0 is None:
                shutil.rmtree(spill_root, ignore_errors=True)
            else:
                done_ids = {u[0] for u in tracker.done}
                for d in glob.glob(os.path.join(spill_root, "shard_*")):
                    idx = int(os.path.basename(d).split("_")[1])
                    if idx not in done_ids or idx >= job.num_shards:
                        shutil.rmtree(d, ignore_errors=True)

        reg = obs.get_registry()
        done_since_ckpt = 0
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
                    done_since_ckpt += 1
            reg.counter("ingest.docs_counted").inc(shards[s].num_docs)
            reg.counter("ingest.shards_done").inc()
            if ckpt_every and done_since_ckpt >= ckpt_every:
                save_checkpoint(
                    ckpt_dir,
                    len(tracker.done),
                    {"acc": acc if dense else np.zeros(1)},
                    extra={"agg": agg, "tracker": tracker.state()},
                )
                done_since_ckpt = 0

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
        # run files are deliberately kept in user-provided out_dirs: together
        # with the tracker checkpoint they make the run resumable even across
        # a crash during (or after) this merge; temp workdirs are removed
        # wholesale by execute().


def _dense_rows(upper: np.ndarray):
    """(primary, secondaries, counts) rows of a strict-upper dense matrix."""
    for i in range(upper.shape[0]):
        nz = np.nonzero(upper[i])[0]
        if len(nz):
            yield i, nz, upper[i][nz]


def _emit_merged_rows(
    plan: Plan, merged, result: ExecutionResult,
    *, single_commit: bool = False,
) -> None:
    """Drive the fully merged row stream into the job's output target,
    tallying exact distinct-pair/total counts on the way through (shared by
    the serial and parallel finalize paths — their byte-identity contract
    ends here, at the same writer over the same rows)."""
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
        _write_store(
            plan, tallied(merged), result, single_commit=single_commit
        )
    else:  # exact stats via the same merge, no materialization
        for _ in tallied(merged):
            pass
    result.summary["distinct_pairs"] = tally["distinct_pairs"]
    result.summary["total_count"] = tally["total_count"]


def _write_store(
    plan: Plan, rows, result: ExecutionResult,
    *, single_commit: bool = False,
) -> None:
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
        single_commit=single_commit,
    )
    with obs.get_registry().span("ingest/refresh") as sp:
        sp.set(visible=reader.refresh())
    result.store = store
    result.segment = seg
    result.summary.setdefault("distinct_pairs", int(seg.nnz))
    result.summary["segment"] = os.path.basename(seg.path)


# ---------------------------------------------------------------------------
# parallel ingest (spawned spill-shard workers + parallel bucket merge)
# ---------------------------------------------------------------------------

# below this much total run data the bucket-merge pool isn't spawned at all:
# a fresh spawned interpreter costs ~0.5s before its first merge, which only
# amortizes once the merge work is tens of MB
_POOL_MIN_MERGE_BYTES = 48 << 20


def _maybe_stall(workdir: str, worker: str, shard: int) -> None:
    """Test-only injection point: ``REPRO_TEST_SPILL_STALL`` (a JSON object
    ``{"worker": .., "shard": .., "seconds": ..}``) makes the matching worker
    publish its pid to ``workdir/stall_<worker>.pid`` and sleep mid-shard —
    after counting, before the completing flush — so a fault test can SIGKILL
    it while it verifiably holds a lease with unpromoted spill output. It
    fires once a run: once a marker is published, no worker stalls again,
    so the survivor that reclaims a ``"shard"``-armed stall's shard counts
    it straight through."""
    spec = os.environ.get("REPRO_TEST_SPILL_STALL")
    if not spec:
        return
    import json

    cfg = json.loads(spec)
    if cfg.get("worker") is not None and cfg["worker"] != worker:
        return
    if cfg.get("shard") is not None and int(cfg["shard"]) != shard:
        return
    if glob.glob(os.path.join(workdir, "stall_*.pid")):
        return
    marker = os.path.join(workdir, f"stall_{worker}.pid")
    with open(marker + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(marker + ".tmp", marker)
    deadline = time.time() + float(cfg.get("seconds", 60.0))
    while time.time() < deadline:
        time.sleep(0.05)


def _spill_claim_loop(
    tracker, spill_root, shards, method_name, fn, kwargs, V, budget_pairs,
    worker, reg, workdir,
) -> int:
    """Claim → count → promote loop one participant runs against the shared
    tracker (spawned workers and the parent's inline drain share it).
    Returns how many shards this participant completed.

    Each claimed shard is counted into a private ``wip_<worker>_<shard>``
    directory (invisible to run discovery) while a heartbeat thread renews
    the lease; the finished directory is promoted to ``shard_<shard>`` by an
    atomic rename executed *under the tracker lock* as the completion's
    commit — so a promoted directory and its done-record are never observed
    apart, and a lost race (a backup task finished first) just discards the
    duplicate attempt. An exception (a :class:`DeviceError` from the card
    included) propagates: the participant stops, and its lease expires."""
    import threading

    from repro_torch.store.builder import SpillSink, shard_dir_name, wip_dir_name

    lease = tracker.lease_seconds
    completed = 0
    while True:
        unit = tracker.claim(worker)
        if unit is None:
            if tracker.finished:
                return completed
            # another worker holds the last lease(s): wait for completion or
            # expiry (claim() reclaims expired leases on the next attempt)
            time.sleep(min(0.2, lease / 4.0))
            continue
        (s,) = unit
        wip = os.path.join(spill_root, wip_dir_name(s, worker))
        shutil.rmtree(wip, ignore_errors=True)
        stop = threading.Event()

        def _heartbeat(unit=unit):
            while not stop.wait(lease / 3.0):
                if not tracker.renew(unit, worker):
                    return  # lease lost: completion would be ignored anyway

        hb = threading.Thread(target=_heartbeat, daemon=True)
        hb.start()
        try:
            with reg.span(
                "ingest/count", shard=s, method=method_name,
                docs=int(shards[s].num_docs), worker=worker,
            ):
                sink = SpillSink(
                    V, memory_budget_pairs=budget_pairs, spill_dir=wip
                )
                fn(shards[s], sink, **kwargs)
                _maybe_stall(workdir, worker, s)
                sink.flush()
        finally:
            stop.set()
            hb.join(timeout=lease)
        final = os.path.join(spill_root, shard_dir_name(s))

        def _promote(wip=wip, final=final):
            shutil.rmtree(final, ignore_errors=True)
            os.replace(wip, final)

        if tracker.complete(unit, worker, commit=_promote):
            reg.counter("ingest.docs_counted").inc(int(shards[s].num_docs))
            reg.counter("ingest.shards_done").inc()
            completed += 1
        else:
            shutil.rmtree(wip, ignore_errors=True)  # backup task lost


def _dump_json(obj, directory: str, name: str) -> None:
    """Write ``obj`` to ``directory/<name>.json`` via an atomic rename."""
    import json

    path = os.path.join(directory, f"{name}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _dump_obs(reg, obs_dir: str, name: str) -> None:
    """Persist a worker's full telemetry snapshot (metrics + span events)
    for the parent to absorb into one cross-process trace."""
    _dump_json(reg.snapshot(include_events=True), obs_dir, name)


def _warm_device(device: str | None) -> str:
    """Resolve a worker's device in the child and, on the card, create its
    CUDA context and load the kernels the parent built. ``None`` (a paper
    method, which has no device) counts on the host. Raises
    :class:`DeviceError` without a card: the worker then dies, never
    counting on the host."""
    if device is None:
        return "cpu"
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build, ops

        torch.zeros(1, device=dev)
        _build.build_all(ops.KERNELS)
    return str(dev)


def _spill_worker_main(workdir, worker, params, telemetry, ready_sem,
                       start_evt) -> None:
    """Spawn entry point for one parallel spill worker.

    The corpus arrives via ``workdir/corpus.npz`` (not pickled args — spawn
    re-imports everything anyway, and the file is shared by all workers);
    sharding is recomputed locally and is deterministic, so every process
    agrees on shard boundaries. The worker's device (the plan's
    ``method_kwargs["device"]``) resolves here, in the child, and is warmed
    before the worker reports ready. The ready semaphore / start event pair
    lets the parent exclude per-process setup (imports, the CUDA context,
    corpus load) from steady-state timing. At exit the worker writes
    ``workdir/workers/<worker>.json``: its device, its own kernel launches
    (launch counters are per process), shards completed, when it was ready
    and its counting seconds."""
    from repro_torch.core.specs import get_spec
    from repro_torch.data.corpus import Collection
    from repro_torch.data.preprocess import shard_documents
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault import SharedWorkTracker

    reg = obs.configure(enabled=True) if telemetry else obs.get_registry()
    kwargs = dict(params["method_kwargs"])
    device = _warm_device(kwargs.get("device"))
    data = np.load(os.path.join(workdir, "corpus.npz"))
    c = Collection(data["doc_ptr"], data["terms"], int(data["vocab"]))
    shards = shard_documents(c, int(params["num_shards"]))
    spec = get_spec(params["method"])
    tracker = SharedWorkTracker.open(
        os.path.join(workdir, "claims.json"),
        lease_seconds=float(params["lease_seconds"]),
    )
    ready_unix = time.time()
    ready_sem.release()
    start_evt.wait(300.0)
    t0 = time.time()
    done = _spill_claim_loop(
        tracker, os.path.join(workdir, "spill"), shards, params["method"],
        spec.fn, kwargs, c.vocab_size, int(params["memory_budget_pairs"]),
        worker, reg, workdir,
    )
    count_s = time.time() - t0
    if telemetry:
        _dump_obs(reg, os.path.join(workdir, "obs"), worker)
    _dump_json(
        {"device": device, "shards": done, "ready_unix": ready_unix,
         "count_s": round(count_s, 3),
         "kernel_launches": {k.name: k.launches for k in ops.KERNELS}},
        os.path.join(workdir, "workers"), worker,
    )


def _merge_bucket_files(tasks, V, cap_pairs, reg, fail_after=None) -> None:
    """Merge each task's bucket runs into one run-format file via an atomic
    tmp + rename — a finished bucket file is the resumable unit, so a crashed
    finalizer redoes only unfinished buckets. ``fail_after`` is the test-only
    crash injection (raise after N fresh merges)."""
    from repro_torch.store.builder import merge_bucket_runs, write_rows_run

    fresh = 0
    for b, paths, out in tasks:
        if os.path.exists(out):
            continue
        if fail_after is not None and fresh >= fail_after:
            raise RuntimeError(
                f"injected finalizer crash after {fresh} bucket merges"
            )
        with reg.span("ingest/bucket_merge_file", bucket=b, runs=len(paths)):
            rows = merge_bucket_runs({b: paths}, V, cap_pairs=cap_pairs)
            tmp = f"{out}.tmp-{os.getpid()}"
            write_rows_run(tmp, rows, V)
            os.replace(tmp, out)
        fresh += 1


def _bucket_merge_main(obs_dir, name, tasks, V, cap_pairs, telemetry) -> None:
    """Spawn entry point for one bucket-merge pool worker."""
    reg = obs.configure(enabled=True) if telemetry else obs.get_registry()
    _merge_bucket_files(tasks, V, cap_pairs, reg)
    if telemetry:
        _dump_obs(reg, obs_dir, name)


class ParallelExecutor:
    """N-process parallel ingest for spill-policy plans.

    The document shards PlanExecutor walks serially become a shared work
    queue: ``num_workers`` spawned processes claim shards through a
    :class:`repro_torch.runtime.fault.SharedWorkTracker` (flock'd lease
    table with TTL + heartbeat renewal), count each claimed shard into a
    private wip directory, and promote it atomically on completion — so a
    SIGKILL'd worker's shard is reclaimed after its lease expires and re-done
    by a survivor (or, if every worker dies, drained inline by the parent,
    on the job's device). Finalization merges the radix buckets — already
    independent by construction — across a process pool into resumable
    per-bucket run files, then streams them (ascending bucket = ascending
    primary range) into the same output writers the serial path uses,
    committing a store segment under one flock'd manifest commit.

    On the card, the parent builds the kernels before it spawns; each
    worker resolves its device in the child, creates its CUDA context and
    loads them before it reports ready. A worker whose card or kernel fails
    (:class:`repro_torch.device.DeviceError`) exits non-zero and its lease
    is reclaimed: it never counts on the host. ``summary["per_worker"]``
    carries each worker's exit code, device, start-up seconds, shards and
    its own kernel launches.

    The result is **byte-identical** to ``PlanExecutor`` for the same plan:
    shard boundaries are deterministic, promoted run files are exactly what
    the serial executor would have spilled, and the per-bucket merge output
    depends only on the bucket's key→count map.

    Example::

        res = ParallelExecutor(num_workers=4).execute(plan, out_dir="/d/run")
        # crashed mid-run? the same out_dir resumes: counted shards and
        # merged buckets are skipped
        res = ParallelExecutor(num_workers=4).execute(
            plan, out_dir="/d/run", resume=True)
    """

    def __init__(
        self,
        num_workers: int = 2,
        *,
        lease_seconds: float = 15.0,
        merge_workers: int | None = None,
        ready_timeout: float = 180.0,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self.lease_seconds = float(lease_seconds)
        # None → num_workers, but only once the spilled data is big enough
        # to amortize pool spawn cost (explicit values always get a pool)
        self.merge_workers = merge_workers
        self.ready_timeout = ready_timeout

    # ------------------------------------------------------------------
    def execute(
        self,
        plan: Plan,
        *,
        out_dir: str | None = None,
        resume: bool = False,
        on_ready=None,
    ) -> ExecutionResult:
        if plan.sink_policy != "spill":
            # dense/stats merges are in-memory cheap: single process wins
            return PlanExecutor().execute(plan, out_dir=out_dir, resume=resume)
        with obs.get_registry().span(
            "ingest/execute",
            method=plan.method,
            sink=plan.sink_policy,
            output=plan.job.output,
            shards=plan.job.num_shards,
            docs=plan.job.collection.num_docs,
            resume=resume,
            workers=self.num_workers,
        ):
            return self._execute(
                plan, out_dir=out_dir, resume=resume, on_ready=on_ready
            )

    def _execute(self, plan, *, out_dir, resume, on_ready) -> ExecutionResult:
        from repro_torch.data.preprocess import shard_documents
        from repro_torch.runtime.fault import SharedWorkTracker
        from repro_torch.store.builder import (
            _iter_run,
            discover_bucket_runs,
            merge_row_streams,
        )

        job = plan.job
        c = job.collection
        V = c.vocab_size
        own_workdir = out_dir is None
        workdir = out_dir or tempfile.mkdtemp(prefix="cooc_par_")
        spill_root = os.path.join(workdir, "spill")
        merge_dir = os.path.join(workdir, "merge")
        obs_dir = os.path.join(workdir, "obs")
        report_dir = os.path.join(workdir, "workers")
        claims = os.path.join(workdir, "claims.json")
        t0 = time.time()
        reg = obs.get_registry()

        if not resume:
            for d in (spill_root, merge_dir, obs_dir, report_dir):
                shutil.rmtree(d, ignore_errors=True)
            for f in (claims, claims + ".lock"):
                if os.path.exists(f):
                    os.remove(f)
        for d in (workdir, spill_root, merge_dir, obs_dir, report_dir):
            os.makedirs(d, exist_ok=True)

        corpus_path = os.path.join(workdir, "corpus.npz")
        if not (resume and os.path.exists(corpus_path)):
            np.savez(
                corpus_path, doc_ptr=c.doc_ptr, terms=c.terms,
                vocab=np.int64(V),
            )

        shards = shard_documents(c, job.num_shards)
        if resume and os.path.exists(claims):
            tracker = SharedWorkTracker.open(
                claims, lease_seconds=self.lease_seconds
            )
            self._heal_resumed(tracker, spill_root, job.num_shards)
        else:
            tracker = SharedWorkTracker.create(
                claims,
                [(s,) for s in range(job.num_shards)],
                lease_seconds=self.lease_seconds,
            )

        telemetry = reg.enabled
        t_ready = time.time()
        per_worker: list = []
        parent_shards = 0
        if not tracker.finished:
            procs, spawned, start = self._spawn_workers(
                plan, workdir, telemetry
            )
            t_ready = time.time()
            if on_ready is not None:
                on_ready()
            start.set()
            while any(p.is_alive() for p in procs):
                time.sleep(0.05)
            for p in procs:
                p.join(timeout=5.0)
            per_worker = self._worker_reports(procs, spawned, report_dir)
            if not tracker.finished:
                # every worker exited with work outstanding (crash storm,
                # spawn failure, a failed card): the parent drains the
                # remaining shards through the same claim loop, with the
                # plan's kwargs, so on the job's device — progress is never
                # hostage to worker liveness
                parent_shards = _spill_claim_loop(
                    tracker, spill_root, shards, plan.method, plan.spec.fn,
                    dict(plan.method_kwargs), V, job.memory_budget_pairs,
                    "parent", reg, workdir,
                )
            if telemetry:
                self._absorb_obs(reg, obs_dir)
        t_counted = time.time()

        by_bucket, legacy = discover_bucket_runs(spill_root)
        if legacy:  # pre-bucketing runs: only a global k-way merge is correct
            merged = merge_row_streams([_iter_run(p) for p in by_bucket[-1]])
        else:
            merged = self._merged_rows_parallel(
                by_bucket, V, job, merge_dir, obs_dir, reg, telemetry
            )

        summary = {
            "num_docs": c.num_docs,
            "vocab_size": V,
            "method": plan.method,
            "output": job.output,
            "num_shards": job.num_shards,
            "exact": plan.exact,
            "ingest_workers": self.num_workers,
            "reclaimed_shards": tracker.reclaims,
            "parent_shards": parent_shards,
            "per_worker": per_worker,
            "plan": plan.describe(),
        }
        result = ExecutionResult(summary=summary)
        _emit_merged_rows(plan, merged, result, single_commit=True)

        end = time.time()
        summary.update(
            {
                "elapsed_s": round(end - t0, 2),
                "ready_wait_s": round(min(t_ready, end) - t0, 2),
                "count_s": round(t_counted - min(t_ready, t_counted), 2),
                "finalize_s": round(end - t_counted, 2),
                # steady-state work time: everything after the ready barrier
                # (what the scaling gates compare across worker counts)
                "work_s": round(end - min(t_ready, end), 2),
                "docs_per_hour": round(
                    c.num_docs / max(end - t0, 1e-9) * 3600
                ),
                "docs_per_hour_work": round(
                    c.num_docs / max(end - t_ready, 1e-9) * 3600
                ),
            }
        )
        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return result

    # ------------------------------------------------------------------
    def _spawn_workers(self, plan: Plan, workdir: str, telemetry: bool):
        """Build the plan's kernels once here (on the card), spawn the
        workers and wait at the ready barrier until each has reported ready
        or died. Returns the processes, each one's spawn time and the event
        that starts them."""
        from repro_torch.store.spawn import spawn_friendly_env

        device = plan.method_kwargs.get("device")
        if (device is not None and torch.device(device).type == "cuda"
                and torch.cuda.is_available()):
            # one nvcc per kernel here, not one per worker: workers only load
            from repro_torch.kernels import _build, ops

            _build.build_all(ops.KERNELS)
        params = {
            "method": plan.method,
            "method_kwargs": dict(plan.method_kwargs),
            "num_shards": plan.job.num_shards,
            "memory_budget_pairs": plan.job.memory_budget_pairs,
            "lease_seconds": self.lease_seconds,
        }
        procs, spawned = [], []
        with spawn_friendly_env() as ctx:
            ready = ctx.Semaphore(0)
            start = ctx.Event()
            for i in range(self.num_workers):
                p = ctx.Process(
                    target=_spill_worker_main,
                    args=(workdir, f"w{i}", params, telemetry, ready, start),
                    daemon=True,
                )
                spawned.append(time.time())
                p.start()
                procs.append(p)
        # ready barrier: workers signal after import, device warm-up and
        # corpus load, so timing from here measures counting, not start-up;
        # a worker that died first (a failed card) is not waited for
        deadline = time.time() + self.ready_timeout
        ready_n = 0
        while ready_n < len(procs) and time.time() < deadline:
            if ready.acquire(timeout=0.05):
                ready_n += 1
            elif ready_n + sum(not p.is_alive() for p in procs) >= len(procs):
                break
        return procs, spawned, start

    @staticmethod
    def _worker_reports(procs, spawned, report_dir: str) -> list[dict]:
        """One entry per spawned worker: its exit code and, when it exited
        cleanly, what it reported (device, kernel launches, shards, counting
        seconds) with its start-up seconds from spawn to ready."""
        import json

        out = []
        for i, (p, t_spawn) in enumerate(zip(procs, spawned)):
            entry = {"worker": f"w{i}", "exitcode": p.exitcode, "device": None,
                     "startup_s": None, "shards": None, "count_s": None,
                     "kernel_launches": None}
            path = os.path.join(report_dir, f"w{i}.json")
            if os.path.exists(path):
                with open(path) as f:
                    rep = json.load(f)
                os.remove(path)
                entry.update({k: rep[k] for k in (
                    "device", "shards", "count_s", "kernel_launches")})
                entry["startup_s"] = round(rep["ready_unix"] - t_spawn, 3)
            out.append(entry)
        return out

    @staticmethod
    def _heal_resumed(tracker, spill_root: str, num_shards: int) -> None:
        """Reconcile the lease table with what actually survived on disk:
        wip partials and out-of-range/undone shard directories are pruned
        (they must not contribute runs), and a done-recorded shard whose
        promoted directory vanished is forced back to pending."""
        from repro_torch.store.builder import SHARD_DIR_RE

        done = {u[0] for u in tracker.done_units()}
        present: set[int] = set()
        for d in glob.glob(os.path.join(spill_root, "*")):
            base = os.path.basename(d)
            m = SHARD_DIR_RE.match(base)
            if m is None:
                if base.startswith("wip_"):
                    shutil.rmtree(d, ignore_errors=True)
                continue
            idx = int(m.group(1))
            if idx in done and idx < num_shards:
                present.add(idx)
            else:
                shutil.rmtree(d, ignore_errors=True)
        for idx in sorted(done - present):
            tracker.requeue((idx,))

    @staticmethod
    def _absorb_obs(reg, obs_dir: str) -> None:
        """Fold every worker's dumped snapshot into the parent registry —
        counters add, histograms merge, and span events land re-based on the
        parent timeline, so one ``--trace-out`` file shows every process."""
        import json

        for p in sorted(glob.glob(os.path.join(obs_dir, "*.json"))):
            try:
                with open(p) as f:
                    snap = json.load(f)
            except (OSError, ValueError):  # half-written by a killed worker
                continue
            os.replace(p, p + ".absorbed")  # never double-absorbed on resume
            # one absorb per worker so its spans carry proc=<worker name>
            reg.absorb(snap, source=os.path.splitext(os.path.basename(p))[0])

    def _merged_rows_parallel(
        self, by_bucket, V, job, merge_dir, obs_dir, reg, telemetry
    ):
        """Merge each bucket's runs into ``merge_dir/bucket_*.run`` across a
        process pool (buckets are independent by construction), then stream
        the finished files back in ascending bucket order — primaries ascend
        across buckets, so the concatenation is the globally merged stream."""
        from repro_torch.store.builder import _iter_run
        from repro_torch.store.spawn import spawn_friendly_env

        cap = 4 * job.memory_budget_pairs
        fail_after = os.environ.get("REPRO_TEST_FAIL_AFTER_MERGES")
        fail_after = int(fail_after) if fail_after else None
        outs, tasks = [], []
        task_bytes = 0
        for b in sorted(by_bucket):
            out = os.path.join(merge_dir, f"bucket_{b:04d}.run")
            outs.append(out)
            if not os.path.exists(out):  # resume: finished buckets skipped
                tasks.append((b, by_bucket[b], out))
                task_bytes += sum(os.path.getsize(p) for p in by_bucket[b])
        n_pool = min(self.merge_workers or self.num_workers, len(tasks))
        if self.merge_workers is None:
            # spawn cost (interpreter + imports per pool process) dwarfs the
            # merge itself on small spills, and pool processes time-slice
            # rather than parallelize without cores to run on: merge inline
            # in either case (an explicit merge_workers= overrides both)
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            if task_bytes < _POOL_MIN_MERGE_BYTES or cores < 2:
                n_pool = min(n_pool, 1)
        with reg.span(
            "ingest/bucket_merge_pool", buckets=len(tasks),
            workers=max(n_pool, 1),
        ):
            if tasks and n_pool > 1 and fail_after is None:
                with spawn_friendly_env() as ctx:
                    procs = [
                        ctx.Process(
                            target=_bucket_merge_main,
                            args=(obs_dir, f"m{i}", tasks[i::n_pool], V, cap,
                                  telemetry),
                            daemon=True,
                        )
                        for i in range(n_pool)
                    ]
                    for p in procs:
                        p.start()
                for p in procs:
                    p.join()
                # buckets a dead pool worker left behind finish inline
                left = [t for t in tasks if not os.path.exists(t[2])]
                if left:
                    _merge_bucket_files(left, V, cap, reg)
                if telemetry:
                    self._absorb_obs(reg, obs_dir)
            elif tasks:
                _merge_bucket_files(tasks, V, cap, reg, fail_after=fail_after)

        def stream():
            for out in outs:
                yield from _iter_run(out)

        return stream()


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
