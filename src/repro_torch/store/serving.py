"""Multi-client co-occurrence serving: shared-mmap workers, micro-batched
kernel launches, typed wire protocol, hot-term routing, streaming top-k,
and a supervised, overload-shedding fault-tolerance layer.

The query engine (store/query.py) already batches *within* one call; this
layer batches *across clients*, the way a real serving deployment amortizes
kernel launches over concurrent traffic:

    clients ──▶ request queue(s) ──▶ worker processes ──▶ response queue ─▶ router
    (threads)   (shared or routed)   (N × Store + QueryEngine)   (mp)      (thread)

* **Typed wire protocol** — the request dataclasses of store/requests.py
  *are* what crosses the process boundary: a client submits
  ``(client_id, request_id, part, parts, request, t_submit, deadline)``
  envelopes (:func:`repro_torch.store.requests.make_envelope`) whose payload
  is the same frozen ``TopKRequest | PairCountsRequest | NeighboursRequest``
  the in-process engine executes. Invalid queries (unknown score, bad dtype,
  k < 1) therefore fail at request construction on the client — a worker
  never sees them.
* **Shared mmap** — every worker process opens the same immutable segment
  files with ``np.memmap``; the OS page cache backs all mappings with one
  physical copy, so N workers serve a 100 GB store with ~one store's worth
  of resident pages. Workers ``Store.refresh()`` between micro-batches, so
  a manifest commit (append/ingest/compact) in the parent becomes visible
  to in-flight serving traffic without a restart; ``refresh_interval_ms``
  adds a periodic idle refresh, so a server with *no* traffic still
  follows a stream daemon's commits (see repro_torch.stream).
* **Micro-batching with a latency budget** — a worker takes the first
  request off its queue, then keeps draining for at most ``batch_window_ms``
  (or until ``max_batch`` requests), coalesces compatible requests — same
  ``(k, score)`` for top-k, all pair lookups together — and executes each
  group as **one** batched launch via the same ``execute_groups`` path the
  in-process engine uses.
* **Hot-term routing** (``routing=True``) — each worker gets its own request
  queue and the client-side :class:`~repro_torch.store.requests.QueryPlanner`
  splits every top-k request by term ownership (``route_term``), so the N
  per-worker LRU row caches hold N disjoint slices of the vocabulary
  instead of N copies of the Zipf head. Per-worker hit rates are surfaced
  in the server's stats.
* **Worker supervision** — before executing a micro-batch, a worker
  *claims* its request tags on the response queue; a supervisor thread
  watches worker exitcodes and, on death, immediately fails exactly the
  claimed (in-flight) tags back to their clients as a typed
  :class:`WorkerDied` — unclaimed envelopes stay queued and survive the
  respawn. The worker slot is respawned up to ``max_respawns`` times with
  its request queue intact; while the replacement warms (and permanently,
  once the budget is spent) ``_submit`` re-routes the slot's vocabulary
  slice to the next live worker — routing is a cache-locality
  optimization, never a correctness dependency, so any worker can serve
  any slice.
* **Admission control** — ``max_inflight`` bounds every request queue;
  a full queue rejects at submit with a typed :class:`ServerOverloaded`
  (load shedding — never a silent drop), and each envelope carries the
  client's absolute deadline so a worker skips requests that have already
  expired client-side instead of burning a launch on them.
  ``CoocClient.execute(retries=...)`` retries sheds and worker deaths
  with jittered exponential backoff (:func:`backoff_delay`) — never
  timeouts, and never mid-stream.
* **Fault injection** — the env-gated failpoints of
  :mod:`repro_torch.runtime.faultinject` (``kill-worker``, ``stall-queue``,
  ``drop-response``) are compiled into the worker loop, so tests and
  ``chip_smoke.py`` script kill/stall/drop schedules through
  ``REPRO_FAULTS`` without patching code. Disarmed they cost one falsy
  check per batch.
* **Cross-process telemetry** — every worker keeps a private
  :class:`repro_torch.obs.Registry` (queue-wait / execute / request-latency
  histograms, batch-size distribution, query counters, the ``query/*``
  spans of each top-k launch) and publishes picklable snapshots over the
  stats queue: periodically between micro-batches when ``stats_interval_s``
  is set, and always once at exit, that last one with the worker's span
  events.
  The parent merges them (histograms merge bucket-wise, so p50/p95/p99 are
  true pooled percentiles) into a live ``server.stats()`` — no shared
  memory, no extra sockets. A worker that dies mid-flight costs its last
  interval of data, not the whole run: its freshest snapshot is archived
  and keeps counting in the aggregate while the replacement starts fresh.
  Resilience counters (``serving/shed``, ``serving/respawns``,
  ``serving/worker_died_failures`` parent-side; ``serving/deadline_expired``
  worker-side) ride the same snapshots into ``stats()["resilience"]``.
* **Streaming top-k** — a ``TopKRequest(chunk=c)`` comes back as an iterator
  of score-ordered ``(ids, scores)`` column blocks: large-k responses cross
  the queue chunk by chunk instead of as one monolithic pickle. If the
  serving worker dies mid-stream, the iterator raises :class:`WorkerDied`
  on the next ``next()`` instead of stalling until the timeout.

Example (driver-side; see launch/cooc_serve.py for the full workload)::

    server = CoocServer(store_path, workers=4, routing=True,
                        batch_window_ms=2.0, device="cuda",
                        max_inflight=256, max_respawns=2).start()
    client = server.client()                 # one per client thread
    ids, scores = client.topk([3, 17], k=10, score="pmi")
    for ids_c, scores_c in client.topk_stream([3], k=5000, chunk=512):
        ...                                  # score-ordered chunks
    server.stats()["resilience"]             # shed / respawns / deadline_expired
    stats = server.stop()                    # {"requests": ..., "cache_hit_rate": ...}

Workers are **spawned** (never forked): a CUDA context does not survive a
fork, and a spawned worker importing the store from disk is exactly the
multi-process serving topology this layer exists to exercise.

* **The card** — each worker resolves ``device`` itself and answers every
  top-k on the ``topk_gather`` kernel in its own CUDA context (``"cpu"``:
  its plain PyTorch version). Requests and answers cross the queues as
  numpy arrays and Python objects only, never as CUDA tensors. The parent
  builds the kernel once before spawning, so workers only load it. A
  worker that cannot reach the card, or whose kernel fails to build or
  launch, dies: the supervisor fails its batch as :class:`WorkerDied` and
  respawns it, and it never answers from the host. Kernel launch counters
  are per process, so each worker reports its device and its launches in
  its stats snapshots (``stats()["per_worker"]``).
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import random
import threading
import time

import numpy as np

import torch

from repro_torch import obs
from repro_torch.device import DeviceError
from repro_torch.kernels import _build, ops
from repro_torch.kernels import topk_gather as _topk_gather
from repro_torch.runtime import faultinject
from repro_torch.store.spawn import spawn_friendly_env
from repro_torch.store.requests import (
    NeighboursRequest,
    PairCountsRequest,
    QueryPlanner,
    TopKRequest,
    coalesce,
    default_kernel,
    envelope_times,
    execute_groups,
    make_envelope,
)


class _StopSentinel:
    """Queue stop marker. mp queues *pickle* items, so a sentinel cannot be
    compared by identity across the process boundary — ``isinstance`` is the
    only check that survives a round-trip. A plain ``None`` sentinel (the
    old idiom) additionally collides with any stray ``None`` that lands on
    a queue during a respawn race and silently stops a healthy worker."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<serving stop sentinel>"


_STOP = _StopSentinel()  # one per worker, re-enqueued if drained early


def _is_stop(item) -> bool:
    return isinstance(item, _StopSentinel)


_STAT_KEYS = (
    "requests", "batches", "max_batch_requests",
    "topk_queries", "topk_launches", "pair_queries", "pair_launches",
    "neighbours_queries", "stream_chunks", "store_refreshes",
)

_SUPERVISE_INTERVAL_S = 0.02  # exitcode poll period of the supervisor thread


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Tuning knobs of one serving deployment (picklable: it crosses the
    process boundary to every worker).

    Example::

        cfg = ServingConfig(workers=4, routing=True, device="cuda",
                            max_inflight=256, max_respawns=2)
    """

    workers: int = 2
    batch_window_ms: float = 2.0      # micro-batch latency budget
    max_batch: int = 64               # requests coalesced per launch, at most
    device: str = "cuda"              # where workers run top-k (store/query.py)
    cache_rows: int = 4096            # per-worker LRU capacity
    routing: bool = False             # hot-term routing: per-worker queues
    stats_interval_s: float = 0.0     # 0 = snapshot only at worker exit
    refresh_interval_ms: float = 0.0  # 0 = refresh only between micro-batches
    max_inflight: int = 0             # per-queue envelope bound; 0 = unbounded
    max_respawns: int = 2             # supervisor respawn budget per worker slot
    report_inputs: bool = False       # top-k answers carry what they read

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.batch_window_ms < 0:
            raise ValueError("batch_window_ms must be >= 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.stats_interval_s < 0:
            raise ValueError("stats_interval_s must be >= 0")
        if self.refresh_interval_ms < 0:
            raise ValueError("refresh_interval_ms must be >= 0")
        if self.max_inflight < 0:
            raise ValueError("max_inflight must be >= 0 (0 = unbounded)")
        if self.max_respawns < 0:
            raise ValueError("max_respawns must be >= 0 (0 = never respawn)")
        if str(self.device).split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(
                f"unsupported device {self.device!r}; have 'cuda', 'cpu'"
            )


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


def _serve_batch(engine, batch, response_q, worker_id: int, stats: dict) -> None:
    """Coalesce one micro-batch of request envelopes and answer it with as
    few kernel launches as possible, through the same ``execute_groups``
    path as ``QueryEngine.execute``. Invalid requests get error responses
    and do not poison the rest of the batch. A failure of the card or of
    its kernel is re-raised instead: the worker dies and its claimed batch
    fails as :class:`WorkerDied`; it never answers from the host."""
    stats["batches"] += 1
    stats["requests"] += len(batch)
    stats["max_batch_requests"] = max(stats["max_batch_requests"], len(batch))
    meta = {"worker": worker_id, "batch_requests": len(batch)}
    finished: set = set()  # tags whose final message went out

    def emit(tag, ok, payload, *, seq=0, last=True, extra=None):
        cid, rid, part, parts = tag
        m = {**meta, **(extra or {})}
        if last:
            finished.add(tag)
        response_q.put((cid, rid, part, parts, seq, last, ok, payload, m))

    # envelopes are (cid, rid, part, parts, request[, t_submit[, deadline]]);
    # the trailing fields (see store/requests.py make_envelope) are optional
    # so hand-built 5-tuple envelopes keep working
    tagged = [
        ((cid, rid, part, parts), req)
        for cid, rid, part, parts, req, *_ in batch
    ]
    try:
        execute_groups(engine, coalesce(tagged), emit, stats=stats)
    except Exception as e:
        if _device_failed(engine, e):
            raise
        # an unexpected error (e.g. a segment racing a parent compact())
        # must not kill the worker with clients blocked on responses: fail
        # every request that has not answered yet and keep serving
        msg = f"worker {worker_id} error: {type(e).__name__}: {e}"
        for tag, _ in tagged:
            if tag not in finished:
                emit(tag, False, ("serving_error", msg))


def _device_failed(engine, e: Exception) -> bool:
    """True when ``e`` is a failure of the worker's card or kernel: a
    :class:`DeviceError` (a kernel that did not build or launch), or any
    error after which the card itself no longer synchronizes."""
    if isinstance(e, DeviceError):
        return True
    if engine.device.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(engine.device)
    except Exception:
        return True
    return False


class _FaultyChannel:
    """Response-queue proxy armed by the ``drop-response`` failpoint:
    discards the worker's next N answer messages instead of enqueueing
    them. Claims and deadline-expiry answers bypass the proxy — supervision
    must stay honest even while responses are being lost."""

    def __init__(self, response_q, fr, worker_id: int):
        self._q = response_q
        self._fr = fr
        self._worker_id = worker_id

    def put(self, item) -> None:
        if self._fr.drop_response(worker=self._worker_id):
            return
        self._q.put(item)


def _worker_payload(stats: dict, engine, registry, incarnation: int = 0,
                    *, events: bool = False) -> dict:
    """One picklable stats-queue snapshot: the worker's counters dict plus
    its metrics registry snapshot (mergeable histograms included; its span
    events with ``events=True``, which the final snapshot sets). The
    incarnation stamp lets the parent ignore pipe-buffered snapshots from a
    dead incarnation after its replacement has started reporting. The
    worker's device and this process's kernel launches ride along: launch
    counters are per process, so the parent cannot see them otherwise."""
    out = dict(stats)
    out.update(engine.stats)  # cache_hits / cache_misses
    hits, misses = out["cache_hits"], out["cache_misses"]
    out["cache_hit_rate"] = round(hits / max(hits + misses, 1), 4)
    out["device"] = str(engine.device)
    out["kernel_launches"] = {k.name: k.launches for k in ops.KERNELS}
    return {
        "stats": out,
        "metrics": registry.snapshot(include_events=events),
        # manifest generation / segment census as this worker sees it; the
        # parent keeps the highest-generation view (a mid-commit sibling may
        # briefly lag by one refresh)
        "freshness": engine.store.freshness(),
        "incarnation": incarnation,
    }


def _worker_main(
    worker_id: int,
    store_path: str,
    cfg: ServingConfig,
    request_q,
    response_q,
    stats_q,
    incarnation: int = 0,
) -> None:
    """One serving worker: open the store (mmap — pages shared with every
    sibling via the OS page cache), then loop: block for a request, drain the
    queue under the latency budget, serve the coalesced batch. Between
    batches the store manifest is refreshed, so parent-process mutations
    (append/compact) invalidate this worker's row cache exactly like they
    invalidate a direct engine's.

    Fault-tolerance duties per batch: already-expired envelopes (deadline
    in the past) are answered with a ``deadline_expired`` error instead of
    executed; the surviving tags are *claimed* on the response queue
    (``("claim", wid, incarnation, tags)``) before execution, so the
    parent's supervisor knows exactly which requests die with this process;
    the :mod:`repro_torch.runtime.faultinject` failpoints (stall, kill, drop)
    fire between claim and execution. A ``("ready", ...)`` stats message
    after the store opens (and, on the card, after the CUDA context and the
    ``topk_gather`` kernel are loaded) tells the supervisor a respawned
    slot is warm. The device resolves here, in the child: without a card
    the worker dies at start-up.

    Telemetry rides a private enabled :class:`repro_torch.obs.Registry` (the
    process-global one stays disabled): per-request queue-wait and latency,
    per-batch execute time and size, query counters and the ``query/*``
    spans via the engine. A ``("snap", id, payload)`` snapshot goes on the
    stats queue at most every ``stats_interval_s`` seconds (0 = never), and
    a ``("final", ...)`` one, with the span events, always goes out at exit
    — so the parent loses at most one interval of data if this process
    dies."""
    from repro_torch.store.query import QueryEngine
    from repro_torch.store.segments import Store

    fr = faultinject.from_env()
    reg = obs.Registry(enabled=True, max_events=10_000)
    # the registry reaches the segments too: codec/bloom counters
    # (blocks decoded, cache hits, bloom negatives) ride the same snapshots
    engine = QueryEngine(
        Store.open(store_path, registry=reg), cache_rows=cfg.cache_rows,
        device=cfg.device, registry=reg, report_inputs=cfg.report_inputs,
    )
    if engine.device.type == "cuda":
        # warm the slot: the CUDA context and the kernel the parent built
        torch.zeros(1, device=engine.device)
        _build.build_all([_topk_gather.KERNEL])
    # the slot is warm: the supervisor clears this worker's degraded flag
    # and routed traffic returns to its own queue
    stats_q.put(("ready", worker_id, {"incarnation": incarnation}))
    stats = {k: 0 for k in _STAT_KEYS}
    c_expired = reg.counter("serving/deadline_expired")
    h_wait = reg.histogram("serving/queue_wait_s")
    h_exec = reg.histogram("serving/execute_s")
    h_lat = reg.histogram("serving/request_latency_s")
    h_bsz = reg.histogram("serving/batch_requests")
    serve_chan = (
        _FaultyChannel(response_q, fr, worker_id)
        if fr.active(faultinject.DROP_RESPONSE) else response_q
    )
    window_s = cfg.batch_window_ms / 1e3
    interval = cfg.stats_interval_s
    refresh_s = cfg.refresh_interval_ms / 1e3
    # idle wake-up: the shorter of the two periodic duties (stats snapshot,
    # manifest refresh); None blocks forever when neither is configured —
    # an idle worker then only refreshes when traffic arrives, as before
    idle_duties = [t for t in (interval, refresh_s) if t > 0]
    idle_timeout = min(idle_duties) if idle_duties else None
    last_pub = last_refresh = time.monotonic()
    stop = False
    while not stop:
        try:
            req = request_q.get(timeout=idle_timeout)
        except queue.Empty:  # idle: periodic duties, then wait again
            now = time.monotonic()
            if refresh_s and now - last_refresh >= refresh_s:
                # an idle server still follows the manifest: segments a
                # stream daemon committed become queryable without traffic
                if engine.store.refresh():
                    stats["store_refreshes"] += 1
                last_refresh = now
            if interval and now - last_pub >= interval:
                stats_q.put(
                    ("snap", worker_id,
                     _worker_payload(stats, engine, reg, incarnation))
                )
                last_pub = now
            continue
        if _is_stop(req):
            break
        if not isinstance(req, tuple) or len(req) < 5:
            continue  # a stray item (e.g. a bare None) is not a stop signal
        batch = [req]
        deadline = time.perf_counter() + window_s
        while len(batch) < cfg.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = request_q.get(timeout=timeout)
            except queue.Empty:
                break
            if _is_stop(nxt):
                request_q.put(_STOP)  # hand the sentinel to a sibling
                stop = True
                break
            if not isinstance(nxt, tuple) or len(nxt) < 5:
                continue
            batch.append(nxt)
        if engine.store.refresh():  # cross-process append/compact visibility
            stats["store_refreshes"] += 1
        last_refresh = time.monotonic()
        # a request whose client-side deadline already passed gets a typed
        # error instead of a kernel launch: the client stopped waiting, so
        # the launch would be pure wasted capacity under overload
        now = time.time()
        live = []
        for item in batch:
            _t_sub, dl = envelope_times(item)
            if dl is not None and now > dl:
                c_expired.inc()
                response_q.put((
                    item[0], item[1], item[2], item[3], 0, True, False,
                    ("deadline_expired",
                     f"deadline passed {now - dl:.3f}s before worker "
                     f"{worker_id} dequeued the request"),
                    {"worker": worker_id},
                ))
                continue
            live.append(item)
        if not live:
            continue
        batch = live
        # claim before executing: if this process dies mid-batch the
        # supervisor fails exactly these tags — queued-but-unclaimed
        # envelopes survive for the respawned worker
        response_q.put((
            "claim", worker_id, incarnation,
            [(it[0], it[1], it[2], it[3]) for it in batch],
        ))
        if fr:
            stall = fr.stall_queue(worker=worker_id)
            if stall:
                time.sleep(stall)
            if fr.kill_worker(worker=worker_id, batches_done=stats["batches"]):
                faultinject.kill_self()
        # queue wait = batch start minus client submit; unix time is the one
        # clock both processes share (perf_counter epochs differ per process)
        t_start = time.time()
        for item in batch:
            t_sub, _dl = envelope_times(item)
            if t_sub is not None:
                h_wait.record(max(t_start - t_sub, 0.0))
        t0 = time.perf_counter()
        _serve_batch(engine, batch, serve_chan, worker_id, stats)
        h_exec.record(time.perf_counter() - t0)
        h_bsz.record(len(batch))
        t_end = time.time()
        for item in batch:
            t_sub, _dl = envelope_times(item)
            if t_sub is not None:
                h_lat.record(max(t_end - t_sub, 0.0))
        if interval and time.monotonic() - last_pub >= interval:
            stats_q.put(
                ("snap", worker_id,
                 _worker_payload(stats, engine, reg, incarnation))
            )
            last_pub = time.monotonic()
    stats_q.put(
        ("final", worker_id,
         _worker_payload(stats, engine, reg, incarnation, events=True))
    )


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


class ServingError(RuntimeError):
    """A request failed inside a worker; carries the worker's message."""


class WorkerDied(ServingError):
    """The worker serving this request died mid-flight; the supervisor
    failed the request back immediately instead of letting the client block
    until its timeout. Safe to retry (``execute(retries=...)`` does)."""


class ServerOverloaded(ServingError):
    """The request was shed at submit because the target queue is full
    (``max_inflight``). Deliberate load shedding, not a failure of the
    request itself — back off and retry (``execute(retries=...)`` does)."""


def backoff_delay(
    attempt: int,
    base_ms: float = 25.0,
    cap_ms: float = 2000.0,
    rng=random.random,
) -> float:
    """Jittered exponential backoff delay in **seconds** for retry number
    ``attempt`` (0-based): uniform in 50–100% of ``base_ms * 2**attempt``,
    capped at ``cap_ms``. The jitter decorrelates clients that were all
    shed by the same full queue — synchronized retries would just
    reproduce the overload spike they are backing off from.

    Example::

        >>> backoff_delay(0, base_ms=100, rng=lambda: 0.0)
        0.05
        >>> backoff_delay(2, base_ms=100, rng=lambda: 1.0)
        0.4
        >>> backoff_delay(10, base_ms=100, cap_ms=500, rng=lambda: 1.0)
        0.5
    """
    span_ms = min(base_ms * (2.0 ** attempt), cap_ms)
    return (0.5 + 0.5 * rng()) * span_ms / 1e3


class _StreamIterator:
    """Chunk iterator of one streamed top-k request. Cleanup (forgetting the
    request id so in-flight chunks are discarded, not buffered forever) is
    guaranteed whether the stream is fully consumed, closed early, errors,
    or is dropped before the first ``next()`` — a plain generator's
    ``finally`` never runs if the body is never entered. If the serving
    worker dies mid-stream, the supervisor's synthetic failure makes the
    next ``next()`` raise :class:`WorkerDied` promptly instead of stalling
    until the timeout."""

    def __init__(self, client: "CoocClient", rid: int, timeout: float):
        self._client = client
        self._rid = rid
        self._timeout = timeout
        self._in_flight = 1
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        try:
            _, _, seq, last, ok, payload, meta = self._client._next_msg(
                self._rid, self._timeout
            )
        except Exception:
            self.close()
            raise
        self._client.last_meta = meta
        if last:
            self._in_flight = 0
        if not ok:
            self.close()
            self._client._raise(payload)
        if last:
            self.close()
        return payload

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._client._forget(self._rid, self._in_flight)

    def __del__(self):  # dropped without consumption
        self.close()


class CoocClient:
    """A client handle bound to one :class:`CoocServer`.

    Each concurrent client (thread) gets its own handle via
    ``server.client()``; a handle's methods are blocking RPCs and may be
    called from exactly one thread. ``last_meta`` exposes how the previous
    request was served (worker id, micro-batch size, coalesced requests).

    ``execute()`` mirrors ``QueryEngine.execute``: a batch of typed request
    objects in, one result per request out — the planner may split a request
    across routed workers and this handle reassembles the slices
    byte-identically.

    Example::

        client = server.client()
        ids, scores = client.topk([3, 17], k=10)
        client.last_meta["batch_requests"]   # how many requests shared the batch
    """

    def __init__(self, server: "CoocServer", client_id: int, box: "queue.Queue"):
        self._server = server
        self._client_id = client_id
        self._box = box
        self._req_ids = itertools.count()
        self._msgs: dict[int, list] = {}       # rid -> buffered messages
        self._positions: dict[int, dict] = {}  # rid -> {part: positions}
        self._discard: dict[int, int] = {}     # forgotten rid -> parts in flight
        self.last_meta: dict = {}

    # ------------------------------------------------------------- typed API
    def execute(
        self,
        requests,
        *,
        timeout: float = 60.0,
        retries: int = 0,
        retry_backoff_ms: float = 25.0,
    ) -> list:
        """Submit a batch of typed requests; returns one result per request
        (streamed top-k yields an iterator of chunks). All parts of all
        requests are submitted before any response is awaited, so distinct
        requests can share a worker micro-batch.

        ``retries`` re-submits the whole batch (with
        :func:`backoff_delay`-jittered exponential backoff) when it fails
        with :class:`ServerOverloaded` (shed at a full queue) or
        :class:`WorkerDied` (supervisor failed an in-flight request) —
        both are transient-by-design and idempotent to repeat. Timeouts
        are **never** retried (the request may still complete server-side),
        and a :class:`WorkerDied` raised *while consuming* a streamed
        iterator is not retried either — by then chunks may already have
        been handed to the caller."""
        requests = list(requests)
        attempt = 0
        while True:
            try:
                return self._execute_once(requests, timeout)
            except (ServerOverloaded, WorkerDied):
                if attempt >= retries:
                    raise
                time.sleep(backoff_delay(attempt, retry_backoff_ms))
                attempt += 1

    def _execute_once(self, requests, timeout: float) -> list:
        plan = self._server.planner.plan(requests)
        deadline = time.time() + timeout
        entries = []  # [rid, req, parts_submitted, parts_planned]
        try:
            for req, parts in zip(plan.requests, plan.parts):
                rid = next(self._req_ids)
                self._positions[rid] = {rp.part: rp.positions for rp in parts}
                entries.append([rid, req, 0, len(parts)])
                for rp in parts:
                    self._server._submit(
                        rp.worker,
                        make_envelope(
                            self._client_id, rid, rp.part, rp.parts,
                            rp.request, t_submit=time.time(),
                            deadline=deadline,
                        ),
                    )
                    entries[-1][2] += 1
        except Exception:
            # shed (or a dead fleet) mid-submit: nothing has been consumed
            # from the box yet, so forget every part already in flight and
            # a retry starts from a clean slate
            for rid, _req, submitted, _planned in entries:
                self._positions.pop(rid, None)
                self._forget(rid, submitted)
            raise
        out = []
        for idx, (rid, req, _submitted, _planned) in enumerate(entries):
            try:
                if isinstance(req, TopKRequest) and req.chunk is not None:
                    out.append(self._stream(rid, req, timeout))
                else:
                    out.append(self._assemble(rid, req, timeout))
            except Exception:
                # the failing request forgot itself; forget the already
                # submitted later siblings too, or their responses would
                # buffer in _msgs forever
                for later_rid, _, _, _ in entries[idx + 1:]:
                    planned = max(len(self._positions.pop(later_rid, {})), 1)
                    self._forget(later_rid, planned)
                raise
        return out

    def topk(self, terms, k: int = 10, *, score: str = "count",
             timeout: float = 60.0, retries: int = 0):
        """Top-k neighbours, served through the shared worker pool. Returns
        ``(ids (B, k), scores (B, k))`` exactly like ``QueryEngine.topk``."""
        return self.execute([TopKRequest(terms, k=k, score=score)],
                            timeout=timeout, retries=retries)[0]

    def topk_stream(
        self, terms, k: int, *, score: str = "count", chunk: int = 1024,
        timeout: float = 60.0,
    ):
        """Streaming top-k: iterator of score-ordered ``(ids, scores)``
        column blocks of width ≤ ``chunk``; concatenation along axis 1
        equals the monolithic ``topk`` result exactly."""
        return self.execute(
            [TopKRequest(terms, k=k, score=score, chunk=chunk)], timeout=timeout
        )[0]

    def pair_counts(self, pairs, *, timeout: float = 60.0,
                    retries: int = 0) -> np.ndarray:
        """Exact counts for a (B, 2) pair batch, served remotely."""
        return self.execute([PairCountsRequest(pairs)], timeout=timeout,
                            retries=retries)[0]

    def neighbours(self, t: int, *, timeout: float = 60.0, retries: int = 0):
        """The full merged ``(ids, counts)`` row of term ``t``, served
        remotely (out-of-vocab ids raise the engine's ValueError)."""
        return self.execute([NeighboursRequest(t)], timeout=timeout,
                            retries=retries)[0]

    # ------------------------------------------------------------- assembly
    def _next_msg(self, rid: int, timeout: float):
        """Next buffered/arriving message for ``rid`` (others are buffered;
        messages for forgotten request ids are dropped, not buffered)."""
        deadline = time.monotonic() + timeout
        while not self._msgs.get(rid):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"no response for request {rid} in {timeout}s")
            try:
                got_rid, *msg = self._box.get(timeout=remaining)
            except queue.Empty:
                raise TimeoutError(
                    f"no response for request {rid} in {timeout}s"
                ) from None
            if got_rid in self._discard:
                if msg[3]:  # last flag: one in-flight part fully drained
                    self._discard[got_rid] -= 1
                    if self._discard[got_rid] <= 0:
                        del self._discard[got_rid]
                continue
            self._msgs.setdefault(got_rid, []).append(msg)
        return self._msgs[rid].pop(0)

    def _forget(self, rid: int, in_flight: int) -> None:
        """Stop expecting ``rid`` (error, timeout, shed retry, or a dropped
        stream): free its buffers and mark however many part-final messages
        are still in flight for discard, so a dead request id can never
        grow ``_msgs`` forever."""
        for msg in self._msgs.pop(rid, []):
            if msg[3]:  # last flag
                in_flight -= 1
        if in_flight > 0:
            self._discard[rid] = in_flight

    def _raise(self, payload):
        kind, message = payload
        if kind == "value_error":
            raise ValueError(message)  # mirror QueryEngine's local errors
        if kind == "worker_died":
            raise WorkerDied(message)
        if kind == "server_overloaded":
            raise ServerOverloaded(message)
        if kind == "deadline_expired":
            # the client-side deadline had already passed when the worker
            # dequeued it; surface the same type a local wait would have
            raise TimeoutError(message)
        raise ServingError(message)

    def _assemble(self, rid: int, req, timeout: float):
        """Collect all parts of a non-streamed request and scatter routed
        top-k slices back into their original row positions."""
        positions = self._positions.pop(rid, {})
        planned = max(len(positions), 1)
        done: dict[int, tuple] = {}
        finished = 0
        try:
            while finished < planned:
                part, nparts, seq, last, ok, payload, meta = self._next_msg(
                    rid, timeout
                )
                self.last_meta = meta
                if last:
                    finished += 1
                if not ok:
                    self._raise(payload)
                done[part] = payload
        except Exception:
            self._forget(rid, planned - finished)
            raise
        self._msgs.pop(rid, None)
        if planned == 1:
            return done[0]
        # routed top-k: scatter each worker's rows back by original position
        ids_p, scores_p = done[0]
        B = req.batch
        ids = np.empty((B, ids_p.shape[1]), dtype=ids_p.dtype)
        scores = np.empty((B, scores_p.shape[1]), dtype=scores_p.dtype)
        for part, (pids, pscores) in done.items():
            pos = positions[part]
            ids[pos] = pids
            scores[pos] = pscores
        return ids, scores

    def _stream(self, rid: int, req, timeout: float) -> _StreamIterator:
        """Lazy iterator over a streamed top-k's chunks, in score order.
        Dropping/closing the iterator at any point (even before the first
        ``next()``) forgets the rid, so unconsumed in-flight chunks are
        discarded instead of buffered forever."""
        self._positions.pop(rid, None)
        return _StreamIterator(self, rid, timeout)


class CoocServer:
    """Serve one on-disk store to many clients through shared-mmap worker
    processes with cross-client micro-batching, (optionally) hot-term
    routing, and a supervised fault-tolerance layer.

    Lifecycle: ``start()`` spawns the workers, the response router, and a
    supervisor thread; ``client()`` mints per-thread client handles;
    ``stats()`` is the live (and, after stop, final) aggregated view —
    counters summed and latency histograms merged across workers, with
    server-side queue-wait / execute / request-latency percentiles under
    ``"server_timing"`` and shed/respawn/deadline counters under
    ``"resilience"``; ``stop()`` drains the workers and returns the final
    stats.

    A worker that crashes is caught by the supervisor: its claimed
    (in-flight) requests fail back to their clients as :class:`WorkerDied`
    immediately, its queue backlog survives, the slot respawns up to
    ``max_respawns`` times, and its routed slice is served by siblings
    while the replacement warms. ``max_inflight`` bounds every request
    queue and sheds the overflow as :class:`ServerOverloaded` at submit.
    Usable as a context manager.

    Example::

        with CoocServer(path, workers=4, routing=True,
                        max_inflight=256) as server:
            ids, scores = server.client().topk([3], k=10)
            server.stats()["resilience"]     # shed / respawns / ...
        # __exit__ stopped the workers; server.stats() is now final
    """

    def __init__(
        self,
        store_path: str,
        *,
        workers: int = 2,
        batch_window_ms: float = 2.0,
        max_batch: int = 64,
        device: str = "cuda",
        cache_rows: int = 4096,
        routing: bool = False,
        stats_interval_s: float = 0.0,
        refresh_interval_ms: float = 0.0,
        max_inflight: int = 0,
        max_respawns: int = 2,
        report_inputs: bool = False,
    ):
        from repro_torch.store.segments import Store

        if not Store.exists(store_path):
            raise FileNotFoundError(f"no store at {store_path}")
        # the client-side planner: with routing, terms are hashed to the
        # worker that owns their cache row; without, one shared queue. The
        # planner's choices are authoritative — the worker config is built
        # from them, so plan and deployment cannot disagree (routing is
        # reported as inactive when workers == 1).
        self.planner = QueryPlanner(
            workers=workers, routing=routing, kernel=default_kernel(device)
        )
        self.store_path = store_path
        self.config = ServingConfig(
            workers=workers,
            batch_window_ms=batch_window_ms,
            max_batch=max_batch,
            device=str(device),
            cache_rows=cache_rows,
            routing=self.planner.routing,
            stats_interval_s=stats_interval_s,
            refresh_interval_ms=refresh_interval_ms,
            max_inflight=max_inflight,
            max_respawns=max_respawns,
            report_inputs=report_inputs,
        )
        self._stats_final: dict = {}
        self._worker_last: dict[int, dict] = {}   # freshest payload per worker
        self._worker_final: set[int] = set()
        # (worker id, payload): each dead incarnation's last snapshot
        self._worker_archive: list[tuple[int, dict]] = []
        self._procs: list = []
        self._boxes: dict[int, queue.Queue] = {}
        self._client_ids = itertools.count()
        self._router = None
        self._supervisor = None
        self._started = False
        # parent-side resilience telemetry + supervision state
        self._reg = obs.Registry(enabled=True)
        self._claims: dict[tuple, int] = {}       # in-flight tag -> worker id
        self._claims_lock = threading.Lock()
        self._failed_tags: set[tuple] = set()     # supervisor-failed; drop late msgs
        self._route_lock = threading.Lock()       # degraded/dead route state
        self._stats_lock = threading.Lock()       # _worker_last/_archive/_final
        self._degraded: set[int] = set()          # dead or warming: re-route
        self._dead: set[int] = set()              # respawn budget spent
        self._incarnation: dict[int, int] = {}    # wid -> current incarnation
        self._respawn_used: dict[int, int] = {}
        self._spawned_at: dict[int, float] = {}   # wid -> spawn time (monotonic)
        self._startup_s: dict[int, float] = {}    # wid -> spawn-to-ready seconds
        self._stopping = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "CoocServer":
        if self._started:
            raise RuntimeError("server already started")
        self._procs = []
        self._worker_final = set()
        self._stopping.clear()
        if self.config.device.startswith("cuda") and torch.cuda.is_available():
            # one nvcc here, not one per worker: the workers only load it
            _build.build_all([_topk_gather.KERNEL])
        # spawned children re-import repro_torch.store.serving: spawn_friendly_env
        # makes the package root importable and hides a script-style
        # __main__ for the duration of the spawns (see store/spawn.py)
        with spawn_friendly_env() as ctx:
            # routed: one request queue per worker (the planner picks the
            # queue); unrouted: one shared queue every worker drains
            # (work stealing). max_inflight bounds each queue — the shared
            # queue gets the whole fleet's budget
            n_queues = self.config.workers if self.config.routing else 1
            per_q = self.config.max_inflight
            if per_q and n_queues == 1:
                per_q *= self.config.workers
            self._request_qs = [
                ctx.Queue(maxsize=per_q) if per_q else ctx.Queue()
                for _ in range(n_queues)
            ]
            self._response_q = ctx.Queue()
            self._stats_q = ctx.Queue()
            for i in range(self.config.workers):
                self._procs.append(self._spawn_worker(ctx, i, incarnation=0))
        self._router = threading.Thread(target=self._route, daemon=True)
        self._router.start()
        self._supervisor = threading.Thread(target=self._supervise, daemon=True)
        self._supervisor.start()
        self._started = True
        return self

    def _spawn_worker(self, ctx, worker_id: int, incarnation: int):
        n_queues = len(self._request_qs)
        self._spawned_at[worker_id] = time.monotonic()
        p = ctx.Process(
            target=_worker_main,
            args=(
                worker_id,
                self.store_path,
                self.config,
                self._request_qs[worker_id % n_queues],
                self._response_q,
                self._stats_q,
                incarnation,
            ),
            daemon=True,
        )
        p.start()
        return p

    def _route(self) -> None:
        """Fan responses out of the single mp queue into per-client boxes,
        and keep the claims ledger: a ``claim`` records which worker holds
        which in-flight tags, a final response clears its tag, and a
        supervisor ``failtag`` delivers a synthetic :class:`WorkerDied`
        only if the tag is still claimed — flushed real responses that
        raced the death win, because they travel the same ordered queue."""
        while True:
            item = self._response_q.get()
            if _is_stop(item):
                return
            if item[0] == "claim":
                _, wid, inc, tags = item
                if inc < self._incarnation.get(wid, 0):
                    # pipe-buffered claim from an incarnation the supervisor
                    # already declared dead: its batch will never be
                    # answered, fail the tags now
                    for tag in tags:
                        self._deliver_failure(
                            tag, f"worker {wid} died mid-batch", wid
                        )
                    continue
                with self._claims_lock:
                    for tag in tags:
                        self._claims[tag] = wid
                continue
            if item[0] == "failtag":
                _, tag, message, wid = item
                with self._claims_lock:
                    owned = self._claims.pop(tag, None) is not None
                if owned:
                    self._deliver_failure(tag, message, wid)
                continue
            cid, rid, part, parts, seq, last, ok, payload, meta = item
            tag = (cid, rid, part, parts)
            if tag in self._failed_tags:
                # the supervisor already failed this tag to its client:
                # drop the late real answer instead of double-delivering
                if last:
                    self._failed_tags.discard(tag)
                    with self._claims_lock:
                        self._claims.pop(tag, None)
                continue
            if last:
                with self._claims_lock:
                    self._claims.pop(tag, None)
            box = self._boxes.get(cid)
            if box is not None:
                box.put((rid, part, parts, seq, last, ok, payload, meta))

    def _deliver_failure(
        self, tag, message: str, worker_id, *,
        kind: str = "worker_died", tombstone: bool = True,
    ) -> None:
        """Synthesize a final error message for ``tag`` into its client's
        box. ``tombstone`` guards against a flushed real answer arriving
        later (only possible for claimed tags; queue-drain failures can
        never be answered, so they skip the tombstone)."""
        cid, rid, part, parts = tag
        if tombstone:
            self._failed_tags.add(tag)
        self._reg.counter("serving/worker_died_failures").inc()
        box = self._boxes.get(cid)
        if box is not None:
            box.put((rid, part, parts, 0, True, False, (kind, message),
                     {"worker": worker_id, "supervisor": True}))

    # ----------------------------------------------------------- submission
    def _submit(self, worker: int | None, envelope) -> None:
        if not self._started:
            raise RuntimeError("server not started (call start())")
        qs = self._request_qs
        with self._route_lock:
            if len(self._dead) >= self.config.workers:
                raise WorkerDied(
                    "every worker is dead and the respawn budget is spent"
                )
            if len(qs) == 1:
                target_q, target_w = qs[0], None
            else:
                w = (worker if worker is not None else 0) % len(qs)
                target = w
                if w in self._degraded:
                    # the slot is dead or warming: serve its vocabulary
                    # slice from the next live worker (routing is a cache
                    # optimization — any worker answers any slice), falling
                    # back to the home queue if the whole fleet is warming
                    for off in range(1, len(qs)):
                        cand = (w + off) % len(qs)
                        if cand not in self._degraded:
                            target = cand
                            break
                    else:
                        if w in self._dead:
                            for off in range(1, len(qs)):
                                cand = (w + off) % len(qs)
                                if cand not in self._dead:
                                    target = cand
                                    break
                target_q, target_w = qs[target], target
        try:
            if self.config.max_inflight:
                target_q.put_nowait(envelope)
            else:
                target_q.put(envelope)
        except queue.Full:
            self._reg.counter("serving/shed").inc()
            where = "" if target_w is None else f" of worker {target_w}"
            raise ServerOverloaded(
                f"request queue{where} is full "
                f"(max_inflight={self.config.max_inflight}); shed at submit"
            ) from None

    def client(self) -> CoocClient:
        """Mint a client handle (one per concurrent client thread)."""
        cid = next(self._client_ids)
        box: queue.Queue = queue.Queue()
        self._boxes[cid] = box
        return CoocClient(self, cid, box)

    # ---------------------------------------------------------- supervision
    def _supervise(self) -> None:
        """Watch worker exitcodes: a dead worker's claimed requests fail
        back typed and fast, its slot respawns (budget allowing) on its
        intact queue, and its routed slice degrades onto siblings until
        the replacement reports ready."""
        while not self._stopping.wait(_SUPERVISE_INTERVAL_S):
            self._drain_stats_q()
            for wid in range(self.config.workers):
                if wid in self._dead:
                    continue
                p = self._procs[wid]
                if p.exitcode is None:
                    continue
                self._on_worker_death(wid, p.exitcode)

    def _on_worker_death(self, wid: int, exitcode) -> None:
        with self._route_lock:
            self._degraded.add(wid)
        # archive the dead incarnation's freshest snapshot (its counters
        # keep contributing to the aggregate) and bump the incarnation so
        # pipe-buffered snapshots from the corpse are ignored
        self._drain_stats_q()
        with self._stats_lock:
            payload = self._worker_last.pop(wid, None)
            if payload is not None:
                self._worker_archive.append((wid, payload))
            self._worker_final.discard(wid)
        inc = self._incarnation.get(wid, 0) + 1
        self._incarnation[wid] = inc
        reason = f"worker {wid} died (exitcode {exitcode})"
        # fail the claimed tags through the response queue, not straight to
        # the boxes: the dead worker's flushed answers are already ahead of
        # the failtag in the same ordered pipe, so whatever it actually
        # answered wins and only the truly stranded tags fail
        with self._claims_lock:
            tags = [t for t, w in self._claims.items() if w == wid]
        for tag in tags:
            self._response_q.put((
                "failtag", tag,
                f"{reason}; in-flight request failed by supervisor", wid,
            ))
        used = self._respawn_used.get(wid, 0)
        if used < self.config.max_respawns:
            self._respawn_used[wid] = used + 1
            self._reg.counter("serving/respawns").inc()
            with spawn_friendly_env() as ctx:
                self._procs[wid] = self._spawn_worker(ctx, wid, incarnation=inc)
        else:
            with self._route_lock:
                self._dead.add(wid)
            if len(self._request_qs) > 1:
                self._drain_dead_queue(wid, reason)

    def _drain_dead_queue(self, wid: int, reason: str) -> None:
        """A slot whose respawn budget is spent leaves envelopes stranded on
        its routed queue: re-route each to a surviving worker, or fail it
        back typed if none can take it."""
        q = self._request_qs[wid % len(self._request_qs)]
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                return
            if _is_stop(item) or not isinstance(item, tuple) or len(item) < 5:
                continue
            tag = (item[0], item[1], item[2], item[3])
            try:
                self._submit(wid + 1, item)
            except ServerOverloaded as e:
                self._deliver_failure(
                    tag, str(e), wid, kind="server_overloaded", tombstone=False
                )
            except Exception as e:
                self._deliver_failure(
                    tag, f"{reason}; re-route failed: {e}", wid,
                    tombstone=False,
                )

    # ------------------------------------------------------------ telemetry
    def _absorb_stats_msg(self, kind: str, wid: int, payload) -> None:
        inc = (payload or {}).get("incarnation", 0)
        cur = self._incarnation.get(wid, 0)
        if kind == "ready":
            if inc >= cur:
                self._startup_s[wid] = time.monotonic() - self._spawned_at[wid]
                with self._route_lock:
                    self._degraded.discard(wid)
            return
        if inc < cur:
            return  # stale pipe data from a dead incarnation (archived)
        with self._stats_lock:
            self._worker_last[wid] = payload
            if kind == "final":
                self._worker_final.add(wid)

    def _drain_stats_q(self) -> None:
        """Pull every pending worker message off the stats queue. Each
        worker's freshest payload wins; ``("final", ...)`` marks a clean
        exit; ``("ready", ...)`` clears a warming slot's degraded flag."""
        while True:
            try:
                kind, wid, payload = self._stats_q.get_nowait()
            except queue.Empty:
                return
            self._absorb_stats_msg(kind, wid, payload)

    def stats(self) -> dict:
        """Aggregated serving stats: counters summed and latency histograms
        merged across workers (dead incarnations' archived snapshots keep
        counting). Live (from the freshest per-worker snapshots) while the
        server runs; final after :meth:`stop`.

        Keys of note: ``server_timing`` (queue-wait / execute /
        request-latency p50/p95/p99 in ms, from the merged histograms),
        ``resilience`` (requests shed at admission, worker respawns,
        supervisor-failed in-flight requests, deadline-expired skips, and
        the currently degraded worker slots), ``freshness`` (manifest
        generation, segment count per format version, seconds since the
        newest segment was created — the most advanced worker view wins, so
        it tracks a stream daemon's commits live), ``workers_lost`` (worker
        slots that never sent a final snapshot), ``storage`` (codec traffic
        on v2 compressed stores: blocks decoded, block-cache hit rate,
        bloom negative rate — zeros on raw v1), ``metrics`` (the raw merged
        snapshot — feed it to ``repro_torch.obs.prometheus_text``; after
        :meth:`stop` it also holds every worker's span ``events``, on the
        timeline of its ``epoch_unix``),
        ``per_worker`` (each slot's own counters from its freshest
        snapshot, a dead incarnation's if its replacement has not reported
        or none was spawned, e.g. per-worker ``cache_hit_rate`` under
        routing, its ``device`` and its ``kernel_launches``; a slot that
        never reported has no entry), ``kernel_launches`` (summed over every
        incarnation), ``worker_startup_s`` (each slot's current incarnation,
        spawn to ready)."""
        if not self._started:
            return self._stats_final
        self._drain_stats_q()
        return self._aggregate(live=True)

    def _aggregate(self, *, live: bool, workers_lost: int = 0) -> dict:
        with self._stats_lock:
            current = dict(self._worker_last)
            archive = list(self._worker_archive)
        payloads = [p for _, p in archive] + list(current.values())
        # a slot's entry is its current incarnation's snapshot, else the
        # last one archived when an incarnation died: a dead slot keeps its
        # place whether or not the supervisor saw the death before stop()
        latest = dict(archive)
        latest.update(current)
        per_worker = {w: p["stats"] for w, p in latest.items()}
        stat_dicts = [p["stats"] for p in payloads]
        agg = {
            k: sum(d[k] for d in stat_dicts)
            for k in stat_dicts[0]
            if k not in ("cache_hit_rate", "device", "kernel_launches")
        } if stat_dicts else {}
        if agg:
            agg["max_batch_requests"] = max(
                d["max_batch_requests"] for d in stat_dicts
            )
            agg["avg_requests_per_batch"] = round(
                agg["requests"] / max(agg["batches"], 1), 2
            )
            agg["cache_hit_rate"] = round(
                agg["cache_hits"]
                / max(agg["cache_hits"] + agg["cache_misses"], 1),
                4,
            )
            agg["kernel_launches"] = {
                k.name: sum(d["kernel_launches"][k.name] for d in stat_dicts)
                for k in ops.KERNELS
            }
        metrics = obs.merge_snapshots(
            [p["metrics"] for p in payloads] + [self._reg.snapshot()]
        )
        timing = {}
        for key, hname in (
            ("queue_wait_ms", "serving/queue_wait_s"),
            ("execute_ms", "serving/execute_s"),
            ("request_latency_ms", "serving/request_latency_s"),
        ):
            state = metrics["histograms"].get(hname)
            if state:
                h = obs.Histogram.from_state(state)
                timing[key] = {
                    "p50": round(h.percentile(50) * 1e3, 3),
                    "p95": round(h.percentile(95) * 1e3, 3),
                    "p99": round(h.percentile(99) * 1e3, 3),
                    "mean": round(h.mean * 1e3, 3),
                    "count": h.count,
                }
        # freshness: the most advanced manifest view any worker has reported
        # (highest generation wins — a sibling mid-refresh may lag by one),
        # with staleness derived from the newest segment's creation stamp
        fresh_views = [p["freshness"] for p in payloads if p.get("freshness")]
        freshness = {}
        if fresh_views:
            freshness = dict(
                max(fresh_views, key=lambda f: f.get("generation", 0))
            )
            last_append = freshness.get("last_append_unix")
            freshness["seconds_since_last_append"] = (
                round(max(time.time() - last_append, 0.0), 3)
                if last_append else None
            )
        # storage-engine counters (v2 compressed segments; zeros on raw v1
        # stores): codec traffic plus derived block-cache / bloom hit rates
        ctr = metrics.get("counters", {})
        decoded = ctr.get("storage.blocks_decoded", 0)
        c_hits = ctr.get("storage.block_cache_hits", 0)
        c_miss = ctr.get("storage.block_cache_misses", 0)
        b_checks = ctr.get("storage.bloom_checks", 0)
        b_neg = ctr.get("storage.bloom_negative", 0)
        storage = {
            "blocks_decoded": decoded,
            "block_cache_hit_rate": round(c_hits / max(c_hits + c_miss, 1), 4),
            "bloom_checks": b_checks,
            "bloom_negative": b_neg,
            "bloom_negative_rate": round(b_neg / max(b_checks, 1), 4),
        }
        with self._route_lock:
            degraded = sorted(self._degraded | self._dead)
        resilience = {
            "shed": ctr.get("serving/shed", 0),
            "respawns": ctr.get("serving/respawns", 0),
            "worker_died_failures": ctr.get("serving/worker_died_failures", 0),
            "deadline_expired": ctr.get("serving/deadline_expired", 0),
            "degraded_workers": degraded,
            "max_inflight": self.config.max_inflight,
            "max_respawns": self.config.max_respawns,
        }
        return {
            "workers": self.config.workers,
            "device": self.config.device,
            "batch_window_ms": self.config.batch_window_ms,
            "routing": self.config.routing,
            "live": live,
            **agg,
            "workers_lost": workers_lost,
            "server_timing": timing,
            "resilience": resilience,
            "freshness": freshness,
            "storage": storage,
            "metrics": metrics,
            "per_worker": [per_worker[w] for w in sorted(per_worker)],
            "worker_startup_s": [
                self._startup_s.get(w) for w in range(self.config.workers)
            ],
        }

    # -------------------------------------------------------------- shutdown
    def _put_sentinel(self, q) -> None:
        """Enqueue one stop sentinel without blocking ``stop()`` behind a
        full bounded queue: a backlog at shutdown is failed back to its
        clients typed, not waited on."""
        need = 1
        while need:
            try:
                q.put_nowait(_STOP)
                need -= 1
            except queue.Full:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    continue
                if _is_stop(item):
                    need += 1  # restore the sentinel we just displaced
                elif isinstance(item, tuple) and len(item) >= 5:
                    self._deliver_failure(
                        (item[0], item[1], item[2], item[3]),
                        "server stopping with the request still queued",
                        None, tombstone=False,
                    )

    def stop(self, timeout: float = 120.0) -> dict:
        """Drain the workers and return the final aggregated serving stats.

        A worker that died without its final snapshot no longer takes the
        whole ``stop()`` down: its freshest periodic snapshot (if any)
        stands in, and the loss is surfaced as ``stats()["workers_lost"]``
        — silent stats loss was the old failure mode. The dead-with-backlog
        case (worker dead while siblings keep the stats pipe busy) is
        detected every iteration, not only when the pipe goes quiet, so
        stop returns in milliseconds instead of burning the full
        ``timeout``."""
        if not self._started:
            return self._stats_final
        # supervision off first: worker exits at the stop sentinel are
        # clean shutdowns, not deaths to respawn
        self._stopping.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        if self.config.routing:
            for q in self._request_qs:
                self._put_sentinel(q)
        else:
            for _ in self._procs:
                self._put_sentinel(self._request_qs[0])
        expected = set(range(len(self._procs)))
        deadline = time.monotonic() + timeout
        while self._worker_final < expected and time.monotonic() < deadline:
            try:
                kind, wid, payload = self._stats_q.get(timeout=0.1)
                self._absorb_stats_msg(kind, wid, payload)
            except queue.Empty:
                pass
            missing = expected - self._worker_final
            if missing and all(
                self._procs[w].exitcode is not None for w in missing
            ):
                # every missing worker is already dead: its final snapshot
                # either sits in the pipe (grace drain below) or will never
                # come — in neither case is the 120s wait loop warranted
                grace = time.monotonic() + 0.5
                while (self._worker_final < expected
                       and time.monotonic() < min(grace, deadline)):
                    time.sleep(0.02)
                    self._drain_stats_q()
                break
        workers_lost = len(expected - self._worker_final)
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
            if p.is_alive():
                p.terminate()
        self._response_q.put(_STOP)
        self._router.join(timeout=5)
        self._started = False
        self._stats_final = self._aggregate(
            live=False, workers_lost=workers_lost
        )
        return self._stats_final

    def __enter__(self) -> "CoocServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
