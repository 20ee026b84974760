"""Typed query requests, query planning, and the one execution path.

Read-side counterpart of the counting planner (core/plan.py): a query is a
frozen, validated request object, a batch of requests is turned into an
executable :class:`QueryPlan` by the :class:`QueryPlanner`, and one shared
executor (:func:`execute_groups`) answers the plan — the same code whether
the caller is the in-process :class:`~repro_torch.store.query.QueryEngine` or a
serving worker process (store/serving.py). The request objects **are** the
wire protocol: a client pickles the exact dataclasses the engine executes,
so invalid queries (unknown score, bad dtype, k < 1) fail at construction
on the client, never mid-batch inside a worker.

    requests ──▶ QueryPlanner.plan() ──▶ QueryPlan ──▶ execute_groups()
       │               │                     │
       │               │                     └─ coalescing groups: one kernel
       │               │                        launch per (k, score) group
       │               └─ hot-term routing: terms hashed to workers so
       │                  per-worker LRU caches partition the vocabulary
       └─ TopKRequest | PairCountsRequest | NeighboursRequest
          (validated at construction; frozen; picklable)

**Hot-term routing.** With ``routing=True`` the planner splits each top-k
request by term ownership: term ``t`` belongs to worker
``(t * 2654435761 mod 2**32) * workers >> 32`` (Knuth's multiplicative
hash with multiply-shift range reduction — deterministic across processes
and Python runs, no seed). Every query for a
given term therefore lands on the same worker, so N per-worker LRU row
caches hold N disjoint slices of the vocabulary instead of N copies of the
Zipf head. The client reassembles per-worker partial results by the
``positions`` recorded in each :class:`RoutedPart` — reassembly is
byte-identical to the unsplit answer (same scores, ids, tie order, padding;
see docs/serving.md).

**Streaming top-k.** A :class:`TopKRequest` with ``chunk=c`` answers as an
iterator of score-ordered ``(ids, scores)`` column blocks of width ≤ c
instead of one monolithic ``(B, k)`` pair — large-k responses cross the
process boundary chunk by chunk. Concatenating the chunks along axis 1
reproduces the monolithic result exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCORES = ("count", "pmi", "dice")
# score-and-select backends, picked by the device the engine runs on: the
# hand-written kernel for a CUDA device, its plain PyTorch version on the host
KERNELS = ("cuda", "plain")

# Knuth's multiplicative hash constant (2^32 / phi); see route_term().
_ROUTE_MULT = 2654435761


# ---------------------------------------------------------------------------
# request types (the wire protocol)
# ---------------------------------------------------------------------------


def _as_terms(terms) -> np.ndarray:
    """Normalize to a 1-D int64 term-id array; reject non-integer dtypes."""
    t = np.atleast_1d(np.asarray(terms))
    if t.ndim != 1:
        raise ValueError(f"terms must be 1-D, got shape {t.shape}")
    if t.size and not np.issubdtype(t.dtype, np.integer):
        raise ValueError(
            f"terms must be integer term ids, got dtype {t.dtype}"
        )
    return np.ascontiguousarray(t, dtype=np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class TopKRequest:
    """Top-k neighbours of a batch of terms, scored by count/PMI/Dice.

    Validation happens at construction — an unknown ``score``, ``k < 1``, a
    float ``terms`` dtype, or ``chunk < 1`` raise here, on the client, not
    inside a serving worker mid-batch. ``chunk`` turns the response into a
    stream of score-ordered column blocks (see module docstring).

    Example::

        req = TopKRequest([3, 17], k=10, score="pmi")
        ids, scores = engine.execute([req])[0]
    """

    terms: np.ndarray
    k: int = 10
    score: str = "count"
    chunk: int | None = None          # None = monolithic; else stream width

    def __post_init__(self):
        object.__setattr__(self, "terms", _as_terms(self.terms))
        if not isinstance(self.k, (int, np.integer)) or self.k < 1:
            raise ValueError(f"k must be an int >= 1, got {self.k!r}")
        if self.score not in SCORES:
            raise ValueError(f"unknown score {self.score!r}; have {SCORES}")
        if self.chunk is not None and (
            not isinstance(self.chunk, (int, np.integer)) or self.chunk < 1
        ):
            raise ValueError(f"chunk must be an int >= 1, got {self.chunk!r}")

    @property
    def batch(self) -> int:
        return len(self.terms)


@dataclasses.dataclass(frozen=True, eq=False)
class PairCountsRequest:
    """Exact co-occurrence counts for a ``(B, 2)`` batch of term pairs.

    Example::

        req = PairCountsRequest(np.array([[3, 17], [5, 5]]))
        counts = engine.execute([req])[0]
    """

    pairs: np.ndarray

    def __post_init__(self):
        p = np.asarray(self.pairs)
        if p.ndim == 1 and p.shape == (2,):
            p = p[None, :]
        if p.ndim != 2 or p.shape[1] != 2:
            raise ValueError(f"pairs must have shape (B, 2), got {p.shape}")
        if p.size and not np.issubdtype(p.dtype, np.integer):
            raise ValueError(
                f"pairs must be integer term ids, got dtype {p.dtype}"
            )
        object.__setattr__(self, "pairs", np.ascontiguousarray(p, dtype=np.int64))

    @property
    def batch(self) -> int:
        return len(self.pairs)


@dataclasses.dataclass(frozen=True, eq=False)
class NeighboursRequest:
    """The full merged ``(neighbour_ids, counts)`` row of one term.

    Example::

        ids, counts = engine.execute([NeighboursRequest(3)])[0]
    """

    term: int

    def __post_init__(self):
        if not isinstance(self.term, (int, np.integer)):
            raise ValueError(
                f"term must be an integer id, got {type(self.term).__name__}"
            )
        object.__setattr__(self, "term", int(self.term))


QueryRequest = TopKRequest | PairCountsRequest | NeighboursRequest


# ---------------------------------------------------------------------------
# wire envelopes
# ---------------------------------------------------------------------------


def make_envelope(
    client_id: int,
    request_id: int,
    part: int,
    parts: int,
    request,
    *,
    t_submit: float | None = None,
    deadline: float | None = None,
) -> tuple:
    """One wire envelope, the unit that crosses a serving request queue:

        (client_id, request_id, part, parts, request, t_submit, deadline)

    ``t_submit`` is the client's submit wall-clock (unix time — the one
    clock two processes share; queue-wait histograms subtract it) and
    ``deadline`` the absolute unix time after which the client has given
    up: a worker dequeueing an expired envelope answers it with a typed
    ``deadline_expired`` error instead of burning a kernel launch on a
    response nobody is waiting for. Both trailing fields are optional —
    :func:`envelope_times` accepts legacy 5-tuples.

    Example::

        env = make_envelope(0, 7, 0, 1, TopKRequest([3]), deadline=1e12)
        envelope_times(env)[1] == 1e12   # True
    """
    return (client_id, request_id, part, parts, request, t_submit, deadline)


def envelope_times(envelope) -> tuple[float | None, float | None]:
    """``(t_submit, deadline)`` of a wire envelope; short (legacy,
    hand-built) tuples yield ``(None, None)`` — both features degrade to
    "not measured" / "no deadline" rather than failing."""
    t_submit = envelope[5] if len(envelope) > 5 else None
    deadline = envelope[6] if len(envelope) > 6 else None
    return t_submit, deadline


def check_request_types(requests) -> None:
    """Raise TypeError unless every element is one of the request types."""
    for r in requests:
        if not isinstance(
            r, (TopKRequest, PairCountsRequest, NeighboursRequest)
        ):
            raise TypeError(
                f"not a query request: {type(r).__name__} (have "
                "TopKRequest, PairCountsRequest, NeighboursRequest)"
            )


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def default_kernel(device: str = "cuda") -> str:
    """The score-and-select backend that runs on ``device``: ``"cuda"`` (the
    hand-written kernel) for a CUDA device, ``"plain"`` (its PyTorch
    version) on the host.

    Example::

        default_kernel("cpu")    # 'plain'
    """
    return "plain" if str(device).startswith("cpu") else "cuda"


def route_term(t: int, workers: int) -> int:
    """The worker that owns term ``t``'s cache row:
    ``(t * 2654435761 mod 2**32) * workers >> 32``.

    Knuth multiplicative hash with multiply-shift range reduction — the
    reduction reads the product's *high* bits, which the multiplier mixes
    well for any worker count (a plain ``% workers`` would read the low
    bits, and 2654435761 ≡ 1 mod 16, collapsing to ``t % workers`` for
    power-of-two worker counts). Stable across processes/runs (no seed, no
    Python hash randomization), so the client-side planner and any
    diagnostic tooling agree on placement without coordination.

    Example::

        route_term(42, 4) == route_term(42, 4)   # always
    """
    return (int(t) * _ROUTE_MULT % (1 << 32)) * workers >> 32


def route_terms(terms: np.ndarray, workers: int) -> np.ndarray:
    """Vectorized :func:`route_term` (identical placement)."""
    t = np.asarray(terms, dtype=np.uint64)
    h = (t * np.uint64(_ROUTE_MULT)) % np.uint64(1 << 32)
    return ((h * np.uint64(workers)) >> np.uint64(32)).astype(np.int64)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoutedPart:
    """One executable slice of a request, bound to (at most) one worker.

    ``worker=None`` means "any worker" (unrouted: the shared queue).
    ``positions`` are the rows of the *original* request this part covers,
    used by the caller to scatter partial results back; ``None`` means the
    part covers the whole request in order.
    """

    request: QueryRequest
    worker: int | None = None
    part: int = 0
    parts: int = 1
    positions: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """What the planner decided for one batch of requests.

    ``parts[i]`` are the routed parts of ``requests[i]``; execution answers
    every part and the caller reassembles by ``positions``. ``kernel`` is
    the planner's score-and-select backend choice — the serving layer boots
    its workers from it, so the plan records what actually executes.

    Example::

        plan = QueryPlanner(workers=4, routing=True).plan([req])
        [p.worker for p in plan.parts[0]]     # cache-owner per slice
    """

    requests: tuple
    parts: tuple
    workers: int = 1
    routing: bool = False
    kernel: str = "cuda"

    def by_worker(self) -> dict:
        """``{worker: [(request_index, RoutedPart), ...]}`` submission order."""
        out: dict = {}
        for i, rparts in enumerate(self.parts):
            for rp in rparts:
                out.setdefault(rp.worker, []).append((i, rp))
        return out

    def describe(self) -> dict:
        """JSON-serializable provenance (mirrors core Plan.describe())."""
        return {
            "requests": len(self.requests),
            "parts": sum(len(p) for p in self.parts),
            "workers": self.workers,
            "routing": self.routing,
            "kernel": self.kernel,
        }


class QueryPlanner:
    """Turns a batch of request objects into an executable :class:`QueryPlan`.

    With ``routing=False`` (or one worker) every request is a single part
    for any worker. With ``routing=True`` top-k requests are split by term
    ownership (:func:`route_term`) so each slice lands on the worker whose
    LRU cache owns those rows; neighbours requests route by their term;
    pair-count requests go whole to one worker (point lookups bypass the
    row cache, so splitting them buys nothing).

    Streamed top-k requests (``chunk`` set) are never split: one worker owns
    the whole stream (routed by the first term) so chunks arrive in order.

    Example::

        planner = QueryPlanner(workers=4, routing=True)
        plan = planner.plan([TopKRequest(range(128), k=10)])
        len(plan.parts[0])        # up to 4 slices, one per cache owner
    """

    def __init__(
        self,
        *,
        workers: int = 1,
        routing: bool = False,
        kernel: str | None = None,
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if kernel is None:
            kernel = default_kernel()
        elif kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; have {KERNELS}")
        self.workers = workers
        # routing needs >= 2 caches to partition; with one worker the plan
        # is honest about being unrouted (and stats report it that way)
        self.routing = routing and workers > 1
        self.kernel = kernel

    def plan(self, requests) -> QueryPlan:
        reqs = tuple(requests)
        check_request_types(reqs)
        return QueryPlan(
            requests=reqs,
            parts=tuple(tuple(self._split(r)) for r in reqs),
            workers=self.workers,
            routing=self.routing,
            kernel=self.kernel,
        )

    # ------------------------------------------------------------ internals
    def _split(self, req) -> list[RoutedPart]:
        if not self.routing:
            return [RoutedPart(request=req)]
        if isinstance(req, NeighboursRequest):
            return [RoutedPart(request=req, worker=route_term(req.term, self.workers))]
        if isinstance(req, PairCountsRequest):
            # point lookups bypass the row cache, so placement only matters
            # for load spread: hash the whole batch, not its first term
            # (which would pile every probe of one hot term on one worker)
            w = route_term(int(req.pairs.sum()), self.workers) if req.batch else 0
            return [RoutedPart(request=req, worker=w)]
        # TopKRequest
        if req.chunk is not None or req.batch == 0:
            w = route_term(int(req.terms[0]), self.workers) if req.batch else 0
            return [RoutedPart(request=req, worker=w)]
        owners = route_terms(req.terms, self.workers)
        used = np.unique(owners)
        if len(used) == 1:
            return [RoutedPart(request=req, worker=int(used[0]))]
        parts = []
        for part, w in enumerate(used):
            pos = np.nonzero(owners == w)[0]
            sub = TopKRequest(
                terms=req.terms[pos], k=req.k, score=req.score, chunk=None
            )
            parts.append(
                RoutedPart(
                    request=sub,
                    worker=int(w),
                    part=part,
                    parts=len(used),
                    positions=pos,
                )
            )
        return parts


# ---------------------------------------------------------------------------
# the one execution path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecGroup:
    """A coalescing group: requests answerable by one kernel launch."""

    kind: str          # "topk" | "topk-stream" | "pairs" | "neighbours"
    key: tuple | None  # (k, score) for "topk"
    items: list        # [(tag, request), ...] — tag is caller-opaque


def coalesce(tagged_requests) -> list[ExecGroup]:
    """Group ``(tag, request)`` pairs for minimal kernel launches: one
    ``topk`` launch per distinct ``(k, score)``, all pair lookups together,
    each stream and each neighbours row on its own. Tags are opaque to the
    executor and come back through ``emit`` — the in-process engine uses
    request indices, serving workers use ``(client, request, part)``."""
    topk: dict[tuple, ExecGroup] = {}
    pairs: ExecGroup | None = None
    out: list[ExecGroup] = []
    for tag, req in tagged_requests:
        if isinstance(req, TopKRequest) and req.chunk is None:
            key = (int(req.k), req.score)
            g = topk.get(key)
            if g is None:
                g = topk[key] = ExecGroup("topk", key, [])
                out.append(g)
            g.items.append((tag, req))
        elif isinstance(req, TopKRequest):
            out.append(ExecGroup("topk-stream", None, [(tag, req)]))
        elif isinstance(req, PairCountsRequest):
            if pairs is None:
                pairs = ExecGroup("pairs", None, [])
                out.append(pairs)
            pairs.items.append((tag, req))
        elif isinstance(req, NeighboursRequest):
            out.append(ExecGroup("neighbours", None, [(tag, req)]))
        else:
            out.append(ExecGroup("invalid", None, [(tag, req)]))
    return out


def _bump(stats, key, n=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def execute_groups(engine, groups, emit, stats=None) -> None:
    """Answer coalesced groups against ``engine``, reporting through
    ``emit(tag, ok, payload, *, seq=0, last=True, extra=None)``.

    This is the single execution path behind ``QueryEngine.execute`` (tags
    are request indices, emit collects into a list) and the serving workers
    (tags carry client/request/part ids, emit puts response messages on the
    mp queue). Per-item validation errors are emitted as
    ``("value_error", message)`` payloads and never poison sibling requests
    in the same group."""
    for g in groups:
        if g.kind == "topk":
            _exec_topk(engine, g, emit, stats)
        elif g.kind == "topk-stream":
            _exec_stream(engine, g, emit, stats)
        elif g.kind == "pairs":
            _exec_pairs(engine, g, emit, stats)
        elif g.kind == "neighbours":
            _exec_neighbours(engine, g, emit, stats)
        else:  # "invalid": a non-request object reached a worker
            for tag, req in g.items:
                emit(
                    tag, False,
                    ("value_error", f"not a query request: {type(req).__name__}"),
                )


def _exec_topk(engine, group, emit, stats) -> None:
    k, score = group.key
    live = []
    for tag, req in group.items:
        try:
            engine._check_terms(req.terms)
            live.append((tag, req))
        except ValueError as e:
            emit(tag, False, ("value_error", str(e)))
    if not live:
        return
    all_terms = np.concatenate([r.terms for _, r in live])
    try:
        ids, scores = engine._topk_batch(all_terms, k=k, score=score)
    except ValueError as e:  # defensive: requests validate score/k upfront
        for tag, _ in live:
            emit(tag, False, ("value_error", str(e)))
        return
    _bump(stats, "topk_launches")
    _bump(stats, "topk_queries", len(all_terms))
    extra = {"coalesced_requests": len(live)}
    off = 0
    for tag, req in live:
        n = req.batch
        emit(tag, True, (ids[off : off + n], scores[off : off + n]), extra=extra)
        off += n


def _exec_stream(engine, group, emit, stats) -> None:
    for tag, req in group.items:
        try:
            engine._check_terms(req.terms)
            ids, scores = engine._topk_batch(req.terms, k=req.k, score=req.score)
        except ValueError as e:
            emit(tag, False, ("value_error", str(e)))
            continue
        _bump(stats, "topk_launches")
        _bump(stats, "topk_queries", req.batch)
        chunk = int(req.chunk)
        n_chunks = max(-(-req.k // chunk), 1)
        extra = {"chunks": n_chunks}
        for i in range(n_chunks):
            sl = slice(i * chunk, min((i + 1) * chunk, req.k))
            _bump(stats, "stream_chunks")
            emit(
                tag, True, (ids[:, sl], scores[:, sl]),
                seq=i, last=(i == n_chunks - 1), extra=extra,
            )


def _exec_pairs(engine, group, emit, stats) -> None:
    live = []
    for tag, req in group.items:
        try:
            engine._check_terms(req.pairs.reshape(-1))
            live.append((tag, req))
        except ValueError as e:
            emit(tag, False, ("value_error", str(e)))
    if not live:
        return
    all_pairs = np.concatenate([r.pairs for _, r in live])
    counts = engine.store.pair_counts(all_pairs)
    _bump(stats, "pair_launches")
    _bump(stats, "pair_queries", len(all_pairs))
    extra = {"coalesced_requests": len(live)}
    off = 0
    for tag, req in live:
        n = req.batch
        emit(tag, True, counts[off : off + n], extra=extra)
        off += n


def _exec_neighbours(engine, group, emit, stats) -> None:
    for tag, req in group.items:
        try:
            engine._check_terms(np.asarray([req.term], dtype=np.int64))
        except ValueError as e:
            emit(tag, False, ("value_error", str(e)))
            continue
        _bump(stats, "neighbours_queries")
        emit(tag, True, engine._row(req.term))
