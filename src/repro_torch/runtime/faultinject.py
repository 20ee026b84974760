"""Env-gated fault injection: named failpoints for resilience testing.

Fault tolerance that was never exercised is hope, not engineering. This
registry lets tests and benchmarks *script* failures into the serving
layer (store/serving.py) — and any future subsystem — without patching
code: a failpoint is a named hook compiled into the hot path that does
nothing unless the ``REPRO_FAULTS`` environment variable arms it. The env
var is the transport on purpose: serving workers are **spawned** processes
that inherit ``os.environ``, so one assignment in the test process arms
the same schedule in every worker it launches.

Spec format — semicolon-separated ``name=arg`` entries::

    REPRO_FAULTS="kill-worker=1:3;stall-queue=0:0.25:2"

Args are colon-separated fields; a leading ``wid`` field — only recognized
when two or more fields are present — scopes the point to one worker
(``*`` or omitted = every worker; a lone field is always the value, so
``drop-response=4`` means N=4 on any worker, not worker 4). The serving
failpoints:

| failpoint       | arg                | effect                               |
|-----------------|--------------------|--------------------------------------|
| ``kill-worker`` | ``[wid:]N``        | SIGKILL self when the worker has     |
|                 |                    | completed ``N`` micro-batches and    |
|                 |                    | claims the next one (mid-flight)     |
| ``stall-queue`` | ``[wid:]S[:N]``    | sleep ``S`` seconds before each of   |
|                 |                    | the next ``N`` batches (default 1) — |
|                 |                    | the queue backs up behind the stall  |
| ``drop-response``| ``[wid:]N[:skip]``| silently discard the worker's next   |
|                 |                    | ``N`` answer messages after letting  |
|                 |                    | ``skip`` through (claims still flow, |
|                 |                    | so supervision stays honest)         |

Disarmed (the default — ``REPRO_FAULTS`` unset or empty) every check is
one dict lookup on an empty registry; nothing is configured, parsed, or
counted. Points are **per-process**: each worker parses the env var once
at startup, and hit counters (the "after N" state) live in that process.

Example::

    >>> fr = FaultRegistry("kill-worker=1:3;stall-queue=0.25")
    >>> fr.active("kill-worker"), fr.active("nope")
    (True, False)
    >>> fr.kill_worker(worker=1, batches_done=2)   # not yet
    False
    >>> fr.stall_queue(worker=0)                   # unscoped: any worker
    0.25
    >>> fr.stall_queue(worker=0)                   # budget of 1 spent
    0.0
    >>> FaultRegistry("").active("kill-worker")    # disarmed registry
    False
"""

from __future__ import annotations

import os
import time

ENV_VAR = "REPRO_FAULTS"

# serving failpoint names (the registry itself is name-agnostic; these are
# the points store/serving.py compiles in)
KILL_WORKER = "kill-worker"
STALL_QUEUE = "stall-queue"
DROP_RESPONSE = "drop-response"

_ANY = None  # unscoped wid field


def _parse_arg(arg: str) -> tuple[int | None, list[str]]:
    """Split ``[wid:]fields...`` — a leading integer field is a worker
    scope only when more fields follow it (a lone field is always the
    value); ``*`` (or a leading non-integer) means every worker."""
    fields = arg.split(":") if arg else []
    if not fields:
        return _ANY, []
    if fields[0] == "*":
        return _ANY, fields[1:]
    if len(fields) >= 2:
        try:
            return int(fields[0]), fields[1:]
        except ValueError:
            return _ANY, fields
    return _ANY, fields


class FaultRegistry:
    """Parsed failpoint schedule of one process.

    ``active(name)`` is the cheap guard call sites use before doing any
    work; the named helpers (:meth:`kill_worker`, :meth:`stall_queue`,
    :meth:`drop_response`) implement the serving failpoints' trigger
    semantics, including their per-process hit budgets.
    """

    def __init__(self, spec: str = ""):
        self.spec = spec or ""
        self._points: dict[str, tuple[int | None, list[str]]] = {}
        self._hits: dict[str, int] = {}
        for entry in self.spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, _, arg = entry.partition("=")
            self._points[name.strip()] = _parse_arg(arg.strip())

    def __bool__(self) -> bool:
        return bool(self._points)

    def active(self, name: str) -> bool:
        return name in self._points

    def _scoped(self, name: str, worker: int) -> list[str] | None:
        """The point's fields if it is armed for ``worker``, else None."""
        point = self._points.get(name)
        if point is None:
            return None
        wid, fields = point
        if wid is not None and wid != worker:
            return None
        return fields

    # ------------------------------------------------- serving failpoints
    def kill_worker(self, *, worker: int, batches_done: int) -> bool:
        """True when this worker should die: it has completed ``N``
        batches (arg) and is claiming another. The caller SIGKILLs itself
        — after flushing its claim, so supervision sees the in-flight
        requests it strands."""
        fields = self._scoped(KILL_WORKER, worker)
        if fields is None:
            return False
        after = int(fields[0]) if fields else 0
        return batches_done >= after

    def stall_queue(self, *, worker: int) -> float:
        """Seconds to stall before serving the next batch — ``S`` for each
        of the first ``N`` triggers (default 1), then 0.0. The queue backs
        up behind the sleep, which is how tests script overload."""
        fields = self._scoped(STALL_QUEUE, worker)
        if not fields:
            return 0.0
        seconds = float(fields[0])
        budget = int(fields[1]) if len(fields) > 1 else 1
        key = f"{STALL_QUEUE}:{worker}"
        if self._hits.get(key, 0) >= budget:
            return 0.0
        self._hits[key] = self._hits.get(key, 0) + 1
        return seconds

    def drop_response(self, *, worker: int) -> bool:
        """True for the worker's next ``N`` answer messages after letting
        the first ``skip`` (default 0) pass: the caller discards them
        instead of enqueueing, simulating a lost response — e.g. a stream
        whose first chunk arrives and whose tail never does (the client's
        deadline or the supervisor, not its patience, must save it)."""
        fields = self._scoped(DROP_RESPONSE, worker)
        if fields is None:
            return False
        budget = int(fields[0]) if fields else 1
        skip = int(fields[1]) if len(fields) > 1 else 0
        key = f"{DROP_RESPONSE}:{worker}"
        n = self._hits.get(key, 0)
        self._hits[key] = n + 1
        return skip <= n < skip + budget


_DISARMED = FaultRegistry("")


def from_env() -> FaultRegistry:
    """The process's fault schedule, parsed fresh from ``REPRO_FAULTS``
    (workers call this once at startup; tests re-call it after mutating
    the env). Returns a shared disarmed registry when unset."""
    spec = os.environ.get(ENV_VAR, "")
    return FaultRegistry(spec) if spec else _DISARMED


def kill_self(*, flush_s: float = 0.1) -> None:  # pragma: no cover - dies
    """SIGKILL the current process after a short pause that lets mp-queue
    feeder threads flush buffered messages (the claim a supervisor needs
    must reach the pipe before the process vanishes)."""
    import signal

    time.sleep(flush_s)
    os.kill(os.getpid(), signal.SIGKILL)
