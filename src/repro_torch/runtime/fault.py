"""Fault tolerance for the co-occurrence pipeline and the training loop.

The key structural property: the distributed Gram sum
C = Σ_s B_sᵀ B_s is a bag of independent, additive (shard × vocab-tile) work
units. Fault tolerance is therefore bookkeeping, not consensus:

  * ``WorkTracker`` — the (shard, tile) completion bitmap. Completed units
    are idempotent (each unit's contribution is added exactly once because
    the unit, not the worker, owns the accumulator slot).
  * ``HeartbeatMonitor`` — deadline-based failure/straggler detection. A unit
    leased past its deadline is re-enqueued (backup-task / speculative
    execution, MapReduce-style). Whichever completion lands first wins; the
    bitmap makes the second a no-op.
  * Training-side: the same tracker drives data-shard reassignment after an
    elastic re-mesh (runtime/elastic.py), and CheckpointManager provides the
    restart point.

Host-level logic (pure python/numpy) — on a real cluster the heartbeats come
from the cluster runtime's client liveness; here workers are simulated, which is
exactly what the unit tests exercise.

``SharedWorkTracker`` lifts the same lease discipline across **process
boundaries**: the tracker state lives in one JSON file mutated only under an
advisory ``flock`` (the same concurrency primitive the store manifest uses),
leases carry wall-clock TTL deadlines renewed by worker heartbeats, and a
lease past its deadline is reclaimed by whichever claimer sees it first — a
SIGKILL'd worker's shard is re-done, never lost. The parallel ingest
executor (core/plan.py) runs its spill-shard workers against it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

try:
    import fcntl
except ImportError:  # non-POSIX: single-process use keeps working unlocked
    fcntl = None


@dataclasses.dataclass
class Lease:
    unit: tuple
    worker: str
    deadline: float


class WorkTracker:
    """Completion bitmap + lease table over independent work units."""

    def __init__(self, units):
        self.pending = list(units)
        self.leases: dict[tuple, Lease] = {}
        self.done: set[tuple] = set()
        self.completions_ignored = 0  # duplicate completions (backup tasks)

    # -- scheduling --
    def claim(self, worker: str, now: float, lease_seconds: float = 60.0):
        if not self.pending:
            # TTL expiry at claim time: a lease acquired and never renewed
            # must not block the unit forever under a second claimer — the
            # stale lease is reclaimed here, not only when the owner's own
            # scheduling loop happens to call expire()
            self.expire(now)
        if not self.pending:
            return None
        unit = self.pending.pop(0)
        self.leases[unit] = Lease(unit, worker, now + lease_seconds)
        return unit

    def complete(self, unit: tuple, worker: str) -> bool:
        """Returns True iff this completion is the FIRST for the unit (the
        caller may then add its contribution to the accumulator)."""
        if unit in self.done:
            self.completions_ignored += 1
            return False
        self.done.add(unit)
        self.leases.pop(unit, None)
        return True

    # -- failure & straggler handling --
    def expire(self, now: float) -> list[tuple]:
        """Re-enqueue units whose lease expired (dead or straggling worker)."""
        expired = [l.unit for l in self.leases.values() if l.deadline < now]
        for u in expired:
            del self.leases[u]
        # retry-first: expired units jump the queue (backup-task semantics)
        self.pending = expired + self.pending
        return expired

    def fail_worker(self, worker: str) -> list[tuple]:
        """Immediately re-enqueue everything leased to a known-dead worker."""
        units = [l.unit for l in self.leases.values() if l.worker == worker]
        for u in units:
            del self.leases[u]
        self.pending = units + self.pending  # retry-first
        return units

    @property
    def finished(self) -> bool:
        return not self.pending and not self.leases

    def state(self) -> dict:
        """Serializable snapshot (checkpointed alongside the accumulator)."""
        return {
            "pending": [list(u) for u in self.pending],
            "leased": [list(l.unit) for l in self.leases.values()],
            "done": [list(u) for u in sorted(self.done)],
        }

    @classmethod
    def from_state(cls, state: dict) -> "WorkTracker":
        t = cls([])
        # leased units were in flight at checkpoint time → re-enqueue
        t.pending = [tuple(u) for u in state["pending"]] + [
            tuple(u) for u in state["leased"]
        ]
        t.done = {tuple(u) for u in state["done"]}
        return t


class SharedWorkTracker:
    """The WorkTracker lease discipline, shared across processes via one
    flock'd JSON state file.

    Every mutation is a read-modify-write of ``path`` under an exclusive
    advisory lock on ``path + ".lock"`` (state itself is replaced
    atomically, so crash mid-write never corrupts it). Leases carry
    wall-clock (``time.time``) TTL deadlines: ``claim`` first re-enqueues
    every lease past its deadline (reclaim), workers extend their own lease
    with ``renew`` heartbeats while a unit is in flight, and ``complete``
    runs an optional ``commit`` callable under the lock *before* recording
    the unit done — so an atomic rename (promoting a worker's finished
    spill directory) and the completion record can never be observed apart.

    Example::

        t = SharedWorkTracker.create("/tmp/claims.json", [(0,), (1,)],
                                     lease_seconds=30.0)
        u = t.claim("w0")
        t.renew(u, "w0")            # heartbeat while working
        t.complete(u, "w0")         # first completion wins
    """

    def __init__(self, path: str, *, lease_seconds: float = 30.0):
        self.path = path
        self.lease_seconds = float(lease_seconds)

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, path: str, units, *, lease_seconds: float = 30.0
               ) -> "SharedWorkTracker":
        """Initialize the state file with ``units`` all pending (overwrites
        any previous state at ``path``)."""
        t = cls(path, lease_seconds=lease_seconds)
        t._write_state(
            {
                "pending": [list(u) for u in units],
                "leases": {},          # key -> {worker, deadline}
                "done": [],
                "reclaims": 0,
                "completions_ignored": 0,
            }
        )
        return t

    @classmethod
    def open(cls, path: str, *, lease_seconds: float = 30.0
             ) -> "SharedWorkTracker":
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return cls(path, lease_seconds=lease_seconds)

    # ------------------------------------------------------------ low level
    @staticmethod
    def _key(unit: tuple) -> str:
        return json.dumps(list(unit))

    def _lock(self):
        lf = open(self.path + ".lock", "a")
        if fcntl is not None:
            fcntl.flock(lf, fcntl.LOCK_EX)
        return lf  # closing the handle releases the flock

    def _read_state(self) -> dict:
        with open(self.path) as f:
            return json.load(f)

    def _write_state(self, state: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.path)

    def _expire_locked(self, state: dict, now: float) -> None:
        stale = [k for k, l in state["leases"].items() if l["deadline"] < now]
        for k in stale:
            del state["leases"][k]
            # retry-first: reclaimed units jump the queue (backup tasks)
            state["pending"].insert(0, json.loads(k))
            state["reclaims"] += 1

    # ----------------------------------------------------------- scheduling
    def claim(self, worker: str) -> tuple | None:
        """Claim the next pending unit (expired leases are reclaimed first).
        Returns None when nothing is claimable right now — the caller should
        check :attr:`finished` and otherwise wait for a lease to expire."""
        lf = self._lock()
        try:
            state = self._read_state()
            self._expire_locked(state, time.time())
            if not state["pending"]:
                self._write_state(state)  # persist any reclaim bookkeeping
                return None
            unit = tuple(state["pending"].pop(0))
            state["leases"][self._key(unit)] = {
                "worker": worker,
                "deadline": time.time() + self.lease_seconds,
            }
            self._write_state(state)
            return unit
        finally:
            lf.close()

    def renew(self, unit: tuple, worker: str) -> bool:
        """Heartbeat: extend this worker's lease on ``unit``. Returns False
        when the lease was lost (expired and reclaimed, or completed) — the
        worker should abandon the unit (its completion would be ignored)."""
        lf = self._lock()
        try:
            state = self._read_state()
            lease = state["leases"].get(self._key(unit))
            if lease is None or lease["worker"] != worker:
                return False
            lease["deadline"] = time.time() + self.lease_seconds
            self._write_state(state)
            return True
        finally:
            lf.close()

    def complete(self, unit: tuple, worker: str, commit=None) -> bool:
        """First completion wins. When this is the first, ``commit()`` (if
        given) runs under the tracker lock *before* the unit is recorded
        done — its side effect (e.g. an atomic directory rename) and the
        done-record are mutually consistent for every other process."""
        lf = self._lock()
        try:
            state = self._read_state()
            if list(unit) in state["done"]:
                state["completions_ignored"] += 1
                self._write_state(state)
                return False
            if commit is not None:
                commit()
            state["leases"].pop(self._key(unit), None)
            state["done"].append(list(unit))
            self._write_state(state)
            return True
        finally:
            lf.close()

    def requeue(self, unit: tuple) -> None:
        """Force a unit back to pending (recovery: its committed artifact
        went missing). Drops any done-record and lease for it."""
        lf = self._lock()
        try:
            state = self._read_state()
            state["done"] = [u for u in state["done"] if u != list(unit)]
            state["leases"].pop(self._key(unit), None)
            if list(unit) not in state["pending"]:
                state["pending"].insert(0, list(unit))
            self._write_state(state)
        finally:
            lf.close()

    # ------------------------------------------------------------- queries
    def snapshot(self) -> dict:
        """A point-in-time copy of the shared state (no lock: reads see
        some complete, atomically-replaced state)."""
        return self._read_state()

    @property
    def finished(self) -> bool:
        s = self._read_state()
        return not s["pending"] and not s["leases"]

    def done_units(self) -> set[tuple]:
        return {tuple(u) for u in self._read_state()["done"]}

    @property
    def reclaims(self) -> int:
        return int(self._read_state()["reclaims"])


class HeartbeatMonitor:
    """Deadline-based liveness. Workers ping; silence past ``timeout`` marks
    them dead; ``slow_factor``× the median completion time marks a straggler
    (which triggers a backup task, not a kill)."""

    def __init__(self, timeout: float = 30.0, slow_factor: float = 3.0):
        self.timeout = timeout
        self.slow_factor = slow_factor
        self.last_seen: dict[str, float] = {}
        self.durations: list[float] = []

    def ping(self, worker: str, now: float | None = None):
        self.last_seen[worker] = time.monotonic() if now is None else now

    def record_duration(self, seconds: float):
        self.durations.append(seconds)

    def dead_workers(self, now: float) -> list[str]:
        return [w for w, t in self.last_seen.items() if now - t > self.timeout]

    def straggler_deadline(self) -> float:
        """Lease duration adapted to observed completion times."""
        if not self.durations:
            return self.timeout
        med = sorted(self.durations)[len(self.durations) // 2]
        return max(self.slow_factor * med, 1e-3)
