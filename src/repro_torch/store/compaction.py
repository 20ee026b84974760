"""Tier-pressure compaction daemon for continuously growing stores.

A batch build compacts once, on demand. A streaming store grows a new
micro-segment every seal and would accumulate unbounded read
amplification, so :class:`CompactionDaemon` watches tier pressure — it
triggers whenever :meth:`Store.plan_compaction`'s size-tiered policy finds
a run of at least ``fanout`` similar-sized segments — and merges that tier,
repeatedly, with exponential backoff while no tier qualifies.

Two execution modes share the trigger logic:

* ``inline=True`` merges in this process (``Store.compact``) — used by
  tests and ``until_converged()``, where per-round process-spawn cost
  would dominate.
* ``inline=False`` (default for ``start()``) delegates to
  ``Store.compact_background``'s spawned worker, so the daemon thread
  never blocks its host (e.g. a serving parent or the stream driver) on a
  large merge; appends continue concurrently and readers pick up the swap
  on their next ``refresh()``.

Compaction never changes query results — only how many segments answer
them — so the daemon is safe to run against a store that is being queried
and appended to at the same time.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import repro_torch.obs as obs


@dataclass
class CompactionPolicy:
    """When to merge: the size-tiered trigger plus backoff tuning.

    ``fanout`` is the invariant the daemon converges the store toward: no
    size tier holds ``fanout`` or more similar-sized segments (it maps to
    ``plan_compaction(min_segments=fanout)``). ``tier_ratio`` defines
    "similar-sized". While no tier qualifies the daemon sleeps
    ``backoff_s`` doubling up to ``max_backoff_s``; any successful merge
    resets the backoff, since one merge often creates the next tier.
    """

    fanout: int = 4
    tier_ratio: float = 4.0
    max_segments_per_merge: int | None = None
    backoff_s: float = 0.05
    max_backoff_s: float = 2.0

    def __post_init__(self):
        if self.fanout < 2:
            raise ValueError("fanout must be >= 2")
        if self.tier_ratio < 1.0:
            raise ValueError("tier_ratio must be >= 1.0")
        if self.backoff_s <= 0 or self.max_backoff_s < self.backoff_s:
            raise ValueError("need 0 < backoff_s <= max_backoff_s")


class CompactionDaemon:
    """Keep a store's tier invariant while it grows.

    ``run_once()`` checks pressure and performs at most one merge;
    ``until_converged()`` loops inline merges until no tier qualifies;
    ``start()``/``stop()`` run the check in a daemon thread with backoff.
    """

    def __init__(self, store, policy: CompactionPolicy | None = None, *,
                 inline: bool = False, registry=None):
        self.store = store
        self.policy = policy or CompactionPolicy()
        self.inline = inline
        self.reg = registry if registry is not None else obs.get_registry()
        self.merges = 0
        self.segments_merged = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- triggers
    def plan(self) -> list[str]:
        """Current tier under pressure ([] = invariant holds)."""
        self.store.refresh()
        return self.store.plan_compaction(
            min_segments=self.policy.fanout,
            tier_ratio=self.policy.tier_ratio,
            max_segments=self.policy.max_segments_per_merge,
        )

    def run_once(self) -> int:
        """One pressure check; returns how many segments were merged away
        (0 when the tier invariant already holds)."""
        names = self.plan()
        if not names:
            return 0
        with self.reg.span(
            "compaction/merge", segments=len(names), inline=self.inline
        ):
            if self.inline:
                self.store.compact(names)
            else:
                handle = self.store.compact_background(names)
                if handle is not None:
                    handle.join()
                    self.store.refresh()
        self.merges += 1
        self.segments_merged += len(names)
        self.reg.counter("compaction/merges").inc(1)
        self.reg.counter("compaction/segments_merged").inc(len(names))
        return len(names)

    def until_converged(self, *, max_rounds: int = 1_000) -> int:
        """Merge inline until no tier exceeds ``fanout``; returns rounds
        performed. The convergence tests drive this directly."""
        was_inline, self.inline = self.inline, True
        try:
            rounds = 0
            while rounds < max_rounds and self.run_once():
                rounds += 1
            return rounds
        finally:
            self.inline = was_inline

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "CompactionDaemon":
        if self._thread is not None:
            raise RuntimeError("compaction daemon already started")
        self._thread = threading.Thread(
            target=self._loop, name="compaction-daemon", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float | None = 60.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        backoff = self.policy.backoff_s
        while not self._stop.is_set():
            merged = self.run_once()
            if merged:
                backoff = self.policy.backoff_s  # pressure: look again soon
                continue
            self._stop.wait(backoff)
            backoff = min(backoff * 2, self.policy.max_backoff_s)

    def summary(self) -> dict:
        return {
            "merges": self.merges,
            "segments_merged": self.segments_merged,
            "fanout": self.policy.fanout,
            "tier_ratio": self.policy.tier_ratio,
        }
