"""Process-local metric primitives: Counter, Gauge, and a log-bucket
Histogram whose percentiles survive merging.

The histogram is the load-bearing piece: latency distributions must travel
from N serving worker processes to the parent and aggregate into fleet
percentiles *without* shipping samples. Values land in fixed logarithmic
buckets (``SUBDIV`` buckets per octave, so bucket edges are powers of
``2**(1/SUBDIV)``); merging two histograms is bucket-wise addition, and any
quantile of the merge equals the quantile of the pooled samples to within
one bucket's relative width (≈ 9% at the default ``SUBDIV = 8``) — the
property tests/test_obs.py asserts directly.

Every metric serializes to a plain-dict ``state()`` (picklable, JSON-able)
and reconstructs with ``from_state`` — that is the wire format the serving
workers publish over the stats queue.
"""

from __future__ import annotations

import math

# log-bucket resolution: SUBDIV buckets per octave -> bucket edges at
# 2**(i/SUBDIV); relative quantile error is bounded by 2**(1/SUBDIV) - 1
SUBDIV = 8
_MIN_IDX = -30 * SUBDIV        # ~1 ns: everything smaller collapses here
_MAX_IDX = 34 * SUBDIV         # ~5e9 s: everything larger collapses here


def bucket_index(value: float) -> int:
    """The fixed log bucket a value falls in (non-positive values clamp to
    the smallest bucket — latencies are never negative, but a clock can
    read 0.0 on coarse timers)."""
    if value <= 0.0:
        return _MIN_IDX
    i = int(math.floor(math.log2(value) * SUBDIV))
    return _MIN_IDX if i < _MIN_IDX else (_MAX_IDX if i > _MAX_IDX else i)


def bucket_mid(idx: int) -> float:
    """Geometric midpoint of bucket ``idx`` (the reported quantile value)."""
    return 2.0 ** ((idx + 0.5) / SUBDIV)


class Counter:
    """Monotonic counter. ``inc`` is the only mutator; merge is addition."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    def inc(self, n: int = 1) -> None:
        self.value += n

    def state(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (e.g. batch-window occupancy)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = float(v)

    def state(self):
        return self.value


class Histogram:
    """Fixed log-bucket histogram: p50/p95/p99 come from merges, not stored
    samples.

    ``record`` costs one ``log2`` plus a dict increment; ``merge`` adds
    bucket counts, so per-worker histograms aggregate into exact pooled
    bucket counts (quantiles agree with pooled samples to within one
    bucket's relative width). ``min``/``max``/``sum`` are tracked exactly.

    Example::

        h = Histogram()
        for v in (0.001, 0.002, 0.004):
            h.record(v)
        h.count, round(h.percentile(50), 3)     # (3, ~0.002)
    """

    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        idx = bucket_index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    # ------------------------------------------------------------ queries
    def percentile(self, q: float) -> float:
        """The q-th percentile (q in (0, 100]): geometric midpoint of the
        bucket holding the rank-``ceil(q/100 * count)`` sample, clamped to
        the exact observed [min, max] so tiny histograms don't report
        values outside what was recorded."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                return min(max(bucket_mid(idx), self.vmin), self.vmax)
        return self.vmax  # pragma: no cover - rank <= count always hits

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        """JSON-able digest: count/sum/mean plus p50/p95/p99."""
        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "mean": round(self.mean, 6),
            "min": round(self.vmin, 6) if self.count else 0.0,
            "max": round(self.vmax, 6) if self.count else 0.0,
            "p50": round(self.percentile(50), 6),
            "p95": round(self.percentile(95), 6),
            "p99": round(self.percentile(99), 6),
        }

    # ------------------------------------------------------------ merging
    def merge(self, other: "Histogram") -> "Histogram":
        """Absorb ``other`` (bucket-wise addition); returns self."""
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def state(self) -> dict:
        return {
            "buckets": dict(self.buckets),
            "count": self.count,
            "total": self.total,
            "vmin": self.vmin,
            "vmax": self.vmax,
        }

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls()
        # JSON round-trips stringify dict keys; accept both
        h.buckets = {int(k): int(v) for k, v in state["buckets"].items()}
        h.count = state["count"]
        h.total = state["total"]
        h.vmin = state["vmin"]
        h.vmax = state["vmax"]
        return h


def merge_snapshots(snapshots) -> dict:
    """Merge registry snapshots (``Registry.snapshot()`` dicts) from N
    processes into one: counters add, gauges keep the last non-None value,
    histograms merge bucket-wise. The parent serving process uses this to
    turn per-worker snapshots into fleet-level stats.

    Example::

        merged = merge_snapshots([w1.snapshot(), w2.snapshot()])
        Histogram.from_state(merged["histograms"]["lat"]).percentile(99)
    """
    out = {"counters": {}, "gauges": {}, "histograms": {}, "dropped_events": 0}
    base_epoch = None
    for snap in snapshots:
        if not snap:
            continue
        for name, v in snap.get("counters", {}).items():
            out["counters"][name] = out["counters"].get(name, 0) + v
        for name, v in snap.get("gauges", {}).items():
            out["gauges"][name] = v
        for name, state in snap.get("histograms", {}).items():
            if name in out["histograms"]:
                merged = Histogram.from_state(out["histograms"][name])
                merged.merge(Histogram.from_state(state))
                out["histograms"][name] = merged.state()
            else:
                out["histograms"][name] = dict(state)
        out["dropped_events"] += snap.get("dropped_events", 0)
        # span events (snapshots taken with include_events=True) concatenate
        # onto the first contributing snapshot's timeline: each later
        # snapshot's events are shifted by its unix-epoch offset, so one
        # merged snapshot holds a coherent multi-process span log
        events = snap.get("events")
        if events:
            epoch = snap.get("epoch_unix", 0.0)
            if base_epoch is None:
                base_epoch = epoch
                out["epoch_unix"] = epoch
            shift_us = (epoch - base_epoch) * 1e6
            out.setdefault("events", []).extend(
                dict(e, ts_us=e["ts_us"] + shift_us) for e in events
            )
    return out
