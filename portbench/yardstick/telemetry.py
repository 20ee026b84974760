"""Reductions of the program's registry telemetry beside ``trace.py`` and
``counters.py``: span events as unix-time intervals, the stretches in which
a span is the innermost open one, their overlap with the card's idle time,
and registry counters windowed between two ``CoocServer.stats()``.

A span event (``repro_torch.obs``) starts at ``epoch_unix + ts_us / 1e6``
unix seconds, the clock of the device operations ``trace.py`` reads.
Intervals are ``(start, end)`` pairs in unix seconds.
"""

from __future__ import annotations

from yardstick import trace as T


def has_span(events, name: str) -> bool:
    return any(e["name"] == name for e in events)


def span_intervals(events, epoch_unix: float, names) -> list[tuple[float, float]]:
    """The intervals of the spans named ``names``, sorted."""
    return sorted((epoch_unix + e["ts_us"] / 1e6,
                   epoch_unix + (e["ts_us"] + e["dur_us"]) / 1e6)
                  for e in events if e["name"] in names)


def innermost_intervals(events, epoch_unix: float, names) -> list[tuple[float, float]]:
    """The stretches in which a span named ``names`` is the innermost span
    open on its thread: each such span less its direct children, sorted."""
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts_us"], -e["dur_us"]))
        for i, e in enumerate(evs):
            if e["name"] not in names:
                continue
            at, end = e["ts_us"], e["ts_us"] + e["dur_us"]
            for f in evs[i + 1:]:
                if f["ts_us"] >= end:
                    break
                if f["depth"] == e["depth"] + 1:
                    if f["ts_us"] > at:
                        out.append((at, f["ts_us"]))
                    at = max(at, f["ts_us"] + f["dur_us"])
            if end > at:
                out.append((at, end))
    return sorted((epoch_unix + a / 1e6, epoch_unix + b / 1e6) for a, b in out)


def union(intervals) -> list[tuple[float, float]]:
    return T.busy_intervals([(None, a, b - a) for a, b in intervals])


def idle_intervals(ops, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of ``[t0, t1]`` with no operation on the card."""
    out, at = [], t0
    for a, b in T.busy_intervals(ops):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def overlap_s(a, b) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def window_counter(ctx: dict, name: str):
    """Registry counter ``name`` of the workers' merged snapshots over the
    serving window, or ``None`` when the server never counted it."""
    def count(snap):
        return (snap or {}).get("metrics", {}).get("counters", {}).get(name)

    final = count(ctx.get("final"))
    if final is None:
        return None
    return final - (count(ctx.get("base")) or 0)
