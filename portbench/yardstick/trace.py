"""Reductions from spans and device traces to numbers.

* Spans are the program's ``repro_torch.obs`` registry events: ``name``,
  ``ts_us`` and ``dur_us`` on the registry's clock (``epoch_unix`` anchors
  it), ``tid`` and nesting ``depth``. A span's self time is its duration
  less that of its direct children on the same thread.
* Device operations come from a ``torch.profiler`` Chrome trace that
  recorded the card's activity: each kernel, copy and fill with its start
  as unix seconds (the trace's ``ts`` plus its ``baseTimeNanoseconds``) and
  its duration. Each belongs to one card: its ``args.device`` (else the
  event's ``pid``, which the profiler sets to the card's index).
  :func:`read_trace_dir` puts every operation on one timeline, which is
  right for one card; :func:`ops_by_card` keeps a timeline a card, and
  :func:`busy_s_by_card` reduces each to its own busy seconds.
"""

from __future__ import annotations

import glob
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def process_cpu_s() -> float:
    """CPU seconds of this process and of its children it has waited for:
    read before and after a window, the harness's own CPU time in it."""
    t = os.times()
    return t.user + t.system + t.children_user + t.children_system


def self_times(events: list[dict]) -> list[tuple[str, float]]:
    """``(name, self seconds)`` of every span event."""
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts_us"], -e["dur_us"]))
        for i, e in enumerate(evs):
            end = e["ts_us"] + e["dur_us"]
            child = 0.0
            for f in evs[i + 1:]:
                if f["ts_us"] >= end:
                    break
                if f["depth"] == e["depth"] + 1:
                    child += f["dur_us"]
            out.append((e["name"], (e["dur_us"] - child) / 1e6))
    return out


def span_self_s(events: list[dict], names: tuple[str, ...]) -> float:
    """Summed self seconds of the spans named ``names``."""
    return sum(s for n, s in self_times(events) if n in names)


def device_events(path: str):
    """``(card, name, start unix s, seconds)`` of each device operation in a
    profiler trace file, in the file's order."""
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    for e in doc.get("traceEvents", []):
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            card = int(e.get("args", {}).get("device", e.get("pid", 0)))
            yield card, e["name"], (e["ts"] + base_us) / 1e6, e["dur"] / 1e6


def read_chrome_trace(path: str) -> list[tuple[str, float, float]]:
    """``(name, start unix s, seconds)`` of each device operation in a
    profiler trace file."""
    return [(n, s, d) for _, n, s, d in device_events(path)]


def read_trace_dir(path: str) -> list[tuple[str, float, float]]:
    ops = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        ops += read_chrome_trace(f)
    return ops


def ops_by_card(path: str) -> dict[int, list[tuple[str, float, float]]]:
    """``{card: [(name, start unix s, seconds)]}`` of every profiler trace
    file in directory ``path`` (one a process: a serving worker, a rank),
    each operation filed under its card, in the order of
    :func:`read_trace_dir`."""
    out: dict = {}
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        for card, n, s, d in device_events(f):
            out.setdefault(card, []).append((n, s, d))
    return out


def clip_by_card(by_card: dict, t0: float, t1: float) -> dict:
    return {c: clip(ops, t0, t1) for c, ops in by_card.items()}


def clip(ops, t0: float, t1: float):
    """The operations' parts inside ``[t0, t1]``."""
    out = []
    for name, s, d in ops:
        a, b = max(s, t0), min(s + d, t1)
        if b > a:
            out.append((name, a, b - a))
    return out


def busy_intervals(ops) -> list[tuple[float, float]]:
    """The union of the operations' intervals, as sorted ``(start, end)``."""
    spans = sorted((s, s + d) for _, s, d in ops)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_s(ops) -> float:
    return sum(b - a for a, b in busy_intervals(ops))


def busy_s_by_card(by_card: dict, cards: int) -> dict[int, float]:
    """Each card's own busy seconds: cards ``0 .. cards - 1``, a card with
    no operation at 0, and any other card the trace names."""
    return {c: busy_s(by_card.get(c, ())) for c in sorted(set(range(cards)) | set(by_card))}


def op_seconds(ops, needle: str) -> float:
    """Summed seconds of the operations whose name holds ``needle``."""
    return sum(d for n, _, d in ops if needle in n)


def top_ops(ops, n: int = 10) -> list[list]:
    """The ``n`` operations with the most device time, by name (the first
    120 characters of it)."""
    by: dict = {}
    for name, _, d in ops:
        by[name[:120]] = by.get(name[:120], 0.0) + d
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(ops, t0: float, t1: float, label, n: int = 10) -> list[list]:
    """The ``n`` longest stretches of ``[t0, t1]`` with nothing on the
    device, each named by ``label(start, end)``: what the host was doing."""
    gaps, at = [], t0
    for a, b in busy_intervals(ops):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[label(a, b), b - a] for a, b in gaps[:n]]


def innermost_span(events: list[dict], epoch_unix: float):
    """``label(start, end)``: the deepest span open at the middle of
    ``[start, end]``, or ``"outside any span"``."""
    def label(a: float, b: float) -> str:
        mid_us = ((a + b) / 2 - epoch_unix) * 1e6
        best = None
        for e in events:
            if e["ts_us"] <= mid_us <= e["ts_us"] + e["dur_us"]:
                if best is None or e["depth"] > best["depth"]:
                    best = e
        return best["name"] if best else "outside any span"

    return label
