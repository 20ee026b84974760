"""Telemetry exporters: Chrome ``trace_event`` JSON and Prometheus text.

Two formats, one registry:

* :func:`chrome_trace` / :func:`write_trace` — the span event log as a
  Chrome trace (``{"traceEvents": [...]}`` with complete ``"ph": "X"``
  events), loadable in ``chrome://tracing`` or https://ui.perfetto.dev —
  answers "where did the time go" for one run visually;
* :func:`prometheus_text` — every counter/gauge/histogram of a snapshot as
  Prometheus exposition text (histograms as quantile-labelled summaries),
  what ``--metrics-interval`` dumps periodically and a scraper would
  ingest.

Both work on plain snapshot dicts too, so the serving parent can export
metrics merged from worker processes it never shared memory with.
"""

from __future__ import annotations

import json
import os
import re

from repro_torch.obs.metrics import Histogram

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def chrome_trace(reg) -> dict:
    """The registry's span log as a Chrome trace dict. Thread ids are
    compacted to small integers (first-seen order); span attributes ride in
    ``args``; counters are attached as one final metadata event so a trace
    is self-contained.

    Example::

        trace = reg.chrome_trace()
        {e["ph"] for e in trace["traceEvents"]} <= {"X", "M"}   # True
    """
    pid = os.getpid()
    tids: dict[int, int] = {}
    events = []
    for e in reg.span_events():
        tid = tids.setdefault(e["tid"], len(tids))
        events.append(
            {
                "name": e["name"],
                "cat": e["name"].split("/", 1)[0],
                "ph": "X",
                "ts": round(e["ts_us"], 3),
                "dur": round(e["dur_us"], 3),
                "pid": pid,
                "tid": tid,
                "args": {**e["args"], "depth": e["depth"]},
            }
        )
    snap = reg.snapshot()
    meta = {
        "name": "repro_torch.obs",
        "ph": "M",
        "pid": pid,
        "tid": 0,
        "ts": 0,
        "args": {
            "counters": snap["counters"],
            "dropped_events": snap["dropped_events"],
            "epoch_unix": reg.epoch_unix,
        },
    }
    return {"traceEvents": events + [meta], "displayTimeUnit": "ms"}


def write_trace(reg, path: str) -> str:
    """Write the Chrome trace JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(reg), f)
    return path


def load_trace(path: str) -> dict:
    """Parse a trace file back; raises if it is not a valid trace (used by
    the CI telemetry smoke step)."""
    with open(path) as f:
        trace = json.load(f)
    if "traceEvents" not in trace:
        raise ValueError(f"{path} is not a Chrome trace (no traceEvents)")
    return trace


def span_names(trace: dict) -> set[str]:
    """The distinct span names of a loaded trace ("X" events only)."""
    return {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}


def _metric_name(name: str, prefix: str) -> str:
    return _NAME_RE.sub("_", f"{prefix}_{name}" if prefix else name)


def prometheus_text(snapshot: dict, *, prefix: str = "repro") -> str:
    """A metrics snapshot as Prometheus exposition text. Counters become
    ``counter`` samples, gauges ``gauge``, histograms summary-style
    ``{quantile=...}`` samples plus ``_sum``/``_count`` (quantiles come
    from the mergeable log buckets, so scraped values match what
    ``CoocServer.stats()`` reports).

    Example::

        text = prometheus_text({"counters": {"ingest.spills": 3},
                                "gauges": {}, "histograms": {}})
        "repro_ingest_spills 3" in text      # True
    """
    lines: list[str] = []
    for name in sorted(snapshot.get("counters", {})):
        m = _metric_name(name, prefix)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {snapshot['counters'][name]}")
    for name in sorted(snapshot.get("gauges", {})):
        m = _metric_name(name, prefix)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {snapshot['gauges'][name]:g}")
    for name in sorted(snapshot.get("histograms", {})):
        h = Histogram.from_state(snapshot["histograms"][name])
        m = _metric_name(name, prefix)
        lines.append(f"# TYPE {m} summary")
        for q in (0.5, 0.95, 0.99):
            lines.append(f'{m}{{quantile="{q}"}} {h.percentile(q * 100):g}')
        lines.append(f"{m}_sum {h.total:g}")
        lines.append(f"{m}_count {h.count}")
    return "\n".join(lines) + "\n"
