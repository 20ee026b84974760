"""Spans and the process-local telemetry Registry.

One :class:`Registry` per process holds every counter/gauge/histogram plus
the finished-span event log. Telemetry is **off by default**: the module
global starts disabled, and a disabled registry hands out shared no-op
singletons — ``span()`` returns a reusable null context manager and
``counter()``/``histogram()``/``gauge()`` return a null metric — so the
instrumented hot paths cost one attribute check when nothing is listening
(the ``BENCH_ingest.json`` throughput gate runs with telemetry disabled and
doubles as the overhead regression test).

Spans nest per thread (a thread-local stack provides parent/depth), carry
attributes, and land in the event log as Chrome ``trace_event``-shaped
records; exporters (obs/export.py) turn the log into a ``chrome://tracing``
/ Perfetto file and the metric tables into Prometheus text.

Example::

    reg = Registry(enabled=True)
    with reg.span("ingest/count", shard=0):
        reg.counter("ingest.pairs_in").inc(128)
    reg.span_events()[0]["name"]            # 'ingest/count'
"""

from __future__ import annotations

import contextlib
import threading
import time

from repro_torch.obs.metrics import Counter, Gauge, Histogram


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass


class _NullMetric:
    """Shared no-op counter/gauge/histogram for disabled registries."""

    __slots__ = ()
    value = 0
    count = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def record(self, v) -> None:
        pass


NULL_SPAN = _NullSpan()
NULL_METRIC = _NullMetric()


class Span:
    """A nested wall-time span (context manager).

    Timing uses ``time.perf_counter`` relative to the registry's epoch;
    nesting depth comes from a per-thread stack, so concurrent client
    threads each get a coherent span tree. ``set(**attrs)`` adds/overrides
    attributes mid-flight (e.g. a result count known only at the end).
    """

    __slots__ = ("_reg", "name", "attrs", "_t0", "_depth")

    def __init__(self, reg: "Registry", name: str, attrs: dict):
        self._reg = reg
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._depth = 0

    def __enter__(self) -> "Span":
        stack = self._reg._stack()
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        self._reg._stack().pop()
        self._reg._record_span(self, self._t0, end - self._t0)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class Registry:
    """Process-local home of every metric and span event.

    * ``counter``/``gauge``/``histogram`` create-or-return named metrics;
    * ``span`` opens a nested wall-time span;
    * ``snapshot()`` is the picklable cross-process wire format (merged
      with :func:`repro_torch.obs.metrics.merge_snapshots`);
    * ``chrome_trace()``/``prometheus_text()`` are the two export formats
      (see obs/export.py and docs/observability.md).

    A disabled registry (``enabled=False``) hands out shared no-op objects:
    the instrumented code paths run, but record nothing and allocate
    nothing.
    """

    def __init__(self, *, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._events: list[dict] = []
        self.dropped_events = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        # span timestamps are perf_counter-relative to this epoch; the unix
        # epoch anchors the trace in wall-clock time for display
        self._epoch = time.perf_counter()
        self.epoch_unix = time.time()

    # ------------------------------------------------------------ metrics
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_METRIC
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_METRIC
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return NULL_METRIC
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    # -------------------------------------------------------------- spans
    def span(self, name: str, **attrs):
        """Open a nested wall-time span; no-op when disabled.

        Example::

            with reg.span("ingest/count", shard=3) as sp:
                sp.set(pairs=n)
        """
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _record_span(self, span: Span, t0: float, dur: float) -> None:
        if len(self._events) >= self.max_events:
            self.dropped_events += 1
            return
        self._events.append(
            {
                "name": span.name,
                "ts_us": (t0 - self._epoch) * 1e6,
                "dur_us": dur * 1e6,
                "tid": threading.get_ident(),
                "depth": span._depth,
                "args": span.attrs,
            }
        )

    def span_events(self) -> list[dict]:
        """The finished-span log (insertion order = completion order)."""
        return list(self._events)

    def stage_totals(self, prefix: str = "") -> dict[str, float]:
        """Total seconds per span name (optionally filtered by prefix) —
        what the benchmarks print as their per-stage breakdown tables.
        Nested spans are totalled under their own names, so a stage's
        number is its inclusive wall time.

        Example::

            reg.stage_totals("ingest/")    # {'ingest/count': 1.2, ...}
        """
        out: dict[str, float] = {}
        for e in self._events:
            if e["name"].startswith(prefix):
                out[e["name"]] = out.get(e["name"], 0.0) + e["dur_us"] / 1e6
        return out

    # ---------------------------------------------------------- snapshots
    def snapshot(self, *, include_events: bool = False) -> dict:
        """Picklable state of every metric (the cross-process wire format —
        serving workers publish these over the stats queue). Span events
        are omitted unless asked for: traces are a single-process artifact,
        metrics are what crosses process boundaries."""
        snap = {
            "counters": {n: c.state() for n, c in self._counters.items()},
            "gauges": {n: g.state() for n, g in self._gauges.items()},
            "histograms": {n: h.state() for n, h in self._histograms.items()},
            "dropped_events": self.dropped_events,
        }
        if include_events:
            snap["events"] = self.span_events()
            # the events' ts_us are relative to THIS registry's epoch; the
            # unix anchor lets an absorbing registry re-base them onto its
            # own timeline (cross-process trace merging)
            snap["epoch_unix"] = self.epoch_unix
        return snap

    def absorb(self, snapshot: dict, *, source: str | None = None) -> None:
        """Merge a snapshot's metrics into this registry (counters add,
        histograms merge bucket-wise) — the parent-side half of the
        worker-snapshot protocol. Span events, when the snapshot carries
        them (``snapshot(include_events=True)``), are re-based onto this
        registry's timeline via the snapshot's unix epoch anchor and
        appended — so one parent trace shows every worker's ingest spans.
        ``source`` tags absorbed events' args (e.g. the worker name)."""
        for name, v in snapshot.get("counters", {}).items():
            self.counter(name).inc(v)
        for name, v in snapshot.get("gauges", {}).items():
            self.gauge(name).set(v)
        for name, state in snapshot.get("histograms", {}).items():
            self.histogram(name).merge(Histogram.from_state(state))
        self.dropped_events += snapshot.get("dropped_events", 0)
        events = snapshot.get("events") or []
        if events:
            shift_us = (
                snapshot.get("epoch_unix", self.epoch_unix) - self.epoch_unix
            ) * 1e6
            for e in events:
                if len(self._events) >= self.max_events:
                    self.dropped_events += 1
                    continue
                e = dict(e, ts_us=e["ts_us"] + shift_us)
                if source is not None:
                    e["args"] = {**e.get("args", {}), "proc": source}
                self._events.append(e)

    # ------------------------------------------------------------ exports
    def chrome_trace(self) -> dict:
        from repro_torch.obs.export import chrome_trace

        return chrome_trace(self)

    def write_trace(self, path: str) -> str:
        from repro_torch.obs.export import write_trace

        return write_trace(self, path)

    def prometheus_text(self) -> str:
        from repro_torch.obs.export import prometheus_text

        return prometheus_text(self.snapshot())


# ---------------------------------------------------------------------------
# the process-global default registry (disabled until configured)
# ---------------------------------------------------------------------------

_default = Registry(enabled=False)


def get_registry() -> Registry:
    """The process-global registry instrumented code records into. Starts
    disabled — every span/metric call is a no-op until :func:`configure`
    (or :func:`set_registry`) installs an enabled one."""
    return _default


def set_registry(reg: Registry) -> Registry:
    global _default
    _default = reg
    return reg


def configure(*, enabled: bool = True, max_events: int = 200_000) -> Registry:
    """Install (and return) a fresh global registry — how the drivers turn
    telemetry on for ``--trace-out`` / ``--metrics-interval``."""
    return set_registry(Registry(enabled=enabled, max_events=max_events))


@contextlib.contextmanager
def scoped(reg: Registry | None = None):
    """Temporarily install ``reg`` (default: a fresh enabled registry) as
    the global registry — how benchmarks and tests collect span timings
    without leaking state:

    Example::

        with scoped() as reg:
            run_instrumented_thing()
        reg.stage_totals("ingest/")
    """
    reg = reg or Registry(enabled=True)
    old = get_registry()
    set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)
