"""Zero-dependency telemetry: spans, counters, and cross-process metrics.

The observability layer behind the ingest, query, and serving pipelines:
nested wall-time :class:`Span` context managers, ``Counter`` /
``Gauge`` / mergeable log-bucket ``Histogram`` metrics, a process-local
:class:`Registry`, and two exporters — Chrome ``trace_event`` JSON
(``chrome://tracing`` / Perfetto) and Prometheus text.

Telemetry is **off by default**: the global registry starts disabled and
every instrumented call site degrades to a no-op (the ingest throughput
gate in CI runs with telemetry disabled and doubles as the overhead
regression test). Drivers enable it with ``--trace-out`` /
``--metrics-interval`` (see launch/cooc_run.py, launch/cooc_serve.py), and
benchmarks/tests use :func:`scoped`.

See docs/observability.md for the span taxonomy and metric names.
"""

from repro_torch.obs.export import (
    chrome_trace,
    load_trace,
    prometheus_text,
    span_names,
    write_trace,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, merge_snapshots
from repro_torch.obs.registry import (
    NULL_METRIC,
    NULL_SPAN,
    Registry,
    Span,
    configure,
    get_registry,
    scoped,
    set_registry,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "merge_snapshots",
    "configure",
    "get_registry",
    "set_registry",
    "scoped",
    "chrome_trace",
    "write_trace",
    "load_trace",
    "span_names",
    "prometheus_text",
    "NULL_SPAN",
    "NULL_METRIC",
]
