"""Self time of the ``ingest/count_emit`` spans (the sink's emit of each
row batch, less the spills nested in it), mean per build job."""

from yardstick import telemetry as S
from yardstick import trace as T


def read(ctx):
    spans = ctx.get("spans")
    if not spans or not S.has_span(spans, "ingest/count_emit"):
        return None
    return T.span_self_s(spans, ("ingest/count_emit",)) / len(ctx["jobs"])
