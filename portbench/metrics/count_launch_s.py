"""Self time of the ``ingest/count_launch`` spans (each row batch's gather
with its token-count read, the grid's fill and the kernel launches), mean
per build job."""

from yardstick import telemetry as S
from yardstick import trace as T


def read(ctx):
    spans = ctx.get("spans")
    if not spans or not S.has_span(spans, "ingest/count_launch"):
        return None
    return T.span_self_s(spans, ("ingest/count_launch",)) / len(ctx["jobs"])
