"""Self time of the ``ingest/count_select`` spans (``nonzero`` over each row
batch's grid and the two copies back: where the host waits for the card),
mean per build job."""

from yardstick import telemetry as S
from yardstick import trace as T


def read(ctx):
    spans = ctx.get("spans")
    if not spans or not S.has_span(spans, "ingest/count_select"):
        return None
    return T.span_self_s(spans, ("ingest/count_select",)) / len(ctx["jobs"])
