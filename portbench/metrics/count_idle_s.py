"""Seconds a build job in which the card was idle while the counting
thread's innermost span was ``ingest/count`` or one of its row-batch spans
(``ingest/count_launch``, ``ingest/count_select``, ``ingest/count_emit``):
the idle time the count loop's host work causes, apart from spills and the
segment write. Mean per build job."""

from yardstick import telemetry as S

COUNT_LOOP = ("ingest/count", "ingest/count_launch", "ingest/count_select",
              "ingest/count_emit")


def read(ctx):
    spans, ops = ctx.get("spans"), ctx.get("ops")
    if not spans or not ops or not S.has_span(spans, "ingest/count_select"):
        return None
    inner = S.innermost_intervals(spans, ctx["epoch_unix"], COUNT_LOOP)
    idle = S.idle_intervals(ops, *ctx["window"])
    return S.overlap_s(inner, idle) / len(ctx["jobs"])
