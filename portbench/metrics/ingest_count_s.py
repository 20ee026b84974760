"""Self time of the ``ingest/count`` spans (the count stage: the method's
kernels, their gathers and the copies back), less the spills nested in
them, mean per build job."""

from yardstick import trace as T


def read(ctx):
    if not ctx.get("spans"):
        return None
    return T.span_self_s(ctx["spans"], ("ingest/count",)) / len(ctx["jobs"])
