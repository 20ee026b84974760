"""Self time of the ``ingest/segment_write`` spans (the store's segment
files, less the bucket merges that feed them), mean per build job."""

from yardstick import trace as T


def read(ctx):
    if not ctx.get("spans"):
        return None
    return T.span_self_s(ctx["spans"], ("ingest/segment_write",)) / len(ctx["jobs"])
