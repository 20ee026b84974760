"""Self time of the ``ingest/spill`` and ``ingest/bucket_merge`` spans (the
spill sink's sorted runs and their merge), mean per build job."""

from yardstick import trace as T


def read(ctx):
    if not ctx.get("spans"):
        return None
    names = ("ingest/spill", "ingest/bucket_merge")
    return T.span_self_s(ctx["spans"], names) / len(ctx["jobs"])
