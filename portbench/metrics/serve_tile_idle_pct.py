"""Share of the serving window's device-idle seconds in which at least one
worker was inside ``query/tile``: the workers' span events, shipped with
their final snapshots, against the idle stretches of their device traces."""

from yardstick import telemetry as S


def read(ctx):
    metrics = (ctx.get("final") or {}).get("metrics", {})
    events, ops = metrics.get("events"), ctx.get("ops")
    if not events or not ops or not S.has_span(events, "query/tile"):
        return None
    tiles = S.union(S.span_intervals(events, metrics["epoch_unix"], ("query/tile",)))
    idle = S.idle_intervals(ops, *ctx["window"])
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0:
        return None
    return 100.0 * S.overlap_s(tiles, idle) / idle_s
