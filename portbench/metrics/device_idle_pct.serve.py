"""Share of the serving window in which no operation ran on the card, from
the profiler traces of the serving workers (the union of their operations:
they share the card)."""

from yardstick import trace as T


def read(ctx):
    if not ctx.get("ops"):
        return None
    t0, t1 = ctx["window"]
    return 100.0 * (1.0 - T.busy_s(ctx["ops"]) / (t1 - t0))
