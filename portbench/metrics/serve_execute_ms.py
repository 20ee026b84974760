"""Median time a serving worker spent executing one micro-batch in the
window: the ``serving/execute_s`` histograms of every worker, differenced
between the window's start and the server's stop."""

from yardstick import counters


def read(ctx):
    if "final" not in ctx:
        return None
    return counters.window_percentile(ctx, "serving/execute_s", 50, 1e3)
