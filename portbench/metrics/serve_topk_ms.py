"""Median time a serving worker spent in one top-k launch and its copies
back in the window: the ``query/topk_s`` histograms of every worker,
differenced between the window's start and the server's stop."""

from yardstick import counters


def read(ctx):
    if "final" not in ctx:
        return None
    return counters.window_percentile(ctx, "query/topk_s", 50, 1e3)
