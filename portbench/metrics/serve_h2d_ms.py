"""Median time a serving worker spent copying one top-k launch's tile to
the card in the window: the ``query/h2d_s`` histograms of every worker,
differenced between the window's start and the server's stop."""

from yardstick import counters


def read(ctx):
    if "final" not in ctx:
        return None
    return counters.window_percentile(ctx, "query/h2d_s", 50, 1e3)
