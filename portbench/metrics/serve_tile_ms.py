"""Median time a serving worker spent building one top-k launch's
candidate tile (row lookups, padding, df gather) in the window: the
``query/tile_s`` histograms of every worker, differenced between the
window's start and the server's stop."""

from yardstick import counters


def read(ctx):
    if "final" not in ctx:
        return None
    return counters.window_percentile(ctx, "query/tile_s", 50, 1e3)
