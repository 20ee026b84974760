"""Median time a request waited between the client's submit and its
worker's batch start in the window: the ``serving/queue_wait_s``
histograms, differenced between the window's start and the server's
stop."""

from yardstick import counters


def read(ctx):
    if "final" not in ctx:
        return None
    return counters.window_percentile(ctx, "serving/queue_wait_s", 50, 1e3)
