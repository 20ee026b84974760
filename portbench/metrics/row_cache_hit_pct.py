"""Share of the rows the workers' engines looked up in the window that
their LRU row caches held: the workers' ``cache_hits`` over hits and misses,
differenced between the window's start and the server's stop."""

from yardstick import counters


def read(ctx):
    if "final" not in ctx:
        return None
    hits = counters.window_count(ctx, "cache_hits")
    misses = counters.window_count(ctx, "cache_misses")
    return 100.0 * hits / (hits + misses) if hits + misses else None
