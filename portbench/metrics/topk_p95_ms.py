"""95th percentile of the clients' batch requests in the window, from send
to reply, on the host's clock."""

import statistics


def read(ctx):
    lat = ctx.get("latency_s")
    if lat is None or len(lat) < 20:
        return None
    return 1e3 * float(statistics.quantiles(list(lat), n=20)[-1])
