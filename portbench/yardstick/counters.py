"""The program's serving telemetry, windowed: ``CoocServer.stats()`` at the
window's start and at the server's stop (the workers' summed counters, and
their merged registry snapshots under ``"metrics"``), differenced. Histograms are the program's log-bucket
format (``repro_torch.obs.metrics``): a percentile is the midpoint of the
bucket that holds its rank."""

from __future__ import annotations

import math


def window_count(ctx: dict, name: str) -> int:
    return ctx["final"].get(name, 0) - ctx["base"].get(name, 0)


def window_percentile(ctx: dict, name: str, q: float, scale: float = 1.0):
    """The ``q``-th percentile of histogram ``name`` over the window, times
    ``scale``, or ``None`` when the window recorded nothing."""
    from repro_torch.obs.metrics import bucket_mid

    def buckets(snap):
        h = snap["metrics"].get("histograms", {}).get(name)
        return {int(k): int(v) for k, v in h["buckets"].items()} if h else {}

    base, final = buckets(ctx["base"]), buckets(ctx["final"])
    diff = {i: n - base.get(i, 0) for i, n in final.items() if n > base.get(i, 0)}
    count = sum(diff.values())
    if count == 0:
        return None
    rank, seen = max(1, math.ceil(q / 100.0 * count)), 0
    for i in sorted(diff):
        seen += diff[i]
        if seen >= rank:
            return bucket_mid(i) * scale
    return None
