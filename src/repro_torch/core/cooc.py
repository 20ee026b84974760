"""Compatibility entry points over the typed counting-plan API.

The method registry now lives in ``core/specs.py`` (typed ``MethodSpec``
records with validated params and §3 cost models) and planning/execution in
``core/plan.py`` (``CountJob`` → ``Planner`` → ``Plan`` → ``PlanExecutor``).
This module keeps the original call signatures as thin shims:

* ``count(method, c, sink, **kwargs)``   — one validated method invocation;
* ``dense_counts(method, c, **kwargs)``  — dense matrix convenience (tests);
* ``count_to_store(method, c, path)``    — count straight into a store;
* ``METHODS``                            — legacy name → callable view.

Migration: ``count("auto", ...)`` is not supported here — build a
``CountJob`` (with ``method="auto"``) and go through the ``Planner`` so the
selection is recorded in the plan.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.specs import REGISTRY, get_spec
from repro_torch.core.types import DenseSink, PairSink
from repro_torch.data.corpus import Collection
from repro_torch.device import resolve_device

# legacy view of the typed registry (name -> counting callable); kept for
# callers that introspect the method set
METHODS: dict[str, Callable] = {name: spec.fn for name, spec in REGISTRY.items()}


def count(method: str, c: Collection, sink: PairSink | None = None, **kwargs):
    """Run ``method`` over collection ``c``. Returns (sink, stats).

    Compatibility shim over the typed registry: kwargs are validated against
    the method's ``MethodSpec`` (unknown or ill-typed params raise TypeError)
    and the output is byte-identical to calling the method directly.
    """
    spec = get_spec(method)  # KeyError for unknown methods (seed behavior)
    if sink is None:
        sink = DenseSink(c.vocab_size)
    stats = spec.run(c, sink, **kwargs)
    return sink, stats


def dense_counts(method: str, c: Collection, **kwargs) -> np.ndarray:
    """Convenience for tests: dense strict-upper count matrix."""
    sink, _ = count(method, c, DenseSink(c.vocab_size), **kwargs)
    return sink.mat


def count_to_store(
    method: str,
    c: Collection,
    store_path: str,
    *,
    memory_budget_pairs: int = 4 << 20,
    num_shards: int = 1,
    device: str = "cuda",
    **kwargs,
):
    """Count ``c`` with ``method`` (or ``"auto"``) straight into a persistent
    queryable store (repro_torch.store) through the plan executor: output streams
    through budgeted per-shard SpillSinks, so the counting phase holds
    O(memory_budget_pairs) pairs instead of a dense V×V matrix. Creates the
    store if ``store_path`` is new, else appends a segment (exact incremental
    update). Returns (store, segment).

    ``device`` is where gpu-kind methods run their kernels: the card by
    default (raising when there is none), the host with ``device="cpu"``.
    ``"auto"`` picks among the methods of that device: ``list-scan-segment``
    on the card, ``list-scan`` on the host.

    Example::

        store, seg = count_to_store("list-scan-segment", c, "/data/store")
    """
    from repro_torch.core.plan import CountJob, Planner

    resolve_device(device)
    job = CountJob(
        collection=c,
        output="store",
        method=method,
        out_path=store_path,
        memory_budget_pairs=memory_budget_pairs,
        num_shards=num_shards,
        device=device,
        method_kwargs=kwargs,
    )
    res = Planner().plan(job).execute()
    return res.store, res.segment
