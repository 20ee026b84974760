"""Core: exact term co-occurrence counting (the paper's contribution).

LIST-SCAN on the host (``list-scan``) and on the device (``list-scan-segment``,
the batched histogram on the ``segment_hist`` kernel), and the typed
counting-plan API (``specs``/``plan``): the MethodSpec registry with §3 cost
models, the Planner (``method="auto"``), and the serial PlanExecutor.

Entry points::

    res = execute_job(CountJob(collection=c, output="store",
                               out_path="/data/store", method="auto"))
    count("list-scan", c, sink)
    store, seg = count_to_store("list-scan-segment", c, "/data/store")
"""

from repro_torch.core.cooc import METHODS, count, count_to_store, dense_counts
from repro_torch.core.plan import (
    CountJob,
    ExecutionResult,
    Plan,
    PlanExecutor,
    Planner,
    execute_job,
)
from repro_torch.core.specs import REGISTRY, MethodSpec, Param, get_spec, method_names
from repro_torch.core.types import DenseSink, FileSink, StatsSink, read_pair_file

__all__ = [
    "METHODS",
    "REGISTRY",
    "MethodSpec",
    "Param",
    "get_spec",
    "method_names",
    "CountJob",
    "Plan",
    "Planner",
    "PlanExecutor",
    "ExecutionResult",
    "execute_job",
    "count",
    "count_to_store",
    "dense_counts",
    "DenseSink",
    "FileSink",
    "StatsSink",
    "read_pair_file",
]
