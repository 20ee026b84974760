"""Core: exact term co-occurrence counting (the paper's contribution).

The five paper methods on the host (naive, list-pairs, list-blocks,
list-scan, multi-scan); their kernel adaptations on the device
(``list-scan-segment`` on ``segment_hist``, ``list-blocks-gram`` and
``multi-scan-matmul`` on ``cooc_gram``, ``list-pairs-bitpacked`` on
``bitpair``); the beyond-paper FREQ-SPLIT hybrid (``cooc_gram`` head,
``segment_hist`` tail); and the typed counting-plan API (``specs``/``plan``):
the MethodSpec registry with §3 cost models, the Planner
(``method="auto"``), the serial, resumable PlanExecutor and the
multi-process ParallelExecutor; and the multi-device Gram on
``torch.distributed`` (``distributed``).

Entry points::

    res = execute_job(CountJob(collection=c, output="store",
                               out_path="/data/store", method="auto"))
    count("list-scan", c, sink)
    mat = dense_counts("naive", c)            # strict-upper oracle
    store, seg = count_to_store("auto", cd, "/data/store", df_descending=True)
"""

from repro_torch.core.cooc import METHODS, count, count_to_store, dense_counts
from repro_torch.core.oracle import brute_force_counts
from repro_torch.core.plan import (
    CountJob,
    ExecutionResult,
    ParallelExecutor,
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
    "ParallelExecutor",
    "PlanExecutor",
    "ExecutionResult",
    "execute_job",
    "count",
    "count_to_store",
    "dense_counts",
    "brute_force_counts",
    "DenseSink",
    "FileSink",
    "StatsSink",
    "read_pair_file",
]
