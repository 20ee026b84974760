"""Persistent, queryable co-occurrence store.

Layers: ``builder`` (SpillSink: budgeted spill-and-merge from any PairSink
producer) → ``codec``/``bloom`` (block-compressed columns, blocked bloom
filters) → ``csr_store`` (immutable segments: v1 raw mmap or v2
compressed, one ``open_segment`` dispatch) → ``segments`` (LSM manifest:
incremental append, shard ingest, size-tiered compaction) → ``requests``
(typed query requests, QueryPlanner routing/coalescing, one execution path)
→ ``query`` (batched pair/top-k/PMI engine on the ``topk_gather`` kernel).
The on-disk formats are the reference package's (docs/formats.md): a store
written by either package opens in the other. The multi-process serving
layer and the compaction daemon are not ported yet.
"""

from repro_torch.store.bloom import BloomFilter
from repro_torch.store.builder import SpillSink, merge_row_streams
from repro_torch.store.codec import BlockCache, CompressedColumn, write_column
from repro_torch.store.csr_store import (
    CompressedSegment,
    CSRSegment,
    compress_segment,
    open_segment,
    segment_bytes,
    segment_from_pair_file,
    write_segment,
)
from repro_torch.store.query import QueryEngine
from repro_torch.store.requests import (
    NeighboursRequest,
    PairCountsRequest,
    QueryPlan,
    QueryPlanner,
    TopKRequest,
    route_term,
)
from repro_torch.store.segments import CompactionHandle, Store

__all__ = [
    "SpillSink",
    "merge_row_streams",
    "BloomFilter",
    "BlockCache",
    "CompressedColumn",
    "write_column",
    "CSRSegment",
    "CompressedSegment",
    "compress_segment",
    "open_segment",
    "segment_bytes",
    "segment_from_pair_file",
    "write_segment",
    "QueryEngine",
    "Store",
    "CompactionHandle",
    "TopKRequest",
    "PairCountsRequest",
    "NeighboursRequest",
    "QueryPlan",
    "QueryPlanner",
    "route_term",
]
