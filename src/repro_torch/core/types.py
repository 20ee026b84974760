"""Output plumbing for co-occurrence counting.

The paper's output format (§2 NAÏVE): "a primary key followed by multiple
tuples of secondary keys and counts" — used for the final output of all
methods. A ``PairSink`` receives rows in that exact shape; implementations
either materialize a dense matrix (tests, small vocab), stream aggregate
statistics (benchmarks at large vocab), or write the paper's binary format.
"""

from __future__ import annotations

import struct
from typing import Protocol

import numpy as np


class PairSink(Protocol):
    def emit_row(self, primary: int, secondaries: np.ndarray, counts: np.ndarray) -> None:
        """Emit all nonzero pairs (primary, s) with primary < s, counts >= 1."""
        ...


class DenseSink:
    """Accumulates into a dense strict-upper-triangular int64 matrix."""

    def __init__(self, vocab_size: int):
        self.mat = np.zeros((vocab_size, vocab_size), dtype=np.int64)

    def emit_row(self, primary, secondaries, counts):
        self.mat[primary, secondaries] += counts.astype(np.int64)

    def emit_col(self, secondary, primaries, counts):
        """Column-order emission (used by the FREQ-SPLIT tail path, which
        discovers pairs one *secondary* at a time)."""
        self.mat[primaries, secondary] += counts.astype(np.int64)


class StatsSink:
    """Aggregate statistics only — distinct pairs, total count mass, the most
    frequent pair (the paper's "to"–"the" observation), and output bytes under
    the paper's format (4B primary + 8B per (secondary, count) tuple)."""

    def __init__(self):
        self.distinct_pairs = 0
        self.total_count = 0
        self.max_count = -1
        self.max_pair = (-1, -1)
        self.output_bytes = 0
        self.rows = 0

    def emit_row(self, primary, secondaries, counts):
        n = len(secondaries)
        if n == 0:
            return
        self.rows += 1
        self.distinct_pairs += n
        self.total_count += int(counts.sum())
        k = int(np.argmax(counts))
        if counts[k] > self.max_count:
            self.max_count = int(counts[k])
            self.max_pair = (int(primary), int(secondaries[k]))
        self.output_bytes += 4 + 8 * n

    def emit_col(self, secondary, primaries, counts):
        n = len(primaries)
        if n == 0:
            return
        self.distinct_pairs += n
        self.total_count += int(counts.sum())
        k = int(np.argmax(counts))
        if counts[k] > self.max_count:
            self.max_count = int(counts[k])
            self.max_pair = (int(primaries[k]), int(secondary))
        self.output_bytes += 8 * n  # column entries join existing rows


class FileSink:
    """The paper's on-disk format: primary key (u32) + count n (u32) + n
    tuples of (secondary u32, count u32)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")

    def emit_row(self, primary, secondaries, counts):
        n = len(secondaries)
        if n == 0:
            return
        self.f.write(struct.pack("<II", primary, n))
        buf = np.empty(2 * n, dtype=np.uint32)
        buf[0::2] = secondaries.astype(np.uint32)
        buf[1::2] = counts.astype(np.uint32)
        self.f.write(buf.tobytes())

    def close(self):
        self.f.close()

    def __enter__(self) -> "FileSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def iter_pair_file(path: str):
    """Stream (primary, secondaries, counts) rows from a FileSink-format
    file without loading it whole (the store's run-merge reads spill files
    through this)."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                return
            primary, n = struct.unpack("<II", hdr)
            buf = np.frombuffer(f.read(8 * n), dtype=np.uint32)
            yield primary, buf[0::2].copy(), buf[1::2].copy()


def read_pair_file(path: str):
    """Inverse of FileSink, for round-trip tests."""
    return list(iter_pair_file(path))


def group_bounds(sorted_arr: np.ndarray) -> np.ndarray:
    """Boundaries of equal-value groups in a sorted array: ``[0, start_1,
    ..., start_{g-1}, n]`` — group i spans ``bounds[i]:bounds[i+1]``. The one
    grouping idiom behind key aggregation, row splitting, and the symmetric
    scatter (callers slice ``[:-1]`` when they only need starts)."""
    n = len(sorted_arr)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    return np.concatenate(
        [[0], np.nonzero(sorted_arr[1:] != sorted_arr[:-1])[0] + 1, [n]]
    )


def emit_dense_rows(
    mat: np.ndarray, sink: PairSink, row_lo: int = 0, col_lo: int = 0
) -> None:
    """Stream the nonzero strict-upper (global j > global i) entries of a
    dense count tile whose [0,0] element is global (row_lo, col_lo).

    One tile-level ``nonzero`` + per-row split — the emission hot loop of
    every dense-accumulating method runs O(nnz) work, not O(rows · cols).
    """
    rs, cs = np.nonzero(mat)
    keep = cs + col_lo > rs + row_lo  # strict upper triangle only
    rs, cs = rs[keep], cs[keep]
    if len(rs) == 0:
        return
    vals = mat[rs, cs]
    # np.nonzero is row-major: rs is sorted, so rows are contiguous segments
    bounds = group_bounds(rs)
    for s, e in zip(bounds[:-1], bounds[1:]):
        sink.emit_row(row_lo + int(rs[s]), cs[s:e] + col_lo, vals[s:e])
