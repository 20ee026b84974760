"""Spill-and-merge store builder.

``SpillSink`` implements the ``PairSink`` protocol, so **any** counting
method in ``core/cooc.py`` (and any per-shard worker of
``core/distributed.py``) can stream its output here instead of into a dense
V×V matrix. Rows are buffered as packed int64 pair keys under a configurable
memory budget; when the budget is hit, the buffer is **radix-partitioned**
by primary range (``primary >> pshift`` — at most 256 buckets spanning the
vocabulary), each small bucket is sorted and aggregated independently, and
every nonempty bucket is spilled as its own sorted run in the paper's binary
pair format (§2 NAÏVE's "sorted runs + merge" discipline, generalized to
every method). Because bucket boundaries align with primary ranges,
finalization merges run files *per bucket* — the k-way heap only ever spans
one bucket's runs — instead of one global merge over every run, and the
buffer, its bucket tags, and the partition scratch are all preallocated once
and reused across spills. Counting, spilling, and merging stay within
O(budget) memory regardless of the distinct-pair count; the segment's
symmetric-adjacency derivation is likewise external-memory (see
csr_store._write_symmetric).
"""

from __future__ import annotations

import glob as _glob
import heapq
import os
import re
import shutil
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.core.types import group_bounds, iter_pair_file

# radix partition width: at most 2^BUCKET_BITS primary-range buckets
BUCKET_BITS = 8

# a completed spill shard's directory (promoted atomically by the executor
# that owns it); in-flight attempts live in wip_* directories that this
# pattern deliberately does not match, so run discovery never sees partials
SHARD_DIR_RE = re.compile(r"^shard_(\d+)$")
_RUN_NAME_RE = re.compile(r"^run_\d+_b(\d+)\.bin$")


def shard_dir_name(shard: int) -> str:
    """Canonical name of a completed spill shard's run directory."""
    return f"shard_{shard:05d}"


def wip_dir_name(shard: int, worker: str) -> str:
    """Name of one worker's in-flight attempt at a shard — distinct per
    (shard, worker) so concurrent attempts (a straggler plus its backup
    task) never collide, and never matched by :data:`SHARD_DIR_RE` so a
    crashed attempt's partial runs are invisible to run discovery."""
    return f"wip_{worker}_{shard:05d}"


def discover_bucket_runs(spill_root: str) -> tuple[dict[int, list[str]], bool]:
    """Group every completed shard's run files by radix bucket.

    Walks ``spill_root/shard_*/run_*_b*.bin`` — the naming every SpillSink
    uses, whichever process wrote it — and returns ``(by_bucket, legacy)``.
    ``legacy`` is True when a pre-bucketing run file (no ``_b`` suffix, from
    a resumed old spill directory) is present, in which case the caller must
    fall back to one global k-way merge; ``by_bucket`` then maps bucket -1
    to every run path. Paths are sorted, so the grouping is deterministic
    across processes."""
    runs = sorted(
        p
        for d in _glob.glob(os.path.join(spill_root, "shard_*"))
        if SHARD_DIR_RE.match(os.path.basename(d))
        for p in _glob.glob(os.path.join(d, "run_*.bin"))
    )
    by_bucket: dict[int, list[str]] = {}
    for p in runs:
        m = _RUN_NAME_RE.match(os.path.basename(p))
        if m is None:
            return {-1: runs}, True
        by_bucket.setdefault(int(m.group(1)), []).append(p)
    return by_bucket, False


def write_rows_run(path: str, rows, V: int, *,
                   buffer_pairs: int = 1 << 20) -> int:
    """Stream merged (primary, secondaries, counts) rows into one run-format
    file (the exact bytes ``_write_run`` would produce for the same rows),
    buffering ~``buffer_pairs`` pairs between writes so a huge bucket never
    materializes in memory. Counts must fit the run format's u32 — final
    merged counts, like spilled ones, are checked. Returns the pair count.

    The parallel finalizer uses this to persist one bucket's fully merged
    rows as a resumable intermediate: re-reading it with ``_iter_run``
    yields back exactly the rows that went in."""
    total = 0
    pend_keys: list[np.ndarray] = []
    pend_cnts: list[np.ndarray] = []
    pending = 0
    with open(path, "wb") as f:

        def _flush():
            nonlocal pending
            if not pending:
                return
            keys = np.concatenate(pend_keys)
            cnts = np.concatenate(pend_cnts)
            pend_keys.clear()
            pend_cnts.clear()
            pending = 0
            _write_run_into(f, keys, cnts, V)

        for primary, secs, cnts in rows:
            cnts = np.asarray(cnts, dtype=np.int64)
            if len(cnts) and int(cnts.max()) >= 1 << 32:
                raise OverflowError(
                    f"merged count {int(cnts.max())} exceeds the u32 run "
                    "format"
                )
            pend_keys.append(
                np.int64(primary) * V + np.asarray(secs, dtype=np.int64)
            )
            pend_cnts.append(cnts)
            pending += len(cnts)
            total += len(cnts)
            if pending >= buffer_pairs:
                _flush()
        _flush()
    return total


def sum_by_key(keys: np.ndarray, cnts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate duplicate keys: returns (sorted unique keys, summed int64
    counts). The one aggregation primitive behind spilling, run merging, and
    multi-segment neighbourhood merging. One stable sort; duplicate-group
    boundaries come from a ``diff`` over the sorted keys (``np.unique`` would
    sort a second time)."""
    cnts = np.asarray(cnts, dtype=np.int64)
    if len(keys) == 0:
        return np.asarray(keys, dtype=np.int64).copy(), cnts.copy()
    order = np.argsort(keys, kind="stable")
    keys, cnts = keys[order], cnts[order]
    starts = group_bounds(keys)[:-1]
    return keys[starts], np.add.reduceat(cnts, starts)


def _iter_run(path: str):
    """Stream int64 rows from a run file (paper binary format, primaries
    strictly ascending within a run)."""
    for primary, secs, cnts in iter_pair_file(path):
        yield int(primary), secs.astype(np.int64), cnts.astype(np.int64)


def _write_run(path: str, keys: np.ndarray, cnts: np.ndarray, V: int) -> None:
    """Write sorted unique packed keys as one run file (paper binary format)
    in a single ``tofile`` — the whole file image is assembled with two
    scatter assignments instead of per-row struct packing + writes."""
    with open(path, "wb") as f:
        _write_run_into(f, keys, cnts, V)


def _write_run_into(f, keys: np.ndarray, cnts: np.ndarray, V: int) -> None:
    """One run-format image of whole rows appended to an open file. Chunks
    written back to back stay a valid run as long as every chunk holds whole
    rows and primaries ascend across chunks (``write_rows_run`` guarantees
    both)."""
    prims = keys // V
    bounds = group_bounds(prims)
    starts = bounds[:-1]
    ns = np.diff(bounds)
    npairs = len(keys)
    nrows = len(starts)
    out = np.empty(2 * nrows + 2 * npairs, dtype=np.uint32)
    # record r sits after r headers and pairs_before(r) tuples (2 words each)
    hdr = 2 * np.arange(nrows, dtype=np.int64) + 2 * starts
    out[hdr] = prims[starts]
    out[hdr + 1] = ns
    # pair p of row r(p) lands at 2·r(p) + 2 + 2·p
    rpp = np.repeat(np.arange(nrows, dtype=np.int64), ns)
    sec_pos = 2 * rpp + 2 + 2 * np.arange(npairs, dtype=np.int64)
    out[sec_pos] = keys % V
    out[sec_pos + 1] = cnts
    out.tofile(f)


def _load_run(path: str, V: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized whole-run parse: one ``np.fromfile`` plus an O(rows)
    header walk, returning the run's (packed int64 keys, int64 counts) —
    sorted unique, exactly as spilled. The per-pair struct unpacking of
    ``iter_pair_file`` is the merge phase's Python hot spot; this replaces
    it with three fancy-index gathers."""
    words = np.fromfile(path, dtype=np.uint32)
    if len(words) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    offs = []
    k = 0
    while k < len(words):  # one step per row, not per pair
        offs.append(k)
        k += 2 + 2 * int(words[k + 1])
    offs = np.asarray(offs, dtype=np.int64)
    prim = words[offs].astype(np.int64)
    ns = words[offs + 1].astype(np.int64)
    lens = 2 * ns
    pos = np.zeros(len(offs) + 1, dtype=np.int64)
    np.cumsum(lens, out=pos[1:])
    idx = np.arange(pos[-1], dtype=np.int64) + np.repeat(offs + 2 - pos[:-1], lens)
    tup = words[idx]
    keys = np.repeat(prim, ns) * V + tup[0::2]
    return keys, tup[1::2].astype(np.int64)


def merge_bucket_runs(by_bucket, V: int, *, cap_pairs: int, live=None):
    """Merged (primary, secondaries, counts) rows across bucket-partitioned
    runs, walking buckets in ascending order (buckets cover disjoint
    ascending primary ranges, so concatenation is globally sorted).

    A bucket whose total pairs fit ``cap_pairs`` is merged **in memory** —
    every run loaded with the vectorized ``_load_run``, one ``sum_by_key``
    — which is the common case by construction (a bucket holds ~1/256 of
    the key space). Oversized buckets fall back to the streaming k-way heap
    merge, so memory stays O(cap_pairs) no matter how skewed the keys are.

    ``by_bucket`` maps bucket -> [run paths]; ``live`` (optional) maps
    bucket -> (sorted unique keys, counts) for a sink's unspilled buffer.
    """
    live = dict(live or {})
    reg = obs.get_registry()
    for b in sorted(set(by_bucket) | set(live)):
        paths = by_bucket.get(b, [])
        lk = live.pop(b, None)
        # run bytes = 8·pairs + 8·rows, so size//8 never underestimates
        est = sum(os.path.getsize(p) // 8 for p in paths)
        est += len(lk[0]) if lk else 0
        reg.counter("ingest.runs_merged").inc(len(paths))
        if est <= cap_pairs:
            # the merge work is the eager part (load + aggregate); the span
            # closes before the rows are yielded so a slow consumer does not
            # inflate the merge timing
            with reg.span("ingest/bucket_merge", bucket=b, runs=len(paths)):
                parts = [_load_run(p, V) for p in paths]
                if lk is not None:
                    parts.append(lk)
                if len(parts) == 1:
                    keys, cnts = parts[0]  # a lone run is already aggregated
                else:
                    keys = np.concatenate([p[0] for p in parts])
                    cnts = np.concatenate([p[1] for p in parts])
                    # a term-order producer (LIST-SCAN) emits globally
                    # ascending keys, so consecutive spills cover disjoint
                    # ascending ranges: one diff check replaces the whole
                    # merge sort
                    if not bool((np.diff(keys) > 0).all()):
                        keys, cnts = sum_by_key(keys, cnts)
            yield from _rows_from_sorted_keys(keys, cnts, V)
        else:
            streams = [_iter_run(p) for p in paths]
            if lk is not None:
                streams.append(_rows_from_sorted_keys(lk[0], lk[1], V))
            if len(streams) == 1:
                yield from streams[0]
            else:
                yield from merge_row_streams(streams)


def merge_row_streams(streams):
    """K-way merge of row streams (each with strictly ascending primaries and
    sorted unique secondaries). Yields (primary, secondaries, counts) with
    strictly ascending primaries, duplicate pairs summed — the exact input
    shape ``csr_store.write_segment`` expects. Streams are consumed lazily,
    so memory is O(k · max row), not O(total pairs)."""
    streams = [iter(s) for s in streams]
    heap = []
    for idx, it in enumerate(streams):
        first = next(it, None)
        if first is not None:
            heap.append((first[0], idx, first))
    heapq.heapify(heap)
    while heap:
        primary = heap[0][0]
        secs_parts, cnts_parts = [], []
        while heap and heap[0][0] == primary:
            _, idx, (_, secs, cnts) = heapq.heappop(heap)
            secs_parts.append(secs)
            cnts_parts.append(cnts)
            nxt = next(streams[idx], None)
            if nxt is not None:
                heapq.heappush(heap, (nxt[0], idx, nxt))
        if len(secs_parts) == 1:
            secs = np.asarray(secs_parts[0], dtype=np.int64)
            cnts = np.asarray(cnts_parts[0], dtype=np.int64)
        else:
            secs, cnts = sum_by_key(
                np.concatenate(secs_parts).astype(np.int64),
                np.concatenate(cnts_parts),
            )
        yield primary, secs, cnts


def _rows_from_sorted_keys(keys: np.ndarray, cnts: np.ndarray, V: int):
    """Split sorted unique packed keys into per-primary rows."""
    if len(keys) == 0:
        return
    primaries = keys // V
    secondaries = keys % V
    bounds = group_bounds(primaries)
    for s, e in zip(bounds[:-1], bounds[1:]):
        yield int(primaries[s]), secondaries[s:e], cnts[s:e]


class SpillSink:
    """PairSink that spills sorted aggregated runs to disk under a memory
    budget (measured in buffered pair entries; the live buffer costs 18
    bytes per budgeted pair — packed key, count, bucket tag — plus, on the
    first unsorted spill only, 16 bytes per pair of partition scratch)."""

    def __init__(
        self,
        vocab_size: int,
        *,
        memory_budget_pairs: int = 4 << 20,
        spill_dir: str | None = None,
    ):
        if memory_budget_pairs < 1:
            raise ValueError("memory_budget_pairs must be >= 1")
        self.vocab_size = vocab_size
        self.memory_budget_pairs = memory_budget_pairs
        self._own_dir = spill_dir is None
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="cooc_spill_")
        os.makedirs(self.spill_dir, exist_ok=True)
        # primary-range radix: bucket = primary >> pshift, <= 2^BUCKET_BITS
        # buckets spanning the vocabulary
        self._pshift = max(0, int(vocab_size).bit_length() - BUCKET_BITS)
        self.num_buckets = ((max(vocab_size, 1) - 1) >> self._pshift) + 1
        # run files, as (bucket, path); every run holds one bucket's primary
        # range, sorted — finalization merges runs bucket by bucket
        self.runs: list[tuple[int, str]] = []
        self._spills = 0
        # scratch reused across the sink's whole life: the live buffer, its
        # bucket tags, and the partition output (filled by np.take)
        cap = memory_budget_pairs
        self._buf_keys = np.empty(cap, dtype=np.int64)
        self._buf_cnts = np.empty(cap, dtype=np.int64)
        self._buf_bkt = np.empty(cap, dtype=np.uint16)
        # partition scratch is only needed on the unsorted spill path —
        # allocated on first use (term-order producers never pay for it)
        self._part_keys: np.ndarray | None = None
        self._part_cnts: np.ndarray | None = None
        self._buffered = 0
        # term-order producers (LIST-SCAN and friends) emit strictly
        # ascending keys; while the streak holds, spilling skips the radix
        # argsort + aggregation entirely (searchsorted bucket split instead)
        self._buf_sorted = True
        self._last_key = -1
        self.stats = {"spills": 0, "pairs_in": 0, "spilled_bytes": 0,
                      "bucket_runs": 0, "sorted_spills": 0}

    # ------------------------------------------------------ PairSink API
    def _reserve(self, n: int) -> int:
        """Make room for ``n`` entries. Returns the buffer write offset, or
        -1 for an oversize emission (larger than the whole buffer) that the
        caller must hand to ``_oversize`` instead."""
        if n > len(self._buf_keys) - self._buffered:
            self._spill()
        return -1 if n > len(self._buf_keys) else self._buffered

    def _commit(self, u: int, n: int) -> None:
        """Account for ``n`` entries just packed at offset ``u``: advance the
        buffer, update the ascending-emission streak, count the pairs."""
        self._buffered = u + n
        self._note_keys(self._buf_keys[u:u + n])
        self.stats["pairs_in"] += n

    def _oversize(self, keys, counts, bkt) -> None:
        """Partition an oversize emission straight to run files."""
        self._partition_spill(keys, np.asarray(counts), bkt)
        self.stats["pairs_in"] += len(keys)

    def emit_row(self, primary, secondaries, counts):
        """Row-order emission: keys are packed straight into the preallocated
        buffer (no intermediate int64 copies of ``secondaries``/``counts``)."""
        n = len(secondaries)
        if n == 0:
            return
        u = self._reserve(n)
        if u < 0:
            keys = np.int64(primary) * self.vocab_size + np.asarray(
                secondaries, dtype=np.int64
            )
            bkt = np.full(n, primary >> self._pshift, dtype=np.uint16)
            self._oversize(keys, counts, bkt)
            return
        buf = self._buf_keys[u:u + n]
        np.add(secondaries, np.int64(primary) * self.vocab_size, out=buf)
        self._buf_cnts[u:u + n] = counts
        self._buf_bkt[u:u + n] = primary >> self._pshift
        self._commit(u, n)

    def emit_col(self, secondary, primaries, counts):
        """Column-order emission (FREQ-SPLIT tail path)."""
        n = len(primaries)
        if n == 0:
            return
        primaries = np.asarray(primaries)
        u = self._reserve(n)
        if u < 0:
            keys = primaries.astype(np.int64) * self.vocab_size + np.int64(
                secondary
            )
            bkt = (primaries >> self._pshift).astype(np.uint16)
            self._oversize(keys, counts, bkt)
            return
        buf = self._buf_keys[u:u + n]
        np.multiply(primaries, np.int64(self.vocab_size), out=buf)
        np.add(buf, np.int64(secondary), out=buf)
        self._buf_cnts[u:u + n] = counts
        np.right_shift(primaries, self._pshift, out=self._buf_bkt[u:u + n],
                       casting="unsafe")
        self._commit(u, n)

    def emit_keys(self, keys, counts):
        """Batch fast path for vectorized producers: pre-packed pair keys
        (``primary * vocab_size + secondary``) in one call, skipping per-row
        splitting entirely. Semantically identical to the equivalent
        ``emit_row`` calls (same buffer contents in the same order); the
        counting hot loops use it when the sink offers it."""
        n = len(keys)
        if n == 0:
            return
        u = self._reserve(n)
        if u < 0:
            keys = np.asarray(keys, dtype=np.int64)
            bkt = ((keys // self.vocab_size) >> self._pshift).astype(np.uint16)
            self._oversize(keys, counts, bkt)
            return
        self._buf_keys[u:u + n] = keys
        self._buf_cnts[u:u + n] = counts
        np.right_shift(
            self._buf_keys[u:u + n] // self.vocab_size, self._pshift,
            out=self._buf_bkt[u:u + n], casting="unsafe",
        )
        self._commit(u, n)

    def _note_keys(self, buf: np.ndarray) -> None:
        """Track the ascending-emission streak: one O(1) range check plus an
        O(n) diff — while it holds, the spill's radix argsort and
        ``sum_by_key`` are skipped (the buffer is already sorted unique)."""
        if self._buf_sorted:
            if int(buf[0]) > self._last_key and (
                len(buf) == 1 or bool((np.diff(buf) > 0).all())
            ):
                self._last_key = int(buf[-1])
            else:
                self._buf_sorted = False

    # ------------------------------------------------------ context manager
    def __enter__(self) -> "SpillSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---------------------------------------------------------- spilling
    def _partition(self, keys, cnts, bkt, *, is_sorted: bool = False):
        """Partition (keys, cnts) by primary-range bucket, yielding
        (bucket, sorted unique keys, summed counts) per nonempty bucket.

        ``is_sorted`` (the ascending-emission streak held for this buffer):
        bucket boundaries come from one ``searchsorted`` over the already
        sorted unique keys — no argsort, no aggregation. Otherwise a radix
        MSB pass (stable argsort of the 16-bit bucket tags into the reused
        scratch arrays) groups the buckets and each small bucket is
        aggregated independently — never a sort of the whole key space."""
        n = len(keys)
        if is_sorted:
            edges = (
                np.arange(1, self.num_buckets, dtype=np.int64) << self._pshift
            ) * self.vocab_size
            bounds = np.concatenate([[0], np.searchsorted(keys, edges), [n]])
            cnts = np.asarray(cnts, dtype=np.int64)
            for b in range(self.num_buckets):
                s, e = bounds[b], bounds[b + 1]
                if e > s:
                    yield int(b), keys[s:e], cnts[s:e]
            return
        order = np.argsort(bkt, kind="stable")  # 16-bit tags: cheap MSB sort
        if self._part_keys is None:
            cap = len(self._buf_keys)
            self._part_keys = np.empty(cap, dtype=np.int64)
            self._part_cnts = np.empty(cap, dtype=np.int64)
        pk = self._part_keys[:n] if n <= len(self._part_keys) else np.empty(
            n, dtype=np.int64
        )
        pc = self._part_cnts[:n] if n <= len(self._part_cnts) else np.empty(
            n, dtype=np.int64
        )
        np.take(keys, order, out=pk)
        np.take(np.asarray(cnts, dtype=np.int64), order, out=pc)
        sizes = np.bincount(bkt, minlength=self.num_buckets)
        bounds = np.zeros(self.num_buckets + 1, dtype=np.int64)
        np.cumsum(sizes, out=bounds[1:])
        for b in np.nonzero(sizes)[0]:
            s, e = bounds[b], bounds[b + 1]
            yield int(b), *sum_by_key(pk[s:e], pc[s:e])

    def _check_u32(self, cnts: np.ndarray) -> None:
        if len(cnts) and int(cnts.max()) >= 1 << 32:
            # the run format stores counts as u32 (paper format); a single
            # buffer can only exceed that when fed pre-aggregated counts
            raise OverflowError(
                f"aggregated count {int(cnts.max())} exceeds the u32 run "
                "format; lower memory_budget_pairs or pre-split the input"
            )

    def _partition_spill(self, keys, cnts, bkt, *, is_sorted=False) -> None:
        """Partition one batch by bucket and write each nonempty bucket as
        its own sorted run file."""
        spill_id = self._spills
        self._spills += 1
        if is_sorted:
            self.stats["sorted_spills"] += 1
        nruns0 = len(self.runs)
        bytes0 = self.stats["spilled_bytes"]
        with obs.get_registry().span(
            "ingest/spill", pairs=len(keys), sorted=is_sorted
        ) as sp:
            for b, bkeys, bcnts in self._partition(keys, cnts, bkt,
                                                   is_sorted=is_sorted):
                self._check_u32(bcnts)
                path = os.path.join(
                    self.spill_dir, f"run_{spill_id:05d}_b{b:04d}.bin"
                )
                _write_run(path, bkeys, bcnts, self.vocab_size)
                self.runs.append((b, path))
                self.stats["spilled_bytes"] += os.path.getsize(path)
            sp.set(runs=len(self.runs) - nruns0)
        self.stats["spills"] += 1
        self.stats["bucket_runs"] = len(self.runs)
        reg = obs.get_registry()
        reg.counter("ingest.spills").inc()
        reg.counter("ingest.bytes_spilled").inc(
            self.stats["spilled_bytes"] - bytes0
        )
        reg.counter("ingest.bucket_runs").inc(len(self.runs) - nruns0)

    def _spill(self) -> None:
        if self._buffered == 0:
            return
        n = self._buffered
        was_sorted = self._buf_sorted
        self._buffered = 0
        # each run stands alone: the next buffer starts a fresh streak
        self._buf_sorted = True
        self._last_key = -1
        self._partition_spill(
            self._buf_keys[:n], self._buf_cnts[:n], self._buf_bkt[:n],
            is_sorted=was_sorted,
        )

    def flush(self) -> None:
        """Force the live buffer to disk as sorted bucket runs. After a flush
        the run files alone carry the sink's full state — the PlanExecutor
        uses this to make completed shards' spill directories restart-safe."""
        self._spill()

    # --------------------------------------------------------- finalize
    def merged_rows(self):
        """Iterator of fully merged (primary, secondaries, counts) rows
        across all spilled runs and the live buffer. May be consumed once.

        Buckets partition the primary range in ascending order, so the merge
        walks buckets one at a time — in memory when the bucket fits the
        merge cap (4× the spill budget), via the streaming heap otherwise —
        never holding more than one bucket's pairs at once
        (see ``merge_bucket_runs``)."""
        runs_by_bucket: dict[int, list[str]] = {}
        for b, path in self.runs:
            runs_by_bucket.setdefault(b, []).append(path)
        live: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if self._buffered:
            n = self._buffered
            was_sorted = self._buf_sorted
            self._buffered = 0
            live = {
                b: (bkeys, bcnts)
                for b, bkeys, bcnts in self._partition(
                    self._buf_keys[:n], self._buf_cnts[:n], self._buf_bkt[:n],
                    is_sorted=was_sorted,
                )
            }
        yield from merge_bucket_runs(
            runs_by_bucket, self.vocab_size,
            cap_pairs=4 * self.memory_budget_pairs, live=live,
        )

    def finalize_segment(
        self,
        out_dir: str,
        *,
        df: np.ndarray | None = None,
        num_docs: int = 0,
        source: str = "spill",
        version: int | None = None,
    ):
        """Merge everything into a CSR segment at ``out_dir`` and clean up
        the spill files. Returns the opened segment (``version`` picks the
        on-disk format, see ``csr_store.write_segment``)."""
        from repro_torch.store.csr_store import open_segment, write_segment

        write_segment(
            out_dir,
            self.merged_rows(),
            self.vocab_size,
            df=df,
            num_docs=num_docs,
            source=source,
            version=version,
        )
        self.close()
        return open_segment(out_dir)

    def close(self) -> None:
        """Delete spill files (and the spill dir if we created it)."""
        for _, p in self.runs:
            if os.path.exists(p):
                os.remove(p)
        self.runs = []
        self._buffered = 0
        if self._own_dir and os.path.isdir(self.spill_dir):
            shutil.rmtree(self.spill_dir, ignore_errors=True)
