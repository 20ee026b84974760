"""Memory-mapped CSR pair-count segments.

A segment is an immutable directory holding the strict-upper co-occurrence
counts of one document batch as CSR arrays, memory-mapped at open so a
serving process touches only the pages a query needs:

    meta.json         vocab_size, nnz, num_docs, total_count, source
    row_ptr.bin       int64[V+1]   CSR row pointers (dense over the vocab)
    cols.bin          int32[nnz]   secondary term IDs, ascending per row
    counts.bin        int64[nnz]   exact pair counts
    df.bin            int64[V]     per-term document frequencies (0 if unknown)
    sym_row_ptr.bin   int64[V+1]   symmetric adjacency (t -> all neighbours,
    sym_cols.bin      int32[2nnz]   both directions), what top-k queries walk
    sym_counts.bin    int64[2nnz]

Lookup costs: ``row``/``neighbours`` are O(1) pointer arithmetic on the
mmap; ``pair_count`` is a binary search within one row, O(log deg). The
strict-upper CSR is the canonical artifact and round-trips with the paper's
binary pair format (``FileSink`` / ``read_pair_file``); the symmetric
adjacency is derived from it at write time so neighbourhood queries never
scan the whole matrix.

The layout above is **format v1** (raw arrays). **Format v2** stores the
same logical arrays as block-compressed columns (repro_torch.store.codec) with
zero-count rows elided and a blocked bloom filter over the pair keys
(repro_torch.store.bloom); see docs/formats.md for the byte-level spec. Both
versions are read through :func:`open_segment`, which dispatches on the
``magic``/``format_version`` header in ``meta.json`` — every consumer above
the segment boundary (query engine, serving, compaction) is
version-oblivious. ``write_segment(..., version=2)`` produces v2 by
building the v1 arrays first (reusing the bounded-memory symmetric build)
and transcoding them in place; decode is exact, so queries are
byte-identical across versions.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.types import FileSink, PairSink, group_bounds, read_pair_file
from repro_torch.store import bloom as bloom_mod
from repro_torch.store import codec as codec_mod
from repro_torch.store.codec import write_column

META_NAME = "meta.json"
SEGMENT_MAGIC = "cooc-seg"
FORMAT_VERSION = 1
SEGMENT_VERSIONS = (1, 2)
DEFAULT_SEGMENT_VERSION = 1

_ARRAYS = {
    "row_ptr": np.int64,
    "cols": np.int32,
    "counts": np.int64,
    "df": np.int64,
    "sym_row_ptr": np.int64,
    "sym_cols": np.int32,
    "sym_counts": np.int64,
}


def _write_array(path: str, arr: np.ndarray, dtype) -> None:
    np.ascontiguousarray(arr, dtype=dtype).tofile(path)


def write_segment(
    out_dir: str,
    rows,
    vocab_size: int,
    *,
    df: np.ndarray | None = None,
    num_docs: int = 0,
    source: str = "",
    sym_chunk_pairs: int | None = None,
    version: int | None = None,
) -> str:
    """Materialize a segment from ``rows`` — an iterator of
    ``(primary, secondaries, counts)`` with strictly ascending primaries and,
    within each row, strictly ascending unique secondaries (the shape
    ``builder.merge_row_streams`` produces). Returns ``out_dir``.

    ``sym_chunk_pairs`` bounds the symmetric-adjacency build's working set
    (pairs streamed per chunk; default ``SYM_CHUNK_PAIRS``) — finalization
    memory is O(V + chunk) regardless of nnz.

    ``version`` picks the on-disk format: 1 (raw arrays, the default) or
    2 (block-compressed columns + bloom filter; the v1 arrays are built
    first, then transcoded in place by :func:`compress_segment`).
    """
    version = DEFAULT_SEGMENT_VERSION if version is None else int(version)
    if version not in SEGMENT_VERSIONS:
        raise ValueError(
            f"unknown segment version {version}; this build writes "
            f"{SEGMENT_VERSIONS}"
        )
    with obs.get_registry().span(
        "ingest/segment_write", vocab=vocab_size, version=version
    ) as sp:
        nnz, nrows = _write_segment_files(
            out_dir, rows, vocab_size, df=df, num_docs=num_docs,
            source=source, sym_chunk_pairs=sym_chunk_pairs,
        )
        sp.set(nnz=nnz, rows=nrows)
        if version == 2:
            compress_segment(out_dir)
    reg = obs.get_registry()
    reg.counter("ingest.rows_written").inc(nrows)
    reg.counter("ingest.pairs_written").inc(nnz)
    return out_dir


def _write_segment_files(
    out_dir, rows, vocab_size, *, df, num_docs, source, sym_chunk_pairs
) -> tuple[int, int]:
    os.makedirs(out_dir, exist_ok=True)
    V = vocab_size
    row_ptr = np.zeros(V + 1, dtype=np.int64)
    nnz = 0
    nrows = 0
    total = 0
    last_primary = -1
    # batch row payloads into ~8 MB writes: thousands of small rows must not
    # mean thousands of syscalls on the ingest hot path
    pend_cols: list[np.ndarray] = []
    pend_cnts: list[np.ndarray] = []
    pending = 0
    with open(os.path.join(out_dir, "cols.bin"), "wb") as fc, open(
        os.path.join(out_dir, "counts.bin"), "wb"
    ) as fn:
        def _flush_pending():
            nonlocal pending
            if pending:
                fc.write(np.concatenate(pend_cols).tobytes())
                fn.write(np.concatenate(pend_cnts).tobytes())
                pend_cols.clear()
                pend_cnts.clear()
                pending = 0

        for primary, secs, cnts in rows:
            if primary <= last_primary:
                raise ValueError(
                    f"rows must have strictly ascending primaries; "
                    f"got {primary} after {last_primary}"
                )
            last_primary = primary
            n = len(secs)
            if n == 0:
                continue
            row_ptr[primary + 1] = n
            nnz += n
            nrows += 1
            cnts64 = np.ascontiguousarray(cnts, dtype=np.int64)
            total += int(cnts64.sum())
            pend_cols.append(np.ascontiguousarray(secs, dtype=np.int32))
            pend_cnts.append(cnts64)
            pending += n
            if pending >= (1 << 20):
                _flush_pending()
        _flush_pending()
    np.cumsum(row_ptr, out=row_ptr)
    _write_array(os.path.join(out_dir, "row_ptr.bin"), row_ptr, np.int64)

    if df is None:
        df = np.zeros(V, dtype=np.int64)
    _write_array(os.path.join(out_dir, "df.bin"), df, np.int64)

    _write_symmetric(
        out_dir, row_ptr, V, nnz,
        chunk_pairs=sym_chunk_pairs or SYM_CHUNK_PAIRS,
    )

    meta = {
        "magic": SEGMENT_MAGIC,
        "format_version": FORMAT_VERSION,
        "vocab_size": V,
        "nnz": nnz,
        "num_docs": int(num_docs),
        "total_count": total,
        "source": source,
        # wall-clock append time: Store.freshness() reports the newest
        # segment's age as seconds-since-last-append (v1→v2 transcode
        # preserves it — compression is not an append)
        "created_unix": time.time(),
    }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    return nnz, nrows


# pairs streamed per chunk by the symmetric build (~20 MB of temporaries)
SYM_CHUNK_PAIRS = 1 << 20


def _write_symmetric(
    out_dir: str,
    row_ptr: np.ndarray,
    V: int,
    nnz: int,
    *,
    chunk_pairs: int = SYM_CHUNK_PAIRS,
) -> dict:
    """Derive the symmetric adjacency from the on-disk upper CSR: every pair
    (i, j, c) contributes j to row i and i to row j.

    Two-pass external-memory build, O(V + chunk_pairs) working memory
    regardless of nnz (the doubled-COO + lexsort build it replaces peaked at
    O(nnz)):

    * **Pass 1** streams ``cols.bin`` in chunks and bincounts incoming
      degrees; symmetric degree = upper out-degree + in-degree gives
      ``sym_row_ptr`` directly.
    * **Pass 2** streams the upper CSR again and scatters each chunk into
      preallocated mmapped ``sym_cols.bin``/``sym_counts.bin`` through
      per-row write cursors. Within a chunk the reverse direction (j ← i)
      is scattered before the forward direction (i → j): for any target row
      t every reverse contribution (i, t) sits at a stream position before
      row t's own forward entries, so cursor order writes each symmetric
      row already ascending — no sort of the output ever happens.

    Returns build stats: chunks processed and the peak per-chunk temporary
    length (tests assert the bound; everything else is O(V))."""
    sym_ptr_path = os.path.join(out_dir, "sym_row_ptr.bin")
    sym_cols_path = os.path.join(out_dir, "sym_cols.bin")
    sym_counts_path = os.path.join(out_dir, "sym_counts.bin")
    stats = {"chunks": 0, "chunk_pairs": chunk_pairs, "peak_temp_elems": 0}
    if nnz == 0:
        _write_array(sym_ptr_path, np.zeros(V + 1, dtype=np.int64), np.int64)
        open(sym_cols_path, "wb").close()
        open(sym_counts_path, "wb").close()
        return stats

    cols = np.memmap(os.path.join(out_dir, "cols.bin"), dtype=np.int32, mode="r")
    counts = np.memmap(
        os.path.join(out_dir, "counts.bin"), dtype=np.int64, mode="r"
    )

    # pass 1: symmetric degrees -> sym_row_ptr
    indeg = np.zeros(V, dtype=np.int64)
    for k0 in range(0, nnz, chunk_pairs):
        indeg += np.bincount(cols[k0:min(k0 + chunk_pairs, nnz)], minlength=V)
    sym_ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(np.diff(row_ptr) + indeg, out=sym_ptr[1:])
    _write_array(sym_ptr_path, sym_ptr, np.int64)

    # pass 2: cursor scatter into the preallocated mmapped outputs
    sym_cols = np.memmap(sym_cols_path, dtype=np.int32, mode="w+", shape=2 * nnz)
    sym_counts = np.memmap(
        sym_counts_path, dtype=np.int64, mode="w+", shape=2 * nnz
    )
    cursor = sym_ptr[:-1].copy()
    for k0 in range(0, nnz, chunk_pairs):
        k1 = min(k0 + chunk_pairs, nnz)
        j = np.asarray(cols[k0:k1])  # int32: halves the chunk sort traffic
        cv = np.asarray(counts[k0:k1])
        # row ids of entries [k0, k1): repeat each covered row by its overlap
        # with the chunk (two scalar searchsorteds, not one per entry)
        r0 = int(np.searchsorted(row_ptr, k0, side="right")) - 1
        r1 = int(np.searchsorted(row_ptr, k1 - 1, side="right")) - 1
        seg_lens = (
            np.minimum(row_ptr[r0 + 1:r1 + 2], k1)
            - np.maximum(row_ptr[r0:r1 + 1], k0)
        )
        rows = np.repeat(np.arange(r0, r1 + 1, dtype=np.int32), seg_lens)

        # reverse direction first (see docstring): row j gets col i
        order = np.argsort(j, kind="stable")  # i stays ascending per j
        js = j[order]
        gb = group_bounds(js)
        gs, glen = gb[:-1], np.diff(gb)
        pos = cursor[js] + (np.arange(len(js)) - np.repeat(gs, glen))
        sym_cols[pos] = rows[order]
        sym_counts[pos] = cv[order]
        cursor[js[gs]] += glen

        # forward direction: row i gets col j (rows nondecreasing in-chunk)
        fb = group_bounds(rows)
        fs, flen = fb[:-1], np.diff(fb)
        pos = cursor[rows] + (np.arange(len(rows)) - np.repeat(fs, flen))
        sym_cols[pos] = j
        sym_counts[pos] = cv
        cursor[rows[fs]] += flen

        stats["chunks"] += 1
        stats["peak_temp_elems"] = max(stats["peak_temp_elems"], k1 - k0)
    # no explicit msync: readers see the pages through the unified page
    # cache immediately (exactly like the tofile() build this replaced);
    # the OS writes dirty pages back asynchronously
    del sym_cols, sym_counts
    return stats


class CSRSegment:
    """Read-only memory-mapped view of one segment directory."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported segment format {self.meta}")
        self.vocab_size = self.meta["vocab_size"]
        self.nnz = self.meta["nnz"]
        self.num_docs = self.meta["num_docs"]
        self.total_count = self.meta["total_count"]
        self._arrays: dict[str, np.ndarray] = {}
        # open every mmap now: once constructed, this segment stays fully
        # readable even if a concurrent compaction unlinks the directory
        # (POSIX keeps mapped files alive until the last mapping drops)
        for name in _ARRAYS:
            self._arr(name)

    def _arr(self, name: str) -> np.ndarray:
        if name not in self._arrays:
            path = os.path.join(self.path, f"{name}.bin")
            dtype = _ARRAYS[name]
            if os.path.getsize(path) == 0:  # mmap rejects empty files
                self._arrays[name] = np.zeros(0, dtype=dtype)
            else:
                self._arrays[name] = np.memmap(path, dtype=dtype, mode="r")
        return self._arrays[name]

    @property
    def df(self) -> np.ndarray:
        return self._arr("df")

    # ---------------------------------------------------------- lookups
    def row(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Strict-upper row of ``t``: (secondaries > t, counts)."""
        ptr = self._arr("row_ptr")
        lo, hi = int(ptr[t]), int(ptr[t + 1])
        return self._arr("cols")[lo:hi], self._arr("counts")[lo:hi]

    def neighbours(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """All co-occurring terms of ``t`` (both directions), ascending IDs."""
        ptr = self._arr("sym_row_ptr")
        lo, hi = int(ptr[t]), int(ptr[t + 1])
        return self._arr("sym_cols")[lo:hi], self._arr("sym_counts")[lo:hi]

    def pair_count(self, i: int, j: int) -> int:
        """Exact count of the unordered pair {i, j}; O(log deg)."""
        if i == j:
            return 0
        lo, hi = (i, j) if i < j else (j, i)
        secs, cnts = self.row(lo)
        k = np.searchsorted(secs, hi)
        if k < len(secs) and secs[k] == hi:
            return int(cnts[k])
        return 0

    def pair_counts(self, pairs: np.ndarray) -> np.ndarray:
        """Batched pair lookup: (B, 2) int array -> int64[B]."""
        pairs = np.asarray(pairs, dtype=np.int64)
        out = np.zeros(len(pairs), dtype=np.int64)
        ptr = self._arr("row_ptr")
        cols, counts = self._arr("cols"), self._arr("counts")
        lo = np.minimum(pairs[:, 0], pairs[:, 1])
        hi = np.maximum(pairs[:, 0], pairs[:, 1])
        for b in range(len(pairs)):
            if lo[b] == hi[b]:
                continue
            s, e = int(ptr[lo[b]]), int(ptr[lo[b] + 1])
            k = s + np.searchsorted(cols[s:e], hi[b])
            if k < e and cols[k] == hi[b]:
                out[b] = counts[k]
        return out

    # -------------------------------------------------------- iteration
    def iter_rows(self):
        """Yield (primary, secondaries, counts) for every nonempty row, the
        same shape ``PairSink.emit_row`` receives (and ``write_segment``
        consumes — segments merge with each other and with spill runs)."""
        ptr = self._arr("row_ptr")
        cols, counts = self._arr("cols"), self._arr("counts")
        for t in range(self.vocab_size):
            lo, hi = int(ptr[t]), int(ptr[t + 1])
            if hi > lo:
                yield t, np.asarray(cols[lo:hi]), np.asarray(counts[lo:hi])

    def to_pair_file(self, path: str) -> None:
        """Write the paper's binary pair format (FileSink round-trip)."""
        sink = FileSink(path)
        for primary, secs, cnts in self.iter_rows():
            if int(cnts.max()) >= 1 << 32:
                # FileSink stores u32 counts; refuse to corrupt the export
                raise OverflowError(
                    f"row {primary} holds a count >= 2^32; the paper's pair "
                    "format cannot represent it"
                )
            sink.emit_row(primary, secs, cnts)
        sink.close()

    def emit_to(self, sink: PairSink) -> None:
        for primary, secs, cnts in self.iter_rows():
            sink.emit_row(primary, secs, cnts)

    def dense(self) -> np.ndarray:
        """Dense strict-upper matrix (tests / small vocab only)."""
        mat = np.zeros((self.vocab_size, self.vocab_size), dtype=np.int64)
        for primary, secs, cnts in self.iter_rows():
            mat[primary, secs.astype(np.int64)] = cnts
        return mat


# ---------------------------------------------------------------------------
# format v2: block-compressed columns + bloom filter
# ---------------------------------------------------------------------------

# v2 column files: (name, decoded dtype, mode, codec). Monotone columns
# bitpack their deltas (narrow, uniform); per-row column ids delta+varint
# (small positive deltas, negative restarts at row boundaries absorbed by
# zigzag); counts varint raw (mostly tiny).
_V2_COLUMNS = {
    "terms": (np.int32, "delta", "bitpack"),
    "row_ptr": (np.int64, "delta", "bitpack"),
    "cols": (np.int32, "delta", "varint"),
    "counts": (np.int64, "raw", "varint"),
    "sym_terms": (np.int32, "delta", "bitpack"),
    "sym_row_ptr": (np.int64, "delta", "bitpack"),
    "sym_cols": (np.int32, "delta", "varint"),
    "sym_counts": (np.int64, "raw", "varint"),
    "df": (np.int64, "raw", "varint"),
}

_V1_FILES = (
    "row_ptr.bin", "cols.bin", "counts.bin", "df.bin",
    "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin",
)


def segment_bytes(path: str) -> int:
    """Total on-disk bytes of a segment directory (any format)."""
    return sum(
        os.path.getsize(os.path.join(path, f))
        for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f))
    )


def _elide_rows(row_ptr: np.ndarray):
    """Dense V+1 row pointers -> (nonzero term ids, row_ptr over them)."""
    lens = np.diff(row_ptr)
    terms = np.nonzero(lens)[0].astype(np.int64)
    rp = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum(lens[terms], out=rp[1:])
    return terms, rp


def compress_segment(
    seg_dir: str,
    *,
    block: int = codec_mod.DEFAULT_BLOCK,
    bits_per_key: int = bloom_mod.DEFAULT_BITS_PER_KEY,
    chunk_pairs: int = SYM_CHUNK_PAIRS,
) -> str:
    """Transcode a v1 segment directory to v2 **in place**: each raw array
    becomes a block-compressed column with zero-count rows elided, a bloom
    filter over the upper pair keys is added, and the raw ``.bin`` files
    are removed. Streams the nnz-sized arrays in chunks — O(V + chunk)
    memory like the v1 build itself. Exact: decoding reproduces every
    array byte for byte."""
    with open(os.path.join(seg_dir, META_NAME)) as f:
        meta = json.load(f)
    if meta["format_version"] != 1:
        raise ValueError(
            f"compress_segment needs a v1 segment, got {meta['format_version']}"
        )
    V, nnz = meta["vocab_size"], meta["nnz"]
    raw_bytes = sum(
        os.path.getsize(os.path.join(seg_dir, f)) for f in _V1_FILES
    )

    def _mm(name, dtype):
        path = os.path.join(seg_dir, name)
        if os.path.getsize(path) == 0:
            return np.zeros(0, dtype=dtype)
        return np.memmap(path, dtype=dtype, mode="r")

    def _col(name, values):
        dtype, mode, cdc = _V2_COLUMNS[name]
        write_column(
            os.path.join(seg_dir, f"{name}.z"),
            np.asarray(values, dtype=dtype) if not hasattr(values, "dtype")
            else values,
            mode=mode, codec=cdc, block=block,
        )

    with obs.get_registry().span("ingest/segment_compress", nnz=nnz):
        for prefix in ("", "sym_"):
            row_ptr = np.fromfile(
                os.path.join(seg_dir, f"{prefix}row_ptr.bin"), dtype=np.int64
            )
            terms, rp = _elide_rows(row_ptr)
            _col(f"{prefix}terms", terms.astype(np.int32))
            _col(f"{prefix}row_ptr", rp)
            _col(f"{prefix}cols", _mm(f"{prefix}cols.bin", np.int32))
            _col(f"{prefix}counts", _mm(f"{prefix}counts.bin", np.int64))
            if prefix == "":
                upper_terms, upper_rp = terms, rp
        _col("df", np.fromfile(os.path.join(seg_dir, "df.bin"), dtype=np.int64))

        # bloom over packed upper pair keys i*V + j, streamed in chunks
        filt = bloom_mod.BloomFilter.create(nnz, bits_per_key=bits_per_key)
        cols = _mm("cols.bin", np.int32)
        for k0 in range(0, nnz, chunk_pairs):
            k1 = min(k0 + chunk_pairs, nnz)
            r0 = int(np.searchsorted(upper_rp, k0, side="right")) - 1
            r1 = int(np.searchsorted(upper_rp, k1 - 1, side="right")) - 1
            seg_lens = (
                np.minimum(upper_rp[r0 + 1:r1 + 2], k1)
                - np.maximum(upper_rp[r0:r1 + 1], k0)
            )
            rows = np.repeat(upper_terms[r0:r1 + 1], seg_lens)
            keys = rows.astype(np.uint64) * np.uint64(V) + np.asarray(
                cols[k0:k1]
            ).astype(np.uint64)
            filt.add(keys)
        filt.save(os.path.join(seg_dir, "bloom.bin"))

    meta.update(
        magic=SEGMENT_MAGIC,
        format_version=2,
        block_size=block,
        bloom_bits_per_key=bits_per_key,
        raw_bytes=raw_bytes,
    )
    tmp = os.path.join(seg_dir, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(seg_dir, META_NAME))
    for name in _V1_FILES:
        os.unlink(os.path.join(seg_dir, name))
    return seg_dir


class CompressedSegment:
    """Read-only view of a v2 (compressed) segment directory.

    Same query surface as :class:`CSRSegment` — ``row``/``neighbours``
    return the identical arrays (dtypes included), so everything above the
    segment boundary is format-oblivious. Point and range reads decode only
    the blocks they span, through one LRU :class:`~repro_torch.store.codec.BlockCache`
    shared by all columns of the segment; ``pair_count``/``pair_counts``
    consult the bloom filter first so cold misses never decode a row."""

    def __init__(self, path: str, *, registry=None, cache_blocks: int = 256):
        self.path = path
        with open(os.path.join(path, META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta["format_version"] != 2:
            raise ValueError(f"unsupported segment format {self.meta}")
        self.vocab_size = self.meta["vocab_size"]
        self.nnz = self.meta["nnz"]
        self.num_docs = self.meta["num_docs"]
        self.total_count = self.meta["total_count"]
        self._registry = registry
        self._cache = codec_mod.BlockCache(cache_blocks, registry=registry)
        self._columns: dict[str, codec_mod.CompressedColumn] = {}
        self._bloom = None
        self._df = None
        # open every column + the bloom filter now (mmaps + header parses):
        # like CSRSegment, an opened segment survives a concurrent
        # compaction unlinking its directory
        for name in _V2_COLUMNS:
            self._col(name)
        _ = self.bloom

    @property
    def registry(self):
        return self._registry if self._registry is not None else obs.get_registry()

    def _col(self, name: str) -> codec_mod.CompressedColumn:
        col = self._columns.get(name)
        if col is None:
            col = codec_mod.CompressedColumn(
                os.path.join(self.path, f"{name}.z"),
                cache=self._cache, tag=name, registry=self._registry,
            )
            self._columns[name] = col
        return col

    @property
    def bloom(self) -> bloom_mod.BloomFilter:
        if self._bloom is None:
            self._bloom = bloom_mod.BloomFilter.load(
                os.path.join(self.path, "bloom.bin")
            )
        return self._bloom

    @property
    def df(self) -> np.ndarray:
        # decoded once and memoized: df is read whole (store-level sums)
        if self._df is None:
            self._df = self._col("df").decode_all()
        return self._df

    # ---------------------------------------------------------- lookups
    def _row_from(self, prefix: str, t: int):
        i = self._col(f"{prefix}terms").find(t)
        if i < 0:
            return (
                np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int64)
            )
        ptr = self._col(f"{prefix}row_ptr").slice(i, i + 2)
        lo, hi = int(ptr[0]), int(ptr[1])
        return (
            self._col(f"{prefix}cols").slice(lo, hi),
            self._col(f"{prefix}counts").slice(lo, hi),
        )

    def row(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Strict-upper row of ``t``: (secondaries > t, counts)."""
        return self._row_from("", t)

    def neighbours(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """All co-occurring terms of ``t`` (both directions), ascending IDs."""
        return self._row_from("sym_", t)

    def _pair_keys(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return lo.astype(np.uint64) * np.uint64(self.vocab_size) + hi.astype(
            np.uint64
        )

    def pair_count(self, i: int, j: int) -> int:
        """Exact count of the unordered pair {i, j}; bloom-gated."""
        if i == j:
            return 0
        lo, hi = (i, j) if i < j else (j, i)
        reg = self.registry
        reg.counter("storage.bloom_checks").inc()
        if not self.bloom.contains(
            self._pair_keys(np.array([lo]), np.array([hi]))
        )[0]:
            reg.counter("storage.bloom_negative").inc()
            return 0
        secs, cnts = self.row(lo)
        k = np.searchsorted(secs, hi)
        if k < len(secs) and secs[k] == hi:
            return int(cnts[k])
        return 0

    def pair_counts(self, pairs: np.ndarray) -> np.ndarray:
        """Batched pair lookup: (B, 2) int array -> int64[B]. The bloom
        filter screens the whole batch first; only maybe-present pairs
        decode their row."""
        pairs = np.asarray(pairs, dtype=np.int64)
        out = np.zeros(len(pairs), dtype=np.int64)
        if len(pairs) == 0:
            return out
        lo = np.minimum(pairs[:, 0], pairs[:, 1])
        hi = np.maximum(pairs[:, 0], pairs[:, 1])
        valid = lo < hi
        reg = self.registry
        reg.counter("storage.bloom_checks").inc(int(valid.sum()))
        maybe = valid.copy()
        maybe[valid] = self.bloom.contains(
            self._pair_keys(lo[valid], hi[valid])
        )
        reg.counter("storage.bloom_negative").inc(
            int(valid.sum() - maybe.sum())
        )
        for b in np.nonzero(maybe)[0]:
            secs, cnts = self.row(int(lo[b]))
            k = np.searchsorted(secs, hi[b])
            if k < len(secs) and secs[k] == hi[b]:
                out[b] = cnts[k]
        return out

    # -------------------------------------------------------- iteration
    def iter_rows(self):
        """Yield (primary, secondaries, counts) for every nonempty row —
        identical shape to :meth:`CSRSegment.iter_rows`, so segments of
        either format merge with each other through the same paths."""
        terms = self._col("terms").decode_all()
        rp = self._col("row_ptr").decode_all()
        cols, counts = self._col("cols"), self._col("counts")
        for k in range(len(terms)):
            lo, hi = int(rp[k]), int(rp[k + 1])
            yield int(terms[k]), cols.slice(lo, hi), counts.slice(lo, hi)

    def to_pair_file(self, path: str) -> None:
        """Write the paper's binary pair format (FileSink round-trip)."""
        sink = FileSink(path)
        for primary, secs, cnts in self.iter_rows():
            if int(cnts.max()) >= 1 << 32:
                raise OverflowError(
                    f"row {primary} holds a count >= 2^32; the paper's pair "
                    "format cannot represent it"
                )
            sink.emit_row(primary, secs, cnts)
        sink.close()

    def emit_to(self, sink: PairSink) -> None:
        for primary, secs, cnts in self.iter_rows():
            sink.emit_row(primary, secs, cnts)

    def dense(self) -> np.ndarray:
        """Dense strict-upper matrix (tests / small vocab only)."""
        mat = np.zeros((self.vocab_size, self.vocab_size), dtype=np.int64)
        for primary, secs, cnts in self.iter_rows():
            mat[primary, secs.astype(np.int64)] = cnts
        return mat


def open_segment(path: str, *, registry=None, cache_blocks: int = 256):
    """Open a segment directory of any supported format. Dispatches on the
    ``magic``/``format_version`` header in meta.json: v1 -> raw mmapped
    :class:`CSRSegment`, v2 -> :class:`CompressedSegment`. An unknown
    version (a newer writer, or a corrupt header) raises a clear error
    instead of attempting a garbage decode."""
    with open(os.path.join(path, META_NAME)) as f:
        meta = json.load(f)
    # pre-magic v1 segments carry no magic field; anything else must match
    magic = meta.get("magic", SEGMENT_MAGIC)
    if magic != SEGMENT_MAGIC:
        raise ValueError(
            f"not a co-occurrence segment (magic {magic!r}) at {path}"
        )
    version = meta.get("format_version")
    if version == 1:
        return CSRSegment(path)
    if version == 2:
        return CompressedSegment(
            path, registry=registry, cache_blocks=cache_blocks
        )
    raise ValueError(
        f"unsupported segment format_version {version!r} at {path}; "
        f"this build reads versions {SEGMENT_VERSIONS}"
    )


def segment_from_pair_file(
    pair_path: str,
    out_dir: str,
    vocab_size: int,
    *,
    df: np.ndarray | None = None,
    num_docs: int = 0,
    version: int | None = None,
):
    """Convert a paper-format pair file (any row order, repeated primaries
    allowed) into a CSR segment, by routing it through the spill builder."""
    from repro_torch.store.builder import SpillSink

    sink = SpillSink(vocab_size)
    try:
        for primary, secs, cnts in read_pair_file(pair_path):
            sink.emit_row(primary, secs.astype(np.int64), cnts.astype(np.int64))
        write_segment(
            out_dir,
            sink.merged_rows(),
            vocab_size,
            df=df,
            num_docs=num_docs,
            source=f"pair_file:{os.path.basename(pair_path)}",
            version=version,
        )
    finally:
        sink.close()
    return open_segment(out_dir)
