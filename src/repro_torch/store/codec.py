"""Block-wise compressed integer columns for v2 CSR segments.

A *column* is an immutable on-disk sequence of integers (the CSR ``cols``,
``counts``, ``row_ptr``, … arrays) stored as fixed-size **blocks** behind a
per-block offset directory, so a point or range read decodes only the
blocks it spans — the random-access discipline of the raw mmap arrays,
kept, at a fraction of the bytes:

    header      32 B      magic, codec, mode, dtype, block size, n values
    offsets     u64[B+1]  payload byte offset of each block (B = #blocks)
    anchors     i64[B]    first value of each block (delta restart points;
                          doubles as a block-level index for binary search)
    payload               concatenated per-block encodings

Two codecs (both lossless, both vectorized end to end — no per-value
Python):

* ``varint`` — LEB128 with zigzag: each value in 1–10 bytes, 7 payload bits
  per byte. The workhorse for counts (mostly tiny) and for column deltas.
* ``bitpack`` — per-block frame-of-reference: subtract the block minimum
  and pack every value at the block's exact bit width via
  ``np.packbits``. The workhorse for monotone columns (``row_ptr``, term
  ids) whose deltas are narrow and uniform.

Two modes:

* ``raw``   — values encoded directly;
* ``delta`` — consecutive differences encoded (zigzag handles the negative
  jumps at CSR row boundaries); each block restarts from its anchor, so
  decoding one block never touches another.

:class:`CompressedColumn` is the reader: ``slice(lo, hi)`` decodes only the
covering blocks (through a shared :class:`BlockCache` LRU), and ``find``
binary-searches a sorted column by bisecting the anchor directory first and
decoding exactly one block. Telemetry lands on the ambient
:class:`repro_torch.obs.Registry` (``storage.blocks_decoded``,
``storage.block_cache_hits`` / ``_misses``) or a registry injected by the
owning segment, so serving workers report codec traffic cross-process.

Example::

    >>> import numpy as np, tempfile, os
    >>> path = os.path.join(tempfile.mkdtemp(), "c.z")
    >>> write_column(path, np.array([3, 9, 27, 81]), mode="delta",
    ...              codec="varint")
    >>> CompressedColumn(path).slice(1, 3).tolist()
    [9, 27]
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from repro_torch import obs

COLUMN_MAGIC = 0x315A4F43  # "COZ1" little-endian
DEFAULT_BLOCK = 1024

CODECS = ("varint", "bitpack")
MODES = ("raw", "delta")
_DTYPES = {0: np.int32, 1: np.int64}
_DTYPE_CODES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1}

_U = np.uint64
_ONE = _U(1)
_SEVEN = _U(7)


# ---------------------------------------------------------------------------
# zigzag + varint (vectorized LEB128)
# ---------------------------------------------------------------------------


def zigzag_encode(v: np.ndarray) -> np.ndarray:
    """int64 -> uint64 zigzag (0, -1, 1, -2, … -> 0, 1, 2, 3, …)."""
    v = np.ascontiguousarray(v, dtype=np.int64)
    u = v.view(np.uint64)
    return (u << _ONE) ^ np.where(v < 0, _U(0xFFFFFFFFFFFFFFFF), _U(0))


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    """uint64 zigzag -> int64 (exact inverse of :func:`zigzag_encode`)."""
    u = np.asarray(u, dtype=np.uint64)
    return ((u >> _ONE) ^ (_U(0) - (u & _ONE))).view(np.int64)


def varint_encode(u: np.ndarray) -> np.ndarray:
    """uint64 values -> one LEB128 byte stream (uint8 array). Vectorized:
    per-value byte counts by repeated shift, then one scatter of 7-bit
    chunks with continuation bits."""
    u = np.asarray(u, dtype=np.uint64)
    n = len(u)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    nbytes = np.ones(n, dtype=np.int64)
    x = u >> _SEVEN
    while x.any():  # <= 9 rounds for 64-bit values
        nbytes += x != 0
        x >>= _SEVEN
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(nbytes[:-1], out=starts[1:])
    total = int(starts[-1] + nbytes[-1])
    val_of = np.repeat(np.arange(n, dtype=np.int64), nbytes)
    byte_in = np.arange(total, dtype=np.int64) - np.repeat(starts, nbytes)
    chunk = (u[val_of] >> (_SEVEN * byte_in.astype(np.uint64))) & _U(0x7F)
    cont = byte_in < (nbytes[val_of] - 1)
    return (chunk.astype(np.uint8) | (cont.astype(np.uint8) << 7))


def varint_decode(b: np.ndarray) -> np.ndarray:
    """LEB128 byte stream -> uint64 values. Vectorized: value boundaries
    from the continuation bits, then one ``np.add.reduceat`` of shifted
    7-bit chunks."""
    b = np.asarray(b, dtype=np.uint8)
    if len(b) == 0:
        return np.zeros(0, dtype=np.uint64)
    ends = np.nonzero(b < 128)[0]
    if len(ends) == 0 or ends[-1] != len(b) - 1:
        raise ValueError("truncated varint stream")
    starts = np.empty(len(ends), dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    byte_in = np.arange(len(b), dtype=np.int64) - np.repeat(starts, lens)
    chunks = (b & 0x7F).astype(np.uint64) << (
        _SEVEN * byte_in.astype(np.uint64)
    )
    return np.add.reduceat(chunks, starts)


# ---------------------------------------------------------------------------
# frame-of-reference bitpacking
# ---------------------------------------------------------------------------


def bitpack_encode(u: np.ndarray) -> np.ndarray:
    """uint64 values -> ``[width u8 | ref u64 | packed bits]`` (uint8 array).
    Frame of reference: values are stored as ``v - min(v)`` at the block's
    exact bit width (width 0 when all values are equal)."""
    u = np.asarray(u, dtype=np.uint64)
    if len(u) == 0:
        return np.zeros(0, dtype=np.uint8)
    ref = u.min()
    d = u - ref
    width = int(d.max()).bit_length()
    head = np.zeros(9, dtype=np.uint8)
    head[0] = width
    head[1:9] = np.array([ref], dtype="<u8").view(np.uint8)
    if width == 0:
        return head
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((d[:, None] >> shifts) & _ONE).astype(np.uint8)
    return np.concatenate([head, np.packbits(bits.ravel())])


def bitpack_decode(b: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`bitpack_encode` for a block of ``n`` values."""
    b = np.asarray(b, dtype=np.uint8)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    width = int(b[0])
    ref = b[1:9].copy().view("<u8")[0]
    if width == 0:
        return np.full(n, ref, dtype=np.uint64)
    bits = np.unpackbits(b[9:], count=n * width).reshape(n, width)
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    vals = (bits.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)
    return vals + ref


# ---------------------------------------------------------------------------
# column writer
# ---------------------------------------------------------------------------

_HEADER_BYTES = 32


def _encode_block(vals: np.ndarray, prev: int, codec: str, mode: str):
    """Encode one block (int64 values). ``prev`` is the last value of the
    preceding block (ignored for the first block / raw mode)."""
    if mode == "delta":
        d = np.empty(len(vals), dtype=np.int64)
        d[0] = 0  # the anchor carries the first value
        np.subtract(vals[1:], vals[:-1], out=d[1:])
        u = zigzag_encode(d)
    else:
        u = zigzag_encode(vals)
    return varint_encode(u) if codec == "varint" else bitpack_encode(u)


def write_column(
    path: str,
    values,
    *,
    mode: str = "raw",
    codec: str = "varint",
    block: int = DEFAULT_BLOCK,
    chunk_blocks: int = 1024,
) -> int:
    """Write ``values`` (any 1-D integer array / memmap) as a compressed
    column file. Streams ``chunk_blocks`` blocks at a time, so encoding a
    memmapped nnz-sized array never materializes it whole. Returns the
    encoded file size in bytes.

    ``mode="delta"`` requires nothing of the data (zigzag absorbs negative
    jumps) but pays off when consecutive values are close; ``find`` on the
    reader additionally requires the column to be globally non-decreasing.
    """
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; have {CODECS}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if block < 2:
        raise ValueError("block size must be >= 2")
    n = len(values)
    out_dtype = np.dtype(values.dtype) if hasattr(values, "dtype") else None
    if out_dtype not in _DTYPE_CODES:
        out_dtype = np.dtype(np.int64)
    n_blocks = (n + block - 1) // block
    header = np.zeros(_HEADER_BYTES, dtype=np.uint8)
    header[0:4] = np.array([COLUMN_MAGIC], dtype="<u4").view(np.uint8)
    header[4] = 1  # column format version
    header[5] = CODECS.index(codec)
    header[6] = MODES.index(mode)
    header[7] = _DTYPE_CODES[out_dtype]
    header[8:12] = np.array([block], dtype="<u4").view(np.uint8)
    header[12:20] = np.array([n], dtype="<u8").view(np.uint8)
    offsets = np.zeros(n_blocks + 1, dtype=np.uint64)
    anchors = np.zeros(n_blocks, dtype=np.int64)
    dir_bytes = offsets.nbytes + anchors.nbytes
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.seek(_HEADER_BYTES + dir_bytes)
        pos = 0
        for c0 in range(0, n, block * chunk_blocks):
            c1 = min(c0 + block * chunk_blocks, n)
            vals = np.ascontiguousarray(values[c0:c1], dtype=np.int64)
            for b0 in range(0, len(vals), block):
                k = (c0 + b0) // block
                bv = vals[b0:b0 + block]
                anchors[k] = bv[0]
                payload = _encode_block(bv, 0, codec, mode)
                f.write(payload.tobytes())
                pos += len(payload)
                offsets[k + 1] = pos
        f.seek(_HEADER_BYTES)
        f.write(offsets.tobytes())
        f.write(anchors.tobytes())
    return _HEADER_BYTES + dir_bytes + pos


# ---------------------------------------------------------------------------
# block cache
# ---------------------------------------------------------------------------


class BlockCache:
    """Small LRU over decoded blocks, shared by every column of a segment
    (keys are ``(column_tag, block_index)``). Capacity is counted in blocks
    — at the default 1024-value blocks, 256 cached blocks ≈ 2 MB of decoded
    int64 — so a serving worker's steady state touches the page cache only
    for genuinely cold blocks."""

    def __init__(self, max_blocks: int = 256, registry=None):
        self.max_blocks = max_blocks
        self._blocks: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._registry = registry

    @property
    def registry(self):
        return self._registry if self._registry is not None else obs.get_registry()

    def get(self, key: tuple):
        hit = self._blocks.get(key)
        if hit is not None:
            self._blocks.move_to_end(key)
            self.registry.counter("storage.block_cache_hits").inc()
        else:
            self.registry.counter("storage.block_cache_misses").inc()
        return hit

    def put(self, key: tuple, block: np.ndarray) -> None:
        self._blocks[key] = block
        if len(self._blocks) > self.max_blocks:
            self._blocks.popitem(last=False)

    def clear(self) -> None:
        self._blocks.clear()


# ---------------------------------------------------------------------------
# column reader
# ---------------------------------------------------------------------------


class CompressedColumn:
    """Read-only view of one compressed column file. The file is mmapped;
    ``slice``/``at`` decode only the blocks the request spans, through the
    shared :class:`BlockCache` when one is attached."""

    def __init__(
        self,
        path: str,
        *,
        cache: BlockCache | None = None,
        tag: str | None = None,
        registry=None,
    ):
        self.path = path
        self._cache = cache
        self._tag = tag if tag is not None else path
        self._registry = registry
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        if len(raw) < _HEADER_BYTES:
            raise ValueError(f"not a compressed column (truncated): {path}")
        header = np.asarray(raw[:_HEADER_BYTES])
        if int(header[0:4].view("<u4")[0]) != COLUMN_MAGIC:
            raise ValueError(f"bad column magic in {path}")
        if int(header[4]) != 1:
            raise ValueError(f"unsupported column version {header[4]} in {path}")
        self.codec = CODECS[int(header[5])]
        self.mode = MODES[int(header[6])]
        self.dtype = np.dtype(_DTYPES[int(header[7])])
        self.block = int(header[8:12].view("<u4")[0])
        self.n = int(header[12:20].view("<u8")[0])
        n_blocks = (self.n + self.block - 1) // self.block
        self.n_blocks = n_blocks
        o0 = _HEADER_BYTES
        o1 = o0 + 8 * (n_blocks + 1)
        o2 = o1 + 8 * n_blocks
        self._offsets = raw[o0:o1].view(np.uint64)
        self.anchors = raw[o1:o2].view(np.int64)
        self._payload = raw[o2:]

    def __len__(self) -> int:
        return self.n

    @property
    def registry(self):
        return self._registry if self._registry is not None else obs.get_registry()

    # -------------------------------------------------------------- decode
    def _decode_block(self, k: int) -> np.ndarray:
        """Decoded int64 values of block ``k`` (cached)."""
        key = (self._tag, k)
        if self._cache is not None:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        lo, hi = int(self._offsets[k]), int(self._offsets[k + 1])
        raw = self._payload[lo:hi]
        n = min(self.block, self.n - k * self.block)
        if self.codec == "varint":
            u = varint_decode(np.asarray(raw))
            if len(u) != n:
                raise ValueError(
                    f"block {k} of {self.path} decoded {len(u)} values, "
                    f"expected {n}"
                )
        else:
            u = bitpack_decode(np.asarray(raw), n)
        vals = zigzag_decode(u)
        if self.mode == "delta":
            vals = vals.copy()
            vals[0] = self.anchors[k]
            np.cumsum(vals, out=vals)
        self.registry.counter("storage.blocks_decoded").inc()
        if self._cache is not None:
            self._cache.put(key, vals)
        return vals

    def slice(self, lo: int, hi: int) -> np.ndarray:
        """``values[lo:hi]`` decoded from the covering blocks only."""
        lo = max(int(lo), 0)
        hi = min(int(hi), self.n)
        if hi <= lo:
            return np.zeros(0, dtype=self.dtype)
        b0, b1 = lo // self.block, (hi - 1) // self.block
        if b0 == b1:
            vals = self._decode_block(b0)
        else:
            vals = np.concatenate(
                [self._decode_block(k) for k in range(b0, b1 + 1)]
            )
        out = vals[lo - b0 * self.block: hi - b0 * self.block]
        return out.astype(self.dtype, copy=False)

    def at(self, i: int) -> int:
        """Single value (decodes one block)."""
        if not 0 <= i < self.n:
            raise IndexError(i)
        return int(self._decode_block(i // self.block)[i % self.block])

    def decode_all(self) -> np.ndarray:
        """The whole column as one array (bulk readers: df, iter_rows)."""
        return self.slice(0, self.n)

    # -------------------------------------------------------------- search
    def find(self, v: int) -> int:
        """Index of ``v`` in a sorted (non-decreasing) column, or -1.
        Bisects the anchor directory, then decodes exactly one block."""
        if self.n == 0:
            return -1
        k = int(np.searchsorted(self.anchors, v, side="right")) - 1
        if k < 0:
            return -1
        vals = self._decode_block(k)
        j = int(np.searchsorted(vals, v, side="left"))
        if j < len(vals) and int(vals[j]) == v:
            return k * self.block + j
        return -1
