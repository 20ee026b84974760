"""Blocked bloom filter over packed pair keys for cold ``pair_counts``.

A v2 segment stores one filter over every upper-triangle pair it holds,
keyed ``i * vocab_size + j`` (``i < j``). A ``pair_counts`` batch probes
the filter first: pairs the filter rejects are *definitely* absent and are
answered 0 without touching the row columns — the common case for cold
random lookups, where the raw-segment path would fault in ``row_ptr`` and
``cols`` pages just to find nothing.

The filter is *blocked* (Putze et al.): each key hashes to one 512-bit
block (a cache line) and sets ``k`` bits **within that block**, so a probe
costs one memory access instead of ``k``. Build and probe are fully
vectorized — block ids and all ``k`` bit positions are derived from two
rounds of the splitmix64 finalizer, bits are set with
``np.bitwise_or.at`` and tested with one gather per round.

With the default 12 bits/key and k=6 the false-positive rate lands around
1% (blocked filters pay a small factor over the classic bound); false
*negatives* are impossible, which is what the byte-identity gate relies
on: a positive merely falls through to the exact row lookup.

File layout (``bloom.bin``, little-endian)::

    magic   u32   0x314D4C42 ("BLM1")
    k       u32   bits set per key
    blocks  u64   number of 512-bit blocks
    keys    u64   number of keys inserted
    words   u64[blocks * 8]

Example::

    >>> import numpy as np
    >>> f = BloomFilter.build(np.array([7, 99], dtype=np.uint64))
    >>> f.contains(np.array([7, 8], dtype=np.uint64)).tolist()
    [True, False]
"""

from __future__ import annotations

import numpy as np

BLOOM_MAGIC = 0x314D4C42  # "BLM1"
WORDS_PER_BLOCK = 8  # 8 x u64 = 512 bits = one cache line
DEFAULT_BITS_PER_KEY = 12
DEFAULT_K = 6

_U = np.uint64
_HEADER_BYTES = 24


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wrapping arithmetic)."""
    z = x + _U(0x9E3779B97F4A7C15)
    z = (z ^ (z >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U(27))) * _U(0x94D049BB133111EB)
    return z ^ (z >> _U(31))


class BloomFilter:
    """In-memory or mmapped blocked bloom filter (see module docstring)."""

    def __init__(self, words: np.ndarray, *, k: int = DEFAULT_K, n_keys: int = 0):
        if len(words) % WORDS_PER_BLOCK:
            raise ValueError("word count must be a multiple of 8")
        self.words = words
        self.n_blocks = len(words) // WORDS_PER_BLOCK
        self.k = k
        self.n_keys = n_keys

    # ------------------------------------------------------------ hashing
    def _positions(self, keys: np.ndarray):
        """(word indices, bit masks) of the k probe bits of each key:
        shapes (n, k). Block from one mix round, the k 9-bit in-block
        positions from a second."""
        keys = np.asarray(keys, dtype=np.uint64)
        h1 = _mix64(keys)
        block = (h1 % _U(self.n_blocks)).astype(np.int64)
        h2 = _mix64(h1 ^ _U(0xD6E8FEB86659FD93))
        shifts = (_U(9) * np.arange(self.k, dtype=np.uint64))[None, :]
        pos = ((h2[:, None] >> shifts) & _U(511)).astype(np.int64)
        word = block[:, None] * WORDS_PER_BLOCK + (pos >> 6)
        mask = _U(1) << (pos & 63).astype(np.uint64)
        return word, mask

    # ------------------------------------------------------------ build
    @classmethod
    def create(cls, n_keys: int, *, bits_per_key: int = DEFAULT_BITS_PER_KEY,
               k: int = DEFAULT_K) -> "BloomFilter":
        """An empty filter sized for ``n_keys`` (add with :meth:`add`)."""
        bits = max(int(n_keys) * bits_per_key, 512)
        n_blocks = (bits + 511) // 512
        words = np.zeros(n_blocks * WORDS_PER_BLOCK, dtype=np.uint64)
        return cls(words, k=k, n_keys=0)

    def add(self, keys: np.ndarray) -> None:
        """Insert a batch of keys (chunk-friendly: call repeatedly while
        streaming an nnz-sized key space)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if len(keys) == 0:
            return
        word, mask = self._positions(keys)
        np.bitwise_or.at(self.words, word.ravel(), mask.ravel())
        self.n_keys += len(keys)

    @classmethod
    def build(cls, keys: np.ndarray, *, bits_per_key: int = DEFAULT_BITS_PER_KEY,
              k: int = DEFAULT_K) -> "BloomFilter":
        f = cls.create(len(keys), bits_per_key=bits_per_key, k=k)
        f.add(keys)
        return f

    # ------------------------------------------------------------ query
    def contains(self, keys: np.ndarray) -> np.ndarray:
        """Boolean mask: False = definitely absent, True = maybe present."""
        keys = np.asarray(keys, dtype=np.uint64)
        if len(keys) == 0:
            return np.zeros(0, dtype=bool)
        word, mask = self._positions(keys)
        hit = (np.asarray(self.words)[word] & mask) == mask
        return hit.all(axis=1)

    # ------------------------------------------------------------ disk
    def save(self, path: str) -> None:
        header = np.zeros(_HEADER_BYTES, dtype=np.uint8)
        header[0:4] = np.array([BLOOM_MAGIC], dtype="<u4").view(np.uint8)
        header[4:8] = np.array([self.k], dtype="<u4").view(np.uint8)
        header[8:16] = np.array([self.n_blocks], dtype="<u8").view(np.uint8)
        header[16:24] = np.array([self.n_keys], dtype="<u8").view(np.uint8)
        with open(path, "wb") as f:
            f.write(header.tobytes())
            f.write(np.ascontiguousarray(self.words).tobytes())

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        """mmap-backed load: probes touch only the blocks they hash to."""
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        if len(raw) < _HEADER_BYTES:
            raise ValueError(f"not a bloom filter (truncated): {path}")
        header = np.asarray(raw[:_HEADER_BYTES])
        if int(header[0:4].view("<u4")[0]) != BLOOM_MAGIC:
            raise ValueError(f"bad bloom magic in {path}")
        k = int(header[4:8].view("<u4")[0])
        n_blocks = int(header[8:16].view("<u8")[0])
        n_keys = int(header[16:24].view("<u8")[0])
        words = raw[_HEADER_BYTES:_HEADER_BYTES + 8 * n_blocks * WORDS_PER_BLOCK]
        return cls(words.view(np.uint64), k=k, n_keys=n_keys)
