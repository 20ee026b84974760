"""``bitpair`` on the card: intersection sizes of bit-packed posting lists.

Wrapper of the hand-written CUDA kernel ``csrc/bitpair.cu``, which replaces
the reference package's Pallas AND + popcount kernel
(src/repro/kernels/bitpair.py). Its plain PyTorch version is
``kernels.ref.bitpair_popcount_ref``; ``kernels.ops.bitpair_popcount``
picks between the two by the tensors' device.

Bitmaps are 32-bit words carried as int32 tensors with the same bits
(numpy's uint32 bitmaps viewed as int32): not every PyTorch build has
uint32 kernels on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "bitpair", "bitpair.cu", "bitpair_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p],
)

TILE = 64                 # output tile edge of a block (csrc/bitpair.cu TILE)
SMS = 132                 # the H100's SMs
MIN_BLOCKS = 2 * SMS      # a call launches at least this many blocks where W allows
KW = 32                   # words a block stages at a time (csrc/bitpair.cu KW)
MAX_SLICES = 65_535       # a grid's second dimension
MAX_TILES = 2**31 - 1     # a grid's first dimension


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers an ``(M, N)`` output over ``W`` words:
    ``tiles`` output tiles of ``TILE`` × ``TILE`` (``tiles_n`` per tile row;
    with ``same``, only the tiles with tile_n >= tile_m), each split into
    ``slices`` word slices, one block per tile and slice. Slice s holds the
    words ``[s·W // slices, (s+1)·W // slices)``, at least one."""

    tiles: int
    tiles_n: int
    slices: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.slices


@functools.lru_cache(maxsize=256)
def plan(M: int, N: int, W: int, same: bool) -> Plan:
    """The launch plan of a ``(M, W) × (N, W)`` call: the one place that
    holds the limits above. Pure host arithmetic; the kernel only checks
    that the slices fit the words.

    The number of slices is the fewest that give ``MIN_BLOCKS`` blocks and
    leave each slice one stage of ``KW`` words, but no more than W, so that
    every slice holds a word.

    Example::

        plan(256, 256, 625, False)   # Plan(tiles=16, tiles_n=4, slices=20)
    """
    if M < 1 or N < 1 or W < 1 or (same and M != N):
        raise ValueError(f"bad plan input (M={M}, N={N}, W={W}, same={same})")
    tm, tn = -(-M // TILE), -(-N // TILE)
    tiles = tm * (tm + 1) // 2 if same else tm * tn
    if tiles > MAX_TILES:
        raise ValueError(f"(M={M}, N={N}) needs {tiles} tiles, past the grid")
    slices = max(-(-MIN_BLOCKS // tiles), -(-W // KW))
    return Plan(tiles, tn, min(W, MAX_SLICES, slices))


def bitpair_cuda(rows_i: torch.Tensor, rows_j: torch.Tensor) -> torch.Tensor:
    """``out[m, n] = Σ_w popcount(rows_i[m, w] & rows_j[n, w])`` on the card.

    ``rows_i``, ``rows_j``: contiguous int32 ``(M, W)`` and ``(N, W)`` CUDA
    tensors of bitmap words, on one device. Passing one tensor twice
    computes only the upper tiles and mirrors them. Returns a new int32
    ``(M, N)`` tensor; with M, N or W = 0 zeros, without a launch. Raises
    on anything the kernel does not take, and if the launch fails.
    """
    for name, t in (("rows_i", rows_i), ("rows_j", rows_j)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int32 CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows_i.device != rows_j.device or rows_i.shape[1] != rows_j.shape[1]:
        raise ValueError(
            f"rows_i {tuple(rows_i.shape)} and rows_j {tuple(rows_j.shape)} "
            "must share their word count and device"
        )
    M, W = rows_i.shape
    N = rows_j.shape[0]
    if W >= 2**26:
        raise ValueError(f"W={W} words: counts exact only below 2^31 bits")
    out = torch.zeros((M, N), dtype=torch.int32, device=rows_i.device)
    if M == 0 or N == 0 or W == 0:
        return out
    same = rows_i.data_ptr() == rows_j.data_ptr() and rows_i.shape == rows_j.shape
    p = plan(M, N, W, same)
    KERNEL.launch(
        rows_i.data_ptr(), rows_j.data_ptr(), M, N, W, out.data_ptr(),
        int(same), p.tiles, p.tiles_n, p.slices,
        torch.cuda.current_stream(rows_i.device).cuda_stream,
    )
    return out
