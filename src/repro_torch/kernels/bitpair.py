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

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "bitpair", "bitpair.cu", "bitpair_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)

# the kernel's grid has one row of blocks per 64 rows of the output, and a
# grid's second dimension holds at most 65,535 blocks
MAX_M = 65_535 * 64


def bitpair_cuda(rows_i: torch.Tensor, rows_j: torch.Tensor) -> torch.Tensor:
    """``out[m, n] = Σ_w popcount(rows_i[m, w] & rows_j[n, w])`` on the card.

    ``rows_i``, ``rows_j``: contiguous int32 ``(M, W)`` and ``(N, W)`` CUDA
    tensors of bitmap words, on one device. Passing one tensor twice lets
    diagonal output tiles stage it once. Returns a new int32 ``(M, N)``
    tensor; with M = 0 or N = 0 an empty one, without a launch. Raises on
    anything the kernel does not take, and if the launch fails.
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
    if W >= 2**26 or M > MAX_M:
        raise ValueError(f"shape (M={M}, W={W}) past the kernel's range")
    out = torch.empty((M, N), dtype=torch.int32, device=rows_i.device)
    if M == 0 or N == 0:
        return out
    same = rows_i.data_ptr() == rows_j.data_ptr() and rows_i.shape == rows_j.shape
    KERNEL.launch(
        rows_i.data_ptr(), rows_j.data_ptr(), M, N, W, out.data_ptr(),
        int(same), torch.cuda.current_stream(rows_i.device).cuda_stream,
    )
    return out
