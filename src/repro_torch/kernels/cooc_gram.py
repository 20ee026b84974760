"""``cooc_gram`` on the card: the exact co-occurrence Gram of two 0/1 tiles.

Wrapper of the hand-written CUDA kernel ``csrc/cooc_gram.cu``, which
replaces the reference package's Pallas MXU Gram
(src/repro/kernels/cooc_gram.py). Its plain PyTorch version is
``kernels.ref.cooc_gram_ref``; ``kernels.ops.cooc_gram`` picks between the
two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "cooc_gram", "cooc_gram.cu", "cooc_gram_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)

# the kernel's grid has one row of blocks per 64 rows of the output, and a
# grid's second dimension holds at most 65,535 blocks
MAX_M = 65_535 * 64


def cooc_gram_cuda(b_i: torch.Tensor, b_j: torch.Tensor) -> torch.Tensor:
    """``b_iᵀ b_j`` on the card, exactly, as int32 ``(M, N)``.

    ``b_i``, ``b_j``: contiguous uint8 ``(D, M)`` and ``(D, N)`` CUDA tensors
    of 0/1 incidence (documents × terms), on one device. Passing one tensor
    twice lets diagonal output tiles stage it once. Returns a new int32
    tensor; with M = 0 or N = 0 an empty one, without a launch. Raises on
    anything the kernel does not take, and if the launch fails.
    """
    for name, t in (("b_i", b_i), ("b_j", b_j)):
        if not t.is_cuda or t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D uint8 CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b_i.device != b_j.device or b_i.shape[0] != b_j.shape[0]:
        raise ValueError(
            f"b_i {tuple(b_i.shape)} and b_j {tuple(b_j.shape)} must share "
            "their document count and device"
        )
    D, M = b_i.shape
    N = b_j.shape[1]
    if D >= 2**31 or M > MAX_M:
        raise ValueError(f"shape (D={D}, M={M}) past the kernel's range")
    out = torch.empty((M, N), dtype=torch.int32, device=b_i.device)
    if M == 0 or N == 0:
        return out
    same = b_i.data_ptr() == b_j.data_ptr() and b_i.shape == b_j.shape
    KERNEL.launch(
        b_i.data_ptr(), b_j.data_ptr(), D, M, N, out.data_ptr(), int(same),
        torch.cuda.current_stream(b_i.device).cuda_stream,
    )
    return out
