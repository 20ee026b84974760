"""``segment_hist`` on the card: the LIST-SCAN batched histogram.

Wrapper of the hand-written CUDA kernel ``csrc/segment_hist.cu``, which
replaces the reference package's Pallas one-hot-matmul histogram
(src/repro/kernels/segment_cooc.py). Its plain PyTorch version is
``kernels.ref.segment_hist_ref``; ``kernels.ops.segment_hist`` picks
between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "segment_hist", "segment_hist.cu", "segment_hist_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
     ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p],
)


def segment_hist_cuda(
    ids: torch.Tensor,
    seg: torch.Tensor,
    *,
    num_rows: int,
    vocab: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``out[r, v] += #{l : seg[l] == r and ids[l] == v}`` on the card.

    ``ids``, ``seg``: contiguous int32 ``(L,)`` CUDA tensors, -1 as padding.
    ``out``: the contiguous int32 ``(num_rows, vocab)`` grid to accumulate
    into (zeroed here when ``None``). Returns ``out``. Raises on anything
    the kernel does not take, and if the launch fails.
    """
    for name, t in (("ids", ids), ("seg", seg)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg.shape != ids.shape or seg.device != ids.device:
        raise ValueError("ids and seg must have one shape and one device")
    if not 1 <= num_rows < 2**31 or vocab < 1:
        raise ValueError(f"bad grid shape ({num_rows}, {vocab})")
    if out is None:
        out = torch.zeros((num_rows, vocab), dtype=torch.int32, device=ids.device)
    elif (
        out.shape != (num_rows, vocab) or out.dtype != torch.int32
        or out.device != ids.device or not out.is_contiguous()
    ):
        raise ValueError(
            f"out must be a contiguous int32 ({num_rows}, {vocab}) tensor "
            f"on {ids.device}"
        )
    if ids.numel() == 0:
        return out
    KERNEL.launch(
        ids.data_ptr(), seg.data_ptr(), ids.numel(), out.data_ptr(),
        num_rows, vocab, torch.cuda.current_stream(ids.device).cuda_stream,
    )
    return out
