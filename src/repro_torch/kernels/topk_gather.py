"""``topk_gather`` on the card: the serving score-and-select step.

Wrapper of the hand-written CUDA kernel ``csrc/topk_gather.cu``, which
replaces the reference package's Pallas top-k gather
(src/repro/kernels/topk_gather.py). Its plain PyTorch version is
``kernels.ref.topk_gather_ref``; ``kernels.ops.topk_gather`` picks between
the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel

SCORE_CODES = {"count": 0, "pmi": 1, "dice": 2}

KERNEL = CudaKernel(
    "topk_gather", "topk_gather.cu", "topk_gather_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p],
)


def topk_gather_cuda(
    ids: torch.Tensor,
    cnts: torch.Tensor,
    df_t: torch.Tensor,
    df_n: torch.Tensor,
    *,
    num_docs: int,
    score: str,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of a padded candidate tile, on the card.

    ``ids``, ``cnts``, ``df_n``: contiguous int32 ``(B, L)`` CUDA tensors
    (id -1 and count 0 in padding slots, ``df_n >= 1``); ``df_t``: int32
    ``(B,)``. Returns ``(ids (B, k) int32, scores (B, k))``, scores int32
    for ``count`` and float32 otherwise; ties go to the lowest column.
    Raises on anything the kernel does not take, and if the launch fails.
    """
    if score not in SCORE_CODES:
        raise ValueError(f"unknown score {score!r}; have {tuple(SCORE_CODES)}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, L), got shape {tuple(ids.shape)}")
    B, L = ids.shape
    for name, t, shape in (
        ("ids", ids, (B, L)), ("cnts", cnts, (B, L)),
        ("df_t", df_t, (B,)), ("df_n", df_n, (B, L)),
    ):
        if not t.is_cuda or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be an int32 CUDA tensor of shape {shape}")
        if not t.is_contiguous() or t.device != ids.device:
            raise ValueError(f"{name} must be contiguous and on {ids.device}")
    if not 1 <= k <= L or L >= 2**31:
        raise ValueError(f"k={k} must be in [1, L={L}]")
    s_dtype = torch.int32 if score == "count" else torch.float32
    scratch = torch.empty((B, L), dtype=s_dtype, device=ids.device)
    retired = torch.empty((B, L), dtype=torch.uint8, device=ids.device)
    out_ids = torch.empty((B, k), dtype=torch.int32, device=ids.device)
    out_s = torch.empty((B, k), dtype=s_dtype, device=ids.device)
    if B == 0:
        return out_ids, out_s
    KERNEL.launch(
        ids.data_ptr(), cnts.data_ptr(), df_t.data_ptr(), df_n.data_ptr(),
        B, L, k, SCORE_CODES[score], float(np.float32(num_docs)),
        scratch.data_ptr(), retired.data_ptr(), out_ids.data_ptr(),
        out_s.data_ptr(), torch.cuda.current_stream(ids.device).cuda_stream,
    )
    return out_ids, out_s
