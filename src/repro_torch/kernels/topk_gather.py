"""``topk_gather`` on the card: the serving score-and-select step.

Wrapper of the hand-written CUDA kernel ``csrc/topk_gather.cu``, which
replaces the reference package's Pallas top-k gather
(src/repro/kernels/topk_gather.py). Its plain PyTorch version is
``kernels.ref.topk_gather_ref``; ``kernels.ops.topk_gather`` picks between
the two by the tensors' device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel

SCORE_CODES = {"count": 0, "pmi": 1, "dice": 2}

KERNEL = CudaKernel(
    "topk_gather", "topk_gather.cu", "topk_gather_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
)

SLOTS_PER_BLOCK = 8192      # a row gets one block of its cluster per 8,192 slots
MAX_CLUSTER = 8             # the portable cluster size
MAX_SMEM_KEYS = 16_384      # slots whose keys one block keeps in shared memory
SMEM_BUDGET = 200 * 1024    # dynamic shared memory a block may ask for


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers a row of ``L`` slots: ``C`` blocks (one
    cluster) of ``S`` slots each; ``W`` entries of winner list per block;
    whether keys and lists live in shared memory; ``scratch`` uint64
    entries per row when the lists do not."""

    C: int
    S: int
    W: int
    keys_in_smem: bool
    list_in_smem: bool

    @property
    def flags(self) -> int:
        return int(self.keys_in_smem) | 2 * int(self.list_in_smem)

    @property
    def scratch_per_row(self) -> int:
        return 0 if self.list_in_smem else self.C * self.W


@functools.lru_cache(maxsize=256)
def plan(L: int, k: int) -> Plan:
    """The launch plan for rows of ``L`` slots and top ``k``: the one place
    that holds the limits above. Pure host arithmetic: the kernel checks
    only that the plan covers the row, and nothing here needs a card.

    Example::

        plan(65_536, 10)   # Plan(C=8, S=8192, W=16, keys_in_smem=True, ...)
    """
    if not 1 <= k <= L:
        raise ValueError(f"k={k} must be in [1, L={L}]")
    C = min(MAX_CLUSTER, -(-L // SLOTS_PER_BLOCK))
    S = -(-(-(-L // C)) // 4) * 4
    W = 1 << (min(k, S) - 1).bit_length()
    keys_in_smem = S <= MAX_SMEM_KEYS
    key_bytes = 4 * S if keys_in_smem else 0
    return Plan(C, S, W, keys_in_smem, key_bytes + 8 * W <= SMEM_BUDGET)


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
    p = plan(L, k)
    if B * p.C >= 2**31:
        raise ValueError(f"B={B} rows of L={L} slots past the kernel's grid")
    s_dtype = torch.int32 if score == "count" else torch.float32
    out_ids = torch.empty((B, k), dtype=torch.int32, device=ids.device)
    out_s = torch.empty((B, k), dtype=s_dtype, device=ids.device)
    if B == 0:
        return out_ids, out_s
    scratch = None
    if p.scratch_per_row:
        scratch = torch.empty(B * p.scratch_per_row, dtype=torch.int64,
                              device=ids.device)
    KERNEL.launch(
        ids.data_ptr(), cnts.data_ptr(), df_t.data_ptr(), df_n.data_ptr(),
        B, L, k, SCORE_CODES[score], float(np.float32(num_docs)),
        p.C, p.S, p.W, p.flags,
        None if scratch is None else scratch.data_ptr(),
        out_ids.data_ptr(), out_s.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream,
    )
    return out_ids, out_s
