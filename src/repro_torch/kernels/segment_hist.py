"""``segment_hist`` on the card: the LIST-SCAN batched histogram.

Wrapper of the hand-written CUDA kernel ``csrc/segment_hist.cu``, which
replaces the reference package's Pallas one-hot-matmul histogram
(src/repro/kernels/segment_cooc.py). Its plain PyTorch version is
``kernels.ref.segment_hist_ref``; ``kernels.ops.segment_hist`` picks
between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "segment_hist", "segment_hist.cu", "segment_hist_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
     ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
     ctypes.c_void_p, ctypes.c_void_p],
)

SMS = 132                   # the H100's SMs
THREADS = 1024              # threads a block with a window (one block an SM)
STEP = 4 * THREADS          # tokens such a block's step covers (4 a thread)
WINDOW_CELLS = 32_768       # int32 cells of a block's window: 128 KiB
MAX_H = 16_384              # widest column prefix a window covers
MIN_H = 32                  # narrower windows are not worth their flushes
MIN_WINDOW_TOKENS = SMS * STEP  # shorter launches take no window
NARROW_THREADS = 64         # threads a block of a launch without a window


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers a stream of ``n`` tokens: ``blocks`` blocks of
    ``threads`` threads, block b on tokens ``[b·span, (b+1)·span)``, each
    with a window of ``R`` rows × the ``H`` lowest columns (none when
    ``R · H == 0``)."""

    R: int
    H: int
    span: int
    blocks: int
    threads: int


def plan(num_rows: int, vocab: int, n: int) -> Plan:
    """The launch plan for ``n`` tokens into a ``(num_rows, vocab)`` grid:
    the one place that holds the limits above. Pure host arithmetic; the
    kernel only checks that the spans cover the stream.

    A launch of ``MIN_WINDOW_TOKENS`` or more runs one block of ``THREADS``
    per SM, each on an equal span of whole steps. The window's rows are
    those a span would meet if every row held ``n / num_rows`` tokens, plus
    the row it starts in (both callers emit rows in non-decreasing order);
    its columns are the lowest ``H``, where the Zipf head lies, as many as
    the window's cells allow, but no more than one cell a token of the span
    per row, so flushing stays cheaper than the tokens it saves.

    A shorter launch (972 of path 1's 1,025) takes no window,
    whose zeroing and flushes would cost more than it saves, and runs
    blocks of ``NARROW_THREADS`` on one step each, so that its global
    atomics spread over as many SMs as it has steps.

    Example::

        plan(64, 65_536, 1 << 26)   # Plan(R=2, H=16384, span=512000, blocks=132, threads=1024)
        plan(64, 65_536, 10_067)    # Plan(R=0, H=0, span=256, blocks=40, threads=64)
    """
    if num_rows < 1 or vocab < 1 or n < 1:
        raise ValueError(f"bad plan input ({num_rows}, {vocab}, {n})")
    if n < MIN_WINDOW_TOKENS:
        step = 4 * NARROW_THREADS
        return Plan(0, 0, step, -(-n // step), NARROW_THREADS)
    blocks = min(SMS, -(-n // STEP))
    span = -(-(-(-n // blocks)) // STEP) * STEP
    blocks = -(-n // span)
    R = min(num_rows, -(-span * num_rows // n) + 1, WINDOW_CELLS // MIN_H)
    H = min(vocab, MAX_H, WINDOW_CELLS // R, span // R)
    if H < MIN_H:
        R = H = 0
    return Plan(R, H, span, blocks, THREADS)


def segment_hist_cuda(
    ids: torch.Tensor,
    seg: torch.Tensor,
    *,
    num_rows: int,
    vocab: int,
    out: torch.Tensor | None = None,
    hits: torch.Tensor | None = None,
) -> torch.Tensor:
    """``out[r, v] += #{l : seg[l] == r and ids[l] == v}`` on the card.

    ``ids``, ``seg``: contiguous int32 ``(L,)`` CUDA tensors, -1 as padding.
    ``out``: the contiguous int32 ``(num_rows, vocab)`` grid to accumulate
    into (zeroed here when ``None``). ``hits``: an int64 ``(1,)`` tensor on
    the same device that gains the number of tokens the blocks' windows
    counted (the window's hit share is ``hits / valid tokens``). Returns
    ``out``. Raises on anything the kernel does not take, and if the launch
    fails.
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
    if hits is not None and (
        hits.shape != (1,) or hits.dtype != torch.int64 or hits.device != ids.device
    ):
        raise ValueError(f"hits must be an int64 (1,) tensor on {ids.device}")
    if ids.numel() == 0:
        return out
    p = plan(num_rows, vocab, ids.numel())
    KERNEL.launch(
        ids.data_ptr(), seg.data_ptr(), ids.numel(), out.data_ptr(),
        num_rows, vocab, p.R, p.H, p.span, p.blocks, p.threads,
        None if hits is None else hits.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream,
    )
    return out
