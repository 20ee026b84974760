"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the least time a kernel's work could
take on it. The arithmetic is ``bound`` of ``chip_smoke.py``, and each
kernel's bytes and operations are counted from the job's inputs and
outputs, never from the kernel's launch arguments, so a roofline reads the
same work whatever implements it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # HBM3
INT8_OPS_PER_S = 1.979e15   # int8 tensor cores, dense


def bound_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    """The larger of bytes over the memory rate and operations over their
    peak rate, in seconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


def segment_hist_bound_s(tokens: int, cells: int) -> float:
    """The histogram's least time: each pair occurrence it counts is one
    token of an int32 id and an int32 row read once (8 bytes), and each
    distinct pair is one int32 cell read and written (8 bytes)."""
    return bound_s(8 * tokens + 8 * cells, 0, INT8_OPS_PER_S)

