"""Gradient compression with error feedback.

The counterpart of the reference package's ``optim/compress.py``. int8
per-block quantisation: gradients are quantised before a cross-node
all-reduce, and the quantisation error is carried in an error-feedback
buffer added to the next step's gradient (Seide et al. 2014 / EF-SGD).

:func:`compressed_psum` is the reference's ``shard_map`` building block on
``torch.distributed``: the ranks agree on each block's largest scale
(``all_reduce(MAX)``), rescale their int8 payloads to it, sum them as
int32 (``all_reduce(SUM)``) and dequantise. It runs on any process group,
the gloo worlds of ``repro_torch.core.distributed`` included.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Per-block symmetric int8: returns ``(q int8 (n, block), scales
    float32 (n,))``; the flat input is zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(scale / torch.full_like(scale, 127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, block: int = 256):
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def ef_compress_update(grad: torch.Tensor, error: torch.Tensor, block: int = 256):
    """Error-feedback compression of one tensor: returns
    ``(decompressed_grad, new_error)``, decompressed = Q(grad + error) in
    ``grad``'s dtype and new_error = (grad + error) - decompressed in
    float32."""
    target = grad.float() + error
    q, s = quantize_int8(target, block)
    deq = dequantize_int8(q, s, grad.shape, block)
    return deq.to(grad.dtype), target - deq


def compressed_psum(x: torch.Tensor, group=None, block: int = 256) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` with an int8 wire
    format: each rank quantises, rescales its payload to the largest scale
    of each block across the ranks, the payloads are summed in int32 and
    dequantised with that scale. Not exact (that is what error feedback is
    for); every rank gets the same result."""
    q, s = quantize_int8(x, block)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    # rescale the local payload to the common scale so the int sum is coherent
    q_common = torch.round(q.float() * (s / s_max)[:, None]).to(torch.int32)
    dist.all_reduce(q_common, op=dist.ReduceOp.SUM, group=group)
    return dequantize_int8(q_common, s_max, x.shape, block)
