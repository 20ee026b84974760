"""Gradient clipping by global norm.

The counterpart of the reference package's ``optim/clip.py``. A tree is a
flat dict of tensors, or of lists of tensors (the per-layer slices of a
leaf the reference stacks); :func:`leaves` walks either.
"""

from __future__ import annotations

import torch


def leaves(tree: dict):
    """Every tensor of ``tree``, in its order (a list's slices in turn)."""
    for v in tree.values():
        yield from (v if isinstance(v, list) else (v,))


def global_norm(tree: dict) -> torch.Tensor:
    """The float32 L2 norm over every leaf: each leaf's sum of squares in
    float32, summed across leaves."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves(tree)))


def clip_by_global_norm(tree: dict, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / norm)`` in place, as
    ``(l.float() * scale).to(l.dtype)``: a bf16 leaf times a float32
    0-dim tensor would round the scale to bf16 first. Returns ``(tree,
    norm)``; the tree is the one given, its leaves rescaled."""
    norm = global_norm(tree)
    # a true division: ``scalar / tensor`` is a reciprocal and a product
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-12),
                        max=1.0)
    for l in leaves(tree):
        l.copy_((l.float() * scale).to(l.dtype))
    return tree, norm
