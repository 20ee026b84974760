"""AdamW / Adafactor / SGD with the reference package's minimal interface.

The counterpart of the reference package's ``optim/optimizers.py``, and
not ``torch.optim``: ``torch.optim.AdamW`` decays as ``p *= 1 - lr·wd``
and keeps float32 moments, so its bits differ. An optimizer is
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, with :func:`apply_updates` adding the updates to the params.

A tree is a flat dict from the reference's dotted leaf path to a tensor,
or to the list of per-layer slices of a leaf the reference stacks over
layers (``TransformerLM.param_tree()``). State keeps the reference's
layout and names (``m``, ``v``, ``count``; ``mu``; ``stats/<leaf>/r|c|v``),
so ``repro_torch.convert`` can write it as the reference's tree.

Memory: ``update`` works leaf by leaf, so the float32 temporaries of one
leaf are all it holds at once; it rewrites the state's tensors in place
(JAX's donated buffers) and returns each update already cast to its
parameter's dtype, the cast :func:`apply_updates` would make, so the bits
are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim.clip import leaves


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` on every leaf of ``tree`` and the matching leaves of
    ``rest``; a list leaf maps slice by slice to a list."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, list):
            out[k] = [fn(*args) for args in zip(v, *(r[k] for r in rest))]
        else:
            out[k] = fn(v, *(r[k] for r in rest))
    return out


def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u.to(p.dtype)`` for every leaf, written into the parameters in
    place (outside autograd). Returns ``params``."""
    with torch.no_grad():
        for p, u in zip(leaves(params), leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


def _sched(lr, count):
    return lr(count) if callable(lr) else lr


def _counter(params: dict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(leaves(params)).device)


def sgd(lr, momentum: float = 0.9) -> Optimizer:
    """SGD with momentum; ``mu`` in each parameter's dtype."""
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params), "count": _counter(params)}

    def update(grads, state, params=None):
        count = state["count"].add_(1)
        step = _sched(lr, count)

        def leaf(m, g):
            m.mul_(momentum).add_(g)
            # a float32 rate makes the reference's update float32; a
            # Python rate keeps mu's dtype
            u = -step * (m.float() if torch.is_tensor(step) else m)
            return u.to(m.dtype)

        return tree_map(leaf, state["mu"], grads), state

    return Optimizer(init, update)


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    moment_dtype=torch.float32,
) -> Optimizer:
    """AdamW with moments in ``moment_dtype`` (bf16 halves their memory):
    each moment updated in float32 and rounded, bias corrections ``1 -
    b ** count`` in float32, decoupled decay added to the step."""
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _counter(params)}

    def update(grads, state, params):
        count = state["count"].add_(1)
        c = count.float()
        c1, c2 = 1 - b1 ** c, 1 - b2 ** c
        neg_step = -_sched(lr, count)

        def leaf(m, v, g, p):
            # the reference's operations in its order, each rounded to
            # float32, the later ones in place on a fresh temporary (a
            # float32 leaf's .float() is the leaf itself)
            g = g.float()
            m.copy_(torch.mul(m.float(), b1).add_(torch.mul(g, 1 - b1)))
            v.copy_(torch.mul(v.float(), b2).add_(torch.square(g).mul_(1 - b2)))
            denom = torch.div(v.float(), c2).sqrt_().add_(eps)
            u = torch.div(m.float(), c1).div_(denom)
            del denom
            u.add_(torch.mul(p.float(), weight_decay)).mul_(neg_step)
            return u.to(p.dtype)

        return tree_map(leaf, state["m"], state["v"], grads, params), state

    return Optimizer(init, update)


def adafactor(
    lr,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored second moments (Shazeer & Stern 2018): a leaf of two or
    more dimensions keeps float32 row (``r``, mean over the last axis) and
    column (``c``, mean over the second to last) statistics, others a full
    ``v``. The leaf is the reference's, so a list of per-layer slices is
    stacked first: its statistics, and the RMS clip, span the layers as
    the reference's do on its stacked leaf."""
    def _stacked(x):
        return torch.stack(x) if isinstance(x, list) else x

    def init(params):
        stats = {}
        for k, p in params.items():
            shape = (len(p), *p[0].shape) if isinstance(p, list) else tuple(p.shape)
            dev = next(leaves({k: p})).device
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
            if len(shape) >= 2:
                stats[k] = {"r": zeros(shape[:-1]), "c": zeros(shape[:-2] + shape[-1:])}
            else:
                stats[k] = {"v": zeros(shape)}
        return {"stats": stats, "count": _counter(params)}

    def update(grads, state, params):
        count = state["count"].add_(1)
        beta = 1.0 - count.float() ** -decay
        neg_step = -_sched(lr, count)
        updates = {}
        for k, p in params.items():
            s = state["stats"][k]
            g = _stacked(grads[k]).float()
            g2 = torch.square(g) + eps
            if "r" in s:
                r, c = s["r"], s["c"]
                r.copy_(beta * r + (1 - beta) * g2.mean(dim=-1))
                c.copy_(beta * c + (1 - beta) * g2.mean(dim=-2))
                denom = (
                    r[..., None] / torch.clamp(r.mean(dim=-1, keepdim=True), min=eps)[..., None]
                ) * c[..., None, :]
                upd = g * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                v = s["v"]
                v.copy_(beta * v + (1 - beta) * g2)
                upd = g * torch.rsqrt(torch.clamp(v, min=eps))
            # relative update clipping (Adafactor's RMS clip)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps)
            upd = upd / torch.clamp(rms / torch.full_like(rms, clip_threshold), min=1.0)
            upd = neg_step * (upd + weight_decay * _stacked(p).float())
            dtype = (p[0] if isinstance(p, list) else p).dtype
            updates[k] = list(upd.to(dtype).unbind(0)) if isinstance(p, list) else upd.to(dtype)
        return updates, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kwargs) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](lr, **kwargs)
