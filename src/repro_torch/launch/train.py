"""Train-step factories for the LM, GraphSAGE and the recsys rankers.

The counterpart of the reference package's ``launch/train.py``. Each
factory returns ``step(state, *inputs) -> (state, metrics)`` with the
reference's signature and metrics (``loss``, ``grad_norm``, and the LM's
``ce``, ``aux``, ``mtp_ce``): the loss and its gradients by autograd, the
gradients clipped to a global norm of 1, the optimizer's update, applied.
``state = (model, opt_state)``: the model (a ``TransformerLM``,
``GraphSAGE`` or ``Ranker``) is updated in place outside autograd, as the
optimizer state is, and both are returned. Metrics are 0-dim tensors on
the model's device; nothing waits on the host.

Optimizer policy: ≥50B params → Adafactor (factored second moments);
smaller models → AdamW with bf16 moments. :func:`opt_state_specs` lays the
optimizer state out as its parameters are (``runtime/sharding.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.optim import adafactor, adamw, apply_updates, clip_by_global_norm, warmup_cosine
from repro_torch.optim.clip import leaves
from repro_torch.optim.optimizers import tree_map
from repro_torch.runtime.sharding import P


def pick_optimizer(num_params: int):
    """``(optimizer, name)``: Adafactor at 50e9 parameters and above, else
    AdamW with bf16 moments; warm-up cosine from 3e-4 over 100,000 steps."""
    lr = warmup_cosine(3e-4, 2000, 100_000)
    if num_params >= 50e9:
        return adafactor(lr), "adafactor"
    return adamw(lr, moment_dtype=torch.bfloat16), "adamw"


def opt_state_specs(opt_name: str, param_specs, shapes_tree):
    """Specs of the optimizer state, derived from the parameters' specs
    (trees of the same structure, whatever their nesting), under the names
    the optimizers' state uses: AdamW ``m``, ``v``, ``count``; SGD ``mu``,
    ``count``; Adafactor ``stats/<leaf>/r|c`` (row and column statistics
    of a leaf of two or more dimensions, each its parameter's spec less the
    reduced dimension) or ``stats/<leaf>/v``, and ``count``."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "count": P()}
    if opt_name == "sgd":
        return {"mu": param_specs, "count": P()}
    if opt_name == "adafactor":
        def walk(spec, shape):
            if isinstance(spec, dict):
                return {k: walk(spec[k], shape[k]) for k in spec}
            if isinstance(spec, list):
                return [walk(s, t) for s, t in zip(spec, shape)]
            parts = P(*spec).padded(len(shape))
            if len(shape) >= 2:
                return {"r": P(*parts[:-1]), "c": P(*parts[:-2], parts[-1])}
            return {"v": spec}

        return {"stats": walk(param_specs, shapes_tree), "count": P()}
    raise ValueError(opt_name)


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d params, as a tree shaped like ``params``; a parameter the
    loss does not reach gets zeros (as ``jax.grad`` gives)."""
    got = iter(torch.autograd.grad(loss, list(leaves(params)), allow_unused=True))

    def take(p):
        g = next(got)
        return torch.zeros_like(p) if g is None else g

    return tree_map(take, params)


def _apply(model, opt_state, opt, loss):
    """Backward, clip, update, apply: returns ``(opt_state, grad_norm)``."""
    params = model.param_tree()
    grads, gnorm = clip_by_global_norm(_grads(loss, params), 1.0)
    updates, opt_state = opt.update(grads, opt_state, params)
    del grads
    apply_updates(params, updates)
    return opt_state, gnorm


def make_lm_train_step(cfg, opt):
    def step(state, batch):
        model, opt_state = state
        loss, metrics = lm_mod.loss_fn(model, batch, cfg)
        opt_state, gnorm = _apply(model, opt_state, opt, loss)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (model, opt_state), {**metrics, "loss": loss.detach(), "grad_norm": gnorm}

    return step


def _simple_step(loss_fn):
    """A step whose metrics are ``loss`` and ``grad_norm``: ``loss_fn(model,
    *inputs, cfg)`` is the loss."""
    def make(cfg, opt):
        def step(state, *inputs):
            model, opt_state = state
            loss = loss_fn(model, *inputs, cfg)
            opt_state, gnorm = _apply(model, opt_state, opt, loss)
            return (model, opt_state), {"loss": loss.detach(), "grad_norm": gnorm}

        return step

    return make


# step(state, feats, edge_index, labels, mask)
make_gnn_full_graph_step = _simple_step(gnn_mod.loss_full_graph)
# step(state, seed_feats, hop1, hop2, labels)
make_gnn_sampled_step = _simple_step(gnn_mod.loss_sampled)
# step(state, feats, edge_index, graph_ids, labels, n_graphs)
make_gnn_batched_graphs_step = _simple_step(
    lambda model, feats, edge_index, graph_ids, labels, n_graphs, cfg:
    gnn_mod.loss_batched_graphs(model, feats, edge_index, graph_ids, labels, cfg, n_graphs))
# step(state, batch)
make_recsys_train_step = _simple_step(recsys_mod.loss_fn)
