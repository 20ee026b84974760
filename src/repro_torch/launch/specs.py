"""Cells: (arch × input shape × mesh) → the step function and its
arguments, laid out on the mesh, with nothing allocated.

The counterpart of the reference package's ``launch/specs.py``, the single
source the dry run, the roofline analysis and ``hillclimb`` share. The
reference builds ``ShapeDtypeStruct``s with shardings and lets GSPMD lower
the step; here every argument is a DTensor on a ``DeviceMesh`` (a fake
world's, in the dry run), its local block made under ``FakeTensorMode``,
laid out by ``runtime/sharding.py``'s rules through :func:`_fit_spec`, and
DTensor's sharding propagation takes GSPMD's place. Build a cell, and run
its ``fn``, inside ``FakeTensorMode`` with the mesh active
(``runtime.sharding.set_mesh_compat``) and ``implicit_replication`` (the
models make plain tensors such as positions, which take part replicated),
as ``launch/dryrun.py`` does.

``model_flops`` and ``act_bytes`` are the reference's formulas, unchanged.
Three things differ from the reference's cells, each from the port's
design:

  * model parameters are the port's modules (one per layer), so an LM's
    layer leaves are laid out per layer; AdamW and SGD state follows them,
    Adafactor's statistics are stacked over the layers as the port's
    optimizer keeps them;
  * a decode cell's ``pos`` is a 0-dim int32 argument, as the reference's,
    but the step decodes at the static position ``seq_len − 1`` (the port's
    decode takes a Python int; the cost does not depend on it);
  * the co-occurrence Gram takes uint8 incidence (``configs/cooc_wt10g``),
    so its cell's compute term is held against the int8 tensor-core peak
    (``Cell.peak_flops``; the card's ``cooc_gram`` multiplies int8).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.configs import ArchSpec, ShapeSpec, get_spec, list_archs
from repro_torch.launch import train as train_factories
from repro_torch.launch.roofline import PEAK_FLOPS, PEAK_INT8_OPS
from repro_torch.models.params import flat_leaves
from repro_torch.runtime.sharding import (
    P,
    axis_group,
    axis_sizes,
    entry_axes,
    fake_dtensor,
    fsdp_axes,
    gnn_param_specs,
    lm_param_specs,
    placements,
    recsys_param_specs,
)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: tuple
    model_flops: float = 0.0   # analytic "useful" FLOPs per step (global)
    act_bytes: float = 0.0     # analytic GLOBAL activation working set
    notes: str = ""
    peak_flops: float = PEAK_FLOPS  # the rate its products run at on the card


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def sharded_arg_bytes(args, mesh) -> float:
    """Per-rank bytes of all inputs, honoring each DTensor's placements (a
    plain tensor counts whole)."""
    from torch.distributed.tensor import DTensor, Shard

    sizes = list(axis_sizes(mesh).values())
    total = 0.0
    for t in _leaves(args):
        ways = 1
        if isinstance(t, DTensor):
            for i, pl in enumerate(t.placements):
                if isinstance(pl, Shard):
                    ways *= sizes[i]
        total += t.numel() * t.element_size() / ways
    return total


def _fit_spec(shape, spec, mesh) -> P:
    """Drop sharding on dimensions the mesh extent does not divide (input
    layouts must tile exactly). E.g. MiniCPM's 73448-row vocab is not
    16-way divisible → replicated."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, P(*spec).padded(len(shape))):
        if entry is None:
            out.append(None)
            continue
        ways = math.prod(sizes[a] for a in entry_axes(entry))
        out.append(entry if dim % ways == 0 else None)
    return P(*out)


def _dt(shape, dtype, mesh, spec, requires_grad: bool = False):
    """A fake DTensor of ``shape`` laid out by ``_fit_spec(spec)``."""
    return fake_dtensor(tuple(shape), dtype, _fit_spec(shape, spec, mesh), mesh,
                        requires_grad=requires_grad)


def _like(t, dtype):
    """A fake DTensor shaped and laid out as DTensor ``t``, of ``dtype``."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(t._local_tensor.shape, dtype=dtype)
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _lookup(tree: dict, path: str):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _distribute(module: torch.nn.Module, specs: dict, mesh, path_of=lambda n: n):
    """Replace every parameter of ``module`` by a fake DTensor parameter of
    its shape and dtype laid out by ``specs`` (the spec tree, looked up at
    ``path_of(name)``)."""
    for name, p in list(module.named_parameters()):
        owner, leaf = module, name
        if "." in name:
            prefix, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(prefix)
        spec = _lookup(specs, path_of(name))
        owner._parameters[leaf] = torch.nn.Parameter(
            _dt(p.shape, p.dtype, mesh, spec), requires_grad=True)
    return module


def _opt_state(opt_name: str, params: dict, mesh, stacked_specs: dict, stacked_shapes: dict):
    """The optimizer state of ``params`` (a flat param tree of DTensors)
    as the port's optimizers make it, laid out by ``opt_state_specs``."""
    count = _dt((), torch.int32, mesh, P())
    if opt_name in ("adamw", "sgd"):
        def zeros(dtype):
            out = {}
            for k, v in params.items():
                out[k] = [_like(q, dtype or q.dtype) for q in v] if isinstance(v, list) \
                    else _like(v, dtype or v.dtype)
            return out

        if opt_name == "sgd":
            return {"mu": zeros(None), "count": count}
        return {"m": zeros(torch.bfloat16), "v": zeros(torch.bfloat16), "count": count}
    specs = train_factories.opt_state_specs(opt_name, stacked_specs, stacked_shapes)
    stats = {}
    for k, shape in stacked_shapes.items():
        s = specs["stats"][k]
        if "r" in s:
            stats[k] = {"r": _dt(shape[:-1], torch.float32, mesh, s["r"]),
                        "c": _dt(shape[:-2] + shape[-1:], torch.float32, mesh, s["c"])}
        else:
            stats[k] = {"v": _dt(shape, torch.float32, mesh, s["v"])}
    return {"stats": stats, "count": count}


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------
def _unstacked(shapes: dict) -> dict:
    """The LM's shape tree with the layer leaves' leading L (or the MTP
    block's 1) taken off: the port's per-layer parameters."""
    out = dict(shapes)
    out["layers"] = {k: v[1:] for k, v in shapes["layers"].items()}
    if "mtp" in shapes:
        out["mtp"] = dict(shapes["mtp"])
        out["mtp"]["block"] = {k: v[1:] for k, v in shapes["mtp"]["block"].items()}
    return out


def _lm_model(cfg, mesh):
    from repro_torch.models import transformer as lm_mod

    shapes = lm_mod.param_shapes(cfg)
    specs = lm_param_specs(_unstacked(shapes), mesh)
    model = _distribute(lm_mod.TransformerLM(cfg, device="cpu"), specs, mesh,
                        path_of=lm_mod.tree_path)
    return model, shapes


def _lm_cell(
    spec: ArchSpec, shape: ShapeSpec, mesh, *, n_layers: int | None = None,
    unroll: bool = False, overrides: dict | None = None,
) -> Cell:
    # ``unroll`` is the reference's keyword: the port's layer loop is
    # always unrolled. The dry run builds n_layers ∈ {1, 2} variants to
    # extrapolate per-layer costs, as the reference does.
    from repro_torch.models import transformer as lm_mod

    del unroll
    repl = dict(overrides or {})
    if n_layers is not None:
        repl["n_layers"] = n_layers
    cfg = dataclasses.replace(spec.model, **repl)
    dp = fsdp_axes(mesh)
    S, B = shape.sizes["seq_len"], shape.sizes["global_batch"]
    model, shapes = _lm_model(cfg, mesh)
    n_active = spec.model.num_active_params()  # FULL config for model_flops

    if shape.kind == "train":
        # optimizer choice must follow the FULL model size, not the L-override
        opt, opt_name = train_factories.pick_optimizer(spec.model.num_params())
        stacked = flat_leaves(shapes)
        ostate = _opt_state(opt_name, model.param_tree(), mesh,
                            flat_leaves(lm_param_specs(shapes, mesh)), stacked)
        tokens = _dt((B, S), torch.int32, mesh, P(dp, None))
        fn = train_factories.make_lm_train_step(cfg, opt)
        act = (
            cfg.n_layers * B * S * cfg.d_model * 2      # remat carries (bf16)
            + B * S * cfg.vocab_size * 4                # logits (f32)
            + 6 * B * S * cfg.d_model * 4               # live working set
        )
        return Cell(
            spec.arch_id, shape.name, "train", fn,
            ((model, ostate), {"tokens": tokens}),
            model_flops=6.0 * n_active * B * S,
            act_bytes=act,
            notes=f"optimizer={opt_name}",
        )

    if shape.kind == "prefill":
        tokens = _dt((B, S), torch.int32, mesh, P(dp, None))
        fn = functools.partial(_no_grad(lm_mod.prefill), cfg=cfg)
        cache_bytes = sum(math.prod(s_) * 2 for s_ in lm_mod.cache_shapes(cfg, B, S).values())
        act = cache_bytes + 6 * B * S * cfg.d_model * 2 + B * cfg.vocab_size * 4
        return Cell(
            spec.arch_id, shape.name, "prefill", fn, (model, tokens),
            model_flops=2.0 * n_active * B * S,
            act_bytes=act,
        )

    # decode: one new token against a seq_len KV cache
    cache_shapes = lm_mod.cache_shapes(cfg, B, S)
    if B == 1:
        batch_spec, seq_axes = None, dp + ("model",)
    else:
        batch_spec, seq_axes = dp, ("model",)
    cache = {
        k: _dt(s, cfg.torch_dtype, mesh, P(None, batch_spec, seq_axes, *(None,) * (len(s) - 3)))
        for k, s in cache_shapes.items()
    }
    tokens = _dt((B, 1), torch.int32, mesh, P(batch_spec, None))
    pos = _dt((), torch.int32, mesh, P())

    def fn(params, cache, tokens, pos, cfg=cfg, at=S - 1):
        with torch.no_grad():
            return lm_mod.decode_step(params, cache, tokens, at, cfg)

    # useful decode flops: param matmuls + attention over the cache
    cache_elems = sum(s[0] * math.prod(s[3:]) for s in cache_shapes.values())
    return Cell(
        spec.arch_id, shape.name, "decode", fn,
        (model, cache, tokens, pos),
        model_flops=2.0 * n_active * B + 2.0 * B * S * cache_elems,
        act_bytes=B * cfg.vocab_size * 4 + 4 * B * cfg.n_heads * S * 4,
    )


def _no_grad(fn):
    """``fn`` run outside autograd (the serving paths)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)

    return run


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------
def _tree_model(cls, cfg, specs_fn, shapes_fn, mesh):
    shapes = shapes_fn(cfg)
    specs = specs_fn(shapes, mesh)
    return _distribute(cls(cfg, device="cpu"), specs, mesh), shapes, specs


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models import gnn as gnn_mod

    dp = fsdp_axes(mesh)
    sz = shape.sizes
    cfg = dataclasses.replace(
        spec.model,
        d_in=sz["d_feat"],
        n_classes=sz.get("n_classes", spec.model.n_classes),
    )
    model, shapes, specs = _tree_model(gnn_mod.GraphSAGE, cfg, gnn_param_specs,
                                       gnn_mod.param_shapes, mesh)
    opt, opt_name = train_factories.pick_optimizer(0)
    ostate = _opt_state(opt_name, model.param_tree(), mesh, flat_leaves(specs),
                        flat_leaves(shapes))
    state = (model, ostate)
    H = cfg.d_hidden
    dense_flops = 2 * (sz["d_feat"] * H * 2 + H * H * 2 + H * cfg.n_classes)

    if shape.kind == "full_graph":
        # pad node/edge counts to mesh multiples (isolated pad nodes with
        # mask=0 — harmless; the dry-run is shape-level anyway)
        pad = lambda n: int(-(-n // 1024) * 1024)  # noqa: E731
        N, E = pad(sz["n_nodes"]), pad(sz["n_edges"])
        feats = _dt((N, sz["d_feat"]), torch.float32, mesh, P(dp, None))
        ei = _dt((2, E), torch.int32, mesh, P(None, dp))
        labels = _dt((N,), torch.int32, mesh, P(dp))
        mask = _dt((N,), torch.float32, mesh, P(dp))
        fn = train_factories.make_gnn_full_graph_step(cfg, opt)
        return Cell(
            spec.arch_id, shape.name, "train", fn,
            (state, feats, ei, labels, mask),
            model_flops=3.0 * (N * dense_flops + 2 * E * sz["d_feat"]),
        )
    if shape.kind == "sampled":
        Bn = sz["batch_nodes"]
        f1, f2 = sz["fanout"]
        F = sz["d_feat"]
        seed = _dt((Bn, F), torch.float32, mesh, P(dp, None))
        hop1 = _dt((Bn, f1, F), torch.float32, mesh, P(dp, None, None))
        hop2 = _dt((Bn, f1, f2, F), torch.float32, mesh, P(dp, None, None, None))
        labels = _dt((Bn,), torch.int32, mesh, P(dp))
        fn = train_factories.make_gnn_sampled_step(
            dataclasses.replace(cfg, sample_sizes=(f1, f2)), opt
        )
        return Cell(
            spec.arch_id, shape.name, "train", fn,
            (state, seed, hop1, hop2, labels),
            model_flops=3.0 * Bn * (1 + f1 + f1 * f2) * dense_flops,
        )
    # batched_graphs (molecule)
    Bg, Nn, Ne = sz["batch"], sz["n_nodes"], sz["n_edges"]
    N, E = Bg * Nn, Bg * Ne
    feats = _dt((N, sz["d_feat"]), torch.float32, mesh, P(dp, None))
    ei = _dt((2, E), torch.int32, mesh, P(None, dp))
    gids = _dt((N,), torch.int32, mesh, P(dp))
    labels = _dt((Bg,), torch.int32, mesh, P(dp))
    base_step = train_factories.make_gnn_batched_graphs_step(cfg, opt)

    def fn2(state, feats, ei, gids, labels):
        return base_step(state, feats, ei, gids, labels, Bg)

    return Cell(
        spec.arch_id, shape.name, "train", fn2,
        (state, feats, ei, gids, labels),
        model_flops=3.0 * (N * dense_flops + 2 * E * sz["d_feat"]),
    )


# --------------------------------------------------------------------------
# recsys cells
# --------------------------------------------------------------------------
def _recsys_batch_sds(cfg, B, mesh, with_label=True):
    dp = fsdp_axes(mesh)
    bspec = P(dp) if B > 1 else P(None)
    bspec2 = P(dp, None) if B > 1 else P(None, None)
    i32 = torch.int32
    if cfg.kind == "dien":
        out = {
            "hist_items": _dt((B, cfg.seq_len), i32, mesh, bspec2),
            "hist_cats": _dt((B, cfg.seq_len), i32, mesh, bspec2),
            "target_item": _dt((B,), i32, mesh, bspec),
            "target_cat": _dt((B,), i32, mesh, bspec),
        }
    elif cfg.kind == "bert4rec":
        out = {
            "items": _dt((B, cfg.seq_len), i32, mesh, bspec2),
            "positions": _dt((B, cfg.n_masked), i32, mesh, bspec2),
        }
        if with_label:
            out["labels"] = _dt((B, cfg.n_masked), i32, mesh, bspec2)
    elif cfg.kind == "xdeepfm":
        ns = cfg.n_fields - cfg.n_multi_hot
        out = {
            "single_ids": _dt((B, ns), i32, mesh, bspec2),
            "multi_ids": _dt(
                (B, cfg.n_multi_hot, cfg.max_bag), i32, mesh,
                P(dp, None, None) if B > 1 else P(None, None, None),
            ),
        }
    else:  # bst
        out = {
            "hist_items": _dt((B, cfg.seq_len), i32, mesh, bspec2),
            "target_item": _dt((B,), i32, mesh, bspec),
        }
    if with_label and cfg.kind != "bert4rec":
        out["label"] = _dt((B,), i32, mesh, bspec)
    return out


_TABLES = ("item_embed", "cat_embed", "embed", "linear")


def _recsys_dense_params(cfg) -> int:
    from repro_torch.models import recsys as recsys_mod

    return sum(math.prod(s) for path, s in flat_leaves(recsys_mod.param_shapes(cfg)).items()
               if path.rsplit(".", 1)[-1] not in _TABLES)


def _recsys_flops(cfg, B) -> float:
    dense = _recsys_dense_params(cfg)
    if cfg.kind == "dien":
        gru = 2 * (3 * (2 * cfg.embed_dim) * cfg.gru_dim + 3 * cfg.gru_dim ** 2)
        return B * (2 * cfg.seq_len * 2 * gru + 2 * dense)
    if cfg.kind in ("bert4rec", "bst"):
        S = cfg.seq_len + (1 if cfg.kind == "bst" else 0)
        # blocks applied per position + attention S² term
        e = cfg.embed_dim
        blk = cfg.n_blocks * (2 * S * (4 * e * e + 8 * e * e) + 4 * S * S * e)
        return B * (blk + 2 * dense)
    return B * 2 * dense  # xdeepfm: CIN+MLP params each used once per example


def _recsys_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models import recsys as recsys_mod

    cfg = spec.model
    dp = fsdp_axes(mesh)
    model, shapes, specs = _tree_model(recsys_mod.Ranker, cfg, recsys_param_specs,
                                       recsys_mod.param_shapes, mesh)

    if shape.kind == "train":
        B = shape.sizes["batch"]
        opt, opt_name = train_factories.pick_optimizer(0)
        ostate = _opt_state(opt_name, model.param_tree(), mesh, flat_leaves(specs),
                            flat_leaves(shapes))
        batch = _recsys_batch_sds(cfg, B, mesh, with_label=True)
        fn = train_factories.make_recsys_train_step(cfg, opt)
        return Cell(
            spec.arch_id, shape.name, "train", fn,
            ((model, ostate), batch),
            model_flops=3.0 * _recsys_flops(cfg, B),
        )
    if shape.kind == "serve":
        B = shape.sizes["batch"]
        batch = _recsys_batch_sds(cfg, B, mesh, with_label=False)
        if cfg.kind == "bert4rec":
            fn = _no_grad(lambda p, b: recsys_mod.bert4rec_logits(p, b["items"], b["positions"], cfg))
        else:
            fn = functools.partial(_no_grad(recsys_mod.FORWARD_FNS[cfg.kind]), cfg=cfg)
        return Cell(
            spec.arch_id, shape.name, "serve", fn, (model, batch),
            model_flops=_recsys_flops(cfg, B),
        )
    # retrieval: one context × n_candidates
    C = shape.sizes["n_candidates"]
    batch = _recsys_batch_sds(cfg, 1, mesh, with_label=False)
    cands = _dt((C,), torch.int32, mesh, P(dp))
    fn = functools.partial(_no_grad(recsys_mod.retrieval_scores), cfg=cfg)
    flops = 2.0 * C * cfg.embed_dim if cfg.kind != "xdeepfm" else _recsys_flops(cfg, C)
    return Cell(
        spec.arch_id, shape.name, "retrieval", fn, (model, batch, cands),
        model_flops=flops,
    )


# --------------------------------------------------------------------------
# cooc cells (the paper's workload)
# --------------------------------------------------------------------------
def _cooc_cell(spec: ArchSpec, shape: ShapeSpec, mesh, overrides: dict | None = None) -> Cell:
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.distributed import distributed_gram
    from repro_torch.kernels import ops as kops

    cfg = dataclasses.replace(spec.model, **(overrides or {}))
    dp = fsdp_axes(mesh)
    if shape.kind == "cooc_gram":
        D, H = shape.sizes["doc_chunk"], shape.sizes["head"]
        if overrides and "doc_chunk" in overrides:
            D = cfg.doc_chunk
        B = _dt((D, H), getattr(torch, cfg.dtype), mesh, P(dp, "model"))
        # each rank's strip of C comes back as its local block (rows
        # model-major, a layout DTensor's placements do not name)
        fn = local_map(
            functools.partial(distributed_gram, mesh=mesh, schedule=cfg.schedule),
            out_placements=None, in_placements=(placements(P(dp, "model"), mesh),),
            device_mesh=mesh,
        )
        return Cell(
            spec.arch_id, shape.name, "cooc_gram", fn, (B,),
            model_flops=2.0 * D * H * H,
            notes=f"schedule={cfg.schedule}; compute at the int8 peak",
            peak_flops=PEAK_INT8_OPS,
        )
    # cooc_hist: tail LIST-SCAN histogram — each rank's postings, then one
    # all-reduce over the doc axes (GSPMD's form of the replicated output)
    L = shape.sizes["postings_chunk"]
    rows, V = shape.sizes["rows"], shape.sizes["vocab_tile"]
    ids = _dt((L,), torch.int32, mesh, P(dp))
    seg = _dt((L,), torch.int32, mesh, P(dp))
    group = axis_group(mesh, dp)

    def region(i, s):
        import torch.distributed as dist

        hist = kops.segment_hist(i, s, num_rows=rows, vocab=V)
        dist.all_reduce(hist, group=group)
        return hist

    fn = local_map(region, out_placements=placements(P(), mesh),
                   in_placements=(placements(P(dp), mesh),) * 2, device_mesh=mesh)
    return Cell(
        spec.arch_id, shape.name, "cooc_hist", fn, (ids, seg),
        model_flops=2.0 * L,  # one add per posting
    )


# --------------------------------------------------------------------------
def build_cell(arch_id: str, shape_name: str, mesh, **kw) -> Cell:
    spec = get_spec(arch_id)
    shape = spec.shapes[shape_name]
    make = {
        "lm": _lm_cell,
        "gnn": _gnn_cell,
        "recsys": _recsys_cell,
        "cooc": _cooc_cell,
    }[spec.family]
    if spec.family in ("lm", "cooc"):
        return make(spec, shape, mesh, **kw)
    return make(spec, shape, mesh)


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch × shape) cells + the paper's own 2 cells."""
    return [(arch, name) for arch in list_archs() for name in get_spec(arch).shapes]
