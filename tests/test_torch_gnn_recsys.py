"""The port's GraphSAGE, recsys rankers and graph sampler against the JAX
package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)``; weights are the JAX
package's ``init_params``, carried across as numpy arrays by
``repro_torch.convert.gnn_params_from_numpy`` and
``recsys_params_from_numpy``. Both sides run the smoke configs in float32,
held to ``rtol = atol = 1e-5`` (``TOL``); the sampler is held to equal
arrays. Ids out of range (negative, past a table, past a graph) go through
both sides and must give the same answer, NaN where the reference gives
NaN.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as ref_get_spec
from repro.data import sampler as RS
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro_torch.configs import get_spec
from repro_torch.convert import gnn_params_from_numpy, recsys_params_from_numpy
from repro_torch.data import sampler as S
from repro_torch.device import DeviceError
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models.params import flat_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
RANKERS = ["dien", "bert4rec", "xdeepfm", "bst"]
POINTWISE = ["dien", "xdeepfm", "bst"]
# parameters at full width, counted from the reference's shapes
FULL_PARAMS = {
    "graphsage-reddit": 192_425,
    "dien": 180_339_353,
    "xdeepfm": 432_742_001,
    "bst": 129_359_745,
    "bert4rec": 3_603_072,
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _close(got, want):
    np.testing.assert_allclose(_n(got), np.asarray(want, dtype=np.float32), **TOL)


def _tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------ sampler
@pytest.mark.parametrize("n,deg,seed", [(50, 3, 0), (300, 7, 5), (1000, 1, 2)])
def test_random_graph_equals_the_reference(n, deg, seed):
    mine, ref = S.random_graph(n, deg, seed), RS.random_graph(n, deg, seed)
    assert mine.indptr.dtype == ref.indptr.dtype and mine.indices.dtype == ref.indices.dtype
    np.testing.assert_array_equal(mine.indptr, ref.indptr)
    np.testing.assert_array_equal(mine.indices, ref.indices)
    assert (mine.num_nodes, mine.num_edges) == (ref.num_nodes, ref.num_edges)
    np.testing.assert_array_equal(mine.degree(), ref.degree())


@pytest.mark.parametrize("n,deg,seed", [(50, 3, 0), (300, 7, 5), (1000, 1, 2), (20_000, 50, 1)])
def test_random_graph_on_device_equals_the_reference(n, deg, seed):
    mine, ref = S.random_graph_on_device(n, deg, seed, "cpu"), RS.random_graph(n, deg, seed)
    assert mine.indptr.dtype == ref.indptr.dtype and mine.indices.dtype == ref.indices.dtype
    np.testing.assert_array_equal(mine.indptr, ref.indptr)
    np.testing.assert_array_equal(mine.indices, ref.indices)


def test_csr_from_edge_index_equals_the_reference():
    rng = np.random.default_rng(3)
    ei = rng.integers(0, 40, (2, 200)).astype(np.int32)
    mine, ref = S.csr_from_edge_index(ei, 45), RS.csr_from_edge_index(ei, 45)
    np.testing.assert_array_equal(mine.indptr, ref.indptr)
    np.testing.assert_array_equal(mine.indices, ref.indices)


def _graph_with_isolated_nodes():
    """Nodes 40-44 have no in-edges: the sampler self-loops them."""
    ei = np.random.default_rng(4).integers(0, 40, (2, 160)).astype(np.int32)
    return ei, 45


@pytest.mark.parametrize("fanout", [1, 4, 9])
def test_sample_neighbors_equals_the_reference(fanout):
    ei, n = _graph_with_isolated_nodes()
    seeds = np.arange(n, dtype=np.int64)
    mine = S.sample_neighbors(S.csr_from_edge_index(ei, n), seeds, fanout,
                              np.random.default_rng(7))
    ref = RS.sample_neighbors(RS.csr_from_edge_index(ei, n), seeds, fanout,
                              np.random.default_rng(7))
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine[40:], np.repeat(seeds[40:, None], fanout, 1))


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (2, 2, 2)])
def test_sample_blocks_equals_the_reference(fanouts):
    g, rg = S.random_graph(500, 6, seed=1), RS.random_graph(500, 6, seed=1)
    seeds = np.random.default_rng(0).choice(500, 32, replace=False)
    mine = S.sample_blocks(g, seeds, fanouts, np.random.default_rng(11))
    ref = RS.sample_blocks(rg, seeds, fanouts, np.random.default_rng(11))
    assert len(mine) == len(ref) == len(fanouts) + 1
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ registry, shapes
@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_param_shapes_and_counts_at_full_width(arch):
    """Analytic, at full width: nothing is allocated."""
    cfg, ref_cfg = get_spec(arch).model, ref_get_spec(arch).model
    mod, ref_mod = (G, RG) if arch.startswith("graphsage") else (R, RR)
    shapes = mod.param_shapes(cfg)
    assert shapes == ref_mod.param_shapes(ref_cfg)
    assert sum(math.prod(s) for s in flat_leaves(shapes).values()) == FULL_PARAMS[arch]


def _gnn_setup(seed=0):
    cfg, ref_cfg = get_spec("graphsage-reddit").smoke(), ref_get_spec("graphsage-reddit").smoke()
    ref_params = RG.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return cfg, ref_cfg, ref_params, gnn_params_from_numpy(_tree(ref_params), cfg, "cpu")


def _recsys_setup(arch, seed=0):
    cfg, ref_cfg = get_spec(arch).smoke(), ref_get_spec(arch).smoke()
    ref_params = RR.init_params(jax.random.PRNGKey(seed), ref_cfg)
    # BERT4Rec's [MASK] row, BST's biases and norms: init leaves zeros and
    # ones; perturb every leaf so that each one matters to the outputs
    leaves, treedef = jax.tree.flatten(ref_params)
    rng = np.random.default_rng(seed + 100)
    leaves = [np.asarray(a) + (rng.normal(size=a.shape) * 0.05).astype(np.float32)
              for a in leaves]
    ref_params = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves])
    return cfg, ref_cfg, ref_params, recsys_params_from_numpy(_tree(ref_params), cfg, "cpu")


# ------------------------------------------------------------ gathers
def test_take_rows_and_take_along_fill_as_jax_does():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(6, 3)).astype(np.float32)
    idx = np.array([[0, 5, -1, -6], [6, -7, 2, 100]], np.int32)
    np.testing.assert_array_equal(_n(L.take_rows(_t(table), _t(idx))),
                                  np.asarray(jnp.take(table, idx, axis=0)))
    x = rng.normal(size=(2, 4, 3)).astype(np.float32)
    pos = np.array([[0, -1, 4], [3, -5, 1]], np.int32)[..., None]
    np.testing.assert_array_equal(_n(L.take_along(_t(x), _t(pos), 1)),
                                  np.asarray(jnp.take_along_axis(x, pos, axis=1)))


def test_clip_rows_and_segment_sum_as_jax_does():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(5, 2)).astype(np.float32)
    idx = np.array([-1, -6, 5, 7, 2, 0], np.int32)
    np.testing.assert_array_equal(_n(L.clip_rows(_t(h), _t(idx))), np.asarray(jnp.asarray(h)[idx]))
    data = rng.normal(size=(6, 2)).astype(np.float32)
    seg = np.array([-1, 0, 4, 5, 3, 0], np.int32)
    _close(L.segment_sum(_t(data), _t(seg), 5), jax.ops.segment_sum(data, seg, num_segments=5))


# ------------------------------------------------------------ GNN
def _edges(rng, n, e, out_of_range):
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    if out_of_range:  # src wraps or clamps, dst drops: the reference's rules
        ei[:, :6] = [[-1, -n - 3, n, n + 7, 0, 1], [2, 3, 4, -1, n, n + 2]]
    return ei


@pytest.mark.parametrize("chunk", ["one chunk", "chunks of 7 edges"])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_forward_full_graph(out_of_range, chunk, monkeypatch):
    if chunk != "one chunk":  # the message sum, EDGE_CHUNK edges at a time
        monkeypatch.setattr(G, "EDGE_CHUNK", 7)
    cfg, ref_cfg, ref_params, model = _gnn_setup()
    rng = np.random.default_rng(2)
    n = 40
    feats = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    ei = _edges(rng, n, 150, out_of_range)
    want = jax.jit(RG.forward_full_graph, static_argnums=3)(ref_params, feats, ei, ref_cfg)
    got = G.forward_full_graph(model, _t(feats), _t(ei), cfg)
    assert got.shape == (n, cfg.n_classes)
    _close(got, want)


def _sampled_inputs(cfg, B=8, seed=3):
    g = S.random_graph(200, 5, seed=seed)
    feats = np.random.default_rng(seed).normal(size=(200, cfg.d_in)).astype(np.float32)
    blocks = S.sample_blocks(g, np.arange(B), cfg.sample_sizes, np.random.default_rng(seed))
    return [feats[b] for b in blocks]


def test_forward_sampled():
    cfg, ref_cfg, ref_params, model = _gnn_setup(1)
    seed_f, hop1, hop2 = _sampled_inputs(cfg)
    want = RG.forward_sampled(ref_params, seed_f, hop1, hop2, ref_cfg)
    got = G.forward_sampled(model, _t(seed_f), _t(hop1), _t(hop2), cfg)
    assert got.shape == (8, cfg.n_classes)
    _close(got, want)


def _molecules(rng, cfg, n_graphs=6, nodes=7, edges=12, out_of_range=False):
    n = n_graphs * nodes
    feats = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    base = np.repeat(np.arange(n_graphs) * nodes, edges)
    ei = (rng.integers(0, nodes, (2, n_graphs * edges)) + base).astype(np.int32)
    gid = np.repeat(np.arange(n_graphs), nodes).astype(np.int32)
    if out_of_range:  # pooled nodes of ids -1 and n_graphs drop
        gid[[0, 9]] = [-1, n_graphs]
    return feats, ei, gid


@pytest.mark.parametrize("out_of_range", [False, True])
def test_forward_batched_graphs(out_of_range):
    cfg, ref_cfg, ref_params, model = _gnn_setup(2)
    feats, ei, gid = _molecules(np.random.default_rng(4), cfg, out_of_range=out_of_range)
    want = RG.forward_batched_graphs(ref_params, feats, ei, gid, ref_cfg, 6)
    got = G.forward_batched_graphs(model, _t(feats), _t(ei), _t(gid), cfg, 6)
    assert got.shape == (6, cfg.n_classes)
    _close(got, want)


@pytest.mark.parametrize("which", ["full_graph", "sampled", "batched_graphs"])
def test_gnn_losses(which):
    cfg, ref_cfg, ref_params, model = _gnn_setup(3)
    rng = np.random.default_rng(5)
    if which == "full_graph":
        feats = rng.normal(size=(30, cfg.d_in)).astype(np.float32)
        ei = _edges(rng, 30, 90, False)
        labels = rng.integers(0, cfg.n_classes, 30).astype(np.int32)
        mask = (rng.random(30) < 0.5).astype(np.float32)
        want = RG.loss_full_graph(ref_params, feats, ei, labels, mask, ref_cfg)
        got = G.loss_full_graph(model, _t(feats), _t(ei), _t(labels), _t(mask), cfg)
    elif which == "sampled":
        arrays = _sampled_inputs(cfg)
        labels = rng.integers(0, cfg.n_classes, 8).astype(np.int32)
        want = RG.loss_sampled(ref_params, *arrays, labels, ref_cfg)
        got = G.loss_sampled(model, *map(_t, arrays), _t(labels), cfg)
    else:
        feats, ei, gid = _molecules(rng, cfg)
        labels = rng.integers(0, cfg.n_classes, 6).astype(np.int32)
        want = RG.loss_batched_graphs(ref_params, feats, ei, gid, labels, ref_cfg, 6)
        got = G.loss_batched_graphs(model, _t(feats), _t(ei), _t(gid), _t(labels), cfg, 6)
    assert got.shape == () and torch.isfinite(got)
    _close(got, want)


def test_gnn_init_params_follows_the_reference_rule():
    cfg = dataclasses.replace(get_spec("graphsage-reddit").model, d_in=256)
    model = G.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = dict(model.named_parameters())
    assert set(p) == set(flat_leaves(G.param_shapes(cfg)))
    assert torch.equal(p["layer0.b"], torch.zeros(cfg.d_hidden))
    assert torch.equal(p["head.b"], torch.zeros(cfg.n_classes))
    for name, fan_in in (("layer0.w_self", 256), ("layer1.w_neigh", 128), ("head.w", 128)):
        assert abs(p[name].std().item() * fan_in ** 0.5 - 1.0) < 0.1, name
    again = G.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# ------------------------------------------------------------ recsys layers
@pytest.mark.parametrize("mode", ["lookup", "sum", "mean"])
def test_embedding_lookup_and_bag_with_pad_and_out_of_range_ids(mode):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(0, 20, (5, 6)).astype(np.int32)
    ids[0, 3:] = -1          # padding
    ids[1, :] = -1           # an empty bag
    ids[2, 1] = 20           # past the table: NaN rows in the reference
    ids[3, 0] = -3           # any negative id is padding
    if mode == "lookup":
        got, want = R.embedding_lookup(_t(table), _t(ids)), RR.embedding_lookup(table, ids)
    else:
        got = R.embedding_bag(_t(table), _t(ids), mode)
        want = RR.embedding_bag(table, ids, mode)
    assert np.isnan(np.asarray(want)).any()
    _close(got, want)


def _gru_params(rng, d_in, H):
    return {"wx": rng.normal(size=(d_in, 3 * H)).astype(np.float32) * 0.3,
            "wh": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.3,
            "b": rng.normal(size=(3 * H,)).astype(np.float32) * 0.1}


def test_gru_states():
    rng = np.random.default_rng(7)
    p = _gru_params(rng, 6, 5)
    xs = rng.normal(size=(3, 9, 6)).astype(np.float32)
    want = jax.jit(RR.gru)(p, xs)
    _close(R.gru({k: _t(v) for k, v in p.items()}, _t(xs)), want)


def test_augru_final_state():
    rng = np.random.default_rng(8)
    p = _gru_params(rng, 6, 5)
    xs = rng.normal(size=(3, 9, 6)).astype(np.float32)
    att = rng.random((3, 9)).astype(np.float32)
    att[0, 5:] = 0  # padded steps keep the state
    want = jax.jit(RR.augru)(p, xs, att)
    _close(R.augru({k: _t(v) for k, v in p.items()}, _t(xs), _t(att)), want)


def test_cin():
    rng = np.random.default_rng(9)
    B, F_, D = 4, 5, 3
    layers = [{"w": rng.normal(size=(F_ * F_, 6)).astype(np.float32)},
              {"w": rng.normal(size=(6 * F_, 4)).astype(np.float32)}]
    x0 = rng.normal(size=(B, F_, D)).astype(np.float32)
    want = RR._cin(layers, x0)
    got = R._cin([{"w": _t(p["w"])} for p in layers], _t(x0))
    assert got.shape == (B, 10)
    _close(got, want)


# ------------------------------------------------------------ recsys models
def _batch(arch, cfg, B=6, seed=0, out_of_range=False) -> dict:
    """A batch of the kind's inputs, ids drawn in range with padding; with
    ``out_of_range`` one history id is past the item table."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    if arch == "dien":
        T = cfg.seq_len
        items = rng.integers(0, cfg.n_items, (B, T))
        cats = rng.integers(0, cfg.n_cats, (B, T))
        for b in range(B):  # right padding of random length
            cut = rng.integers(T // 2, T + 1)
            items[b, cut:] = cats[b, cut:] = -1
        if out_of_range:
            items[1, 0] = cfg.n_items + 5
        return {"hist_items": i32(items), "hist_cats": i32(cats),
                "target_item": i32(rng.integers(0, cfg.n_items, B)),
                "target_cat": i32(rng.integers(0, cfg.n_cats, B)),
                "label": i32(rng.integers(0, 2, B))}
    if arch == "bst":
        items = rng.integers(0, cfg.n_items, (B, cfg.seq_len))
        items[0, -3:] = -1
        if out_of_range:
            items[1, 0] = cfg.n_items
        return {"hist_items": i32(items),
                "target_item": i32(rng.integers(0, cfg.n_items, B)),
                "label": i32(rng.integers(0, 2, B))}
    if arch == "bert4rec":
        S_, M = cfg.seq_len, cfg.n_masked
        items = rng.integers(0, cfg.n_items, (B, S_))
        items[0, :4] = -1
        positions = np.stack([rng.choice(S_, M, replace=False) for _ in range(B)])
        labels = items[np.arange(B)[:, None], positions].copy()
        items[np.arange(B)[:, None], positions] = cfg.n_items  # [MASK]
        labels[:, -1] = -1  # some positions carry no label
        if out_of_range:
            items[1, 1] = cfg.n_items + 1
        return {"items": i32(items), "positions": i32(positions), "labels": i32(labels)}
    n_single = cfg.n_fields - cfg.n_multi_hot
    vocabs = np.asarray(cfg.field_vocabs)
    single = rng.integers(0, vocabs[:n_single], (B, n_single))
    multi = rng.integers(0, vocabs[n_single:, None], (B, cfg.n_multi_hot, cfg.max_bag))
    multi[:, :, -1] = -1
    multi[0, 0, :] = -1  # an empty bag
    if out_of_range:
        multi[1, -1, 0] = vocabs[-1]  # past the last field: past the table
    return {"single_ids": i32(single), "multi_ids": i32(multi),
            "label": i32(rng.integers(0, 2, B))}


def _torch_batch(batch) -> dict:
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("arch", POINTWISE)
def test_ranker_forward(arch, out_of_range):
    cfg, ref_cfg, ref_params, model = _recsys_setup(arch)
    batch = _batch(arch, cfg, out_of_range=out_of_range)
    want = jax.jit(RR.FORWARD_FNS[arch], static_argnums=2)(ref_params, batch, ref_cfg)
    got = R.FORWARD_FNS[arch](model, _torch_batch(batch), cfg)
    assert got.shape == (6,)
    assert np.isnan(np.asarray(want)).any() == out_of_range
    _close(got, want)


@pytest.mark.parametrize("arch", ["dien", "bst"])
def test_user_vectors(arch):
    cfg, ref_cfg, ref_params, model = _recsys_setup(arch, 1)
    batch = _batch(arch, cfg, seed=1)
    fn, ref_fn = ((R.dien_user_vector, RR.dien_user_vector) if arch == "dien"
                  else (R.bst_user_vector, RR.bst_user_vector))
    want = jax.jit(ref_fn, static_argnums=2)(ref_params, batch, ref_cfg)
    got = fn(model, _torch_batch(batch), cfg)
    assert got.shape == (6, cfg.embed_dim)
    _close(got, want)


@pytest.mark.parametrize("out_of_range", [False, True])
def test_bert4rec_encode_and_logits(out_of_range):
    cfg, ref_cfg, ref_params, model = _recsys_setup("bert4rec", 2)
    batch = _batch("bert4rec", cfg, seed=2, out_of_range=out_of_range)
    pos = batch["positions"].copy()
    if out_of_range:  # take_along_axis: -1 counts from the end, S is NaN
        pos[0, :2] = [-1, cfg.seq_len]
    enc = jax.jit(RR.bert4rec_encode, static_argnums=2)(ref_params, batch["items"], ref_cfg)
    _close(R.bert4rec_encode(model, _t(batch["items"]), cfg), enc)
    want = jax.jit(RR.bert4rec_logits, static_argnums=3)(ref_params, batch["items"], pos, ref_cfg)
    got = R.bert4rec_logits(model, _t(batch["items"]), _t(pos), cfg)
    assert got.shape == (6, cfg.n_masked, cfg.n_items) and got.dtype == torch.float32
    _close(got, want)


def test_bert_block_uses_the_tanh_gelu():
    """At an input of 1 the tanh GELU gives 0.841192, the exact one
    0.8413447: the block must follow ``jax.nn.gelu``'s default."""
    cfg, ref_cfg, ref_params, model = _recsys_setup("bst", 3)
    blk, ref_blk = model["blocks"][0], ref_params["blocks"][0]
    h = np.random.default_rng(3).normal(size=(2, cfg.seq_len + 1, cfg.embed_dim))
    h = (h * 3).astype(np.float32)
    _close(R._bert_block(blk, _t(h), cfg.n_heads), RR._bert_block(ref_blk, h, cfg.n_heads))
    assert float(torch.nn.functional.gelu(torch.tensor(1.0), approximate="tanh")) == \
        pytest.approx(float(jax.nn.gelu(1.0)), abs=1e-7)


@pytest.mark.parametrize("arch", RANKERS)
def test_loss_fn(arch):
    cfg, ref_cfg, ref_params, model = _recsys_setup(arch, 4)
    batch = _batch(arch, cfg, seed=4)
    want = jax.jit(RR.loss_fn, static_argnums=2)(ref_params, batch, ref_cfg)
    got = R.loss_fn(model, _torch_batch(batch), cfg)
    assert got.shape == () and torch.isfinite(got)
    _close(got, want)
    own = R.masked_item_loss if arch == "bert4rec" else R.pointwise_loss
    assert torch.equal(own(model, _torch_batch(batch), cfg), got)


@pytest.mark.parametrize("labels", ["all masked", "out of range"])
def test_masked_item_loss_edge_labels(labels):
    """Labels of -1 are gathered (clamped in the port) and masked out;
    an all-masked batch gives 0; a label past the vocab is NaN in both."""
    cfg, ref_cfg, ref_params, model = _recsys_setup("bert4rec", 5)
    batch = _batch("bert4rec", cfg, seed=5)
    if labels == "all masked":
        batch["labels"][:] = -1
    else:
        batch["labels"][2, 0] = cfg.n_items
    want = RR.masked_item_loss(ref_params, batch, ref_cfg)
    got = R.masked_item_loss(model, _torch_batch(batch), cfg)
    _close(got, want)
    assert (float(got) == 0.0) if labels == "all masked" else math.isnan(float(got))


@pytest.mark.parametrize("arch", RANKERS)
def test_retrieval_scores(arch):
    cfg, ref_cfg, ref_params, model = _recsys_setup(arch, 6)
    batch = {k: v[:1] for k, v in _batch(arch, cfg, seed=6).items()}
    rows = cfg.field_vocabs[0] if arch == "xdeepfm" else cfg.n_items
    cands = np.random.default_rng(6).integers(0, rows, 50).astype(np.int32)
    # past the table: clamped to its last row; -1 counts from the end
    cands[:3] = [rows + 40, -1, rows - 1]
    want = jax.jit(RR.retrieval_scores, static_argnums=3)(ref_params, batch, cands, ref_cfg)
    got = R.retrieval_scores(model, _torch_batch(batch), _t(cands), cfg)
    assert got.shape == (50,) and got.dtype == torch.float32
    _close(got, want)


# ------------------------------------------------------------ init, converters
@pytest.mark.parametrize("arch", RANKERS)
def test_recsys_init_params_follows_the_reference_rule(arch):
    cfg = get_spec(arch).smoke()
    model = R.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = dict(model.named_parameters())
    assert set(p) == set(flat_leaves(R.param_shapes(cfg)))
    for name, t in p.items():
        leaf = name.rsplit(".", 1)[-1]
        if "ln" in leaf:
            assert torch.equal(t, torch.ones_like(t)), name
        elif leaf in ("b", "b_in", "b_out", "linear"):
            assert torch.equal(t, torch.zeros_like(t)), name
        elif t.numel() >= 400:  # normal · min(fan_in^-1/2, 0.05)
            scale = min(t.shape[0] ** -0.5, 0.05)
            assert abs(t.std().item() / scale - 1.0) < 0.15, name
    again = R.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", RANKERS + ["graphsage-reddit"])
def test_converters_keep_every_leaf_under_its_name(arch):
    if arch.startswith("graphsage"):
        _, _, ref_params, model = _gnn_setup()
    else:
        _, _, ref_params, model = _recsys_setup(arch)
    want = flat_leaves(_tree(ref_params))
    got = {k: _n(v) for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped", "short list"])
@pytest.mark.parametrize("arch", ["dien", "xdeepfm", "graphsage-reddit"])
def test_converters_raise_on_a_bad_tree(arch, fault):
    gnn_arch = arch.startswith("graphsage")
    cfg = get_spec(arch).smoke()
    if gnn_arch:
        tree = _tree(RG.init_params(jax.random.PRNGKey(0), ref_get_spec(arch).smoke()))
        convert, group = gnn_params_from_numpy, "layer1"
    else:
        tree = _tree(RR.init_params(jax.random.PRNGKey(0), ref_get_spec(arch).smoke()))
        convert, group = recsys_params_from_numpy, "mlp"
    match = {"missing": "missing", "extra": "extra", "misshaped": "shape",
             "short list": "missing"}[fault]
    if fault == "missing":
        del tree[group]
    elif fault == "extra":
        tree["bonus"] = np.zeros(3, np.float32)
    elif fault == "misshaped":
        key = "head" if gnn_arch else "mlp"
        leaf = tree[key] if gnn_arch else tree[key][0]
        leaf["w"] = leaf["w"][:, :-1]
    elif gnn_arch:
        del tree["layer1"]["b"]
    else:
        tree["mlp"] = tree["mlp"][:-1]
    with pytest.raises(ValueError, match=match):
        convert(tree, cfg, "cpu")


@pytest.mark.parametrize("make", ["gnn init", "recsys init", "gnn convert", "recsys convert",
                                  "device graph"])
def test_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    gen = torch.Generator()
    with pytest.raises(DeviceError):
        if make == "gnn init":
            G.init_params(get_spec("graphsage-reddit").smoke(), gen)
        elif make == "recsys init":
            R.init_params(get_spec("bst").smoke(), gen)
        elif make == "device graph":
            S.random_graph_on_device(50, 3)
        elif make == "gnn convert":
            _, _, ref_params, _ = _gnn_setup()
            gnn_params_from_numpy(_tree(ref_params), get_spec("graphsage-reddit").smoke())
        else:
            _, _, ref_params, _ = _recsys_setup("bst")
            recsys_params_from_numpy(_tree(ref_params), get_spec("bst").smoke())
