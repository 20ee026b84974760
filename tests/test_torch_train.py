"""The port's training path against the JAX package's, on the CPU.

Gradients of the layer functions (``jax.grad`` against autograd), the LM's
``loss_fn`` with its MTP head, one and three ``make_lm_train_step`` steps
of the five smoke LMs, the GraphSAGE and ranker step factories,
``pick_optimizer``, and ``launch.train_lm`` (resume, device default).
Inputs come from ``np.random.default_rng(seed)``; weights are the JAX
package's, carried across by ``repro_torch.convert``. Float32 throughout,
the reference jitted, held to ``rtol = 1e-5, atol = 1e-6`` (``TOL``);
gradients to ``rtol = 1e-5`` and an atol of 1e-5 of the tensor's largest
element (``_close_grad``: an element that is a cancellation of large terms
keeps their float32 rounding); AdamW's bf16 moments (``pick_optimizer``'s)
within a bf16 ulp a step, save a few elements a leaf
(``assert_bf16_moments``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.configs import get_spec as ref_get_spec
from repro.launch import train as RTR
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import optim as O
from repro_torch.configs import get_spec
from repro_torch.convert import lm_params_from_numpy, opt_state_to_numpy, params_to_numpy
from repro_torch.device import DeviceError
from repro_torch.launch import train as TR
from repro_torch.launch import train_lm
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_gnn_recsys import (
    _batch,
    _edges,
    _gnn_setup,
    _molecules,
    _recsys_setup,
    _sampled_inputs,
)

TOL = dict(rtol=1e-5, atol=1e-6)
LM_ARCHS = ["deepseek-v3-671b", "olmoe-1b-7b", "qwen1.5-110b", "minicpm3-4b", "nemotron-4-340b"]
RANKERS = ["dien", "bert4rec", "xdeepfm", "bst"]


def _t(a, grad=False) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _n(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_n(got), np.asarray(want, np.float32), **(tol or TOL))


def _close_grad(got, want, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_n(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------ layer gradients
@pytest.mark.parametrize("causal,Sq,Sk,H,K,chunk", [
    (True, 24, 24, 4, 2, 8), (True, 20, 20, 4, 4, 7), (False, 9, 13, 2, 1, 4),
])
def test_blocked_attention_gradient(causal, Sq, Sk, H, K, chunk):
    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, 2, Sq, H, 8), _normal(rng, 2, Sk, K, 8), _normal(rng, 2, Sk, K, 6)
    w = _normal(rng, 2, Sq, H, 6)
    kw = dict(causal=causal, q_chunk=chunk, kv_chunk=chunk)

    def ref_loss(q, k, v):
        return jnp.sum(RL.blocked_attention(q, k, v, **kw) * w)

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (L.blocked_attention(tq, tk, tv, **kw) * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close_grad(got, ref)


@pytest.mark.parametrize("capacity_factor,n_shared", [(1.25, 0), (1.25, 1), (8.0, 0)])
def test_moe_ffn_gradient(capacity_factor, n_shared):
    """Through the sort-based dispatch (real drops at 1.25), the router's
    softmax and top-k, the combine and the aux loss."""
    E, k, d = 8, 2, 16
    params = RL.init_moe(jax.random.PRNGKey(5), d, 24, E, n_shared, "swiglu", jnp.float32)
    rng = np.random.default_rng(6)
    x, w = _normal(rng, 2, 32, d), _normal(rng, 2, 32, d)
    kw = dict(n_experts=E, top_k=k, capacity_factor=capacity_factor, expert_kind="swiglu")

    def ref_loss(p, x):
        y, aux = RL.moe_ffn(p, x, **kw)
        return jnp.sum(y * w) + 3.0 * aux

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    mine = jax.tree.map(lambda a: _t(a, True), params)
    tx = _t(x, True)
    y, aux = L.moe_ffn(mine, tx, **kw)
    ((y * _t(w)).sum() + 3.0 * aux).backward()
    _close_grad(tx.grad, want_x)
    for (path, ref), got in zip(jax.tree_util.tree_flatten_with_path(want_p)[0],
                                jax.tree.leaves(mine)):
        _close_grad(got.grad, ref, str(path))


def test_gathers_give_zero_gradient_past_the_table():
    """``take_rows`` / ``take_along`` fill NaN past the table (JAX's
    fill-mode gather): those entries send no gradient. ``clip_rows`` reads
    the clamped row, but JAX's backward scatter drops an index out of
    range, so only in-range (and wrapped negative) indices accumulate;
    ``segment_sum`` drops ids out of range."""
    rng = np.random.default_rng(7)
    table = _normal(rng, 6, 3)
    idx = np.array([[0, 5, -1, -6], [6, -7, 2, 100]], np.int32)
    x = _normal(rng, 2, 5, 3)
    pos = np.array([[0, -1, 4, 9], [3, -6, 1, 1]], np.int32)[..., None]
    rows = np.array([-1, -6, 5, 7, 2, 0, 0], np.int32)
    seg = np.array([-1, 0, 4, 5, 3, 0, 2], np.int32)
    data = _normal(rng, 7, 3)
    w1, w2, w3, w4 = (_normal(rng, *s) for s in ((2, 4, 3), (2, 4, 3), (7, 3), (5, 3)))

    def masked(y, w):
        return jnp.sum(jnp.where(jnp.isnan(y), 0.0, y * w))

    def ref_loss(table, x, data):
        return (masked(jnp.take(table, idx, axis=0), w1)
                + masked(jnp.take_along_axis(x, pos, axis=1), w2)
                + jnp.sum(table[rows] * w3)
                + jnp.sum(jax.ops.segment_sum(data, seg, num_segments=5) * w4))

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(table, x, data)
    tt, tx, td = _t(table, True), _t(x, True), _t(data, True)

    def mine_masked(y, w):
        return torch.where(torch.isnan(y), 0.0, y * _t(w)).sum()

    loss = (mine_masked(L.take_rows(tt, _t(idx)), w1)
            + mine_masked(L.take_along(tx, _t(pos), 1), w2)
            + (L.clip_rows(tt, _t(rows)) * _t(w3)).sum()
            + (L.segment_sum(td, _t(seg), 5) * _t(w4)).sum())
    loss.backward()
    for got, ref in zip((tt.grad, tx.grad, td.grad), want):
        assert torch.isfinite(got).all()
        _close_grad(got, ref)


def test_segment_sum_in_chunks_has_the_same_gradient():
    rng = np.random.default_rng(8)
    h, src = _normal(rng, 9, 4), rng.integers(-2, 11, 40).astype(np.int32)
    dst, w = rng.integers(-1, 10, 40).astype(np.int32), _normal(rng, 9, 4)
    grads = []
    for chunk in (None, 7):
        th = _t(h, True)
        out = L.segment_sum(lambda lo, hi: L.clip_rows(th, _t(src)[lo:hi]), _t(dst), 9, chunk)
        (out * _t(w)).sum().backward()
        grads.append(th.grad)
    want = jax.grad(lambda h: jnp.sum(
        jax.ops.segment_sum(jnp.asarray(h)[src], dst, num_segments=9) * w))(h)
    _close_grad(grads[0], want)
    _close_grad(grads[1], want)


# ------------------------------------------------------------ the LM
_SETUPS: dict = {}


def _setup(arch, **overrides):
    """(ref cfg, port cfg, reference params, tokens) of the arch's smoke
    config, shared across this file's tests."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _SETUPS:
        ref_cfg = dataclasses.replace(ref_get_spec(arch).smoke(), **overrides)
        cfg = dataclasses.replace(get_spec(arch).smoke(), **overrides)
        ref_params = jax.jit(RT.init_params, static_argnums=1)(jax.random.PRNGKey(0), ref_cfg)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        _SETUPS[key] = ref_cfg, cfg, ref_params, tokens
    return _SETUPS[key]


def _model(cfg, ref_params):
    return lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")


def test_ce_gather_equals_the_one_hot_contraction_and_its_gradient():
    rng = np.random.default_rng(9)
    logits, labels = _normal(rng, 2, 5, 11, scale=4), rng.integers(0, 11, (2, 5)).astype(np.int32)
    w = _normal(rng, 2, 5)
    want, want_g = jax.jit(jax.value_and_grad(lambda z: jnp.sum(RT._ce(z, labels) * w)))(logits)
    tl = _t(logits, True)
    got = (T._ce(tl, _t(labels)) * _t(w)).sum()
    got.backward()
    _close(got, want)
    _close_grad(tl.grad, want_g)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_and_every_gradient(arch):
    ref_cfg, cfg, ref_params, tokens = _setup(arch)
    (want, want_m), want_g = jax.jit(
        jax.value_and_grad(RT.loss_fn, has_aux=True), static_argnums=2
    )(ref_params, {"tokens": jnp.asarray(tokens)}, ref_cfg)
    model = _model(cfg, ref_params)
    loss, metrics = T.loss_fn(model, {"tokens": _t(tokens)}, cfg)
    _close(loss, want)
    assert set(metrics) == set(want_m) == ({"ce", "aux", "mtp_ce"} if cfg.mtp else {"ce", "aux"})
    for k in metrics:
        _close(metrics[k], want_m[k])
    params = model.param_tree()
    got = dict(zip(params, TR._grads(loss, params).values()))
    flat_ref = {".".join(str(p.key) for p in path): g
                for path, g in jax.tree_util.tree_flatten_with_path(want_g)[0]}
    assert set(got) == set(flat_ref)
    for name, g in got.items():
        _close_grad(torch.stack(g) if isinstance(g, list) else g, flat_ref[name], name)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "olmoe-1b-7b"])
def test_remat_recomputes_to_the_same_gradients(arch):
    """``cfg.remat`` keeps each block's input only and recomputes it in the
    backward pass: the same loss and the same gradient bits."""
    ref_cfg, cfg, ref_params, tokens = _setup(arch)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = _model(c, ref_params)
        loss, _ = T.loss_fn(model, {"tokens": _t(tokens)}, c)
        out.append((loss, TR._grads(loss, model.param_tree())))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name in g0:
        a, b = g0[name], g1[name]
        assert all(torch.equal(x, y) for x, y in zip(a if isinstance(a, list) else [a],
                                                     b if isinstance(b, list) else [b])), name


# Of a bf16 moment leaf, at most this many elements may stray past a bf16
# ulp a step: an element whose gradients cancel keeps the other
# framework's float32 rounding as its value. Measured after 3 steps of the
# five smoke LMs: at most 9 such elements a leaf (of 98,304), up to 178
# bf16 ulps from the reference, the farthest 8.2e-4 of its leaf's largest
# moment past the ulp bound (qwen1.5-110b's ``wo``).
MOMENT_STRAYS = 16


def assert_bf16_moments(got: np.ndarray, want: np.ndarray, steps: int, name: str):
    """bf16 moments within a bf16 ulp a step (rtol ``steps`` · 2^-7: each
    step rounds them anew), save at most MOMENT_STRAYS elements of the
    leaf, which must be within a further 1e-3 of the leaf's largest
    moment."""
    a, b = got.astype(np.float32), want.astype(np.float32)
    rtol = steps * 2 ** -7
    stray = np.abs(a - b) > rtol * np.abs(b)
    assert stray.sum() <= MOMENT_STRAYS, (name, int(stray.sum()), stray.size)
    np.testing.assert_allclose(a[stray], b[stray], rtol=rtol, atol=1e-3 * np.abs(b).max(),
                               err_msg=name)


def _assert_state(model, opt_state, ref_state, steps):
    tree = params_to_numpy(model)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(ref_state[0])[0]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **TOL)
    st = opt_state_to_numpy(opt_state, model)
    assert int(st["count"]) == int(ref_state[1]["count"]) == steps
    for key in ("m", "v"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(st[key])[0],
                                     jax.tree_util.tree_flatten_with_path(ref_state[1][key])[0]):
            assert a.dtype == np.asarray(b).dtype
            assert_bf16_moments(a, np.asarray(b), steps, str(path))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_three_train_steps_equal_the_reference(arch):
    """``pick_optimizer``'s AdamW (bf16 moments): loss, metrics and
    grad_norm of each step, then params and moments."""
    ref_cfg, cfg, ref_params, tokens = _setup(arch)
    ref_opt, ref_name = RTR.pick_optimizer(ref_cfg.num_params())
    opt, name = TR.pick_optimizer(cfg.num_params())
    assert name == ref_name == "adamw"
    ref_step = jax.jit(RTR.make_lm_train_step(ref_cfg, ref_opt))
    step = TR.make_lm_train_step(cfg, opt)
    ref_state = (ref_params, ref_opt.init(ref_params))
    model = _model(cfg, ref_params)
    state = (model, opt.init(model.param_tree()))
    rng = np.random.default_rng(2)
    for i in range(3):
        batch = tokens if i == 0 else rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        ref_state, want = ref_step(ref_state, {"tokens": jnp.asarray(batch)})
        state, got = step(state, {"tokens": _t(batch)})
        assert state[0] is model
        assert set(got) == set(want)
        for k in want:
            assert got[k].dim() == 0 and not got[k].requires_grad
            _close(got[k], want[k])
    _assert_state(*state, ref_state, 3)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_five_steps_on_one_batch_reduce_the_loss(arch):
    ref_cfg, cfg, ref_params, tokens = _setup(arch)
    opt, _ = TR.pick_optimizer(cfg.num_params())
    model = _model(cfg, ref_params)
    state, step = (model, opt.init(model.param_tree())), TR.make_lm_train_step(cfg, opt)
    losses = []
    for _ in range(5):
        state, metrics = step(state, {"tokens": _t(tokens)})
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], f"{arch}: loss did not decrease: {losses}"


def test_pick_optimizer_switches_at_50e9():
    assert TR.pick_optimizer(49_999_999_999)[1] == RTR.pick_optimizer(49_999_999_999)[1] == "adamw"
    assert TR.pick_optimizer(50_000_000_000)[1] == RTR.pick_optimizer(50_000_000_000)[1] \
        == "adafactor"
    opt, _ = TR.pick_optimizer(10)
    st = opt.init({"w": torch.zeros(3, 2)})
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.bfloat16
    assert "stats" in TR.pick_optimizer(get_spec("nemotron-4-340b").model.num_params())[0].init(
        {"w": torch.zeros(3, 2)})


# ------------------------------------------------------------ GNN and rankers
def _f32_sgd():
    """SGD, whose update is linear in the gradient: AdamW's normalised one
    would turn a tiny gradient element's float32 noise into a whole step."""
    return RO.sgd(0.1), O.sgd(0.1)


@pytest.mark.parametrize("which", ["full_graph", "sampled", "batched_graphs"])
def test_gnn_train_steps_equal_the_reference(which):
    cfg, ref_cfg, ref_params, model = _gnn_setup(4)
    ref_opt, opt = _f32_sgd()
    rng = np.random.default_rng(10)
    if which == "full_graph":
        feats = _normal(rng, 30, cfg.d_in)
        inputs = (feats, _edges(rng, 30, 90, True), rng.integers(0, cfg.n_classes, 30)
                  .astype(np.int32), (rng.random(30) < 0.5).astype(np.float32))
        ref_make, make, static = RTR.make_gnn_full_graph_step, TR.make_gnn_full_graph_step, ()
    elif which == "sampled":
        inputs = (*_sampled_inputs(cfg), rng.integers(0, cfg.n_classes, 8).astype(np.int32))
        ref_make, make, static = RTR.make_gnn_sampled_step, TR.make_gnn_sampled_step, ()
    else:
        feats, ei, gid = _molecules(rng, cfg, out_of_range=True)
        inputs = (feats, ei, gid, rng.integers(0, cfg.n_classes, 6).astype(np.int32), 6)
        ref_make, make = RTR.make_gnn_batched_graphs_step, TR.make_gnn_batched_graphs_step
        static = (5,)
    ref_step = jax.jit(ref_make(ref_cfg, ref_opt), static_argnums=static)
    step = make(cfg, opt)
    ref_state = (ref_params, ref_opt.init(ref_params))
    state = (model, opt.init(model.param_tree()))
    mine = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in inputs)
    for _ in range(2):
        ref_state, want = ref_step(ref_state, *inputs)
        state, got = step(state, *mine)
        assert set(got) == set(want) == {"loss", "grad_norm"}
        for k in want:
            _close(got[k], want[k])
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(params_to_numpy(model))[0],
                                 jax.tree_util.tree_flatten_with_path(ref_state[0])[0]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **TOL)


@pytest.mark.parametrize("arch", RANKERS)
def test_recsys_train_steps_equal_the_reference(arch):
    cfg, ref_cfg, ref_params, model = _recsys_setup(arch, 1)
    ref_opt, opt = _f32_sgd()
    batch = _batch(arch, cfg, B=6, seed=3)
    ref_step = jax.jit(RTR.make_recsys_train_step(ref_cfg, ref_opt))
    step = TR.make_recsys_train_step(cfg, opt)
    ref_state = (ref_params, ref_opt.init(ref_params))
    state = (model, opt.init(model.param_tree()))
    for _ in range(2):
        ref_state, want = ref_step(ref_state, jax.tree.map(jnp.asarray, batch))
        state, got = step(state, {k: _t(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            _close(got[k], want[k])
    tree = params_to_numpy(model)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(ref_state[0])[0]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **TOL)
    # a leaf the loss does not reach (the retrieval head) gets zero gradient
    if "user_proj" in tree:
        assert np.abs(opt_state_to_numpy(state[1], model)["mu"]["user_proj"]).max() == 0


# ------------------------------------------------------------ train_lm
def _args(tmp_path, steps, *extra):
    return ["--steps", str(steps), "--d-model", "32", "--layers", "2", "--batch", "2",
            "--seq", "16", "--vocab", "64", "--ckpt-dir", str(tmp_path), "--device", "cpu",
            *extra]


def test_train_lm_kill_and_resume_continues_the_killed_run(tmp_path, monkeypatch):
    """A run of 120 steps killed after its step-100 checkpoint, then
    resumed, ends where that checkpoint's state taken on in memory ends:
    the checkpoint holds 101 steps (saved after step 100, as the reference
    saves), and the resume replays 100 batches and applies batches 100 to
    119, batch 100 a second time, as the reference's resume does."""
    cosine = train_lm.warmup_cosine
    # the in-memory run: 101 steps, then 20 more from batch 100, all on the
    # killed run's schedule (a cosine over 120 steps)
    monkeypatch.setattr(train_lm, "warmup_cosine", lambda peak, warm, _: cosine(peak, warm, 120))
    state, losses = train_lm.main(_args(tmp_path / "a", 101))
    assert losses[-1] < losses[0]
    (want, _), _ = train_lm.train(train_lm._parser().parse_args(_args(tmp_path / "a", 120)),
                                  state, start=100)
    monkeypatch.setattr(train_lm, "warmup_cosine", cosine)
    stream = train_lm.token_stream

    def dies_after(n):
        def gen(*a, **kw):
            it = stream(*a, **kw)
            for _ in range(n):
                yield next(it)
            raise KeyboardInterrupt
        return gen

    monkeypatch.setattr(train_lm, "token_stream", dies_after(107))
    with pytest.raises(KeyboardInterrupt):
        train_lm.main(_args(tmp_path / "b", 120))
    assert train_lm.latest_step(str(tmp_path / "b")) == 100
    monkeypatch.setattr(train_lm, "token_stream", stream)
    (resumed, opt_state), _ = train_lm.main(_args(tmp_path / "b", 120, "--resume"))
    assert int(opt_state["count"]) == 121
    for (name, a), b in zip(want.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), name


def test_train_lm_numbers_checkpoints_as_the_reference(tmp_path):
    """The reference's ``examples/train_lm.py`` and the port's at the same
    small flags for 60 steps keep the same checkpoints, and under each
    number the same ``extra`` and step count: the mid-run one 50 holds 51
    steps in both."""
    import json
    import os
    import subprocess
    import sys

    flags = ["--steps", "60", "--d-model", "32", "--layers", "2", "--batch", "2", "--seq",
             "16", "--vocab", "64"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "examples/train_lm.py", *flags, "--ckpt-dir",
                    str(tmp_path / "ref")], cwd=root, env=env, check=True,
                   capture_output=True, timeout=600)
    train_lm.main([*flags, "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])

    def steps(directory):
        out = {}
        for name in sorted(os.listdir(directory)):
            with open(os.path.join(directory, name, "manifest.json")) as f:
                manifest = json.load(f)
            rec = next(r for r in manifest["leaves"] if r["name"] == "1/count")
            out[name] = (manifest["extra"], int(np.load(os.path.join(directory, name,
                                                                     rec["file"]))))
        return out

    assert steps(tmp_path / "port") == steps(tmp_path / "ref") == {
        "step_00000050": ({"step": 50}, 51), "step_00000060": ({"step": 60}, 60)}


def test_train_lm_takes_the_reference_flags_and_stream(tmp_path):
    import importlib.util
    import os
    import re

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "train_lm.py")
    with open(path) as f:
        ref_flags = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', f.read()))
    mine = {o for a in train_lm._parser()._actions for o in a.option_strings}
    assert len(ref_flags) == 8 and ref_flags | {"--device"} <= mine
    assert train_lm._parser().parse_args([]).device == "cuda"
    spec = importlib.util.spec_from_file_location("ref_train_lm_example", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    a, b = ref.token_stream(64, 2, 16, seed=1), train_lm.token_stream(64, 2, 16, seed=1)
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(next(a)), next(b))


def test_train_lm_without_a_card_raises_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(DeviceError):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
