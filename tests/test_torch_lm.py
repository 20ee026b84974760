"""The port's LM modules against the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)``; weights are the JAX
package's ``init_params`` (or ``init_ffn``/``init_moe``), carried across as
numpy arrays by ``repro_torch.convert.lm_params_from_numpy``. Both sides
run in float32, held to ``rtol = atol = 1e-4`` (``TOL``); the one bfloat16
case states its own tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as ref_get_spec
from repro.configs import list_archs as ref_list_archs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_spec, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's functions, compiled once per shape (eager JAX dispatches
# every op of the attention loops and the layer scan on its own)
ref_blocked_attention = jax.jit(
    RL.blocked_attention, static_argnames=("causal", "q_chunk", "kv_chunk", "scale"))
ref_forward = jax.jit(RT.forward, static_argnums=2)
ref_prefill = jax.jit(RT.prefill, static_argnums=2)
ref_decode_step = jax.jit(RT.decode_step, static_argnums=4)
ref_init_params = jax.jit(RT.init_params, static_argnums=1)
LM_ARCHS = [
    "deepseek-v3-671b",
    "olmoe-1b-7b",
    "qwen1.5-110b",
    "minicpm3-4b",
    "nemotron-4-340b",
]
GNN_RECSYS_ARCHS = ["graphsage-reddit", "dien", "bert4rec", "xdeepfm", "bst"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_n(got), np.asarray(want, dtype=np.float32), **(tol or TOL))


# ------------------------------------------------------------ configs
def _same_fields(cfg, ref_cfg) -> bool:
    """Every field of the port's config equals the reference's, and every
    reference field the port leaves out is at its default (a config that
    set one would be ignored by the port)."""
    ref_fields = {f.name: f.default for f in dataclasses.fields(ref_cfg)}
    ours = {f.name for f in dataclasses.fields(cfg)}
    return (ours <= set(ref_fields)
            and all(getattr(cfg, n) == getattr(ref_cfg, n) for n in ours)
            and all(getattr(ref_cfg, n) == d for n, d in ref_fields.items()
                    if n not in ours))


def test_registry_has_the_reference_archs_but_the_cooc_config():
    """Every reference arch is registered, the co-occurrence config too
    (it came with the dry run); an unknown id names the ones there are."""
    assert list_archs() == sorted(ref_list_archs())
    assert get_spec("cooc-wt10g").family == "cooc"
    with pytest.raises(KeyError, match="olmoe-1b-7b"):
        get_spec("cooc-wt9g")


@pytest.mark.parametrize("arch", LM_ARCHS + GNN_RECSYS_ARCHS)
def test_configs_are_copies_of_the_reference(arch):
    mine, ref = get_spec(arch), ref_get_spec(arch)
    assert (mine.arch_id, mine.family, mine.notes) == (ref.arch_id, ref.family, ref.notes)
    for cfg, ref_cfg in ((mine.model, ref.model), (mine.smoke(), ref.smoke())):
        assert _same_fields(cfg, ref_cfg)
    assert {k: dataclasses.astuple(v) for k, v in mine.shapes.items()} == {
        k: dataclasses.astuple(v) for k, v in ref.shapes.items()
    }


def test_cooc_config_is_a_copy_of_the_reference_but_its_dtype():
    """Every field of ``cooc-wt10g``'s config and of its smoke config, its
    shapes and notes are the reference's. The one difference is ``dtype``,
    on purpose: the port's Gram takes uint8 0/1 incidence and counts in
    exact int32 (``core/distributed.py``), where the reference multiplies
    bfloat16 (float32 in the smoke config)."""
    mine, ref = get_spec("cooc-wt10g"), ref_get_spec("cooc-wt10g")
    assert (mine.arch_id, mine.family, mine.notes) == (ref.arch_id, ref.family, ref.notes)
    for cfg, ref_cfg, ref_dtype in ((mine.model, ref.model, "bfloat16"),
                                    (mine.smoke(), ref.smoke(), "float32")):
        assert [f.name for f in dataclasses.fields(cfg)] == [
            f.name for f in dataclasses.fields(ref_cfg)]
        assert dataclasses.astuple(dataclasses.replace(cfg, dtype=ref_cfg.dtype)) == (
            dataclasses.astuple(ref_cfg))
        assert (cfg.dtype, ref_cfg.dtype) == ("uint8", ref_dtype)
    assert {k: dataclasses.astuple(v) for k, v in mine.shapes.items()} == {
        k: dataclasses.astuple(v) for k, v in ref.shapes.items()
    }


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shapes_and_counts_equal_the_reference(arch):
    """Analytic, at full width: nothing is allocated."""
    cfg, ref_cfg = get_spec(arch).model, ref_get_spec(arch).model
    assert T.param_shapes(cfg) == RT.param_shapes(ref_cfg)
    assert cfg.num_params() == ref_cfg.num_params()
    assert cfg.num_active_params() == ref_cfg.num_active_params()


def test_full_widths_of_the_two_single_card_models():
    assert get_spec("minicpm3-4b").model.num_params() == 4_261_902_848
    assert get_spec("olmoe-1b-7b").model.num_params() == 6_919_100_416


# ------------------------------------------------------------ layers
def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _normal(rng, 3, 5, 16, scale=3.0), _normal(rng, 16)
    _close(L.rms_norm(_t(scale), _t(x)), RL.rms_norm(jnp.asarray(scale), jnp.asarray(x)))


@pytest.mark.parametrize("shape,theta", [((2, 7, 3, 16), 10_000.0), ((2, 7, 8), 1e6)])
def test_apply_rope(shape, theta):
    rng = np.random.default_rng(1)
    x = _normal(rng, *shape)
    pos = np.arange(5, 12, dtype=np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(L.apply_rope(_t(x), _t(pos), theta), want)
    np.testing.assert_array_equal(_n(L.rope_freqs(shape[-1], theta)),
                                  RL.rope_freqs(shape[-1], theta).astype(np.float32))


@pytest.mark.parametrize(
    "causal,Sq,Sk,H,K,q_chunk,kv_chunk,scale",
    [
        (True, 33, 33, 8, 2, 8, 8, None),       # ragged last chunk, K < H
        (True, 33, 33, 4, 4, 16, 5, 0.3),       # unequal chunks, custom scale
        (True, 12, 12, 4, 1, 64, 64, None),     # one block, masked diagonal
        (False, 20, 37, 8, 2, 6, 8, None),      # Sq != Sk
        (False, 9, 9, 2, 2, 4, 4, 0.05),
    ],
)
def test_blocked_attention(causal, Sq, Sk, H, K, q_chunk, kv_chunk, scale):
    rng = np.random.default_rng(Sq * 100 + Sk)
    B, Dh, Dv = 2, 16, 12
    q, k, v = _normal(rng, B, Sq, H, Dh), _normal(rng, B, Sk, K, Dh), _normal(rng, B, Sk, K, Dv)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale)
    want = ref_blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(L.blocked_attention(_t(q), _t(k), _t(v), **kw), want)


@pytest.mark.parametrize("H,K,pos", [(4, 4, 17), (8, 2, 0), (8, 2, 39)])
def test_decode_attention(H, K, pos):
    rng = np.random.default_rng(pos)
    B, S, Dh = 2, 40, 8
    q, k, v = _normal(rng, B, 1, H, Dh), _normal(rng, B, S, K, Dh), _normal(rng, B, S, K, Dh)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
    _close(L.decode_attention(_t(q), _t(k), _t(v), pos), want)


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_ffn(kind):
    p = RL.init_ffn(jax.random.PRNGKey(3), 32, 48, kind, jnp.float32)
    x = _normal(np.random.default_rng(4), 2, 5, 32)
    want = RL.ffn(p, jnp.asarray(x), kind)
    _close(L.ffn({n: _t(a) for n, a in p.items()}, _t(x), kind), want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_init_ffn_shapes_and_scales(kind):
    p = L.init_ffn(torch.Generator().manual_seed(0), 256, 512, kind, torch.bfloat16, "cpu")
    ref = RL.init_ffn(jax.random.PRNGKey(0), 256, 512, kind, jnp.bfloat16)
    assert {n: (tuple(t.shape), t.dtype) for n, t in p.items()} == {
        n: (a.shape, torch.bfloat16) for n, a in ref.items()}
    for name, fan_in in (("w_in", 256), ("w_out", 512)):  # He: (2 / fan_in)^1/2
        assert abs(p[name].float().std().item() * (fan_in / 2) ** 0.5 - 1) < 0.05


def _dropped(params, x, n_experts, top_k, capacity_factor) -> int:
    """How many (token, choice) pairs exceed their expert's capacity, from
    the reference's own routing."""
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), params["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1), top_k)
    B, S = x.shape[:2]
    cap = int(np.ceil(S * top_k / n_experts * capacity_factor))
    counts = np.stack([np.bincount(r, minlength=n_experts)
                       for r in np.asarray(idx).reshape(B, -1)])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize(
    "capacity_factor,n_shared,kind",
    [(8.0, 0, "swiglu"), (1.25, 0, "swiglu"), (1.25, 1, "swiglu"), (1.25, 0, "squared_relu")],
)
def test_moe_ffn(capacity_factor, n_shared, kind):
    E, k, d = 8, 2, 32
    params = RL.init_moe(jax.random.PRNGKey(5), d, 40, E, n_shared, kind, jnp.float32)
    x = _normal(np.random.default_rng(6), 2, 32, d)
    kw = dict(n_experts=E, top_k=k, capacity_factor=capacity_factor, expert_kind=kind)
    dropped = _dropped(params, x, E, k, capacity_factor)
    if capacity_factor < 2:
        assert dropped > 0, "the case must really drop tokens"
    else:
        assert dropped == 0
    y_ref, aux_ref = jax.jit(functools.partial(RL.moe_ffn, **kw))(params, jnp.asarray(x))
    mine = jax.tree.map(lambda a: _t(a), params)
    y, aux = L.moe_ffn(mine, _t(x), **kw)
    _close(y, y_ref)
    _close(aux, aux_ref)
    y_ep, _ = L.moe_ffn_ep(mine, _t(x), **kw)
    assert torch.equal(y_ep, y)


# ------------------------------------------------------------ models
_SETUPS: dict = {}


def _setup(arch, **overrides):
    """(ref cfg, port cfg, reference params, port model, tokens) of the
    arch's smoke config, shared across this file's tests."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _SETUPS:
        ref_cfg = dataclasses.replace(ref_get_spec(arch).smoke(), **overrides)
        cfg = dataclasses.replace(get_spec(arch).smoke(), **overrides)
        ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
        model = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        _SETUPS[key] = ref_cfg, cfg, ref_params, model, tokens
    return _SETUPS[key]


def _layer0(ref_params, model):
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"])
    return ref_p, model.layers[0].tensors()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward(arch):
    ref_cfg, cfg, ref_params, model, tokens = _setup(arch)
    logits_ref, h_ref, aux_ref = ref_forward(ref_params, jnp.asarray(tokens), ref_cfg)
    with torch.no_grad():
        logits, h, aux = T.forward(model, _t(tokens), cfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 24, cfg.vocab_size)
    _close(logits, logits_ref)
    _close(h, h_ref)
    _close(aux, aux_ref)
    with torch.no_grad():
        assert torch.equal(model(_t(tokens))[0], logits)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_six_decode_steps(arch):
    ref_cfg, cfg, ref_params, model, tokens = _setup(arch)
    P, n_dec = 18, 6
    logits_ref, cache_ref = ref_prefill(ref_params, jnp.asarray(tokens[:, :P]), ref_cfg)
    with torch.no_grad():
        logits, cache = T.prefill(model, _t(tokens[:, :P]), cfg)
    _close(logits, logits_ref)
    assert set(cache) == set(cache_ref)
    for name in cache:
        _close(cache[name], cache_ref[name])

    full_ref = jax.tree.map(
        lambda f, p: jax.lax.dynamic_update_slice(f, p.astype(f.dtype), (0,) * f.ndim),
        RT.init_cache(ref_cfg, 2, P + n_dec), cache_ref,
    )
    full = T.init_cache(cfg, 2, P + n_dec, "cpu")
    for name, t in full.items():
        assert tuple(t.shape) == full_ref[name].shape and t.dtype == cfg.torch_dtype
        t[:, :, :P] = cache[name]
    for step in range(n_dec):
        tok = tokens[:, P + step: P + step + 1]
        logits_ref, full_ref = ref_decode_step(
            ref_params, full_ref, jnp.asarray(tok), jnp.int32(P + step), ref_cfg)
        with torch.no_grad():
            logits, full = T.decode_step(model, full, _t(tok), P + step, cfg)
        _close(logits, logits_ref)
    for name in full:
        _close(full[name], full_ref[name])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b", "qwen1.5-110b", "olmoe-1b-7b"])
def test_decode_paths_of_one_layer(arch):
    """``mla_decode`` / ``gqa_decode`` against the reference's, on layer 0
    with a random cache, at a middle position."""
    ref_cfg, cfg, ref_params, model, _ = _setup(arch)
    ref_p, p = _layer0(ref_params, model)
    rng = np.random.default_rng(7)
    x = _normal(rng, 2, 1, cfg.d_model)
    shapes = T.cache_shapes(cfg, 2, 16)
    cache = {n: _normal(rng, *s[1:]) for n, s in shapes.items()}
    dec, ref_dec = (T.mla_decode, RT.mla_decode) if cfg.attn == "mla" else (
        T.gqa_decode, RT.gqa_decode)
    out_ref, cache_ref = jax.jit(ref_dec, static_argnums=2)(ref_p, jnp.asarray(x), ref_cfg,
                                 {n: jnp.asarray(c) for n, c in cache.items()}, jnp.int32(9))
    with torch.no_grad():
        out, new = dec(p, _t(x), cfg, {n: _t(c) for n, c in cache.items()}, 9)
    _close(out, out_ref)
    for n in cache:
        _close(new[n], cache_ref[n])


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "minicpm3-4b", "olmoe-1b-7b"])
def test_bfloat16_prefill_and_decode(arch):
    """A smoke config under ``dtype="bfloat16"``: weights, activations and
    cache in bf16; norms, softmax, the MoE combine and logits in float32 on
    both sides. The three archs cover GQA with a dense FFN (qwen), the
    absorbed-MLA decode over a bf16 latent cache (minicpm3) and the bf16
    MoE dispatch with its float32 combine (olmoe).

    Held against the reference run op by op (``jax.disable_jit()``), where
    every op rounds its bf16 output as torch's does: tolerance 1e-3
    absolute on logits of magnitude about 3 to 4 (measured: at most 5e-7 on
    each arch).
    Compiled, XLA fuses bf16 elementwise chains and keeps their
    intermediates in float32, which moves these logits by up to 0.037
    against either eager run: a different rounding order, not a fault of
    either side."""
    ref_cfg, cfg, ref_params, model, tokens = _setup(arch, dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in model.parameters())
    tol = dict(rtol=0, atol=1e-3)
    tokens, P = tokens[:, :9], 8  # eager JAX dispatches op by op: keep it short
    with jax.disable_jit():
        last_ref, cache_ref = RT.prefill(ref_params, jnp.asarray(tokens[:, :P]), ref_cfg)
        full_ref = jax.tree.map(
            lambda f, p: jax.lax.dynamic_update_slice(f, p.astype(f.dtype), (0,) * f.ndim),
            RT.init_cache(ref_cfg, 2, P + 1), cache_ref)
        step_ref, _ = RT.decode_step(ref_params, full_ref, jnp.asarray(tokens[:, P:]),
                                     jnp.int32(P), ref_cfg)
    with torch.no_grad():
        last, cache = T.prefill(model, _t(tokens[:, :P]), cfg)
        full = T.init_cache(cfg, 2, P + 1, "cpu")
        for name, t in full.items():
            t[:, :, :P] = cache[name]
        step, _ = T.decode_step(model, full, _t(tokens[:, P:]), P, cfg)
    assert last.dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for t in cache.values())
    _close(last, last_ref, **tol)
    _close(step, step_ref, **tol)


# ------------------------------------------------------------ converter
def test_converter_keeps_every_leaf_under_its_name():
    ref_cfg, cfg, ref_params, model, _ = _setup("deepseek-v3-671b")
    names = dict(model.named_parameters())
    assert {"embed", "final_ln", "out_head", "layers.1.wq" if cfg.attn == "gqa"
            else "layers.1.w_uq", "mtp.proj", "mtp.block.0.router"} <= set(names)
    assert sum(t.numel() for t in names.values()) == cfg.num_params()
    np.testing.assert_array_equal(_n(names["layers.1.moe_w_in"]),
                                  np.asarray(ref_params["layers"]["moe_w_in"][1]))
    np.testing.assert_array_equal(_n(names["mtp.block.0.w_dkv"]),
                                  np.asarray(ref_params["mtp"]["block"]["w_dkv"][0]))


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped"])
def test_converter_raises_on_a_bad_tree(fault):
    _, cfg, ref_params, _, _ = _setup("olmoe-1b-7b")
    tree = jax.tree.map(np.asarray, ref_params)
    tree["layers"] = dict(tree["layers"])
    if fault == "missing":
        del tree["layers"]["router"]
    elif fault == "extra":
        tree["layers"]["bq"] = np.zeros((cfg.n_layers, 4), np.float32)
    else:
        tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="router" if fault == "missing" else
                       "bq" if fault == "extra" else "wq"):
        lm_params_from_numpy(tree, cfg, "cpu")


def test_init_params_follows_the_reference_rule():
    cfg = get_spec("qwen1.5-110b").smoke()
    g = torch.Generator().manual_seed(0)
    model = T.init_params(cfg, g, "cpu")
    p = dict(model.named_parameters())
    assert torch.equal(p["layers.0.ln1"], torch.ones(cfg.d_model))
    assert torch.equal(p["layers.1.bq"], torch.zeros(cfg.n_heads * cfg.d_head))
    # normal · fan_in^-1/2 with fan_in = shape[-2]
    for name, fan_in in (("layers.0.wq", cfg.d_model), ("embed", cfg.vocab_size),
                         ("out_head", cfg.d_model)):
        assert abs(p[name].std().item() * fan_in ** 0.5 - 1.0) < 0.1
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
