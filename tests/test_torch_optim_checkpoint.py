"""The port's optimizers, schedule, clipping, compression and checkpoints
against the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)``. The reference runs
jitted where it computes in float32 and op by op (``jax.disable_jit()``)
where bfloat16 is involved, since compiled XLA keeps fused bf16
intermediates in float32. Tolerances: the schedule bit-equal to the
reference run op by op (within 3 float32 ulps of the compiled one, which
reassociates and fuses the scalar chain); optimizer states and params
``rtol = atol = 1e-6``; bf16 moments within 1 bf16 ulp; bf16 clipping bit-equal;
int8 payloads equal.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as RC
from repro import optim as RO
from repro.configs import get_spec as ref_get_spec
from repro.launch import train as RTR
from repro.models import transformer as RT
from repro.optim import compress as RCP
from repro_torch import checkpoint as C
from repro_torch import optim as O
from repro_torch.configs import get_spec
from repro_torch.convert import (
    lm_params_from_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_to_numpy,
    train_state_tree,
)
from repro_torch.device import DeviceError
from repro_torch.launch import train as TR
from repro_torch.launch import train_lm
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import compress as CP
from test_torch_train import assert_bf16_moments

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RTOL = 1e-6
ATOL = 1e-6  # params and moments are O(1): a float32 ulp or two of a step


def _n(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _bits16(a) -> np.ndarray:
    """bf16 values as int32 of their bits (for ulp distances)."""
    if torch.is_tensor(a):
        return a.detach().view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


# ------------------------------------------------------------ schedule
SCHEDULES = [(3e-4, 2000, 100_000), (3e-4, 20, 250), (1.0, 10, 100)]


@pytest.mark.parametrize("peak,warm,total", SCHEDULES)
@pytest.mark.parametrize("where", ["zero", "one", "warm-up", "mid", "end", "past"])
def test_warmup_cosine_equals_the_reference(peak, warm, total, where):
    count = {"zero": 0, "one": 1, "warm-up": warm, "mid": (warm + total) // 2,
             "end": total, "past": total + 7}[where]
    got = O.warmup_cosine(peak, warm, total)(torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.dim() == 0
    ref = RO.warmup_cosine(peak, warm, total)
    with jax.disable_jit():
        eager = np.asarray(ref(jnp.int32(count)))
    assert got.numpy().view(np.int32) == eager.view(np.int32)
    compiled = np.asarray(jax.jit(ref)(jnp.int32(count)))
    np.testing.assert_array_max_ulp(got.numpy(), compiled, maxulp=3)


# ------------------------------------------------------------ optimizers
def _tree(rng, dtype=np.float32):
    """A reference tree of 1-D, 2-D and 3-D leaves and one stacked over two
    layers, as numpy arrays."""
    return {
        "a": rng.normal(size=(7,)).astype(dtype),
        "b": rng.normal(size=(5, 6)).astype(dtype),
        "c": rng.normal(size=(3, 4, 5)).astype(dtype),
        "layers": {"ln": rng.normal(size=(2, 4)).astype(dtype),
                   "w": rng.normal(size=(2, 4, 3)).astype(dtype)},
    }


def _port(tree: dict) -> dict:
    """The port's flat form: dotted paths, the stacked leaves as slices."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in tree.items() if k != "layers"}
    for k, v in tree["layers"].items():
        out[f"layers.{k}"] = list(torch.from_numpy(np.array(v)).unbind(0))
    return out


def _nested(flat: dict):
    """The port's flat form back as the reference's tree (slices stacked)."""
    out = {"layers": {}}
    for k, v in flat.items():
        v = torch.stack(v) if isinstance(v, list) else v
        if k.startswith("layers."):
            out["layers"][k.split(".", 1)[1]] = v
        else:
            out[k] = v
    return out


def _assert_tree(got_flat, want, **tol):
    got = _nested(got_flat)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        if g.dtype == torch.bfloat16:
            d = np.abs(_bits16(g) - _bits16(w))
            assert d.max() <= 1, (path, d.max())
        else:
            np.testing.assert_allclose(_n(g), np.asarray(w), err_msg=str(path), **tol)


def _schedule_lr(t):
    return 0.5 / jnp.sqrt(t.astype(jnp.float32)) if isinstance(t, jax.Array) else \
        0.5 / torch.sqrt(t.float())


OPTIMIZERS = {
    "sgd": (lambda: RO.sgd(0.05), lambda: O.sgd(0.05), True),
    "sgd-schedule": (lambda: RO.sgd(RO.warmup_cosine(0.1, 2, 10)),
                     lambda: O.sgd(O.warmup_cosine(0.1, 2, 10)), True),
    "adamw": (lambda: RO.adamw(0.05), lambda: O.adamw(0.05), True),
    "adamw-bf16-moments": (lambda: RO.adamw(RO.warmup_cosine(0.05, 2, 10),
                                            moment_dtype=jnp.bfloat16),
                           lambda: O.adamw(O.warmup_cosine(0.05, 2, 10),
                                           moment_dtype=torch.bfloat16), False),
    "adafactor": (lambda: RO.adafactor(_schedule_lr), lambda: O.adafactor(_schedule_lr), True),
    "adafactor-decay": (lambda: RO.adafactor(0.01, weight_decay=0.1),
                        lambda: O.adafactor(0.01, weight_decay=0.1), True),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_five_steps_equal_the_reference(name):
    """Five updates with fresh random grads a step: params after each step
    and the whole state at the end. ``count`` must equal 5."""
    make_ref, make_mine, jit = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    ref_opt, opt = make_ref(), make_mine()
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_opt.init(ref_p)
    p = _port(params)
    s = opt.init(p)

    def ref_step(grads, state, params):
        updates, state = ref_opt.update(grads, state, params)
        return RO.apply_updates(params, updates), state

    if jit:
        ref_step = jax.jit(ref_step)
    for _ in range(5):
        g = _tree(rng)
        if jit:
            ref_p, ref_s = ref_step(jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        else:
            with jax.disable_jit():
                ref_p, ref_s = ref_step(jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        updates, s = opt.update(_port(g), s, p)
        O.apply_updates(p, updates)
        _assert_tree(p, ref_p, rtol=RTOL, atol=ATOL)
    assert int(s["count"]) == int(ref_s["count"]) == 5 and s["count"].dtype == torch.int32
    for key, sub in s.items():
        if key == "count":
            continue
        if key == "stats":
            for leaf, st in sub.items():
                ref_st = ref_s["stats"]
                for part in leaf.split("."):
                    ref_st = ref_st[part]
                assert set(st) == set(ref_st)
                for k in st:
                    np.testing.assert_allclose(_n(st[k]), np.asarray(ref_st[k]), rtol=RTOL)
        else:
            _assert_tree(sub, ref_s[key], rtol=RTOL, atol=ATOL)


def test_adafactor_factors_the_stacked_leaf():
    """A leaf stacked over layers is one leaf: a (2, 4) stack of 1-D norms
    is factored into r (2,) and c (4,), as the reference does."""
    params = _port(_tree(np.random.default_rng(1)))
    stats = O.adafactor(0.1).init(params)["stats"]
    assert stats["layers.ln"]["r"].shape == (2,) and stats["layers.ln"]["c"].shape == (4,)
    assert stats["layers.w"]["r"].shape == (2, 4) and stats["layers.w"]["c"].shape == (2, 3)
    assert set(stats["a"]) == {"v"}
    assert stats["c"]["r"].shape == (3, 4) and stats["c"]["c"].shape == (3, 5)


def test_make_optimizer_names_the_three():
    for name, kind in (("adamw", "m"), ("sgd", "mu"), ("adafactor", "stats")):
        opt = O.optimizers.make_optimizer(name, 0.1)
        assert kind in opt.init({"w": torch.zeros(3, 2)})


# ------------------------------------------------------------ clipping
def test_clip_by_global_norm_on_bf16_leaves_is_bit_equal():
    """Integer-valued bf16 leaves make every square and sum exact, so the
    norm and the scale are the reference's bits; the clip itself must
    scale in float32 and round once (on the card a bf16 tensor times a
    float32 0-dim tensor rounds the scale to bf16 first)."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.integers(-8, 9, (33,)), "b": rng.integers(-8, 9, (6, 7))}
    ref = {k: jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()}
    mine = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for k, v in tree.items()}
    with jax.disable_jit():
        ref_c, ref_norm = RO.clip_by_global_norm(ref, 1.0)
    got, norm = O.clip_by_global_norm(mine, 1.0)
    assert got is mine  # in place
    assert float(norm) == float(ref_norm)
    for k in tree:
        assert mine[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits16(mine[k]), _bits16(ref_c[k]))


@pytest.mark.parametrize("max_norm", [1.0, 0.3, 1e3])
def test_clip_by_global_norm_float32(max_norm):
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    ref, ref_norm = jax.jit(RO.clip_by_global_norm, static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), max_norm)
    got, norm = O.clip_by_global_norm(_port(tree), max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=RTOL)
    _assert_tree(got, ref, rtol=RTOL)
    assert float(O.global_norm(got)) == pytest.approx(min(max_norm, float(ref_norm)), rel=1e-5)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("shape,block", [((1000,), 256), ((33, 7), 64), ((4, 256), 256)])
def test_quantize_int8_equals_the_reference(shape, block):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32) * 3
    x[0] = 0.0
    q, s = CP.quantize_int8(torch.from_numpy(x), block)
    ref_q, ref_s = jax.jit(RCP.quantize_int8, static_argnums=1)(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=RTOL)
    back = CP.dequantize_int8(q, s, shape, block)
    np.testing.assert_allclose(back.numpy(), np.asarray(RCP.dequantize_int8(ref_q, ref_s, shape, block)),
                               rtol=RTOL)


def test_ef_compress_update_ten_steps_equal_the_reference():
    rng = np.random.default_rng(5)
    err, ref_err = torch.zeros((300,)), jnp.zeros((300,))
    ef = jax.jit(RCP.ef_compress_update)
    for _ in range(10):
        g = rng.normal(size=(300,)).astype(np.float32)
        sent, err = CP.ef_compress_update(torch.from_numpy(g), err)
        ref_sent, ref_err = ef(jnp.asarray(g), ref_err)
        np.testing.assert_allclose(sent.numpy(), np.asarray(ref_sent), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(err.numpy(), np.asarray(ref_err), rtol=1e-5, atol=1e-6)


PSUM_RANK = textwrap.dedent(
    """
    import datetime, os, sys
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.optim.compress import compressed_psum
    rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4, timeout=datetime.timedelta(seconds=120))
    x = torch.from_numpy(np.load(os.path.join(d, "x.npy"))[rank])
    np.save(os.path.join(d, f"out_{rank}.npy"), compressed_psum(x, block=64).numpy())
    dist.destroy_process_group()
    """
)

PSUM_REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import numpy as np, jax
    from jax.sharding import PartitionSpec as P
    from repro.optim.compress import compressed_psum
    shard_map = jax.shard_map if hasattr(jax, "shard_map") else \\
        __import__("jax.experimental.shard_map", fromlist=["x"]).shard_map
    d = sys.argv[1]
    x = np.load(os.path.join(d, "x.npy"))
    mesh = jax.make_mesh((4,), ("pod",))
    f = shard_map(lambda v: compressed_psum(v[0], "pod", 64)[None], mesh=mesh,
                  in_specs=P("pod"), out_specs=P("pod"))
    np.save(os.path.join(d, "ref.npy"), np.asarray(jax.jit(f)(x)))
    """
)


def test_compressed_psum_on_four_gloo_ranks_equals_the_reference_shard_map(tmp_path):
    """Each of 4 ranks holds its own (3, 50) gradient; every rank must get
    the reference's int8-wire sum (blocks of 64, so one block is padded),
    and the sum must be within the int8 error of the exact one."""
    import socket

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 3, 50)) * np.array([1, 10, 0.1, 3])[:, None, None]).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ranks = [subprocess.Popen([sys.executable, "-c", PSUM_RANK, str(r), str(port), str(tmp_path)],
                              env=env, stderr=subprocess.PIPE, text=True) for r in range(4)]
    ref = subprocess.run([sys.executable, "-c", PSUM_REFERENCE, str(tmp_path)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    for p in ranks:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = np.load(tmp_path / "ref.npy")
    for r in range(4):
        got = np.load(tmp_path / f"out_{r}.npy")
        assert got.shape == (3, 50)
        np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)
    exact = x.sum(axis=0)
    assert np.abs(want[0] - exact).max() <= 4 * np.abs(x).max() / 127


# ------------------------------------------------------------ checkpoints
def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_a_tree_of_tuples_lists_and_bf16_saves_as_the_reference_does(tmp_path):
    """The same tree through both packages' ``save_checkpoint``: equal
    manifests (names, shapes, logical dtypes, leaf order) and equal leaf
    files, bf16 leaves as their uint16 bits; and each restores the
    other's, bf16 by view."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    m = rng.normal(size=(2, 3, 4)).astype(np.float32)
    idx = rng.integers(0, 9, (11,)).astype(np.int32)
    ref_tree = ({"w": jnp.asarray(w), "blocks": [{"b": jnp.asarray(idx)}]},
                {"m": jnp.asarray(m, jnp.bfloat16), "count": jnp.int32(3)})
    mine = ({"w": torch.from_numpy(w), "blocks": [{"b": torch.from_numpy(idx)}]},
            {"m": C.Stacked(torch.from_numpy(m).to(torch.bfloat16).unbind(0)),
             "count": torch.tensor(3, dtype=torch.int32)})
    RC.save_checkpoint(str(tmp_path / "ref"), 3, ref_tree, extra={"step": 3})
    C.save_checkpoint(str(tmp_path / "mine"), 3, mine, extra={"step": 3})
    a, b = _manifest(tmp_path / "ref", 3), _manifest(tmp_path / "mine", 3)
    assert a == b
    assert [r["name"] for r in a["leaves"]] == ["0/blocks/0/b", "0/w", "1/count", "1/m"]
    assert a["leaves"][3]["dtype"] == "bfloat16"
    for rec in a["leaves"]:
        x = np.load(tmp_path / "ref" / "step_00000003" / rec["file"])
        y = np.load(tmp_path / "mine" / "step_00000003" / rec["file"])
        assert x.dtype == y.dtype and np.array_equal(x, y), rec["name"]
    got, extra = C.restore_checkpoint(str(tmp_path / "ref"), 3, mine)
    assert extra == {"step": 3} and isinstance(got, tuple) and isinstance(got[0]["blocks"], list)
    assert isinstance(got[1]["m"], C.Stacked) and got[1]["m"][0].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(got[1]["m"], mine[1]["m"]))
    assert torch.equal(got[0]["w"], mine[0]["w"]) and int(got[1]["count"]) == 3
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref_tree)
    back, _ = RC.restore_checkpoint(str(tmp_path / "mine"), 3, like)
    assert back[1]["m"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back[1]["m"]).view(np.uint16),
                                  np.asarray(ref_tree[1]["m"]).view(np.uint16))


def test_restore_converts_by_value_after_reading_bf16_bits(tmp_path):
    t = torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)
    C.save_checkpoint(str(tmp_path), 1, {"t": t})
    got, _ = C.restore_checkpoint(str(tmp_path), 1, {"t": torch.zeros(3)})
    assert got["t"].dtype == torch.float32 and torch.equal(got["t"], t.float())
    arr, _ = C.restore_checkpoint(str(tmp_path), 1, {"t": np.zeros(3, np.float64)})
    np.testing.assert_array_equal(arr["t"], t.double().numpy())
    with pytest.raises(ValueError, match="shape"):
        C.restore_checkpoint(str(tmp_path), 1, {"t": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        C.restore_checkpoint(str(tmp_path), 1, {"t": torch.zeros(3), "u": torch.zeros(1)})


def test_save_async_snapshots_before_the_next_in_place_step(tmp_path):
    t = torch.arange(6, dtype=torch.float32)
    mgr = C.CheckpointManager(str(tmp_path), keep_last=5)
    mgr.save_async(1, {"t": t, "s": C.Stacked([t[:3], t[3:]])})
    t.add_(100)  # what the next train step does to its tensors
    mgr.wait()
    got, _ = C.restore_checkpoint(str(tmp_path), 1, {"t": torch.zeros(6),
                                                      "s": C.Stacked([torch.zeros(3)] * 2)})
    assert torch.equal(got["t"], torch.arange(6.0))
    assert torch.equal(torch.stack(list(got["s"])), torch.arange(6.0).reshape(2, 3))


def test_keep_last_collects_old_steps(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path), keep_last=2)
    for step in range(1, 6):
        mgr.save_async(step, {"x": torch.full((2,), float(step))})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert C.latest_step(str(tmp_path)) == 5


def test_a_writer_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = C.CheckpointManager(str(blocker / "ckpt"))
    mgr.save_async(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # reported once


def _lm_state(arch="olmoe-1b-7b"):
    """A smoke LM and its AdamW (bf16 moments) state after one reference
    step, in both packages: ``(ref_cfg, cfg, ref_step, ref_state, step)``."""
    ref_cfg, cfg = ref_get_spec(arch).smoke(), get_spec(arch).smoke()
    ref_opt, _ = RTR.pick_optimizer(ref_cfg.num_params())
    ref_step = jax.jit(RTR.make_lm_train_step(ref_cfg, ref_opt))
    params = RT.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, ref_step, (params, ref_opt.init(params))


def _batches(cfg, n, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(n)]


def _assert_lm_state(model, opt_state, ref_state, steps):
    """Params at rtol 1e-5 / atol 1e-6; bf16 moments within one bf16 ulp
    a step taken, save a few elements a leaf whose gradients cancel
    (``test_torch_train.assert_bf16_moments``)."""
    tree = params_to_numpy(model)
    ref_p = jax.tree.map(np.asarray, ref_state[0])
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(ref_p)[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=str(path))
    st = opt_state_to_numpy(opt_state, model)
    ref_st = jax.tree.map(np.asarray, ref_state[1])
    assert int(st["count"]) == int(ref_st["count"])
    for key in ("m", "v"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(st[key])[0],
                                     jax.tree_util.tree_flatten_with_path(ref_st[key])[0]):
            assert a.dtype == b.dtype and a.dtype.name == "bfloat16"
            assert_bf16_moments(a, b, steps, str(path))


def test_a_reference_checkpoint_restores_in_the_port_and_trains_on(tmp_path):
    """JAX writes (params, opt_state) after one step with its
    CheckpointManager; the port restores it into its own state (layers
    unstacked, bf16 moments by view) and both take 2 more steps."""
    ref_cfg, cfg, ref_step, state = _lm_state()
    b0, b1, b2 = _batches(cfg, 3)
    state, _ = ref_step(state, {"tokens": jnp.asarray(b0)})
    mgr = RC.CheckpointManager(str(tmp_path))
    mgr.save_async(1, state, extra={"step": 1})
    mgr.wait()
    model = T.TransformerLM(cfg, "cpu")
    opt, name = TR.pick_optimizer(cfg.num_params())
    assert name == "adamw"
    opt_state = opt.init(model.param_tree())
    assert train_lm._restore(str(tmp_path), 1, model, opt_state) == {"step": 1}
    _assert_lm_state(model, opt_state, state, 1)
    step = TR.make_lm_train_step(cfg, opt)
    mine = (model, opt_state)
    for b in (b1, b2):
        state, _ = ref_step(state, {"tokens": jnp.asarray(b)})
        mine, _ = step(mine, {"tokens": torch.from_numpy(b)})
    _assert_lm_state(*mine, state, 3)


def test_a_port_checkpoint_restores_in_the_reference_and_trains_on(tmp_path):
    ref_cfg, cfg, ref_step, state = _lm_state("minicpm3-4b")
    b0, b1, b2 = _batches(cfg, 3)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, state[0]), cfg, "cpu")
    opt, _ = TR.pick_optimizer(cfg.num_params())
    mine = (model, opt.init(model.param_tree()))
    mine, _ = TR.make_lm_train_step(cfg, opt)(mine, {"tokens": torch.from_numpy(b0)})
    state, _ = ref_step(state, {"tokens": jnp.asarray(b0)})
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save_async(1, train_state_tree(*mine), extra={"step": 1})
    mgr.wait()
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    restored, extra = RC.restore_checkpoint(str(tmp_path), 1, like)
    assert extra == {"step": 1}
    _assert_lm_state(*mine, restored, 1)
    for b in (b1, b2):
        state, _ = ref_step(state, {"tokens": jnp.asarray(b)})
        restored, _ = ref_step(restored, {"tokens": jnp.asarray(b)})
        mine, _ = TR.make_lm_train_step(cfg, opt)(mine, {"tokens": torch.from_numpy(b)})
    _assert_lm_state(*mine, restored, 3)
    _assert_lm_state(*mine, state, 3)


def test_opt_state_round_trips_through_the_reference_tree():
    cfg = get_spec("deepseek-v3-671b").smoke()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for opt in (O.adamw(0.1, moment_dtype=torch.bfloat16), O.sgd(0.1), O.adafactor(0.1)):
        st = opt.init(model.param_tree())
        with torch.no_grad():
            for t in C.flatten(train_state_tree(model, st)[1]):
                for x in t[1] if isinstance(t[1], list) else (t[1],):
                    x.copy_(torch.randn(x.shape).to(x.dtype))
        back = opt_state_from_numpy(opt_state_to_numpy(st, model), model)
        a, b = C.flatten(train_state_tree(model, st)[1]), C.flatten(train_state_tree(model, back)[1])
        assert [n for n, _ in a] == [n for n, _ in b]
        for (n, x), (_, y) in zip(a, b):
            xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
            assert all(torch.equal(p, q) for p, q in zip(xs, ys)), n
    tree = opt_state_to_numpy(O.adamw(0.1).init(model.param_tree()), model)
    assert tree["m"]["layers"]["wo"].shape == (cfg.n_layers, *T.param_shapes(cfg)["layers"]["wo"][1:])
    del tree["v"]["layers"]["wo"]
    with pytest.raises(ValueError, match="wo"):
        opt_state_from_numpy(tree, model)


# ------------------------------------------------------------ device defaults
@pytest.mark.parametrize("call", ["TransformerLM", "init_params", "init_cache", "init_ffn",
                                  "lm_params_from_numpy"])
def test_lm_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_spec("qwen1.5-110b").smoke()
    tree = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0),
                                                   ref_get_spec("qwen1.5-110b").smoke()))
    calls = {
        "TransformerLM": lambda: T.TransformerLM(cfg),
        "init_params": lambda: T.init_params(cfg, torch.Generator()),
        "init_cache": lambda: T.init_cache(cfg, 1, 4),
        "init_ffn": lambda: L.init_ffn(torch.Generator(), 8, 16, "swiglu", torch.float32),
        "lm_params_from_numpy": lambda: lm_params_from_numpy(tree, cfg),
    }
    with pytest.raises(DeviceError):
        calls[call]()
