"""The port's expert-parallel MoE against the JAX package's.

The port runs ``models.layers.moe_ffn_ep`` on an 8-rank gloo world laid
out ``(2, 4)`` over ``("data", "model")`` (``launch.moe_ep.
moe_ep_on_world``): each rank holds its block of the expert weights (2
experts of 8, half of d_model) and of the batch, and backpropagates
``sum(y²) + 0.01·aux``. The reference runs its ``shard_map`` body on 8
placeholder devices in a subprocess, as ``tests/test_moe_ep.py`` does.
Outputs match at 2e-5, gradients at 3e-4 / 3e-3, with and without drops,
with a replicated batch of one, and with a bf16 combine (at bf16's
rounding). Under an active ``"model"`` mesh ``moe_ffn_ep`` never runs
``moe_ffn``, whose capacity is per batch row.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.moe_ep import moe_ep_on_world  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, K, D, F, B, S = 8, 2, 32, 16, 4, 16
AUX_W = 0.01
# name → (capacity factor, batch, combine dtype)
CASES = {
    "no_drops": (float(E), B, None),
    "drops": (1.25, B, None),
    "batch_of_one": (float(E), 1, None),
    "batch_of_one_drops": (1.25, 1, None),
    "bf16_combine": (float(E), B, "bfloat16"),
}

REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import numpy as np, jax, jax.numpy as jnp
    from repro.models.layers import moe_ffn_ep
    from repro.runtime.sharding import set_mesh_compat as set_mesh

    z = dict(np.load(sys.argv[1]))
    cases = %r
    x_all = jnp.asarray(z.pop("x"))
    params = {k: jnp.asarray(v) for k, v in z.items() if not k.startswith("sh_")}
    params["shared"] = {k[3:]: jnp.asarray(v) for k, v in z.items() if k.startswith("sh_")}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for name, (cf, b, cdt) in cases.items():
        x = x_all[:b]
        def fn(p):
            return moe_ffn_ep(p, x, n_experts=%d, top_k=%d, capacity_factor=cf,
                              expert_kind="swiglu",
                              combine_dtype=None if cdt is None else jnp.dtype(cdt))
        def loss(p):
            y, aux = fn(p)
            return jnp.sum(y.astype(jnp.float32) ** 2) + %r * aux
        with set_mesh(mesh):
            y, aux = jax.jit(fn)(params)
            g = jax.jit(jax.grad(loss))(params)
        out[f"{name}/y"] = np.asarray(y, np.float32)
        out[f"{name}/aux"] = np.asarray(aux)
        for k, v in g.items():
            if k == "shared":
                for kk, vv in v.items():
                    out[f"{name}/g_sh_{kk}"] = np.asarray(vv)
            else:
                out[f"{name}/g_{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    """
) % (CASES, E, K, AUX_W)


def _inputs():
    rng = np.random.default_rng(20)
    p = {
        "router": rng.normal(size=(D, E)) * 0.3,
        "w_in": rng.normal(size=(E, D, F)) * 0.2,
        "w_gate": rng.normal(size=(E, D, F)) * 0.2,
        "w_out": rng.normal(size=(E, F, D)) * 0.2,
        "sh_w_in": rng.normal(size=(D, F)) * 0.2,
        "sh_w_gate": rng.normal(size=(D, F)) * 0.2,
        "sh_w_out": rng.normal(size=(F, D)) * 0.2,
    }
    # skewed routing: expert 0 draws most tokens, so capacity 1.25 drops
    p["router"][:, 0] += 0.3
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, (rng.normal(size=(B, S, D)) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    p, x = _inputs()
    np.savez(d / "in.npz", x=x, **p)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, cwd=ROOT, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return dict(z)


@pytest.fixture(scope="module")
def port():
    """The cases of one batch size and combine dtype run by one world."""
    p, x = _inputs()
    out = {}
    groups = {}
    for name, (cf, b, cdt) in CASES.items():
        groups.setdefault((b, cdt), []).append((name, cf))
    for (b, cdt), cases in groups.items():
        runs = moe_ep_on_world(p, x[:b], (2, 4), ("data", "model"), top_k=K,
                               capacity_factor=tuple(cf for _, cf in cases),
                               combine_dtype=cdt, aux_weight=AUX_W, device="cpu")
        out.update({name: r for (name, _), r in zip(cases, runs)})
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_ep_on_eight_gloo_ranks_equals_the_reference(name, port, reference):
    got = port[name]
    want_y = reference[f"{name}/y"]
    if CASES[name][2] == "bfloat16":  # both round the same float32 sums to bf16
        tol = dict(rtol=1e-2, atol=1e-2 * np.abs(want_y).max())
    else:
        tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["y"], want_y, **tol)
    np.testing.assert_allclose(got["aux"], reference[f"{name}/aux"], rtol=1e-5, atol=1e-6)
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, reference[f"{name}/g_{k}"], rtol=3e-3, atol=3e-4,
                                   err_msg=k)


@pytest.mark.parametrize("b", [B, 1])
def test_capacity_is_per_local_token_count_so_drops_change_the_output(b, port, reference):
    """At capacity factor 1.25 tokens are dropped (the output differs from
    the one without drops), as in the reference."""
    name = "drops" if b == B else "batch_of_one_drops"
    base = "no_drops" if b == B else "batch_of_one"
    assert not np.allclose(port[name]["y"], port[base]["y"], atol=1e-4)
    assert not np.allclose(reference[f"{name}/y"], reference[f"{base}/y"], atol=1e-4)


def test_without_drops_ep_equals_moe_ffn():
    """No drops: the expert-parallel output and gradients are the unsharded
    ``moe_ffn``'s (whose capacity differs, but nothing is dropped)."""
    p, x = _inputs()
    out = moe_ep_on_world(p, x, (2, 4), top_k=K, capacity_factor=float(E), device="cpu")
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items() if not k.startswith("sh_")}
    tp["shared"] = {k[3:]: torch.tensor(v, requires_grad=True)
                    for k, v in p.items() if k.startswith("sh_")}
    y, _ = L.moe_ffn(tp, torch.tensor(x), n_experts=E, top_k=K, capacity_factor=float(E))
    (y ** 2).sum().backward()
    np.testing.assert_allclose(out["y"], y.detach().numpy(), rtol=2e-5, atol=2e-5)
    for k in p:
        want = (tp["shared"][k[3:]] if k.startswith("sh_") else tp[k]).grad.numpy()
        np.testing.assert_allclose(out["grads"][k], want, rtol=3e-3, atol=3e-4, err_msg=k)


def test_under_a_model_mesh_moe_ffn_ep_never_runs_moe_ffn(monkeypatch):
    """With an active mesh that has a ``"model"`` axis the EP body runs (a
    world of one rank here); without one it is ``moe_ffn``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import _free_port
    from repro_torch.runtime.sharding import set_mesh_compat

    p, x = _inputs()
    tp = {k: torch.tensor(v) for k, v in p.items() if not k.startswith("sh_")}
    calls = []
    real = L.moe_ffn
    monkeypatch.setattr(L, "moe_ffn", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(n_experts=E, top_k=K, capacity_factor=float(E))
    L.moe_ffn_ep(tp, torch.tensor(x), **kw)
    assert calls == [1]
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
        with set_mesh_compat(mesh):
            y, _ = L.moe_ffn_ep(tp, torch.tensor(x), **kw)
        assert calls == [1]
        want, _ = real(tp, torch.tensor(x), **kw)
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    finally:
        dist.destroy_process_group()
