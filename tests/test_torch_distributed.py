"""The port's distributed Gram against the JAX package's.

The port runs ``core.distributed.distributed_gram`` SPMD on gloo worlds of
8 ranks (``gram_on_world``) on the CPU, where the local product is
``cooc_gram``'s plain version; the JAX package runs ``make_distributed_gram``
in a subprocess with 8 placeholder devices, as ``tests/test_distributed.py``
runs it. Both schedules on the ``(2, 4)`` and ``(2, 2, 2)`` meshes must give
the reference's Gram exactly (the port's int32 against the reference's
float32, with ``np.array_equal``), and each schedule must issue its own
collectives: the ring point-to-point transfers and no ``all_gather``, the
all-gather schedule ``all_gather``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distributed import (  # noqa: E402
    gram_on_world,
    gram_reference,
    world_backend,
)

MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.distributed import make_distributed_gram, gram_reference

    B = np.load(sys.argv[1])
    out = {"reference": np.asarray(gram_reference(jnp.asarray(B)))}
    for shape, names in %r:
        mesh = jax.make_mesh(shape, names)
        for sched in ["allgather", "ring"]:
            g = make_distributed_gram(mesh, schedule=sched)
            out[f"{sched}_{len(shape)}"] = np.asarray(g(jnp.asarray(B)))
    np.savez(sys.argv[2], **out)
    """
) % (MESHES,)


def incidence(seed=0, D=128, V=64, p=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random((D, V)) < p).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_grams(tmp_path_factory):
    """The JAX package's Gram of ``incidence()`` on both meshes, both
    schedules, and its single-device reference."""
    d = tmp_path_factory.mktemp("jax_gram")
    np.save(d / "B.npy", incidence())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d / "B.npy"), str(d / "out.npz")],
        capture_output=True, text=True, cwd=ROOT, timeout=600, env=env,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return dict(z)


@pytest.mark.parametrize("shape,axes", MESHES, ids=["2x4", "2x2x2"])
def test_distributed_gram_equals_the_reference(shape, axes, jax_grams):
    out = gram_on_world(incidence(), shape, axes, device="cpu")
    for sched in ("allgather", "ring"):
        C = out["C"][sched]
        assert C.dtype == np.int32
        assert np.array_equal(C, jax_grams[f"{sched}_{len(shape)}"]), sched
        assert np.array_equal(C, jax_grams["reference"]), sched
    assert len(out["ranks"]) == 8
    # collective audit: each rank's own counters, as the reference audits
    # its compiled HLO for collective-permute and all-gather
    n_model = shape[axes.index("model")]
    for rank in out["ranks"]:
        ring = rank["schedules"]["ring"]["counters"]
        ag = rank["schedules"]["allgather"]["counters"]
        assert ring.get("dist.p2p") == n_model - 1 and "dist.all_gather" not in ring
        assert ag.get("dist.all_gather") == 1 and "dist.p2p" not in ag
        assert ring.get("dist.reduce_scatter") == ag.get("dist.reduce_scatter") == 1
        # on the CPU the collectives take the blocks as they are: no copies
        assert "dist.host_copies" not in ring and "dist.host_copies" not in ag
        assert rank["device"] == "cpu" and rank["backend"] == "gloo"


def test_gram_reference_equals_the_reference(jax_grams):
    got = gram_reference(torch.from_numpy(incidence()))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), jax_grams["reference"])


@pytest.mark.parametrize("shape,axes", [((1, 2), ("data", "model")), ((2, 1), ("data", "model"))])
def test_distributed_gram_degenerate_axes(shape, axes):
    """A model axis of one rank needs no ring step and no all-gather; a doc
    axis of one rank no reduce-scatter."""
    B = incidence(seed=3, D=40, V=24, p=0.3)
    want = B.T.astype(np.int64) @ B.astype(np.int64)
    out = gram_on_world(B, shape, axes, device="cpu")
    for sched, C in out["C"].items():
        assert np.array_equal(C, want), sched
    counters = out["ranks"][0]["schedules"]
    if shape[1] == 1:
        assert "dist.p2p" not in counters["ring"]["counters"]
        assert "dist.all_gather" not in counters["allgather"]["counters"]
    else:
        assert "dist.reduce_scatter" not in counters["ring"]["counters"]


def test_gram_on_world_rejects_blocks_that_do_not_split():
    with pytest.raises(ValueError, match="does not split"):
        gram_on_world(incidence(D=127), (2, 4), ("data", "model"), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_gram_on_world_runs_on_the_card_by_default():
    """The entry point's default is the card: on a host without one it
    raises ``DeviceError`` before any rank computes on the host."""
    from repro_torch.device import DeviceError

    with pytest.raises(DeviceError, match="no CUDA device"):
        gram_on_world(incidence(), (2, 4), ("data", "model"))


@pytest.mark.parametrize("device_type,world,cards,want", [
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"), ("cuda", 4, 1, "gloo"),
    ("cpu", 8, 8, "gloo"), ("cpu", 2, 0, "gloo"),
])
def test_world_backend_is_nccl_only_with_a_card_for_each_rank(device_type, world, cards, want):
    assert world_backend(device_type, world, cards) == want
