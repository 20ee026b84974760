"""The port's sharding rules against the JAX package's.

``runtime/sharding.py``'s spec trees for the five LMs, GraphSAGE and the
four rankers at full width equal the reference's on both production meshes'
axis names (the rules need nothing else of a mesh). The reference stacks an
LM's layers, so its layer leaves carry a leading ``None`` for ``L``; the
port's per-layer specs are the same without it, and on the stacked shapes
the port's rule gives the reference's spec itself. ``opt_state_specs``
follows for AdamW, SGD and Adafactor; ``_fit_spec`` on the reference's own
cases; ``placements`` maps a spec onto DTensor placements.
"""

import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_spec as ref_get_spec  # noqa: E402
from repro.launch import train as RTR  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.runtime import sharding as RS  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.launch.specs import _fit_spec, _unstacked  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import sharding as S  # noqa: E402

LM_ARCHS = ["deepseek-v3-671b", "olmoe-1b-7b", "qwen1.5-110b", "minicpm3-4b", "nemotron-4-340b"]
RECSYS_ARCHS = ["dien", "bert4rec", "xdeepfm", "bst"]


class Mesh:
    """Only what the rules read: axis names and extents."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)


MESHES = {
    "single": Mesh(("data", "model"), (16, 16)),
    "multi": Mesh(("pod", "data", "model"), (2, 16, 16)),
}


def _norm(spec, ndim):
    """A spec (the port's or JAX's) as a tuple of ``ndim`` entries, each
    None, a name, or a tuple of names (JAX writes a tuple of one name as
    the name)."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))

    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e

    return tuple(entry(e) for e in entries)


def _flat(spec_tree, shape_tree, prefix=""):
    """path → normalised spec, for a tree of specs and its shapes."""
    items = spec_tree.items() if isinstance(spec_tree, dict) else enumerate(spec_tree)
    out = {}
    for k, v in items:
        shp = shape_tree[k]
        if isinstance(v, (dict, list)):
            out.update(_flat(v, shp, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _norm(v, len(shp))
    return out


def _flat_opt(tree, prefix=""):
    """path → entries of an optimizer-state spec tree (no shapes: the
    trailing Nones are stripped on both sides)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_opt(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_opt(v, f"{prefix}{i}."))
        return out
    entries = list(_norm(tree, len(tuple(tree))))
    while entries and entries[-1] is None:
        entries.pop()
    return {prefix[:-1]: tuple(entries)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    cfg, ref_cfg = get_spec(arch).model, ref_get_spec(arch).model
    ref_shapes = RT.param_shapes(ref_cfg)
    want = _flat(RS.lm_param_specs(ref_shapes, m), ref_shapes)
    stacked = T.param_shapes(cfg)
    assert _flat(S.lm_param_specs(stacked, m), stacked) == want
    # per layer: the reference's spec without the stacked L entry
    per_layer = _unstacked(stacked)
    got = _flat(S.lm_param_specs(per_layer, m), per_layer)
    stacked_paths = ("layers.", "mtp.block.")
    for path, spec in want.items():
        if path.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
            # the reference's rule reads a stacked (L, X) bias as a 1-D
            # leaf and shards L over "model"; a per-layer bias is 1-D, and
            # the same rule shards X
            assert spec == ("model", None) and got[path] == ("model",), path
            continue
        if path.startswith(stacked_paths):
            assert spec[0] is None
            spec = spec[1:]
        assert got[path] == spec, path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["graphsage-reddit"] + RECSYS_ARCHS)
def test_gnn_and_recsys_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    cfg, ref_cfg = get_spec(arch).model, ref_get_spec(arch).model
    if arch == "graphsage-reddit":
        mine, ref = G.param_shapes(cfg), RG.param_shapes(ref_cfg)
        got, want = S.gnn_param_specs(mine, m), RS.gnn_param_specs(ref, m)
    else:
        mine, ref = R.param_shapes(cfg), RR.param_shapes(ref_cfg)
        got, want = S.recsys_param_specs(mine, m), RS.recsys_param_specs(ref, m)
    assert _flat(got, mine) == _flat(want, ref)


@pytest.mark.parametrize("opt", ["adamw", "sgd", "adafactor"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "minicpm3-4b", "bert4rec"])
def test_opt_state_specs_equal_the_reference(opt, arch):
    m = MESHES["multi"]
    cfg, ref_cfg = get_spec(arch).model, ref_get_spec(arch).model
    if arch == "bert4rec":
        mine, ref = R.param_shapes(cfg), RR.param_shapes(ref_cfg)
        specs, ref_specs = S.recsys_param_specs(mine, m), RS.recsys_param_specs(ref, m)
    else:
        mine, ref = T.param_shapes(cfg), RT.param_shapes(ref_cfg)
        specs, ref_specs = S.lm_param_specs(mine, m), RS.lm_param_specs(ref, m)
    got = TR.opt_state_specs(opt, specs, mine)
    want = RTR.opt_state_specs(opt, ref_specs, ref)
    assert _flat_opt(got) == _flat_opt(want)
    assert set(got) == set(want)


def test_opt_state_specs_rejects_an_unknown_optimizer():
    with pytest.raises(ValueError):
        TR.opt_state_specs("lamb", {}, {})


def test_fit_spec_divisibility():
    """The reference's own cases (``tests/test_launch.py``)."""
    class FakeMesh:
        axis_names = ("data", "model")

        class devices:
            shape = (16, 16)

    assert _fit_spec((73448, 2560), S.P("model", "data"), FakeMesh) == S.P(None, "data")
    assert _fit_spec((128, 64), S.P(("data", "model"), None), FakeMesh) == S.P(None, None)
    assert _fit_spec((512, 64), S.P(("data", "model"), None), FakeMesh) == S.P(("data", "model"), None)


def test_placements_map_a_spec_onto_the_mesh():
    m = MESHES["single"]
    assert S.placements(S.P("model", ("data",)), m) == [Shard(1), Shard(0)]
    assert S.placements(S.P(("data", "model"), None), m) == [Shard(0), Shard(0)]
    assert S.placements(S.P(None, None), m) == [Replicate(), Replicate()]
    assert S.placements(S.P(), MESHES["multi"]) == [Replicate()] * 3
    assert S.placements(S.P(("pod", "data"), "model"), MESHES["multi"]) == [
        Shard(0), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        S.placements(S.P(("model", "data")), m)
    with pytest.raises(ValueError, match="shards two"):
        S.placements(S.P("data", "data"), m)


def test_local_shape_splits_each_dimension_over_its_axes():
    m = MESHES["multi"]
    assert S.local_shape((64, 48, 5), S.P(("pod", "data"), "model"), m) == (2, 3, 5)
    with pytest.raises(ValueError, match="does not split"):
        S.local_shape((10,), S.P("model"), m)


def test_set_mesh_compat_is_thread_local_and_nests():
    a, b = MESHES["single"], MESHES["multi"]
    assert S.active_mesh() is None
    seen = []
    with S.set_mesh_compat(a):
        t = threading.Thread(target=lambda: seen.append(S.active_mesh()))
        t.start()
        t.join(timeout=10)
        with S.set_mesh_compat(b):
            assert S.active_mesh() is b
        assert S.active_mesh() is a
    assert S.active_mesh() is None and seen == [None]


def test_maybe_shard_is_a_no_op_without_a_mesh_or_on_a_plain_tensor():
    from repro_torch.models.layers import maybe_shard, shard_batch

    x = torch.ones(4, 3)
    assert maybe_shard(x, "data", None) is x and shard_batch(x) is x
    with S.set_mesh_compat(MESHES["single"]):
        assert maybe_shard(x, "data", None) is x and shard_batch(x) is x
