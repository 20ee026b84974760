"""The port's dry-run tools against the JAX package's.

* Every cell of ``launch.specs.all_cells()`` on both production meshes has
  the reference's ``model_flops``, ``act_bytes`` and ``sharded_arg_bytes``
  (the reference's cells are built, not compiled, in a subprocess with 512
  placeholder devices; the port's on a fake world of 512 ranks in one of
  its own). The one difference is the co-occurrence Gram's incidence:
  uint8 in the port, bfloat16 in the reference, so half the bytes.
* A fake-world dry run of the two co-occurrence cells and smoke-width LM
  cells on a ``(2, 4)`` mesh gives records with the reference's keys.
* The trace counts per-rank FLOPs (a sharded matmul counts its local
  block, a replicated one all of it) and collective bytes to the byte.
* The ``zero3_gather_weights`` and ``shard_decode_dmodel`` variants on real
  DTensors of an 8-rank gloo world give the unsharded port's loss and
  logits within 1e-5, the MoE model through the expert-parallel body.
* ``hillclimb.EXPERIMENTS`` is the reference's but for the hypotheses.

The fake world lives in subprocesses: a process group is process-global.
"""

import ast
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

REF_CELLS = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, "src")
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import build_cell, all_cells, sharded_arg_bytes
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape in all_cells():
            c = build_cell(arch, shape, mesh)
            out[f"{arch}/{shape}/{int(multi)}"] = [
                c.model_flops, c.act_bytes, sharded_arg_bytes(c.args, mesh)]
    json.dump(out, open(sys.argv[1], "w"))
    """
)

PORT_CELLS = textwrap.dedent(
    """
    import sys, json
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell, all_cells, sharded_arg_bytes
    init_fake_world()
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        with FakeTensorMode(allow_non_fake_inputs=True):
            for arch, shape in all_cells():
                c = build_cell(arch, shape, mesh)
                out[f"{arch}/{shape}/{int(multi)}"] = [
                    c.model_flops, c.act_bytes, sharded_arg_bytes(c.args, mesh)]
    json.dump(out, open(sys.argv[1], "w"))
    """
)

# smoke-width LM cells on a (2, 4) mesh, the trace's own counts, and the
# records' keys
FAKE_WORLD = textwrap.dedent(
    """
    import sys, json, dataclasses
    import torch, torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_spec
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import init_fake_world, run_cell
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.runtime.sharding import P, fake_dtensor
    init_fake_world()
    out = {"records": []}
    mesh = make_test_mesh((2, 4))
    for arch, shape in [("cooc-wt10g", "head_gram"), ("cooc-wt10g", "tail_hist"),
                        ("olmoe-1b-7b", "decode_32k"), ("qwen1.5-110b", "decode_32k"),
                        ("minicpm3-4b", "long_500k")]:
        kw = {}
        if get_spec(arch).family == "lm":
            smoke = get_spec(arch).smoke()
            kw = {"overrides": {f.name: getattr(smoke, f.name)
                                for f in dataclasses.fields(smoke)
                                if f.name not in ("n_layers", "kv_chunk")}}
        out["records"].append(run_cell(arch, shape, False, None, cell_kw=kw, mesh=mesh))
    big = make_production_mesh()
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = fake_dtensor((4096, 1024), torch.float32, P("data", None), big)
        b = fake_dtensor((1024, 4096), torch.float32, P(None, "model"), big)
        with rl.Trace() as tr:
            a @ b
        out["sharded_flops"] = tr.flops
        a = fake_dtensor((4096, 1024), torch.float32, P(), big)
        b = fake_dtensor((1024, 4096), torch.float32, P(), big)
        with rl.Trace() as tr:
            a @ b
        out["replicated_flops"] = tr.flops
        with rl.Trace() as tr:
            t = torch.empty(8, 4)
            parts = [torch.empty_like(t) for _ in range(16)]
            dist.all_gather(parts, t, group=big.get_group("model"))
            u = torch.empty(1024)
            dist.all_reduce(u, group=big.get_group("data"))
            x = fake_dtensor((256, 64), torch.bfloat16, P("data", "model"), big)
            x.redistribute(big, [Shard(0), Replicate()])
        out["coll"] = rl.collective_bytes(tr)
        from repro_torch.runtime.sharding import attach
        tree = attach(mesh, {"w": P("data", "model"), "b": [P(None)]},
                      {"w": (8, 12), "b": [(5,)]}, {"w": "bfloat16", "b": ["float32"]})
        out["attach"] = [tuple(tree["w"].shape), tuple(tree["w"]._local_tensor.shape),
                         str(tree["w"].dtype), tuple(tree["b"][0]._local_tensor.shape),
                         str(tree["b"][0].dtype)]
        # an operation DTensor has no sharding rule for, twice in one process:
        # the rule registered by the first trace stays, the second names it too
        fb_runs = []
        for _ in range(2):
            with rl.Trace() as fb:
                y = torch.renorm(fake_dtensor((16, 8), torch.float32, P("data", "model"), mesh),
                                 2, 0, 1.0)
            fb_runs.append(fb)
        out["fallback"] = [sorted(fb.fallback_ops) for fb in fb_runs]
        out["fallback_coll"] = [rl.collective_bytes(fb) for fb in fb_runs]
        out["fallback_out"] = [str(p) for p in y.placements]
        out["coll_groups"] = [len(c["ranks"]) for c in tr.collectives]
        out["coll_s"] = rl.collective_seconds(tr)
    json.dump(out, open(sys.argv[1], "w"))
    """
)


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(p, timeout=600):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's cells, the port's, and the fake-world script, run
    side by side."""
    d = tmp_path_factory.mktemp("runs")
    procs = [_run(REF_CELLS, d / "ref.json"), _run(PORT_CELLS, d / "port.json"),
             _run(FAKE_WORLD, d / "fake.json")]
    for p in procs:
        _wait(p)
    return {k: json.load(open(d / f"{k}.json")) for k in ("ref", "port", "fake")}


@pytest.fixture(scope="module")
def cells(runs):
    return runs["ref"], runs["port"]


@pytest.fixture(scope="module")
def fake_world(runs):
    return runs["fake"]


def _all_cells():
    from repro_torch.launch.specs import all_cells

    return all_cells()


def test_all_cells_are_the_references():
    from repro.configs import get_spec as ref_get_spec, list_archs as ref_list_archs

    want = [(a, s) for a in ref_list_archs() for s in ref_get_spec(a).shapes]
    assert _all_cells() == want and len(want) == 42


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in _all_cells()])
def test_cell_flops_bytes_and_arg_bytes_equal_the_reference(cell, cells):
    ref, port = cells
    for multi in (0, 1):
        want, got = ref[f"{cell}/{multi}"], port[f"{cell}/{multi}"]
        assert got[:2] == want[:2], (cell, multi)
        if cell == "cooc-wt10g/head_gram":  # uint8 incidence, not bfloat16
            assert got[2] == want[2] / 2
        else:
            assert got[2] == want[2], (cell, multi)


def test_dry_run_records_have_the_reference_keys(fake_world):
    from repro.launch.roofline import Roofline as RefRoofline

    roof_keys = set(RefRoofline(1.0, 1.0, 1.0, {}, 1, 1.0, 1.0).to_dict())
    for rec in fake_world["records"]:
        assert rec["ok"], rec.get("error")
        assert set(rec) >= {"arch", "shape", "mesh", "n_chips", "analytic", "kind", "notes",
                            "ok", "lower_s", "compile_s", "memory", "roofline",
                            "layer_extrapolated"}
        assert set(rec["analytic"]) == {"args_gb_per_chip", "act_gb_per_chip", "fits_80gb"}
        assert set(rec["roofline"]) == roof_keys
        assert set(rec["memory"]) >= {"argument_size_in_bytes", "output_size_in_bytes",
                                      "temp_size_in_bytes", "alias_size_in_bytes",
                                      "total_hbm_bytes"}
        assert rec["mesh"] == "2x4" and rec["n_chips"] == 8
        assert rec["layer_extrapolated"] == (rec["arch"] != "cooc-wt10g")
        r = rec["roofline"]
        # the histogram's adds are no matmul: the FLOP formulas count none
        assert (r["flops_per_chip"] > 0) == (rec["shape"] != "tail_hist")
        assert r["bytes_per_chip"] > 0
        assert r["coll_bytes_per_chip"] == sum(r["coll_breakdown"].values()) > 0
        assert set(r["coll_breakdown"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                            "all-to-all", "collective-permute"}


def test_cooc_cells_run_their_schedules_collectives(fake_world):
    recs = {r["shape"]: r for r in fake_world["records"]}
    ring = recs["head_gram"]["roofline"]["coll_breakdown"]
    # ring schedule on 4 model ranks: 3 block sends, then the reduce-scatter
    # of the (V/4, V) strip over 2 doc ranks; (524288, 65536) uint8 blocks
    block = (524288 // 2) * (65536 // 4)
    assert ring["collective-permute"] == 3 * block
    assert ring["reduce-scatter"] == (65536 // 8) * 65536 * 4
    assert ring["all-gather"] == 0
    # the Gram's products, 0/1 uint8 on the card's int8 tensor cores, are
    # held against the int8 peak (1,979 TOPS), not bf16's 989 TFLOP/s
    gram = recs["head_gram"]["roofline"]
    assert gram["flops_per_chip"] == 2 * (524288 // 2) * (65536 // 4) * 65536
    assert gram["t_compute_s"] == pytest.approx(gram["flops_per_chip"] / 1979e12)
    hist = recs["tail_hist"]["roofline"]
    assert hist["coll_breakdown"]["all-reduce"] == 256 * 65536 * 4
    assert hist["flops_per_chip"] == 0


def test_the_trace_counts_each_ranks_own_flops(fake_world):
    """A (data, ·) × (·, model) matmul of 4,096 × 1,024 × 4,096 on the
    16 × 16 mesh computes 1/256 of the product on each rank;
    ``FlopCounterMode`` on DTensors would count all of it."""
    total = 2 * 4096 * 1024 * 4096
    assert fake_world["sharded_flops"] == total / 256
    assert fake_world["replicated_flops"] == total


def test_attach_lays_a_shape_tree_out_as_fake_dtensors(fake_world):
    assert fake_world["attach"] == [[8, 12], [4, 3], "torch.bfloat16", [5], "torch.float32"]


def test_collective_bytes_to_the_byte(fake_world):
    coll = fake_world["coll"]
    # all_gather of 16 (8, 4) f32 blocks; all_reduce of 1,024 f32; the
    # DTensor redistribution (data, model) → (data, replicated) of a
    # (256, 64) bf16 tensor: each rank gathers its (16, 64) rows
    assert coll["all-gather"] == 16 * 8 * 4 * 4 + 16 * 64 * 2
    assert coll["all-reduce"] == 1024 * 4
    assert coll["reduce-scatter"] == coll["all-to-all"] == coll["collective-permute"] == 0
    assert fake_world["coll_groups"] == [16, 16, 16]
    # every group of 16 ranks spans two 8-rank nodes: InfiniBand
    assert fake_world["coll_s"] == pytest.approx(sum([2048, 4096, 2048]) / 50e9)


def test_an_operation_without_a_sharding_rule_runs_replicated_and_is_named(fake_world):
    """Its operands are gathered (traced like any redistribution), it runs
    replicated, and every trace that runs it names the operation without a
    rule (``renorm``'s sharding comes from its decomposition, whose
    ``where`` has none), not only the trace that first met it."""
    first, second = fake_world["fallback"]
    assert first == second == ["prims.where.default"]
    assert all(c["all-gather"] > 0 for c in fake_world["fallback_coll"])
    assert fake_world["fallback_out"] == ["R", "R"]  # replicated on both axes


def test_the_dry_run_fails_without_the_fake_backend(tmp_path):
    script = textwrap.dedent(
        """
        import sys
        sys.modules["torch.testing._internal.distributed.fake_pg"] = None
        from repro_torch.launch.dryrun import main
        main(["--arch", "cooc-wt10g", "--shape", "tail_hist", "--out", sys.argv[1]])
        """
    )
    p = _run(script, tmp_path / "out.jsonl")
    _, err = p.communicate(timeout=300)
    assert p.returncode != 0 and "fake_pg" in err
    assert not (tmp_path / "out.jsonl").exists()


def test_hillclimb_experiments_are_the_references_but_the_hypotheses():
    from repro_torch.launch.hillclimb import EXPERIMENTS

    src = open(os.path.join(SRC, "repro", "launch", "hillclimb.py")).read()
    node = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "EXPERIMENTS")
    ref = ast.literal_eval(node.value)
    assert set(EXPERIMENTS) == set(ref)
    for name, variants in ref.items():
        assert [v[:5] for v in EXPERIMENTS[name]] == [v[:5] for v in variants], name
        for mine, theirs in zip(EXPERIMENTS[name], variants):
            assert mine[5] and "VMEM" not in mine[5] and "MXU" not in mine[5]


# ------------------------------------------------ the variants on real ranks
VARIANT_RANK = textwrap.dedent(
    """
    import datetime, os, sys, json, dataclasses
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor, DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_spec
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import _fit_spec, _unstacked
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import P, lm_param_specs, placements, set_mesh_compat
    rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=8, timeout=datetime.timedelta(seconds=300))
    mesh = make_test_mesh((2, 4))
    out = {}

    def sharded(model, cfg):
        specs = lm_param_specs(_unstacked(T.param_shapes(cfg)), mesh)
        for name, p in list(model.named_parameters()):
            spec = specs
            for part in T.tree_path(name).split("."):
                spec = spec[part]
            owner, leaf = model, name
            if "." in name:
                prefix, leaf = name.rsplit(".", 1)
                owner = model.get_submodule(prefix)
            pl = placements(_fit_spec(p.shape, spec, mesh), mesh)
            owner._parameters[leaf] = torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, pl), requires_grad=False)
        return model

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    for arch, variant in [("qwen1.5-110b", "zero3"), ("olmoe-1b-7b", "zero3"),
                          ("qwen1.5-110b", "decode"), ("deepseek-v3-671b", "decode")]:
        base = get_spec(arch).smoke()
        base = dataclasses.replace(base, capacity_factor=float(max(base.n_experts, 1)))
        cfg = dataclasses.replace(base, zero3_gather_weights=variant == "zero3",
                                  shard_decode_dmodel=variant == "decode")
        model = T.init_params(base, torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        if variant == "zero3":
            tokens = torch.randint(0, base.vocab_size, (4, 16), generator=g)
            with torch.no_grad():
                _, want = T.loss_fn(model, {"tokens": tokens}, base)
            dm = sharded(model, cfg)
            tk = distribute_tensor(tokens, mesh, placements(P("data", None), mesh))
            with torch.no_grad(), set_mesh_compat(mesh), implicit_replication():
                _, got = T.loss_fn(dm, {"tokens": tk}, cfg)
            # the cross-entropy: the expert-parallel aux loss is a mean of
            # per-data-shard losses, as the reference's is
            want, got = want["ce"], got["ce"]
        else:
            cache = {k: torch.randn(s, generator=g) * 0.5
                     for k, s in T.cache_shapes(base, 2, 8).items()}
            tokens = torch.randint(0, base.vocab_size, (2, 1), generator=g)
            with torch.no_grad():
                want, _ = T.decode_step(model, {k: v.clone() for k, v in cache.items()},
                                        tokens, 5, base)
            dm = sharded(model, cfg)
            dc = {k: distribute_tensor(v.clone(), mesh, placements(P(None, "data", "model"), mesh))
                  for k, v in cache.items()}
            tk = distribute_tensor(tokens, mesh, placements(P("data", None), mesh))
            with torch.no_grad(), set_mesh_compat(mesh), implicit_replication():
                got, _ = T.decode_step(dm, dc, tk, 5, cfg)
        out[f"{arch}/{variant}"] = float(np.abs(full(got).numpy() - want.numpy()).max())
        out[f"{arch}/{variant}/scale"] = float(np.abs(want.numpy()).max())
    if rank == 0:
        json.dump(out, open(os.path.join(d, "variants.json"), "w"))
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    d = tmp_path_factory.mktemp("variants")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ranks = [_run(VARIANT_RANK, r, port, d) for r in range(8)]
    for p in ranks:
        _wait(p)
    return json.load(open(d / "variants.json"))


@pytest.mark.parametrize("case", ["qwen1.5-110b/zero3", "olmoe-1b-7b/zero3",
                                  "qwen1.5-110b/decode", "deepseek-v3-671b/decode"])
def test_sharding_variants_on_real_ranks_equal_the_unsharded_port(case, variants):
    assert variants[f"{case}/scale"] > 0.1
    assert variants[case] <= 1e-5 * max(1.0, variants[f"{case}/scale"])
