"""The port's parallel ingest under faults, and its elastic re-meshing.

Twins of ``tests/test_fault_elastic.py`` on ``repro_torch`` with
``device="cpu"``:

* ``plan_mesh`` and ``rebalance_shards`` give what the JAX package's give;
  ``build_mesh`` and ``launch.mesh`` build ``DeviceMesh``es over a gloo
  world and refuse a world smaller than the mesh;
* a SIGKILLed spill worker, every worker dead, and a crashed finalizer each
  end in the segment the JAX package's serial executor writes, byte for
  byte. The SIGKILL stall is armed by shard (``"shard": 0``), not by
  worker, so it must fire whichever worker claims shard 0 first — the
  reference test arms worker ``w0``, which may never claim a shard when
  ``w1`` is quicker;
* a workdir the JAX package's ``ParallelExecutor`` left after a finalizer
  crash is resumed by the port's, to the same bytes.
"""

import dataclasses
import glob
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plan import CountJob as JCountJob  # noqa: E402
from repro.core.plan import ParallelExecutor as JParallelExecutor  # noqa: E402
from repro.core.plan import Planner as JPlanner  # noqa: E402
from repro.core.plan import PlanExecutor as JPlanExecutor  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro.data.preprocess import remap_df_descending  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.convert import collection_from_numpy  # noqa: E402
from repro_torch.core.plan import CountJob, ParallelExecutor, Planner  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.store.spawn import spawn_friendly_env  # noqa: E402


# ------------------------------------------------------------ elastic meshes
@pytest.mark.parametrize("n,mp", [(512, 16), (256, 16), (250, 16), (8, 16),
                                  (1, 4), (37, 8), (3, 2)])
def test_plan_mesh_matches_the_reference(n, mp):
    assert dataclasses.astuple(elastic.plan_mesh(n, mp)) == \
        dataclasses.astuple(jelastic.plan_mesh(n, mp))


def test_plan_mesh_shrinks_gracefully():
    assert elastic.plan_mesh(512, 16).shape == (32, 16)
    assert elastic.plan_mesh(256, 16).shape == (16, 16)
    p = elastic.plan_mesh(250, 16)   # lost 6 nodes of a 256 pod
    assert p.shape == (15, 16) and p.spares == 10
    p2 = elastic.plan_mesh(8, 16)    # catastrophic loss: degrade TP
    assert p2.shape[1] <= 8 and p2.num_devices <= 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rebalance_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    old = [f"w{i}" for i in range(int(rng.integers(2, 9)))]
    new = [w for w in old if rng.random() < 0.6] or old[:1]
    num_shards = int(rng.integers(1, 40))
    assert elastic.rebalance_shards(num_shards, old, new) == \
        jelastic.rebalance_shards(num_shards, old, new)


def test_rebalance_minimizes_movement():
    old = ["w0", "w1", "w2", "w3"]
    new = ["w0", "w1", "w3"]  # w2 died
    assign = elastic.rebalance_shards(8, old, new)
    for s in range(8):
        if old[s % 4] != "w2":
            assert assign[s] == old[s % 4]
    assert set(assign.values()) <= set(new)
    counts = [list(assign.values()).count(w) for w in new]
    assert max(counts) - min(counts) <= 1


def test_meshes_refuse_a_world_smaller_than_the_mesh():
    """Importing launch.mesh touched no process group; without a world of
    enough ranks every mesh builder raises, as the reference raises without
    enough devices."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        port_mesh.make_test_mesh()
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        port_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True)


def _mesh_rank(rank, world, port, out_dir):
    """One rank of a 4-rank gloo world: build the meshes and record them."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        a = elastic.build_mesh(elastic.plan_mesh(world, model_parallel=2))
        b = port_mesh.make_test_mesh((2, 2), ("data", "model"))
        c = elastic.build_mesh(elastic.plan_mesh(3, model_parallel=2))
        out = {
            "a": [a.mesh.tolist(), list(a.mesh_dim_names)],
            "b": [b.mesh.tolist(), list(b.mesh_dim_names)],
            "c": [c.mesh.tolist(), list(c.mesh_dim_names)],
            "model_group": dist.get_process_group_ranks(b.get_group("model")),
        }
        try:
            port_mesh.make_test_mesh((2, 4))
        except RuntimeError as e:
            out["too_small"] = str(e)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_meshes_over_a_gloo_world(tmp_path):
    from repro_torch.core.distributed import _free_port

    port = _free_port()
    with spawn_friendly_env() as ctx:
        procs = [ctx.Process(target=_mesh_rank, args=(r, 4, port, str(tmp_path)))
                 for r in range(4)]
        for p in procs:
            p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0] * 4
    for r in range(4):
        with open(tmp_path / f"{r}.json") as f:
            got = json.load(f)
        assert got["a"] == [[[0, 1], [2, 3]], ["data", "model"]]
        assert got["b"] == got["a"]
        assert got["c"] == [[[0, 1]], ["data", "model"]]  # 1 spare of 3 survivors
        assert got["model_group"] == ([0, 1] if r < 2 else [2, 3])
        assert "needs 8 ranks, have 4" in got["too_small"]


# ------------------------------------------------- parallel-ingest faults
def _spill_job_kw(out_path, num_shards=6, budget=1 << 12):
    return dict(output="store", out_path=out_path, method="list-scan",
                num_shards=num_shards, dense_vocab_cap=1,  # force spill
                memory_budget_pairs=budget, df_descending=True)


def _plan(jc, out_path):
    c = collection_from_numpy(jc.doc_ptr, jc.terms, jc.vocab_size)
    plan = Planner().plan(CountJob(collection=c, device="cpu", **_spill_job_kw(out_path)))
    assert plan.sink_policy == "spill"
    return plan


def _jplan(jc, out_path):
    return JPlanner().plan(JCountJob(collection=jc, use_kernel=False,
                                     **_spill_job_kw(out_path)))


def _segment_files(store_dir):
    segs = sorted(glob.glob(os.path.join(store_dir, "seg-*")))
    assert len(segs) == 1, segs
    out = {}
    for p in sorted(glob.glob(os.path.join(segs[0], "*.bin"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


@pytest.fixture(scope="module")
def fault_corpus():
    c = synthetic_zipf_collection(90, vocab=300, mean_len=12, seed=7)
    cd, _ = remap_df_descending(c)
    return cd


@pytest.fixture(scope="module")
def want(fault_corpus, tmp_path_factory):
    """The JAX package's serial segment of the fault corpus."""
    root = tmp_path_factory.mktemp("serial")
    JPlanExecutor().execute(_jplan(fault_corpus, str(root / "store")),
                            out_dir=str(root / "wd"))
    return _segment_files(str(root / "store"))


def _kill_stalled(monkeypatch, tmp_path, plan, ex, stall):
    """Run ``ex`` on ``plan`` in a thread with the stall armed, SIGKILL the
    worker that publishes its pid, and return the result and the pid."""
    monkeypatch.setenv("REPRO_TEST_SPILL_STALL", json.dumps(stall))
    wd = str(tmp_path / "wd_par")
    holder = {}
    th = threading.Thread(
        target=lambda: holder.update(res=ex.execute(plan, out_dir=wd)), daemon=True
    )
    th.start()
    deadline = time.time() + 90.0
    markers = []
    while not markers and time.time() < deadline:
        markers = glob.glob(os.path.join(wd, "stall_*.pid"))
        time.sleep(0.02)
    assert markers, "stalled worker never published its pid"
    with open(markers[0]) as f:
        pid = int(f.read())
    os.kill(pid, signal.SIGKILL)
    th.join(timeout=180.0)
    assert not th.is_alive(), "parallel ingest did not finish after the kill"
    return holder["res"], os.path.basename(markers[0])[len("stall_"):-len(".pid")]


def test_parallel_ingest_survives_sigkilled_worker(
    tmp_path, monkeypatch, fault_corpus, want
):
    """SIGKILL the spill worker that claimed shard 0, mid-shard (lease held,
    spill output still in its wip directory): the lease expires, a survivor
    reclaims the shard, and the final segment is byte-identical to a serial
    build."""
    plan = _plan(fault_corpus, str(tmp_path / "store_par"))
    ex = ParallelExecutor(num_workers=2, lease_seconds=2.0)
    res, killed = _kill_stalled(monkeypatch, tmp_path, plan, ex,
                                {"shard": 0, "seconds": 120})
    assert res.summary["reclaimed_shards"] >= 1     # the lease was reclaimed
    assert _segment_files(str(tmp_path / "store_par")) == want
    per = {w["worker"]: w for w in res.summary["per_worker"]}
    assert per[killed]["exitcode"] == -signal.SIGKILL
    assert per[killed]["device"] is None            # it never reported
    survivor = per["w1" if killed == "w0" else "w0"]
    assert survivor["exitcode"] == 0 and survivor["shards"] >= 1


def test_parallel_ingest_parent_drains_when_all_workers_die(
    tmp_path, monkeypatch, fault_corpus, want
):
    """Crash storm: with every worker dead and shards outstanding, the
    parent drains the queue inline through the same claim loop — output is
    still byte-identical."""
    plan = _plan(fault_corpus, str(tmp_path / "store_par"))
    ex = ParallelExecutor(num_workers=1, lease_seconds=1.5)  # lone worker
    res, _ = _kill_stalled(monkeypatch, tmp_path, plan, ex,
                           {"worker": "w0", "seconds": 120})
    assert res.summary["reclaimed_shards"] >= 1
    assert res.summary["parent_shards"] >= 1
    assert _segment_files(str(tmp_path / "store_par")) == want


def test_parallel_finalizer_crash_resumes(tmp_path, monkeypatch, fault_corpus, want):
    """Kill the finalizer between bucket merges: the already-merged bucket
    files survive as resumable intermediates, and a resume completes from
    them (without redoing them) to a byte-identical segment."""
    wd = str(tmp_path / "wd_par")
    plan = _plan(fault_corpus, str(tmp_path / "store_par"))
    monkeypatch.setenv("REPRO_TEST_FAIL_AFTER_MERGES", "2")
    with pytest.raises(RuntimeError, match="injected finalizer crash"):
        ParallelExecutor(num_workers=1).execute(plan, out_dir=wd)
    survivors = sorted(glob.glob(os.path.join(wd, "merge", "bucket_*.run")))
    assert len(survivors) == 2          # exactly the pre-crash merges remain
    before = {p: os.stat(p).st_mtime_ns for p in survivors}

    monkeypatch.delenv("REPRO_TEST_FAIL_AFTER_MERGES")
    res = ParallelExecutor(num_workers=1).execute(plan, out_dir=wd, resume=True)
    assert _segment_files(str(tmp_path / "store_par")) == want
    assert res.summary["exact"] is True
    assert res.summary["per_worker"] == []  # every shard was already counted
    for p, mtime in before.items():
        assert os.stat(p).st_mtime_ns == mtime


def test_port_resumes_the_reference_executors_crashed_run(
    tmp_path, monkeypatch, fault_corpus, want
):
    """The JAX package's ParallelExecutor crashes between bucket merges; the
    port's resumes its workdir (claims file, promoted shards, merged
    buckets) without counting a shard again, to the same bytes."""
    wd = str(tmp_path / "wd")
    store = str(tmp_path / "store")
    monkeypatch.setenv("REPRO_TEST_FAIL_AFTER_MERGES", "2")
    with pytest.raises(RuntimeError, match="injected finalizer crash"):
        JParallelExecutor(num_workers=1).execute(_jplan(fault_corpus, store), out_dir=wd)
    survivors = sorted(glob.glob(os.path.join(wd, "merge", "bucket_*.run")))
    assert len(survivors) == 2
    before = {p: os.stat(p).st_mtime_ns for p in survivors}

    monkeypatch.delenv("REPRO_TEST_FAIL_AFTER_MERGES")
    res = ParallelExecutor(num_workers=2).execute(
        _plan(fault_corpus, store), out_dir=wd, resume=True
    )
    assert _segment_files(store) == want
    assert res.summary["per_worker"] == [] and res.summary["parent_shards"] == 0
    for p, mtime in before.items():
        assert os.stat(p).st_mtime_ns == mtime
