"""The port's parallel ingest against its serial executor and the JAX
package's.

Twins of ``tests/test_parallel_ingest.py`` on ``repro_torch`` with
``device="cpu"``: the ``SharedWorkTracker`` lease discipline (and a claims
file one package creates, the other works), and the byte-identity sweep
over every ingest method × workers {1, 2, 4} — the port's
``ParallelExecutor`` must write the segment its serial ``PlanExecutor``
writes and the one the JAX package's serial executor writes, byte for byte.
Then the empty corpus, the explicit merge pool, the pairs file, non-spill
delegation, what each spawned worker reports, and ``cooc_run
--ingest-workers``.
"""

import filecmp
import glob
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plan import CountJob as JCountJob  # noqa: E402
from repro.core.plan import Planner as JPlanner  # noqa: E402
from repro.core.plan import PlanExecutor as JPlanExecutor  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection as jzipf  # noqa: E402
from repro.data.preprocess import preprocess_documents  # noqa: E402
from repro.data.preprocess import remap_df_descending as jremap  # noqa: E402
from repro.runtime.fault import SharedWorkTracker as JSharedWorkTracker  # noqa: E402
from repro_torch.convert import collection_from_numpy  # noqa: E402
from repro_torch.core.oracle import brute_force_counts  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    CountJob,
    ParallelExecutor,
    Planner,
    PlanExecutor,
)
from repro_torch.launch import cooc_run  # noqa: E402
from repro_torch.runtime.fault import SharedWorkTracker  # noqa: E402

# the ingest write-path methods (the reference test's set)
INGEST_METHODS = ["list-scan", "list-blocks", "freq-split", "list-scan-segment"]

VOCAB = 40


def random_corpus(seed: int):
    """The reference test's random raw corpus (duplicates, unsorted) through
    the JAX package's preprocessing, remapped by df: the same collection
    reaches both packages."""
    rng = np.random.default_rng(seed)
    docs = [
        rng.integers(0, VOCAB, size=int(rng.integers(0, 25))).tolist()
        for _ in range(int(rng.integers(1, 25)))
    ]
    jc, _ = jremap(preprocess_documents(docs, vocab_size=VOCAB))
    return jc


def port(jc):
    return collection_from_numpy(jc.doc_ptr, jc.terms, jc.vocab_size)


# ------------------------------------------------------------------ helpers
def build_store(cd, method, out_root, executor, *, num_shards=4, budget=512):
    """Plan + execute a store build under the spill policy (dense_vocab_cap
    is forced to 1 so even tiny test vocabularies take the spill path the
    parallel executor parallelizes)."""
    job = CountJob(
        collection=cd, output="store", out_path=os.path.join(out_root, "store"),
        method=method, num_shards=num_shards, dense_vocab_cap=1,
        memory_budget_pairs=budget, df_descending=True, device="cpu",
    )
    plan = Planner().plan(job)
    assert plan.sink_policy == "spill"
    return executor.execute(plan, out_dir=os.path.join(out_root, "wd"))


def build_store_jax(jc, method, out_root, *, num_shards=4, budget=512):
    job = JCountJob(
        collection=jc, output="store", out_path=os.path.join(out_root, "store"),
        method=method, num_shards=num_shards, dense_vocab_cap=1,
        memory_budget_pairs=budget, df_descending=True, use_kernel=False,
    )
    JPlanExecutor().execute(JPlanner().plan(job), out_dir=os.path.join(out_root, "wd"))


def segment_files(store_dir):
    """{filename: bytes} of the store's single segment's binary arrays."""
    segs = sorted(glob.glob(os.path.join(store_dir, "seg-*")))
    assert len(segs) == 1, segs
    out = {}
    for p in sorted(glob.glob(os.path.join(segs[0], "*.bin"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    assert out, "segment has no binary arrays"
    return out


# ------------------------------------------------- SharedWorkTracker units
def test_shared_tracker_flow(tmp_path):
    path = str(tmp_path / "claims.json")
    t = SharedWorkTracker.create(path, [(0,), (1,)], lease_seconds=30.0)
    u = t.claim("a")
    assert u == (0,)
    assert t.renew(u, "a") is True
    assert t.renew(u, "b") is False           # not the lease holder
    committed = []
    assert t.complete(u, "a", commit=lambda: committed.append(u)) is True
    assert committed == [u]
    assert t.complete(u, "a") is False        # duplicate ignored
    assert t.snapshot()["completions_ignored"] == 1
    # a second process opens the same state file and sees the same queue
    u2 = SharedWorkTracker.open(path).claim("b")
    assert u2 == (1,)
    assert not t.finished                     # (1,) still leased
    assert t.complete(u2, "b")
    assert t.finished
    assert t.done_units() == {(0,), (1,)}


def test_shared_tracker_ttl_reclaim(tmp_path):
    """A lease acquired and never renewed must not block the shard forever:
    a second claimer reclaims it once the TTL deadline passes."""
    t = SharedWorkTracker.create(str(tmp_path / "c.json"), [(0,)], lease_seconds=0.2)
    u = t.claim("dead")
    assert t.claim("live") is None            # lease still current
    time.sleep(0.3)
    assert t.claim("live") == u               # expired → reclaimed
    assert t.reclaims == 1
    assert t.renew(u, "dead") is False        # original lost the lease
    assert t.complete(u, "live")
    assert t.complete(u, "dead") is False     # late straggler ignored
    assert t.finished


def test_shared_tracker_renew_keeps_lease_alive(tmp_path):
    t = SharedWorkTracker.create(str(tmp_path / "c.json"), [(0,)], lease_seconds=0.3)
    u = t.claim("w")
    for _ in range(4):                        # heartbeats outlive the TTL
        time.sleep(0.15)
        assert t.renew(u, "w") is True
    assert t.claim("thief") is None           # never reclaimable while renewed
    assert t.complete(u, "w")


def test_shared_tracker_requeue_drops_done_record(tmp_path):
    t = SharedWorkTracker.create(str(tmp_path / "c.json"), [(3,)])
    u = t.claim("w")
    assert t.complete(u, "w")
    assert t.finished
    t.requeue(u)                              # committed artifact went missing
    assert not t.finished
    assert t.done_units() == set()
    assert t.claim("w2") == u


def test_shared_tracker_failed_commit_keeps_unit_undone(tmp_path):
    """complete() runs the commit under the lock BEFORE recording done — a
    commit that raises must leave the unit leased/undone, so the lease TTL
    eventually hands it to another worker."""
    t = SharedWorkTracker.create(str(tmp_path / "c.json"), [(0,)], lease_seconds=0.2)
    u = t.claim("w")

    def boom():
        raise RuntimeError("rename failed")

    with pytest.raises(RuntimeError, match="rename failed"):
        t.complete(u, "w", commit=boom)
    assert t.done_units() == set()
    time.sleep(0.3)
    assert t.claim("retry") == u


@pytest.mark.parametrize("creator", ["port", "reference"])
def test_shared_tracker_state_file_is_shared_across_packages(creator, tmp_path):
    """One claims file, both packages' trackers: what one leases and
    completes, the other sees."""
    make, other = ((SharedWorkTracker, JSharedWorkTracker) if creator == "port"
                   else (JSharedWorkTracker, SharedWorkTracker))
    path = str(tmp_path / "claims.json")
    a = make.create(path, [(0,), (1,), (2,)], lease_seconds=30.0)
    u = a.claim("a")
    b = other.open(path)
    assert b.claim("b") == (1,)               # (0,) is a's lease
    assert b.complete((1,), "b") and a.complete(u, "a")
    assert a.done_units() == b.done_units() == {(0,), (1,)}
    assert b.claim("b") == (2,) and b.complete((2,), "b")
    assert a.finished and b.finished


# ----------------------------------------------------- byte-identity tests
@pytest.fixture(scope="module")
def serial_bytes(tmp_path_factory):
    """Per (seed, method): the port's serial segment and the JAX package's
    serial segment, each built once for the worker-count sweep."""
    cache = {}

    def get(seed, method, jc):
        if (seed, method) not in cache:
            root = tmp_path_factory.mktemp(f"serial_{seed}_{method}")
            build_store(port(jc), method, str(root / "port"), PlanExecutor())
            build_store_jax(jc, method, str(root / "jax"))
            cache[seed, method] = (
                segment_files(str(root / "port" / "store")),
                segment_files(str(root / "jax" / "store")),
            )
        return cache[seed, method]

    return get


def _check_byte_identical(jc, workers, method, tmp_path, serial_bytes, seed):
    cd = port(jc)
    mine, theirs = serial_bytes(seed, method, jc)
    assert mine == theirs                     # the serial builds agree
    res = build_store(cd, method, str(tmp_path / "par"),
                      ParallelExecutor(num_workers=workers))
    assert segment_files(str(tmp_path / "par" / "store")) == mine
    assert np.array_equal(res.store.dense(), brute_force_counts(cd))
    assert res.summary["ingest_workers"] == workers
    assert res.summary["exact"] is True
    return res


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("method", INGEST_METHODS)
def test_parallel_ingest_byte_identical(method, workers, tmp_path, serial_bytes):
    """Random corpora, worker counts N ∈ {1, 2, 4}, every ingest method: the
    port's parallel segment is byte-for-byte its serial executor's and the
    JAX package's serial executor's, and holds the brute-force counts."""
    seed = 100 + INGEST_METHODS.index(method)
    res = _check_byte_identical(random_corpus(seed), workers, method, tmp_path,
                                serial_bytes, seed)
    per = res.summary["per_worker"]
    assert [w["worker"] for w in per] == [f"w{i}" for i in range(workers)]
    assert all(w["exitcode"] == 0 and w["device"] == "cpu" for w in per)
    assert sum(w["shards"] for w in per) == 4 and res.summary["parent_shards"] == 0
    assert all(w["startup_s"] > 0 for w in per)
    # launch counters count the card's kernels only: none on the CPU
    assert not any(sum(w["kernel_launches"].values()) for w in per)


def test_parallel_ingest_empty_corpus(tmp_path, serial_bytes):
    """Degenerate corpus (no pairs at all) still round-trips: empty shards
    promote, zero buckets merge, and the empty segments match."""
    jc, _ = jremap(preprocess_documents([[], [7], []], vocab_size=VOCAB))
    _check_byte_identical(jc, 2, "list-scan", tmp_path, serial_bytes, "empty")


def test_parallel_merge_pool_explicit_below_threshold(tmp_path):
    """Small spills merge inline by default (pool spawn cost would dominate),
    but an explicit merge_workers= forces the bucket-merge process pool —
    which must still produce byte-identical segments."""
    jc = random_corpus(321)
    build_store_jax(jc, "list-scan", str(tmp_path / "a"))
    want = segment_files(str(tmp_path / "a" / "store"))
    build_store(port(jc), "list-scan", str(tmp_path / "b"),
                ParallelExecutor(num_workers=2, merge_workers=2))
    assert segment_files(str(tmp_path / "b" / "store")) == want


def test_parallel_pairs_file_identical(tmp_path):
    """The pairs-file output target goes through the same shared row
    emitter: parallel bytes == serial bytes == the JAX package's."""
    jc, _ = jremap(jzipf(150, vocab=500, mean_len=12, seed=13))
    kw = dict(output="pairs-file", method="list-scan", num_shards=5,
              memory_budget_pairs=1 << 12, df_descending=True)

    def build(out_root, executor):
        job = CountJob(collection=port(jc), out_path=str(out_root / "pairs.bin"),
                       device="cpu", **kw)
        plan = Planner().plan(job)
        assert plan.sink_policy == "spill"
        executor.execute(plan, out_dir=str(out_root / "wd"))
        return str(out_root / "pairs.bin")

    jplan = JPlanner().plan(JCountJob(collection=jc, out_path=str(tmp_path / "j.bin"),
                                      use_kernel=False, **kw))
    JPlanExecutor().execute(jplan, out_dir=str(tmp_path / "jwd"))
    a = build(tmp_path / "a", PlanExecutor())
    b = build(tmp_path / "b", ParallelExecutor(num_workers=2))
    assert filecmp.cmp(a, b, shallow=False)
    assert filecmp.cmp(b, str(tmp_path / "j.bin"), shallow=False)


def test_parallel_delegates_non_spill_policies(tmp_path):
    """Dense-policy plans fall back to the serial executor (in-memory merges
    gain nothing from process fan-out) and still produce exact output."""
    c = port(jzipf(40, vocab=60, mean_len=8, seed=2))
    plan = Planner().plan(CountJob(collection=c, output="dense",
                                   method="list-scan", device="cpu"))
    assert plan.sink_policy == "dense"
    res = ParallelExecutor(num_workers=2).execute(plan, out_dir=str(tmp_path / "wd"))
    assert np.array_equal(res.counts, brute_force_counts(c))
    assert "per_worker" not in res.summary


def test_parallel_summary_splits_start_up_from_counting(tmp_path):
    """The summary's timings: ready_wait_s (spawn to the ready barrier),
    count_s and finalize_s tile elapsed_s; docs/hour of the work after the
    barrier is at least the whole run's."""
    jc = random_corpus(7)
    res = build_store(port(jc), "list-scan", str(tmp_path), ParallelExecutor(2))
    s = res.summary
    assert s["ready_wait_s"] > 0 and s["count_s"] >= 0 and s["finalize_s"] >= 0
    assert abs(s["ready_wait_s"] + s["count_s"] + s["finalize_s"]
               - s["elapsed_s"]) <= 0.05
    assert s["docs_per_hour_work"] >= s["docs_per_hour"]
    assert max(w["startup_s"] for w in s["per_worker"]) <= s["ready_wait_s"] + 0.05
    assert s["reclaimed_shards"] == 0


@pytest.mark.parametrize("workers", [2])
def test_cooc_run_ingest_workers_matches_serial(workers, tmp_path):
    """``cooc_run --ingest-workers N`` through its CLI: the pairs file equals
    the serial run's, and the result carries the parallel summary."""
    args = ["--docs", "300", "--vocab", "1500", "--shards", "4",
            "--budget-pairs", "4096", "--device", "cpu"]
    cooc_run.main(args + ["--out", str(tmp_path / "serial")])
    cooc_run.main(args + ["--out", str(tmp_path / "par"),
                          "--ingest-workers", str(workers)])
    assert filecmp.cmp(str(tmp_path / "serial" / "pairs.bin"),
                       str(tmp_path / "par" / "pairs.bin"), shallow=False)
    import json

    with open(tmp_path / "par" / "result.json") as f:
        res = json.load(f)
    assert res["ingest_workers"] == workers and len(res["per_worker"]) == workers
