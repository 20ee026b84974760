"""The port's planner, checkpoint/resume and batch driver against the JAX
package's.

* ``method="auto"`` on the host picks what the reference picks, on the same
  statistics and collections (the golden selections of tests/test_plan.py);
* on a CUDA device (planning only, nothing is launched) auto ranks
  ``list-scan-segment``, plus ``freq-split`` when the IDs are df-descending,
  and never the opt-in kernel adaptations;
* the executor resumes from its checkpoints exactly, and a checkpoint that
  either package writes restores in the other;
* ``launch.cooc_run`` on the CPU writes a pairs file byte-identical to the
  reference driver's.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt  # noqa: E402
from repro.core.oracle import brute_force_counts  # noqa: E402
from repro.core.plan import CountJob as JCountJob  # noqa: E402
from repro.core.plan import Planner as JPlanner  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro.data.preprocess import remap_df_descending as jremap  # noqa: E402
from repro.launch import cooc_run as jcooc_run  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.convert import collection_from_numpy  # noqa: E402
from repro_torch.core import specs  # noqa: E402
from repro_torch.core.plan import CountJob, Planner, execute_job  # noqa: E402
from repro_torch.data.corpus import CollectionStats  # noqa: E402
from repro_torch.launch import cooc_run  # noqa: E402

OPT_IN = {"list-blocks-gram", "multi-scan-matmul", "list-pairs-bitpacked"}


def _pair(docs, vocab, mean_len, seed=5, df=False):
    jc = synthetic_zipf_collection(docs, vocab=vocab, mean_len=mean_len, seed=seed)
    if df:
        jc, _ = jremap(jc)
    return jc, collection_from_numpy(jc.doc_ptr, jc.terms, jc.vocab_size)


@pytest.fixture(scope="module")
def coll():
    return _pair(80, 150, 14, seed=11)


# ------------------------------------------------------------ auto selection
def _auto_pick(stats):
    ranked = sorted(
        (spec.cost(stats, spec.defaults()), name)
        for name, spec in specs.REGISTRY.items()
        if spec.kind == "paper"
    )
    return ranked[0][1]


def test_auto_selection_golden_small_medium_large():
    """The paper's narrative, on the port's statistics and cost models:
    LIST-PAIRS wins small, LIST-BLOCKS medium, LIST-SCAN large."""
    picks = [
        _auto_pick(CollectionStats.from_collection(_pair(d, v, ml)[1]))
        for d, v, ml in ((400, 64, 60), (1_500, 30_000, 40), (40_000, 16_000, 50))
    ]
    assert picks == ["list-pairs", "list-blocks", "list-scan"]


@pytest.mark.parametrize(
    "docs,vocab,mean_len,df",
    [(400, 64, 60, False), (1_500, 30_000, 40, False), (400, 2_000, 40, True),
     (600, 3_000, 230, True), (80, 150, 14, False), (150, 5_000, 60, False)],
)
def test_host_auto_picks_what_the_reference_picks(docs, vocab, mean_len, df):
    jc, c = _pair(docs, vocab, mean_len, df=df)
    plan = Planner().plan(
        CountJob(collection=c, output="stats", df_descending=df, device="cpu")
    )
    jplan = JPlanner().plan(JCountJob(collection=jc, output="stats", df_descending=df))
    assert plan.method == jplan.method
    assert plan.ranking == jplan.ranking
    if df:
        assert "freq-split" in dict(plan.ranking)
        if "head" in plan.method_kwargs:
            assert plan.method_kwargs["head"] == jplan.method_kwargs["head"]


@pytest.mark.parametrize("df", [False, True])
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_cuda_auto_ranks_freq_split_only_when_df_descending(df, device):
    """Planning only. On this collection the opt-in ``multi-scan-matmul``
    prices below ``list-scan-segment``, and is still not ranked."""
    _, c = _pair(600, 3_000, 230, df=df)
    plan = Planner().plan(
        CountJob(collection=c, output="stats", df_descending=df, device=device)
    )
    ranked = dict(plan.ranking)
    assert set(ranked) == ({"list-scan-segment", "freq-split"} if df
                           else {"list-scan-segment"})
    assert plan.method == ("freq-split" if df else "list-scan-segment")
    assert plan.method_kwargs["device"] == device
    stats = plan.collection_stats
    ms = specs.REGISTRY["multi-scan-matmul"]
    assert ms.cost(stats, ms.defaults()) < ranked["list-scan-segment"]


def test_opt_in_methods_are_never_ranked():
    jobs = [
        CountJob(collection=_pair(200, 500, 30, df=df)[1], output="stats",
                 df_descending=df, device=dev)
        for df in (False, True) for dev in ("cpu", "cuda")
    ]
    for job in jobs:
        names = {s.name for s in Planner().candidates(job)}
        assert not names & OPT_IN
        assert ("freq-split" in names) == job.df_descending
    assert {n for n, s in specs.REGISTRY.items() if s.kind == "opt-in"} == OPT_IN


def test_explicit_opt_in_method_runs_when_named(coll):
    jc, c = coll
    for method in sorted(OPT_IN):
        res = execute_job(CountJob(collection=c, output="dense", method=method,
                                   device="cpu"))
        assert np.array_equal(res.counts, brute_force_counts(jc)), method


def test_count_job_df_descending_validation(coll):
    _, c = coll
    with pytest.raises(ValueError, match="df-descending"):
        CountJob(collection=c, method="freq-split")
    CountJob(collection=c, method="freq-split", df_descending=True)
    with pytest.raises(ValueError, match="unsupported device"):
        CountJob(collection=c, device="mps")
    assert specs.REGISTRY["freq-split"].needs_df_descending
    assert specs.REGISTRY["freq-split"].needs_emit_col


def test_auto_clamps_the_freq_split_head_to_the_vocabulary():
    _, c = _pair(100, 300, 20, df=True)
    plan = Planner().plan(CountJob(collection=c, output="stats", method="auto",
                                   df_descending=True, device="cpu"))
    kw = Planner().resolve_kwargs(specs.REGISTRY["freq-split"], plan.job,
                                  plan.collection_stats)
    assert kw["head"] == 300


# ---------------------------------------------------------- checkpoint/resume
def _spill_job(c, shards, method="list-scan"):
    return CountJob(collection=c, output="stats", method=method, device="cpu",
                    dense_vocab_cap=1, num_shards=shards, memory_budget_pairs=128)


def test_executor_resume_spill(tmp_path, coll):
    """Resume after completion on the spill path: completed shards' run
    files are reused, nothing is counted twice."""
    jc, c = coll
    oracle = brute_force_counts(jc)
    out = str(tmp_path / "run")
    plan = Planner().plan(_spill_job(c, 6))
    res = plan.execute(out_dir=out, ckpt_every=2)
    assert res.summary["total_count"] == int(oracle.sum())
    res2 = plan.execute(out_dir=out, ckpt_every=2, resume=True)
    assert res2.summary["total_count"] == int(oracle.sum())
    assert res2.summary["distinct_pairs"] == int((oracle > 0).sum())


def test_executor_fresh_run_ignores_stale_spill_dirs(tmp_path, coll):
    """A fresh run into an out_dir that a run with MORE shards populated
    must not fold the stale runs into the merge."""
    jc, c = coll
    oracle = brute_force_counts(jc)
    out = str(tmp_path / "run")
    res8 = execute_job(_spill_job(c, 8), out_dir=out)
    res3 = execute_job(_spill_job(c, 3), out_dir=out)
    assert res8.summary["total_count"] == int(oracle.sum())
    assert res3.summary["total_count"] == int(oracle.sum())
    assert res3.summary["distinct_pairs"] == int((oracle > 0).sum())


class _Crash(RuntimeError):
    pass


def _counting(monkeypatch, method, crash_at=None):
    """Wrap ``method``'s registered callable: record the documents of each
    shard it counts and raise on call number ``crash_at``."""
    spec = specs.REGISTRY[method]
    base = getattr(spec.fn, "counted", spec.fn)
    seen = []

    def fn(shard, sink, **kw):
        if crash_at is not None and len(seen) + 1 == crash_at:
            raise _Crash(f"shard call {crash_at}")
        seen.append(shard.num_docs)
        return base(shard, sink, **kw)

    fn.counted = base
    monkeypatch.setitem(specs.REGISTRY, method, dataclasses.replace(spec, fn=fn))
    return seen


@pytest.mark.parametrize("output,cap", [("stats", 1), ("dense", 4096)])
def test_executor_resumes_a_crashed_run_exactly(output, cap, tmp_path, coll, monkeypatch):
    """A run that dies on its 5th shard (checkpoints every 2) resumes from
    the last checkpoint: only the 2 shards after it are counted again, and
    the result is exact — on the spill and the dense policy alike."""
    jc, c = coll
    oracle = brute_force_counts(jc)
    out = str(tmp_path / "run")
    job = CountJob(collection=c, output=output, method="list-scan", device="cpu",
                   dense_vocab_cap=cap, num_shards=6, memory_budget_pairs=128)
    plan = Planner().plan(job)
    assert plan.sink_policy == ("spill" if output == "stats" else "dense")
    first = _counting(monkeypatch, "list-scan", crash_at=5)
    with pytest.raises(_Crash):
        plan.execute(out_dir=out, ckpt_every=2)
    assert len(first) == 4
    assert checkpoint.latest_step(os.path.join(out, "ckpt")) == 4
    again = _counting(monkeypatch, "list-scan")
    res = plan.execute(out_dir=out, ckpt_every=2, resume=True)
    assert len(again) == 2
    assert res.summary["total_count"] == int(oracle.sum())
    assert res.summary["distinct_pairs"] == int((oracle > 0).sum())
    if output == "dense":
        assert np.array_equal(res.counts, oracle)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_written_by_one_package_restores_in_the_other(writer, tmp_path):
    rng = np.random.default_rng(3)
    tree = {
        "acc": rng.integers(0, 1000, (5, 7)).astype(np.int32),
        "nested": {"b": rng.random(4).astype(np.float32), "a": np.arange(3, dtype=np.int32)},
    }
    extra = {"agg": {"total_count": 12}, "tracker": [[0], [1]]}
    save, restore = (
        (checkpoint.save_checkpoint, jckpt.restore_checkpoint) if writer == "port"
        else (jckpt.save_checkpoint, checkpoint.restore_checkpoint)
    )
    d = str(tmp_path / "ckpt")
    save(d, 3, tree, extra=extra)
    save(d, 7, tree, extra=extra)
    assert checkpoint.latest_step(d) == jckpt.latest_step(d) == 7
    got, got_extra = restore(d, 7, tree)
    assert got_extra == extra
    for key in ("acc",):
        assert np.array_equal(np.asarray(got[key]), tree[key])
    for key in ("a", "b"):
        assert np.array_equal(np.asarray(got["nested"][key]), tree["nested"][key])


def test_checkpoint_restore_rejects_another_structure(tmp_path):
    d = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(d, 1, {"acc": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_checkpoint(d, 1, {"acc": np.zeros((3, 2))})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_checkpoint(d, 1, {"acc": np.zeros((2, 2)), "b": np.zeros(1)})


# ----------------------------------------------------------------- cooc_run
@pytest.mark.parametrize(
    "method,docs,vocab", [("auto", 400, 2_000), ("auto", 300, 120), ("freq-split", 400, 2_000)]
)
def test_cooc_run_pairs_file_matches_the_reference_driver(method, docs, vocab, tmp_path):
    kw = dict(num_docs=docs, vocab=vocab, num_shards=4, memory_budget_pairs=4096)
    res = cooc_run.run(method=method, out_dir=str(tmp_path / "port"), device="cpu", **kw)
    jres = jcooc_run.run(method=method, out_dir=str(tmp_path / "ref"), **kw)
    assert res["method"] == jres["method"]
    assert res["device"] == "cpu"
    assert filecmp.cmp(str(tmp_path / "port" / "pairs.bin"),
                       str(tmp_path / "ref" / "pairs.bin"), shallow=False)
    assert res["total_count"] == jres["total_count"]


def test_cooc_run_resume_counts_no_shard_again(tmp_path, monkeypatch):
    kw = dict(num_docs=300, vocab=1_500, num_shards=4, memory_budget_pairs=4096,
              out_dir=str(tmp_path), device="cpu", method="freq-split")
    first = _counting(monkeypatch, "freq-split")
    res = cooc_run.run(**kw)
    assert len(first) == 4
    with open(tmp_path / "pairs.bin", "rb") as f:
        pairs = f.read()
    again = _counting(monkeypatch, "freq-split")
    res2 = cooc_run.run(resume=True, **kw)
    assert again == []
    assert res2["total_count"] == res["total_count"]
    with open(tmp_path / "pairs.bin", "rb") as f:
        assert f.read() == pairs


def test_cooc_run_cli_rejects_ingest_workers(capsys):
    """N > 1 ingest workers run (tests/test_torch_parallel_ingest.py);
    fewer than one is refused before anything runs."""
    with pytest.raises(SystemExit):
        cooc_run.main(["--ingest-workers", "0", "--device", "cpu"])
    assert "--ingest-workers must be at least 1" in capsys.readouterr().err
