"""The port's LIST-SCAN and store build against the JAX package's.

The same Zipf collections (numpy, from a seed) go through both packages:
dense counts must be equal, and a store's six CSR arrays byte-identical.
Stores cross between the packages through their shared on-disk format,
v1 and v2 alike.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cooc as jcooc  # noqa: E402
from repro.core.list_scan import count_list_scan_segment as jax_segment  # noqa: E402
from repro.core.oracle import brute_force_counts  # noqa: E402
from repro.core.types import DenseSink as JDenseSink  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro_torch.convert import collection_from_numpy  # noqa: E402
from repro_torch.core import cooc, list_scan  # noqa: E402
from repro_torch.core.list_scan import count_list_scan_segment  # noqa: E402
from repro_torch.core.plan import CountJob, Planner  # noqa: E402
from repro_torch.core.types import DenseSink  # noqa: E402
from repro_torch.data.index import DeviceIndex, build_inverted_index  # noqa: E402
from repro_torch.store import QueryEngine, Store  # noqa: E402

SEGMENT_ARRAYS = (
    "row_ptr.bin", "cols.bin", "counts.bin", "df.bin",
    "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin",
)


def _pair(docs, vocab, seed, mean_len=30):
    """The same collection in both packages."""
    jc = synthetic_zipf_collection(docs, vocab=vocab, mean_len=mean_len, seed=seed)
    return jc, collection_from_numpy(jc.doc_ptr, jc.terms, jc.vocab_size)


def _same_segments(dir_a, dir_b):
    return all(
        filecmp.cmp(os.path.join(dir_a, n), os.path.join(dir_b, n), shallow=False)
        for n in SEGMENT_ARRAYS
    )


@pytest.mark.parametrize(
    "docs,vocab,seed,rows_per_batch,launch_tokens",
    [
        (60, 40, 0, 64, 1 << 26),
        (120, 200, 1, 16, 1 << 26),
        (200, 300, 2, 7, 500),     # small launches: batches split in chunks
        (90, 130, 3, 32, 1),       # one posting per launch
    ],
)
def test_segment_counts_match_jax_and_oracle(
    docs, vocab, seed, rows_per_batch, launch_tokens, monkeypatch
):
    monkeypatch.setattr(list_scan, "LAUNCH_TOKENS", launch_tokens)
    jc, c = _pair(docs, vocab, seed)
    sink = DenseSink(vocab)
    stats = count_list_scan_segment(
        c, sink, rows_per_batch=rows_per_batch, device="cpu"
    )
    jsink = JDenseSink(vocab)
    jstats = jax_segment(jc, jsink, rows_per_batch=rows_per_batch, use_kernel=False)
    assert np.array_equal(sink.mat, jsink.mat)
    assert np.array_equal(sink.mat, np.triu(brute_force_counts(jc), 1))
    assert stats == jstats


def test_segment_counts_match_host_list_scan_through_spill_sink(tmp_path):
    """The packed-key emission path (SpillSink.emit_keys) builds the same
    store as the host list-scan, at a vocabulary past the dense cap."""
    _, c = _pair(150, 5000, 4, mean_len=60)
    _, a = cooc.count_to_store("list-scan", c, str(tmp_path / "a"), device="cpu")
    _, b = cooc.count_to_store(
        "list-scan-segment", c, str(tmp_path / "b"), device="cpu",
        rows_per_batch=32,
    )
    assert a.nnz == b.nnz > 0
    assert _same_segments(a.path, b.path)


@pytest.mark.parametrize("method", ["list-scan", "list-scan-segment"])
def test_store_bytes_match_jax(method, tmp_path):
    jc, c = _pair(180, 600, 5)
    _, jseg = jcooc.count_to_store(method, jc, str(tmp_path / "jax"))
    _, seg = cooc.count_to_store(method, c, str(tmp_path / "torch"), device="cpu")
    assert seg.nnz == jseg.nnz > 0
    assert _same_segments(seg.path, jseg.path)


@pytest.mark.parametrize("version", [1, 2])
def test_each_package_opens_the_others_store(version, tmp_path):
    jc, c = _pair(150, 300, 6)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    JStore.create(jpath, 300, segment_version=version)
    jcooc.count_to_store("list-scan", jc, jpath)
    Store.create(tpath, 300, segment_version=version)
    cooc.count_to_store("list-scan-segment", c, tpath, device="cpu")

    terms = np.arange(300)
    pairs = np.stack([terms, terms[::-1]], axis=1)
    for path in (jpath, tpath):
        tst, jst = Store.open(path), JStore.open(path)
        assert tst.segment_version == jst.segment_version == version
        assert np.array_equal(tst.df(), jst.df())
        assert np.array_equal(tst.pair_counts(pairs), jst.pair_counts(pairs))
        for t in (0, 1, 17, 299):
            for x, y in zip(tst.neighbours(t), jst.neighbours(t)):
                assert np.array_equal(x, y)
        ti, ts = QueryEngine(tst, device="cpu").topk(terms, k=7)
        ji, js = JQueryEngine(jst).topk(terms, k=7)
        assert np.array_equal(ti, ji) and np.array_equal(ts, js)


def test_device_index_matches_host_index():
    _, c = _pair(50, 80, 7)
    inv = build_inverted_index(c)
    idx = DeviceIndex.from_collection(c, "cpu")
    for got, want in (
        (idx.doc_ptr, c.doc_ptr), (idx.terms, c.terms),
        (idx.term_ptr, inv.term_ptr), (idx.docs, inv.docs),
        (idx.positions, inv.positions),
    ):
        assert got.dtype == torch.from_numpy(want).dtype
        assert np.array_equal(got.numpy(), want)
    assert idx.vocab_size == 80


def test_collection_from_numpy_rejects_bad_arrays():
    with pytest.raises(ValueError, match="doc_ptr ends"):
        collection_from_numpy(np.array([0, 3]), np.array([0, 1]), 4)
    with pytest.raises(ValueError, match="term ids"):
        collection_from_numpy(np.array([0, 2]), np.array([0, 4]), 4)


def test_planner_keeps_the_gpu_method_opt_in():
    """On the host, auto picks the host method; the gpu kind runs there
    only when it is named."""
    _, c = _pair(40, 30, 8)
    plan = Planner().plan(CountJob(collection=c, output="stats", device="cpu"))
    assert plan.method == "list-scan"
    plan = Planner().plan(
        CountJob(collection=c, output="dense", method="list-scan-segment", device="cpu")
    )
    assert plan.method_kwargs["device"] == "cpu"
    res = plan.execute()
    assert np.array_equal(res.counts, cooc.dense_counts("list-scan", c))


@pytest.mark.parametrize(
    "device,method",
    [("cuda", "list-scan-segment"), ("cuda:0", "list-scan-segment"),
     ("cpu", "list-scan")],
)
def test_auto_ranks_the_methods_of_the_jobs_device(device, method):
    """Planning only: on a CUDA device auto picks the kernel path and hands
    it the job's device; it never picks the host method there."""
    _, c = _pair(40, 30, 10)
    plan = Planner().plan(CountJob(collection=c, output="stats", device=device))
    assert plan.method == method
    assert [m for m, _ in plan.ranking] == [method]
    if method == "list-scan-segment":
        assert plan.method_kwargs["device"] == device


def test_auto_store_on_the_cpu_matches_the_segment_build(tmp_path):
    _, c = _pair(150, 5000, 11, mean_len=60)
    _, a = cooc.count_to_store("auto", c, str(tmp_path / "a"), device="cpu")
    _, b = cooc.count_to_store(
        "list-scan-segment", c, str(tmp_path / "b"), device="cpu"
    )
    assert a.meta["source"] == "plan:list-scan"
    assert a.nnz == b.nnz > 0
    assert _same_segments(a.path, b.path)


def test_checkpoint_resume_not_ported(tmp_path):
    _, c = _pair(20, 30, 9)
    plan = Planner().plan(CountJob(collection=c, output="stats"))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        plan.execute(out_dir=str(tmp_path), ckpt_every=1)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        plan.execute(out_dir=str(tmp_path), resume=True)
