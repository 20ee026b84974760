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
from repro.core.plan import CountJob as JCountJob  # noqa: E402
from repro.core.plan import Planner as JPlanner  # noqa: E402
from repro.core.types import DenseSink as JDenseSink  # noqa: E402
from repro.data.corpus import Collection as JCollection  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro_torch import obs  # noqa: E402
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
    _assert_segment_matches_jax_and_oracle(*_pair(docs, vocab, seed), rows_per_batch)


def _assert_segment_matches_jax_and_oracle(jc, c, rows_per_batch):
    sink = DenseSink(c.vocab_size)
    stats = count_list_scan_segment(
        c, sink, rows_per_batch=rows_per_batch, device="cpu"
    )
    jsink = JDenseSink(c.vocab_size)
    jstats = jax_segment(jc, jsink, rows_per_batch=rows_per_batch, use_kernel=False)
    assert np.array_equal(sink.mat, jsink.mat)
    assert np.array_equal(sink.mat, np.triu(brute_force_counts(jc), 1))
    assert stats == jstats


def _gapped(docs, live, stride, vocab, seed, mean_len=30):
    """A Zipf collection over ``live`` terms with every id multiplied by
    ``stride``, in a vocabulary of ``vocab`` ids: most ids never occur."""
    jc = synthetic_zipf_collection(docs, vocab=live, mean_len=mean_len, seed=seed)
    terms = (jc.terms.astype(np.int64) * stride).astype(np.int32)
    assert int(terms.max()) < vocab
    jc = JCollection(jc.doc_ptr, terms, vocab)
    return jc, collection_from_numpy(jc.doc_ptr, jc.terms, vocab)


@pytest.mark.parametrize(
    "docs,live,stride,vocab,seed,rows_per_batch,launch_tokens",
    [
        (120, 100, 7, 700, 12, 64, 1 << 26),    # every id ≡ 0 mod 7
        (120, 100, 7, 700, 13, 64, 300),        # batches split in chunks
        (40, 1500, 1, 1500, 14, 128, 1 << 26),  # a Zipf draw: the tail unused
        (80, 120, 5, 601, 15, 64, 1),           # one posting per launch
    ],
)
def test_segment_counts_on_a_gapped_vocabulary_match_jax_and_oracle(
    docs, live, stride, vocab, seed, rows_per_batch, launch_tokens, monkeypatch
):
    monkeypatch.setattr(list_scan, "LAUNCH_TOKENS", launch_tokens)
    jc, c = _gapped(docs, live, stride, vocab, seed)
    assert len(np.unique(c.terms)) < vocab // 2
    _assert_segment_matches_jax_and_oracle(jc, c, rows_per_batch)


class _KeySink:
    """Records every emission in order: packed keys and counts."""

    def __init__(self, vocab):
        self.vocab, self.keys, self.counts = vocab, [], []

    def emit_keys(self, keys, counts):
        self.keys.append(np.asarray(keys, dtype=np.int64))
        self.counts.append(np.asarray(counts, dtype=np.int64))

    def emit_row(self, primary, secondaries, counts):
        self.emit_keys(np.int64(primary) * self.vocab + secondaries, counts)

    def stream(self):
        return np.concatenate(self.keys), np.concatenate(self.counts)


def test_segment_emits_the_host_list_scans_keys_in_order_on_a_gapped_vocabulary():
    """The packed keys reach the sink ascending, each pair once, with the
    counts and in the order the host ``list-scan`` emits them."""
    _, c = _gapped(90, 500, 11, 1_000_000, 16)
    got, want = _KeySink(1_000_000), _KeySink(1_000_000)
    count_list_scan_segment(c, got, rows_per_batch=8, device="cpu")
    list_scan.count_list_scan(c, want, rows_per_batch=4096)
    gk, gc = got.stream()
    wk, wc = want.stream()
    assert len(gk) > 0 and bool((np.diff(gk) > 0).all())
    assert np.array_equal(gk, wk) and np.array_equal(gc, wc)


@pytest.mark.parametrize(
    "docs,vocab,seed,mean_len,all_live",
    [
        (36, 1_000_000, 17, 80, False),  # past the dense cap, ~0.3% of ids live
        (60, 40, 0, 30, True),           # every id live: the identity map
    ],
)
def test_segment_store_bytes_match_host_list_scan(
    docs, vocab, seed, mean_len, all_live, tmp_path
):
    _, c = _pair(docs, vocab, seed, mean_len=mean_len)
    assert (len(np.unique(c.terms)) == vocab) == all_live
    _, a = cooc.count_to_store("list-scan", c, str(tmp_path / "a"), device="cpu")
    _, b = cooc.count_to_store(
        "list-scan-segment", c, str(tmp_path / "b"), device="cpu"
    )
    assert a.nnz == b.nnz > 0
    assert _same_segments(a.path, b.path)


def _counted(c, rows_per_batch):
    with obs.scoped() as reg:
        stats = count_list_scan_segment(
            c, DenseSink(c.vocab_size), rows_per_batch=rows_per_batch, device="cpu"
        )
    names = [e["name"] for e in reg.span_events()]
    return stats, reg.snapshot()["counters"], names


@pytest.mark.parametrize("docs,vocab,seed", [(60, 40, 0), (90, 1_000_000, 16)])
def test_live_vocabulary_renumbers_by_rank(docs, vocab, seed):
    """Live ids ascend, each term maps back to itself, each document stays
    strictly ascending, and a vocabulary that is all live maps to itself."""
    _, c = _pair(docs, vocab, seed)
    live, lc = list_scan.live_vocabulary(c)
    assert live.dtype == np.int64 and lc.terms.dtype == np.int32
    assert lc.vocab_size == len(live) and bool((np.diff(live) > 0).all())
    assert np.array_equal(live[lc.terms], c.terms)
    assert np.array_equal(lc.doc_ptr, c.doc_ptr)
    for d in range(lc.num_docs):
        assert bool((np.diff(lc.doc(d)) > 0).all())
    if len(live) == vocab:
        assert np.array_equal(lc.terms, c.terms)


def test_segment_counters_on_a_known_collection():
    # live ids 3, 7, 10 | 500, 999, 1200 | 1500, 1700 in batches of 3: the
    # first two batches hold tokens, the third only documents' last terms
    docs = [[3, 10, 500], [10, 500, 999], [7], [999, 1200], [1500], [1700]]
    ptr = np.cumsum([0] + [len(d) for d in docs])
    terms = np.concatenate(docs)
    c = collection_from_numpy(ptr, terms, 2000)
    stats, counters, names = _counted(c, 3)
    assert counters["ingest.count_live_terms"] == 8
    assert counters["ingest.count_batches"] == 2
    assert counters["ingest.count_grid_cells"] == 3 * 8 + 3 * 8
    # the reference counts the batches of 3 ids of all 2,000 that hold a
    # token: those of ids 3, 10, 500 (in the second document) and 999
    jc = JCollection(ptr, terms.astype(np.int32), 2000)
    assert stats == jax_segment(jc, JDenseSink(2000), rows_per_batch=3,
                                use_kernel=False) == {"row_batches": 4}
    # one select and one emit span a batch launched; a launch span also
    # for the batch whose postings held no token
    assert names.count("ingest/count_select") == names.count("ingest/count_emit") == 2
    assert names.count("ingest/count_launch") == 3


def test_segment_counters_when_every_id_is_live():
    _, c = _pair(60, 40, 0)
    assert len(np.unique(c.terms)) == 40
    stats, counters, names = _counted(c, 16)
    launched = names.count("ingest/count_select")
    assert counters["ingest.count_live_terms"] == 40
    assert counters["ingest.count_batches"] == launched == 3 == stats["row_batches"]
    assert counters["ingest.count_grid_cells"] == (16 + 16 + 8) * 40


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
    """On the host, auto picks what the reference planner picks; the gpu
    kind runs there only when it is named."""
    jc, c = _pair(40, 30, 8)
    plan = Planner().plan(CountJob(collection=c, output="stats", device="cpu"))
    jplan = JPlanner().plan(JCountJob(collection=jc, output="stats"))
    assert plan.method == jplan.method
    assert "list-scan-segment" not in dict(plan.ranking)
    plan = Planner().plan(
        CountJob(collection=c, output="dense", method="list-scan-segment", device="cpu")
    )
    assert plan.method_kwargs["device"] == "cpu"
    res = plan.execute()
    assert np.array_equal(res.counts, cooc.dense_counts("list-scan", c))


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_auto_ranks_the_methods_of_the_jobs_device(device):
    """Planning only: on a CUDA device auto picks the kernel path and hands
    it the job's device; on the host it ranks what the reference ranks."""
    jc, c = _pair(40, 30, 10)
    plan = Planner().plan(CountJob(collection=c, output="stats", device=device))
    if device == "cpu":
        jplan = JPlanner().plan(JCountJob(collection=jc, output="stats"))
        assert plan.method == jplan.method
        assert plan.ranking == jplan.ranking
    else:
        assert plan.method == "list-scan-segment"
        assert [m for m, _ in plan.ranking] == ["list-scan-segment"]
        assert plan.method_kwargs["device"] == device


def test_auto_store_on_the_cpu_matches_the_segment_build(tmp_path):
    jc, c = _pair(150, 5000, 11, mean_len=60)
    _, a = cooc.count_to_store("auto", c, str(tmp_path / "a"), device="cpu")
    _, b = cooc.count_to_store(
        "list-scan-segment", c, str(tmp_path / "b"), device="cpu"
    )
    jplan = JPlanner().plan(JCountJob(collection=jc, output="store",
                                      out_path=str(tmp_path / "j")))
    assert a.meta["source"] == f"plan:{jplan.method}"
    assert a.nnz == b.nnz > 0
    assert _same_segments(a.path, b.path)
