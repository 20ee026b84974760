"""Every counting method of the port against the JAX package's and the
brute-force oracle, exactly (``np.array_equal``, integer counts).

The same numpy-seeded collections go through both packages. The port's
kernel methods run on the CPU (``device="cpu"``: the plain PyTorch versions
of ``cooc_gram``, ``bitpair`` and ``segment_hist``); the JAX package's run
their jnp oracles (``use_kernel=False``) and, at a small size, their Pallas
kernels in interpret mode.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cooc as jcooc  # noqa: E402
from repro.core.oracle import brute_force_counts as jax_brute_force  # noqa: E402
from repro.core.types import StatsSink as JStatsSink  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro.data.preprocess import remap_df_descending as jremap  # noqa: E402
from repro_torch.convert import collection_from_numpy  # noqa: E402
from repro_torch.core import cooc, hybrid, list_scan  # noqa: E402
from repro_torch.core.oracle import brute_force_counts  # noqa: E402
from repro_torch.core.specs import REGISTRY  # noqa: E402
from repro_torch.core.types import StatsSink  # noqa: E402
from repro_torch.data.preprocess import preprocess_documents, remap_df_descending  # noqa: E402

HOST_METHODS = ["naive", "list-pairs", "list-blocks", "list-scan", "multi-scan"]
KERNEL_METHODS = [
    "list-pairs-bitpacked", "list-blocks-gram", "list-scan-segment",
    "multi-scan-matmul",
]
SEGMENT_ARRAYS = (
    "row_ptr.bin", "cols.bin", "counts.bin", "df.bin",
    "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin",
)


def _port(jc):
    return collection_from_numpy(jc.doc_ptr, jc.terms, jc.vocab_size)


@pytest.fixture(scope="module")
def colls():
    """The fixture of tests/test_cooc_methods.py in both packages, as is and
    remapped by descending df."""
    jc = synthetic_zipf_collection(80, vocab=150, mean_len=14, seed=11)
    jd, _ = jremap(jc)
    return {"plain": (jc, _port(jc)), "df": (jd, _port(jd))}


def _run_both(method, jc, c, **kw):
    """(port dense, port stats, reference dense, reference stats)."""
    ref_kw = dict(kw)
    port_kw = dict(kw)
    if "device" in REGISTRY[method].defaults():
        ref_kw["use_kernel"] = port_kw.pop("use_kernel", False)
        port_kw["device"] = "cpu"
    sink, stats = cooc.count(method, c, **port_kw)
    jsink, jstats = jcooc.count(method, jc, **ref_kw)
    return sink.mat, stats, jsink.mat, jstats


@pytest.mark.parametrize("method", HOST_METHODS + KERNEL_METHODS)
def test_method_matches_jax_and_oracle(method, colls):
    jc, c = colls["plain"]
    got, stats, want, jstats = _run_both(method, jc, c)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_brute_force(jc))
    assert stats == jstats


@pytest.mark.parametrize("method", ["list-blocks-gram", "list-pairs-bitpacked"])
def test_kernel_method_matches_pallas_interpret(method, colls):
    jc, c = colls["plain"]
    jsmall = jc.head(30)
    got, _, want, _ = _run_both(method, jsmall, _port(jsmall), use_kernel=True)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_brute_force(jsmall))


def test_port_oracle_matches_jax_oracle(colls):
    for jc, c in colls.values():
        assert np.array_equal(brute_force_counts(c), jax_brute_force(jc))


@pytest.mark.parametrize("head", [0, 1, 32, 64, 10_000])
def test_freq_split_heads_match_jax_and_stats(head, colls):
    """All-tail (head=0), all-head (head >= V) and splits between; the stats
    dict is the reference's."""
    jd, cd = colls["df"]
    got, stats, want, jstats = _run_both("freq-split", jd, cd, head=head)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_brute_force(jd))
    assert stats == jstats
    assert set(stats) == {"head", "head_matmuls", "tail_postings_scanned"}


@pytest.mark.parametrize("cells,launch_tokens", [(1, 1), (40, 7), (1 << 24, 1 << 26)])
def test_freq_split_tail_batches_and_chunks(cells, launch_tokens, colls, monkeypatch):
    """Tail batches of one term and of a few, and token streams cut into
    chunks of a few tokens, count the same."""
    monkeypatch.setattr(hybrid, "TAIL_GRID_CELLS", cells)
    monkeypatch.setattr(hybrid, "LAUNCH_TOKENS", launch_tokens)
    jd, cd = colls["df"]
    got, _, want, _ = _run_both("freq-split", jd, cd, head=16)
    assert np.array_equal(got, want)


def test_freq_split_stats_sink_matches_jax(colls):
    """Column emission in the reference's order: a StatsSink (whose most
    frequent pair keeps the first maximum) ends in the same state."""
    jd, cd = colls["df"]
    sink, jsink = StatsSink(), JStatsSink()
    cooc.count("freq-split", cd, sink, head=8, device="cpu")
    jcooc.count("freq-split", jd, jsink, head=8, use_kernel=False)
    assert vars(sink) == vars(jsink)


def test_freq_split_store_matches_jax_and_list_scan(tmp_path):
    """Through the planner and a SpillSink (``emit_keys``) past the dense
    cap: the store bytes equal the reference's freq-split store and a
    host list-scan store."""
    jc = synthetic_zipf_collection(150, vocab=5000, mean_len=60, seed=4)
    jd, _ = jremap(jc)
    cd = _port(jd)
    _, seg = cooc.count_to_store(
        "freq-split", cd, str(tmp_path / "fs"), df_descending=True,
        device="cpu", head=256,
    )
    _, jseg = jcooc.count_to_store(
        "freq-split", jd, str(tmp_path / "jfs"), df_descending=True,
        head=256, use_kernel=False,
    )
    _, ls = cooc.count_to_store("list-scan", cd, str(tmp_path / "ls"), device="cpu")
    assert seg.nnz == jseg.nnz == ls.nnz > 0
    for name in SEGMENT_ARRAYS:
        a = os.path.join(seg.path, name)
        assert filecmp.cmp(a, os.path.join(jseg.path, name), shallow=False), name
        assert filecmp.cmp(a, os.path.join(ls.path, name), shallow=False), name


def test_naive_flushing_equivalence(colls):
    jc, c = colls["plain"]
    for flush in (50, 1000, 10**9):
        got, stats, want, jstats = _run_both("naive", jc, c, flush_pairs=flush)
        assert np.array_equal(got, want)
        assert stats == jstats
        if flush == 50:
            assert stats["num_flushes"] > 1


@pytest.mark.parametrize(
    "method,param,values",
    [
        ("list-blocks", "block_size", [1, 7, 13, 150, 1000]),
        ("multi-scan", "accumulators", [1, 3, 100, 10_000]),
        ("list-blocks-gram", "vocab_tile", [13, 64, 1000]),
        ("multi-scan-matmul", "accumulators", [1, 13, 1000]),
        ("list-pairs-bitpacked", "block", [9, 100, 1000]),
    ],
)
def test_parameter_sweeps_match_jax(method, param, values, colls):
    jc, c = colls["plain"]
    oracle = jax_brute_force(jc)
    for v in values:
        got, stats, want, jstats = _run_both(method, jc, c, **{param: v})
        assert np.array_equal(got, want), (param, v)
        assert np.array_equal(got, oracle), (param, v)
        assert stats == jstats, (param, v)


def test_gram_methods_with_small_document_tiles(colls):
    jc, c = colls["plain"]
    jd, cd = colls["df"]
    for method, (jx, x) in (("list-blocks-gram", (jc, c)),
                            ("multi-scan-matmul", (jc, c)),
                            ("freq-split", (jd, cd))):
        got, stats, want, jstats = _run_both(method, jx, x, doc_tile=7)
        assert np.array_equal(got, want), method
        assert stats == jstats, method


def test_list_scan_segment_lower_stream_is_the_prefix(colls):
    """The strict-lower token stream holds, per posting of t, exactly the
    terms of its document below t."""
    from repro_torch.data.index import DeviceIndex

    _, c = colls["plain"]
    idx = DeviceIndex.from_collection(c, "cpu")
    tokens, seg = next(list_scan._device_chunks(idx, 100, 110, 1 << 26, lower=True))
    want_t, want_s = [], []
    for t in range(100, 110):
        for d in range(c.num_docs):
            ts = c.doc(d)
            if t in ts:
                want_t += ts[ts < t].tolist()
                want_s += [t - 100] * int((ts < t).sum())
    assert tokens.tolist() == want_t and seg.tolist() == want_s


# ------------------------------------------------------ hypothesis property
VOCAB = 40

documents = st.lists(
    st.lists(st.integers(0, VOCAB - 1), min_size=0, max_size=25),
    min_size=1, max_size=30,
)


@settings(max_examples=8, deadline=None)
@given(documents, st.integers(0, VOCAB))
def test_every_method_agrees_with_jax_on_random_corpora(docs, head):
    """Raw documents with duplicates and unsorted tokens go through the
    port's preprocessing; every method, and freq-split at any head on the
    df-remapped corpus, equals the reference's oracle."""
    from repro.data.preprocess import preprocess_documents as jpre

    c = preprocess_documents(docs, vocab_size=VOCAB)
    jc = jpre(docs, vocab_size=VOCAB)
    oracle = jax_brute_force(jc)
    for method in HOST_METHODS + KERNEL_METHODS:
        kw = {"device": "cpu"} if "device" in REGISTRY[method].defaults() else {}
        assert np.array_equal(cooc.dense_counts(method, c, **kw), oracle), method
    cd, _ = remap_df_descending(c)
    jd, _ = jremap(jc)
    got = cooc.dense_counts("freq-split", cd, head=head, device="cpu")
    assert np.array_equal(got, jax_brute_force(jd))
