"""The port's QueryEngine (on the CPU) against the JAX package's engine.

Both engines read the same store, written by the JAX package. Ids, tie
order, counts and count/Dice scores must be equal; PMI scores may differ by
1 ulp (torch's CPU ``log`` against XLA's; the arguments are bit-identical).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cooc import count_to_store as jax_count_to_store  # noqa: E402
from repro.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro.data.preprocess import preprocess_documents  # noqa: E402
from repro import store as jstore_mod  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro_torch import store as store_mod  # noqa: E402
from repro_torch.store import QueryEngine, Store  # noqa: E402

SCORES = ["count", "pmi", "dice"]


def _assert_same_topk(got, want, score):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_array_equal(gi, np.asarray(wi), err_msg=f"ids {score}")
    assert gs.dtype == np.asarray(ws).dtype
    if score == "pmi":
        np.testing.assert_array_max_ulp(gs, np.asarray(ws), maxulp=1)
    else:
        np.testing.assert_array_equal(gs, np.asarray(ws), err_msg=f"scores {score}")


@pytest.fixture(scope="module")
def tiny_engines(tmp_path_factory):
    docs = [[0, 1, 2], [0, 1], [3], [4, 5, 4], []]  # term 6 never occurs
    c = preprocess_documents(docs, vocab_size=8)
    path = str(tmp_path_factory.mktemp("s") / "store")
    jax_count_to_store("list-scan", c, path)
    return QueryEngine(Store.open(path), device="cpu"), JQueryEngine(JStore.open(path))


@pytest.fixture(scope="module")
def zipf_engines(tmp_path_factory):
    c = synthetic_zipf_collection(300, vocab=160, mean_len=14, seed=4)
    path = str(tmp_path_factory.mktemp("z") / "store")
    jstore, _ = jax_count_to_store("list-scan", c, path)
    return QueryEngine(Store.open(path), device="cpu"), JQueryEngine(jstore)


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("k", [1, 9, 40])
def test_zipf_store_topk_matches_jax(zipf_engines, score, k):
    eng, jeng = zipf_engines
    terms = np.arange(160)
    _assert_same_topk(eng.topk(terms, k=k, score=score),
                      jeng.topk(terms, k=k, score=score), score)


@pytest.mark.parametrize("score", SCORES)
def test_empty_row_and_k_past_nnz_match_jax(tiny_engines, score):
    eng, jeng = tiny_engines
    got = eng.topk([0, 3, 6], k=50, score=score)
    _assert_same_topk(got, jeng.topk([0, 3, 6], k=50, score=score), score)
    ids, scores = got
    assert ids.shape == (3, 50) and (ids[1:] == -1).all()  # 3 and 6: no pairs
    assert (scores[2] == 0).all() if score == "count" else np.isneginf(scores[2]).all()


def test_out_of_vocab_raises(tiny_engines):
    eng, _ = tiny_engines
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.topk([0, 8], k=2)
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.topk([-1], k=2)
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.pair_counts(np.array([[0, 99]]))
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.neighbours(8)


def test_pair_counts_and_neighbours_match_jax(zipf_engines):
    eng, jeng = zipf_engines
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 160, size=(500, 2))
    assert np.array_equal(eng.pair_counts(pairs), jeng.pair_counts(pairs))
    for t in (0, 1, 50, 159):
        for x, y in zip(eng.neighbours(t), jeng.neighbours(t)):
            assert np.array_equal(x, y)


def _mixed_requests(mod):
    """One batch of each request type, built from ``mod``'s request classes
    (each package executes its own)."""
    return [
        mod.TopKRequest([3, 17, 3], k=5, score="dice"),
        mod.PairCountsRequest(np.array([[3, 17], [5, 5]])),
        mod.NeighboursRequest(42),
        mod.TopKRequest([9], k=5, score="dice"),
    ]


def test_execute_mixed_requests_match_jax(zipf_engines):
    eng, jeng = zipf_engines
    got = eng.execute(_mixed_requests(store_mod))
    want = jeng.execute(_mixed_requests(jstore_mod))
    _assert_same_topk(got[0], want[0], "dice")
    assert np.array_equal(got[1], want[1])
    assert all(np.array_equal(x, y) for x, y in zip(got[2], want[2]))
    _assert_same_topk(got[3], want[3], "dice")


def test_topk_stream_chunks_concatenate_to_topk(zipf_engines):
    eng, _ = zipf_engines
    chunks = list(eng.topk_stream([0, 1], k=70, score="count", chunk=16))
    assert len(chunks) == 5
    ids = np.concatenate([c[0] for c in chunks], axis=1)
    want_ids, _ = eng.topk([0, 1], k=70, score="count")
    assert np.array_equal(ids, want_ids)


def test_engine_reports_its_kernel(zipf_engines):
    eng, _ = zipf_engines
    assert eng.device.type == "cpu" and eng.kernel == "plain"
