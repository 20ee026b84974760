"""The port's kernels against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's ``kernels.ops`` runs each kernel's plain PyTorch version; the
JAX side runs its Pallas kernels with ``interpret=True`` and its jnp
oracles, as its own tests do. Counts, ids and count/Dice scores must be
equal. PMI scores may differ by 1 ulp: torch's CPU ``log`` and XLA's CPU
``log`` round some values differently (the arguments of ``log`` are
bit-identical). The CUDA kernels themselves are compared with their plain
versions on the card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.topk_gather import topk_gather as jax_topk_gather  # noqa: E402
from repro.store.query import _score_topk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SCORES = ["count", "pmi", "dice"]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


# ------------------------------------------------------------- segment_hist
def _port_hist(ids, seg, rows, vocab, out=None):
    return ops.segment_hist(
        _i32(ids), _i32(seg), num_rows=rows, vocab=vocab, out=out
    ).numpy()


@pytest.mark.parametrize(
    "L,rows,vocab",
    [(1, 1, 1), (100, 4, 50), (512, 8, 128), (1000, 16, 300), (2048, 32, 513)],
)
def test_segment_hist_matches_jax(L, rows, vocab):
    rng = np.random.default_rng(42 + L)
    ids = rng.integers(-1, vocab, size=L).astype(np.int32)
    seg = rng.integers(-1, rows, size=L).astype(np.int32)
    got = _port_hist(ids, seg, rows, vocab)
    pallas = np.asarray(jops.segment_hist(ids, seg, num_rows=rows, vocab=vocab))
    oracle = np.asarray(
        jref.segment_hist_ref(jnp.asarray(ids), jnp.asarray(seg), rows, vocab)
    )
    assert got.shape == (rows, vocab) and got.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, oracle)


def test_segment_hist_against_numpy_histogram():
    rng = np.random.default_rng(7)
    L, rows, vocab = 700, 5, 90
    ids = rng.integers(0, vocab, size=L).astype(np.int32)
    seg = rng.integers(0, rows, size=L).astype(np.int32)
    want = np.zeros((rows, vocab), dtype=np.int64)
    np.add.at(want, (seg, ids), 1)
    assert np.array_equal(_port_hist(ids, seg, rows, vocab), want)


def test_segment_hist_all_padding():
    ids = np.full(64, -1, dtype=np.int32)
    seg = np.full(64, -1, dtype=np.int32)
    got = _port_hist(ids, seg, 3, 10)
    assert np.array_equal(got, np.asarray(jops.segment_hist(ids, seg, num_rows=3, vocab=10)))
    assert not got.any()


def test_segment_hist_accumulates_into_out():
    """Two launches into one grid count what one launch over both halves
    counts — how LIST-SCAN splits a large batch."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 40, size=600).astype(np.int32)
    seg = rng.integers(0, 6, size=600).astype(np.int32)
    grid = torch.zeros((6, 40), dtype=torch.int32)
    _port_hist(ids[:250], seg[:250], 6, 40, out=grid)
    _port_hist(ids[250:], seg[250:], 6, 40, out=grid)
    assert np.array_equal(grid.numpy(), _port_hist(ids, seg, 6, 40))


def test_segment_hist_skips_out_of_grid_entries():
    ids = np.array([0, 5, 9, 10, 3], dtype=np.int32)
    seg = np.array([0, 1, 2, 0, 3], dtype=np.int32)  # (10, _), (_, 3) outside
    got = _port_hist(ids, seg, 3, 10)
    assert got.sum() == 3 and got[0, 0] == got[1, 5] == got[2, 9] == 1


# --------------------------------------------------------------- topk_gather
def _port_topk(ids, cnts, df_t, df_n, num_docs, score, k):
    ti, ts = ops.topk_gather(
        _i32(ids), _i32(cnts), _i32(np.asarray(df_t).reshape(-1)), _i32(df_n),
        num_docs=num_docs, score=score, k=k,
    )
    return ti.numpy(), ts.numpy()


def _assert_matches_jax(ids, cnts, df_t, df_n, num_docs, score, k):
    """The port's plain version against the Pallas kernel (interpret) and
    the reference scorer: ids equal; scores equal, PMI within 1 ulp."""
    pi, ps = _port_topk(ids, cnts, df_t, df_n, num_docs, score, k)
    ri, rs = _score_topk(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(df_t),
        jnp.asarray(df_n), num_docs, score=score, k=k,
    )
    ki, ks = jax_topk_gather(
        ids, cnts, df_t, df_n, num_docs=num_docs, score=score, k=k,
        interpret=True,
    )
    for ji, js in ((np.asarray(ri), np.asarray(rs)), (np.asarray(ki), np.asarray(ks))):
        np.testing.assert_array_equal(pi, ji, err_msg=f"ids {score}")
        assert ps.dtype == js.dtype
        if score == "pmi":
            np.testing.assert_array_max_ulp(ps, js, maxulp=1)
        else:
            np.testing.assert_array_equal(ps, js, err_msg=f"scores {score}")
    return pi, ps


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("B,L,k", [(1, 8, 1), (4, 16, 5), (9, 130, 17)])
def test_topk_random_tiles_match_jax(score, B, L, k):
    rng = np.random.default_rng(3 + B)
    lens = rng.integers(0, L + 1, size=B)
    ids = np.full((B, L), -1, dtype=np.int64)
    cnts = np.zeros((B, L), dtype=np.int64)
    for b in range(B):
        n = int(lens[b])
        ids[b, :n] = np.sort(rng.choice(4 * L, size=n, replace=False))
        cnts[b, :n] = rng.integers(1, 6, size=n)  # narrow range: many ties
    df_t = rng.integers(1, 40, size=B)
    df_n = np.where(ids >= 0, rng.integers(1, 40, size=(B, L)), 1)
    _assert_matches_jax(ids, cnts, df_t, df_n, 500, score, k)


@pytest.mark.parametrize("score", SCORES)
def test_topk_all_empty_rows(score):
    B, L, k = 3, 8, 4
    ids = np.full((B, L), -1, dtype=np.int64)
    pi, ps = _assert_matches_jax(
        ids, np.zeros((B, L), np.int64), np.ones(B, np.int64),
        np.ones((B, L), np.int64), 10, score, k,
    )
    assert (pi == -1).all()
    assert (ps == 0).all() if score == "count" else np.isneginf(ps).all()


@pytest.mark.parametrize("score", SCORES)
def test_topk_ties_take_the_lowest_slot(score):
    B, L, k = 2, 16, 16
    ids = np.tile(np.arange(10, 10 + L, dtype=np.int64), (B, 1))
    pi, _ = _assert_matches_jax(
        ids, np.full((B, L), 7, np.int64), np.full(B, 3, np.int64),
        np.full((B, L), 5, np.int64), 100, score, k,
    )
    np.testing.assert_array_equal(pi[0], np.arange(10, 10 + L))


def test_topk_pmi_large_num_docs_matches_jax():
    """num_docs past 2^24 rounds on its way to float32: both packages round
    it the same way."""
    rng = np.random.default_rng(5)
    ids = np.arange(64, dtype=np.int64).reshape(2, 32)
    cnts = rng.integers(1, 1000, size=(2, 32))
    df_n = rng.integers(1000, 100_000, size=(2, 32))
    _assert_matches_jax(ids, cnts, np.array([5000, 70_000]), df_n,
                        (1 << 24) + 3, "pmi", 32)


def test_topk_rejects_bad_k_and_score():
    ids = _i32([[1, 2, -1, -1]])
    cnts = _i32([[1, 1, 0, 0]])
    ones = torch.ones_like(ids)
    with pytest.raises(ValueError, match="k=9"):
        ops.topk_gather(ids, cnts, _i32([1]), ones, num_docs=10, k=9)
    with pytest.raises(ValueError, match="unknown score"):
        ops.topk_gather(ids, cnts, _i32([1]), ones, num_docs=10, k=1, score="tfidf")
