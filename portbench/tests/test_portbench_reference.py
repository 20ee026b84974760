"""The yardstick's arithmetic against hand-worked cases: pair counts, PMI,
ulps, the top-k comparison and the roofline bounds."""

import itertools

import numpy as np
import pytest

from yardstick import gen, judge, peaks, reference as R


def _csr(docs):
    ptr = np.zeros(len(docs) + 1, np.int64)
    ptr[1:] = np.cumsum([len(d) for d in docs])
    return ptr, np.concatenate([np.asarray(sorted(d), np.int32) for d in docs])


def test_pair_counts_match_a_dict_count():
    rng = np.random.default_rng(3)
    V = 50
    docs = [sorted(set(rng.integers(0, V, rng.integers(1, 12)).tolist()))
            for _ in range(40)]
    want: dict = {}
    for d in docs:
        for a, b in itertools.combinations(d, 2):
            want[(a, b)] = want.get((a, b), 0) + 1
    keys, counts, occ = R.pair_counts(*_csr(docs), V)
    got = {(int(k) // V, int(k) % V): int(c) for k, c in zip(keys, counts)}
    assert got == want
    assert occ == sum(len(d) * (len(d) - 1) // 2 for d in docs)


@pytest.mark.parametrize("V", [6, 5_750_000])
def test_symmetric_and_postings_rows_agree(V):
    """At a tiny vocabulary and at the published one, ids spread over it."""
    f = V // 6
    ptr, terms = _csr([[0, 2 * f, 5 * f], [2 * f, 5 * f], [f, 5 * f]])
    keys, counts, _ = R.pair_counts(ptr, terms, V)
    sk, sc = R.symmetric(keys, counts, V)
    post = R.Postings(ptr, terms, V)
    for t in range(0, V, f):
        ids, c = post.row(t)
        sel = sk // V == t
        assert np.array_equal(sk[sel] % V, ids) and np.array_equal(sc[sel], c)
    assert post.row(5 * f)[0].tolist() == [0, f, 2 * f]
    assert post.row(5 * f)[1].tolist() == [1, 1, 2]


def test_pmi_by_hand():
    # c = 2, D = 10, df_t = 4, df_n = 5: log(20 / 20) = 0; c = 3: log(1.5)
    got = R.pmi(np.array([2, 3]), 4, np.array([5, 5]), 10)
    assert got.dtype == np.float32
    assert got[0] == 0.0 and got[1] == np.float32(np.log(1.5))


def test_ulps():
    one = np.float32(1.0)
    nxt = np.nextafter(one, np.float32(2))
    assert judge.ulps(one, nxt) == 1
    assert judge.ulps(np.float32(-0.0), np.float32(0.0)) == 0
    assert judge.ulps(np.float32(-np.inf), np.float32(-np.inf)) == 0
    assert judge.ulps(np.float32(-np.inf), one) == judge.NOT_A_NEIGHBOUR
    assert judge.ulps(-nxt, -one) == 1


def test_judge_topk_reads_ties_wrong_ids_and_score_gaps():
    # term 0 co-occurs with 1, 2 and 3 once each in a 3-document collection
    ptr, terms = _csr([[0, 1, 4], [0, 2, 4], [0, 3, 4]])
    post = R.Postings(ptr, terms, 5)
    # neighbours 1, 2, 3 tie exactly (c = 1, df_n = 1); 4 ranks last
    good = judge.judge_topk(post, [0], [[1, 2]], [R.pmi([1, 1], 3, [1, 1], 3)], 2)
    assert good == {"score_ulps": 0, "rank_ulps": 0}
    swapped = judge.judge_topk(post, [0], [[2, 1]], [R.pmi([1, 1], 3, [1, 1], 3)], 2)
    assert swapped["rank_ulps"] == judge.TIE_BROKEN
    # D = 4, df = (3, 2, 2, 1): PMI(0, 1) = log(2·4 / 6), PMI(0, 2) = log(4 / 6)
    p2 = R.Postings(*_csr([[0, 1], [0, 1], [0, 2], [2, 3]]), 4)
    hi, lo = R.pmi([2], 3, [2], 4)[0], R.pmi([1], 3, [2], 4)[0]
    below = judge.judge_topk(p2, [0], [[2, 1]], [[lo, hi]], 2)
    assert below == {"score_ulps": 0, "rank_ulps": int(judge.ulps(hi, lo))}
    padded = judge.judge_topk(post, [0], [[1, -1]], [[R.pmi([1], 3, [1], 3)[0], -np.inf]], 2)
    assert padded["rank_ulps"] == judge.NOT_A_NEIGHBOUR
    stranger = judge.judge_topk(post, [0], [[1, 0]], [R.pmi([1, 1], 3, [1, 1], 3)], 2)
    assert stranger["rank_ulps"] == judge.NOT_A_NEIGHBOUR
    off = R.pmi([1, 1], 3, [1, 1], 3)
    off[0] = np.nextafter(off[0], np.float32(9))
    assert judge.judge_topk(post, [0], [[1, 2]], [off], 2)["score_ulps"] == 1


def test_store_judge_counts_each_fault():
    keys, counts = np.array([1, 7, 9]), np.array([2, 1, 5])
    df = np.array([1, 2, 3])
    sk, sc = R.symmetric(keys, counts, 3)
    ok = judge.judge_store((keys, counts, sk, sc, df, 4), (keys, counts, df, 4))
    assert not any(ok.values())
    bad = judge.judge_store((keys[:2], counts[:2], sk, sc, df, 4), (keys, counts, df, 4))
    assert bad["pairs_wrong"] == 1
    missing = judge.judge_store(None, (keys, counts, df, 4))
    assert missing == {"pairs_wrong": 3, "sym_wrong": 6, "df_wrong": 3, "docs_wrong": 1}


@pytest.mark.parametrize("tokens,cells,want_bytes", [(1000, 10, 8080), (0, 7, 56)])
def test_segment_hist_bound(tokens, cells, want_bytes):
    assert peaks.segment_hist_bound_s(tokens, cells) == want_bytes / peaks.HBM_BYTES_PER_S


def test_collection_lengths_do_not_depend_on_the_seed():
    kw = dict(vocab=4096, mean_len=50.0, zipf_s=1.07, sigma=0.9, length_seed=0)
    a = gen.zipf_collection(200, seed=1, **kw)
    b = gen.zipf_collection(200, seed=1, **kw)
    c = gen.zipf_collection(200, seed=2, **kw)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    # duplicates removed, ids ascending within each document
    ptr, terms = a
    for d in range(200):
        doc = terms[ptr[d]:ptr[d + 1]]
        assert (np.diff(doc) > 0).all()


def test_remap_df_descending_orders_ids_by_df():
    ptr, terms = _csr([[3, 4], [3], [3, 4], [0]])
    new = gen.remap_df_descending(ptr, terms, 5)
    df = np.bincount(new, minlength=5)
    assert (np.diff(df) <= 0).all() and df[0] == 3
