"""The order key and the selection scheme of the ``topk_gather`` kernel, on
the CPU.

The CUDA kernel (``kernels/csrc/topk_gather.cu``) ranks slots by a 32-bit
order key (``kernels.ref.order_key``) and selects by radix over a cluster
of row slices. Neither runs here, so this file checks the two things they
rest on, against ``topk_gather_ref`` and the JAX package's Pallas kernel
(interpret mode):

* a stable descending sort by ``order_key`` gives exactly the reference's
  order, on random tiles, ties, -inf padding and +-0.0;
* a numpy model of the kernel's steps (four 8-bit radix passes over the
  cluster's summed histograms, ties taken in column order across slices,
  per-slice sorted lists placed by binary search) gives the reference's
  top k, for slices cut through runs of ties;
* the launch plan (``kernels.topk_gather.plan``) covers every row.

The kernel itself is held to ``topk_gather_ref`` on the card in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.topk_gather import topk_gather as jax_topk_gather  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.topk_gather import (  # noqa: E402
    MAX_CLUSTER, MAX_SMEM_KEYS, SMEM_BUDGET, plan,
)

SCORES = ["count", "pmi", "dice"]


def _tile(B, L, seed, *, fill=0.7, cmax=5, dfmax=50):
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random((B, L)) < fill, rng.integers(0, 9999, (B, L)), -1)
    cnts = np.where(ids >= 0, rng.integers(1, cmax, (B, L)), 0)
    df_t = rng.integers(1, dfmax, B)
    df_n = np.where(ids >= 0, rng.integers(1, dfmax, (B, L)), 1)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            for a in (ids, cnts, df_t, df_n)]


def _key_order(tile, *, num_docs, score, k):
    """Top k by a stable descending sort of the order keys."""
    ids = tile[0]
    s = ref.score_tile(*tile, num_docs=num_docs, score=score)
    order = torch.sort(ref.order_key(s), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return ids.gather(1, order), s.gather(1, order)


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


# ------------------------------------------------------------- order key
@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("B,L,seed", [(8, 64, 0), (5, 1000, 1), (3, 4096, 2)])
def test_key_sort_is_the_reference_order(score, B, L, seed):
    tile = _tile(B, L, seed)
    tile[0][1] = -1  # an all-padding row
    for k in (1, 10, L):
        _assert_same(_key_order(tile, num_docs=777, score=score, k=k),
                     ref.topk_gather_ref(*tile, num_docs=777, score=score, k=k))


@pytest.mark.parametrize("score", SCORES)
def test_key_sort_keeps_column_order_on_ties(score):
    B, L = 3, 300
    ids = torch.arange(B * L, dtype=torch.int32).reshape(B, L)
    tile = [ids, torch.full((B, L), 4, dtype=torch.int32),
            torch.full((B,), 9, dtype=torch.int32),
            torch.full((B, L), 6, dtype=torch.int32)]
    got = _key_order(tile, num_docs=100, score=score, k=L)
    _assert_same(got, ref.topk_gather_ref(*tile, num_docs=100, score=score, k=L))
    assert torch.equal(got[0], ids)


def test_key_is_monotone_and_joins_signed_zeros():
    vals = torch.tensor(
        [float("-inf"), -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 3e38,
         float("inf")], dtype=torch.float32)
    key = ref.order_key(vals)
    assert key[4] == key[5] == 2**31
    d = torch.diff(key)
    assert (d[:4] > 0).all() and d[4] == 0 and (d[5:] > 0).all()
    assert ref.order_key(torch.tensor([float("nan")])).item() == 2**32 - 1
    counts = torch.tensor([-2**31, -1, 0, 1, 2**31 - 1], dtype=torch.int32)
    assert torch.equal(ref.order_key(counts),
                       torch.tensor([0, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1]))


def test_key_sort_of_signed_zeros_is_torch_sort():
    s = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0, float("-inf"), -1.0, -0.0]])
    want = torch.sort(s, dim=1, descending=True, stable=True).indices
    got = torch.sort(ref.order_key(s), dim=1, descending=True, stable=True).indices
    assert torch.equal(got, want)


def test_pmi_zero_score_ties_in_column_order():
    """c·D == df_t·df_n scores +0.0; such slots tie with each other, in
    column order, on the key sort, the reference and the Pallas kernel."""
    ids = np.array([[5, 6, 7, 8, -1, 9, 10, 11]], dtype=np.int32)
    cnts = np.array([[2, 1, 2, 4, 0, 2, 3, 1]], dtype=np.int32)
    df_t = np.array([10], dtype=np.int32)
    df_n = np.array([[20, 20, 20, 40, 1, 20, 40, 1]], dtype=np.int32)
    tile = [torch.from_numpy(a) for a in (ids, cnts, df_t, df_n)]
    s = ref.score_tile(*tile, num_docs=100, score="pmi")
    assert (s[0, [0, 2, 3, 5]] == 0).all()
    got = _key_order(tile, num_docs=100, score="pmi", k=8)
    _assert_same(got, ref.topk_gather_ref(*tile, num_docs=100, score="pmi", k=8))
    ki, _ = jax_topk_gather(ids, cnts, df_t, df_n, num_docs=100, score="pmi",
                            k=8, interpret=True)
    assert np.array_equal(got[0].numpy(), np.asarray(ki))
    assert got[0][0, 1:5].tolist() == [5, 7, 8, 9]


# ------------------------------------------------ the kernel's scheme, modelled
def _model_row(keys: np.ndarray, C: int, S: int, k: int) -> np.ndarray:
    """Columns of the top k of one row of uint32 keys, by the kernel's
    steps: 4 radix passes over the summed histograms of the C slices, ties
    taken in column order across slices, each slice's winners sorted as
    (~key << 32 | column), placed by binary search in the other slices'."""
    keys = keys.astype(np.uint64)
    prefix, krem = 0, k
    for p in range(4):
        shift = 24 - 8 * p
        hi = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        hist = np.zeros(256, dtype=np.int64)
        for r in range(C):
            sl = keys[r * S:(r + 1) * S]
            match = (sl & np.uint64(hi)) == np.uint64(prefix)
            hist += np.bincount(((sl[match] >> np.uint64(shift)) & np.uint64(255))
                                .astype(np.int64), minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if krem <= above + hist[d]:
                prefix |= d << shift
                krem -= above
                break
            above += hist[d]
    T = np.uint64(prefix)
    lists, eq_before = [], 0
    for r in range(C):
        sl = keys[r * S:(r + 1) * S]
        cols = np.arange(r * S, r * S + len(sl), dtype=np.uint64)
        eq = sl == T
        eq_rank = eq_before + np.cumsum(eq) - 1
        take = (sl > T) | (eq & (eq_rank < krem))
        eq_before += int(eq.sum())
        comp = ((~sl[take] & np.uint64(0xFFFFFFFF)) << np.uint64(32)) | cols[take]
        lists.append(np.sort(comp))
    assert sum(len(x) for x in lists) == k
    out = np.full(k, np.iinfo(np.uint64).max, dtype=np.uint64)
    for r, lst in enumerate(lists):
        for i, x in enumerate(lst):
            pos = i + sum(int(np.searchsorted(lists[q], x, side="left"))
                          for q in range(C) if q != r)
            assert out[pos] == np.iinfo(np.uint64).max
            out[pos] = x
    return (out & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _model(tile, *, num_docs, score, k, C, S):
    s = ref.score_tile(*tile, num_docs=num_docs, score=score)
    keys = ref.order_key(s).numpy()
    cols = torch.from_numpy(np.stack([_model_row(r, C, S, k) for r in keys]))
    return tile[0].gather(1, cols), s.gather(1, cols)


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("L,C,S", [(8, 1, 8), (1000, 3, 336), (4096, 8, 512)])
def test_model_of_the_kernel_is_the_reference(score, L, C, S):
    tile = _tile(4, L, L, cmax=4, dfmax=6)  # few distinct scores: long ties
    tile[0][2] = -1
    for k in sorted({1, min(L, 10), min(L, 700), L}):
        _assert_same(_model(tile, num_docs=50, score=score, k=k, C=C, S=S),
                     ref.topk_gather_ref(*tile, num_docs=50, score=score, k=k))


@pytest.mark.parametrize("k", [1, 7, 8, 9, 20, 64])
def test_model_takes_ties_across_slice_boundaries(k):
    """One row, every score equal; another whose k-th score ties on both
    sides of every slice boundary: the ties taken are the lowest columns."""
    L, C, S = 64, 4, 16
    ids = torch.arange(2 * L, dtype=torch.int32).reshape(2, L)
    cnts = torch.full((2, L), 3, dtype=torch.int32)
    cnts[1, ::5] = 9   # above the tie
    cnts[1, 14:19] = 5  # the k-th score's ties straddle slots 15 | 16
    cnts[1, 46:50] = 5  # and 47 | 48
    tile = [ids, cnts, torch.tensor([4, 4], dtype=torch.int32),
            torch.full((2, L), 4, dtype=torch.int32)]
    for score in SCORES:
        _assert_same(_model(tile, num_docs=10, score=score, k=k, C=C, S=S),
                     ref.topk_gather_ref(*tile, num_docs=10, score=score, k=k))


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize(
    "L", [8, 9, 1000, 8192, 8193, 65_536, 131_072, 131_073, 1 << 20])
def test_plan_covers_every_row(L):
    for k in sorted({1, min(L, 10), min(L, 1000), L}):
        p = plan(L, k)
        assert 1 <= p.C <= MAX_CLUSTER and p.S % 4 == 0
        assert p.C * p.S >= L and (p.C - 1) * p.S < L
        assert p.W >= min(k, p.S) and p.W & (p.W - 1) == 0
        assert p.keys_in_smem == (p.S <= MAX_SMEM_KEYS)
        smem = 4 * p.S * p.keys_in_smem + 8 * p.W * p.list_in_smem
        assert smem <= SMEM_BUDGET
        assert p.scratch_per_row == (0 if p.list_in_smem else p.C * p.W)
        assert p.flags in (0, 2, 3)  # the kernel's instantiations


def test_plan_on_the_serving_tile():
    """B = 64 rows of L = 65,536 fill the card: clusters of 8 blocks, keys
    and winner lists in shared memory, no scratch for k up to L."""
    for k in (10, 1000, 65_536):
        p = plan(65_536, k)
        assert (p.C, p.S, p.keys_in_smem, p.list_in_smem) == (8, 8192, True, True)
    with pytest.raises(ValueError):
        plan(16, 17)
