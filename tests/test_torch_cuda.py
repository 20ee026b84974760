"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device (the hand-written kernels have no CPU
mode) and skips without one. This file imports neither JAX nor the
reference package, so it runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance is 0 throughout (``torch.equal``): integer counts, and float
scores computed with the same accurate ``logf`` and IEEE division on both
sides.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import list_scan  # noqa: E402
from repro_torch.core.cooc import count_to_store, dense_counts  # noqa: E402
from repro_torch.core.list_scan import count_list_scan_segment  # noqa: E402
from repro_torch.core.types import DenseSink  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.data.preprocess import remap_df_descending  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bitpair import KERNEL as BITPAIR  # noqa: E402
from repro_torch.kernels.bitpair import bitpair_cuda  # noqa: E402
from repro_torch.kernels.cooc_gram import KERNEL as COOC_GRAM  # noqa: E402
from repro_torch.kernels.cooc_gram import cooc_gram_cuda  # noqa: E402
from repro_torch.kernels.segment_hist import KERNEL as SEGMENT_HIST  # noqa: E402
from repro_torch.kernels.segment_hist import segment_hist_cuda  # noqa: E402
from repro_torch.kernels.topk_gather import topk_gather_cuda  # noqa: E402

SCORES = ["count", "pmi", "dice"]
SEGMENT_ARRAYS = ("row_ptr.bin", "cols.bin", "counts.bin", "df.bin",
                  "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("L,rows,vocab", [(1, 1, 1), (200_003, 64, 5000), (4096, 3, 70_000)])
def test_segment_hist_equals_plain(cuda, L, rows, vocab):
    rng = np.random.default_rng(L)
    ids, seg = _on(cuda, rng.integers(-1, vocab, size=L), rng.integers(-1, rows, size=L))
    got = segment_hist_cuda(ids, seg, num_rows=rows, vocab=vocab)
    assert torch.equal(got, ref.segment_hist_ref(ids, seg, rows, vocab))
    segment_hist_cuda(ids, seg, num_rows=rows, vocab=vocab, out=got)  # accumulate
    assert torch.equal(got, 2 * ref.segment_hist_ref(ids, seg, rows, vocab))


@pytest.mark.cuda
@pytest.mark.parametrize("score", SCORES)
def test_topk_gather_equals_plain(cuda, score):
    rng = np.random.default_rng(1)
    B, L = 16, 1024
    ids = np.where(rng.random((B, L)) < 0.7, rng.integers(0, 9999, (B, L)), -1)
    ids[3] = -1  # an empty row
    tile = _on(
        cuda, ids, np.where(ids >= 0, rng.integers(1, 5, (B, L)), 0),
        rng.integers(1, 50, B), np.where(ids >= 0, rng.integers(1, 50, (B, L)), 1),
    )
    for k in (1, 10, L):
        gi, gs = topk_gather_cuda(*tile, num_docs=777, score=score, k=k)
        wi, ws = ref.topk_gather_ref(*tile, num_docs=777, score=score, k=k)
        assert torch.equal(gi, wi) and torch.equal(gs, ws), k


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ids, seg = _on(cuda, np.zeros(8), np.zeros(8))
    with pytest.raises(ValueError, match="int32"):
        segment_hist_cuda(ids.long(), seg, num_rows=1, vocab=4)
    with pytest.raises(ValueError, match="out must be"):
        segment_hist_cuda(ids, seg, num_rows=2, vocab=4,
                          out=torch.zeros((2, 5), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="different devices"):
        ops.segment_hist(ids, seg.cpu(), num_rows=1, vocab=4)
    tile = torch.zeros((8, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        cooc_gram_cuda(tile.float(), tile)
    with pytest.raises(ValueError, match="contiguous"):
        cooc_gram_cuda(tile.t(), tile.t())
    with pytest.raises(ValueError, match="document count"):
        cooc_gram_cuda(tile, tile[:5])
    words = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        bitpair_cuda(words.long(), words)
    with pytest.raises(ValueError, match="word count"):
        bitpair_cuda(words, words[:, :2].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "d,m,n,p",
    [(1, 1, 1, 0.5), (2048, 1024, 0, 0.2), (2048, 512, 512, 0.2),
     (1250, 1000, 777, 0.1), (63, 65, 129, 0.5), (300, 70, 70, 0.0)],
)
def test_cooc_gram_equals_plain(cuda, d, m, n, p):
    rng = np.random.default_rng(d + m + n)
    bi = torch.from_numpy((rng.random((d, m)) < p).astype(np.uint8)).to(cuda)
    bj = torch.from_numpy((rng.random((d, n)) < p).astype(np.uint8)).to(cuda)
    assert torch.equal(cooc_gram_cuda(bi, bj), ref.cooc_gram_ref(bi, bj))
    assert torch.equal(cooc_gram_cuda(bi, bi), ref.cooc_gram_ref(bi, bi))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,w", [(1, 1, 1), (256, 256, 625), (70, 130, 33), (64, 64, 0)])
def test_bitpair_equals_plain(cuda, m, n, w):
    rng = np.random.default_rng(m + n + w)
    wi = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    wj = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    wi[:, ::3] = 0  # all-zero words
    ti = torch.from_numpy(wi.view(np.int32)).to(cuda)
    tj = torch.from_numpy(wj.view(np.int32)).to(cuda)
    assert torch.equal(bitpair_cuda(ti, tj), ref.bitpair_popcount_ref(ti, tj))
    assert torch.equal(bitpair_cuda(ti, ti), ref.bitpair_popcount_ref(ti, ti))


@pytest.mark.cuda
def test_auto_freq_split_on_the_card_equals_the_host(cuda, tmp_path):
    """``count_to_store("auto", ..., df_descending=True)`` picks freq-split
    on the card, launches cooc_gram and segment_hist, and writes the store
    bytes of a host list-scan build."""
    c = synthetic_zipf_collection(600, vocab=3000, mean_len=230, seed=4)
    cd, _ = remap_df_descending(c)
    gram0, hist0 = COOC_GRAM.launches, SEGMENT_HIST.launches
    _, card = count_to_store("auto", cd, str(tmp_path / "card"), df_descending=True)
    assert card.meta["source"] == "plan:freq-split"
    assert COOC_GRAM.launches > gram0 and SEGMENT_HIST.launches > hist0
    _, host = count_to_store("list-scan", cd, str(tmp_path / "host"), device="cpu")
    for name in SEGMENT_ARRAYS:
        with open(os.path.join(card.path, name), "rb") as a, \
                open(os.path.join(host.path, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.cuda
@pytest.mark.parametrize(
    "method", ["list-blocks-gram", "multi-scan-matmul", "list-pairs-bitpacked"]
)
def test_opt_in_methods_on_the_card_equal_the_host(cuda, method):
    c = synthetic_zipf_collection(500, vocab=1200, mean_len=60, seed=5)
    kernel = BITPAIR if method == "list-pairs-bitpacked" else COOC_GRAM
    before = kernel.launches
    got = dense_counts(method, c)
    assert kernel.launches > before
    assert np.array_equal(got, dense_counts("list-scan", c))


@pytest.mark.cuda
def test_list_scan_segment_on_the_card_equals_the_host(cuda, monkeypatch):
    monkeypatch.setattr(list_scan, "LAUNCH_TOKENS", 3000)  # split batches
    c = synthetic_zipf_collection(300, vocab=500, mean_len=40, seed=2)
    on_card, on_host = DenseSink(500), DenseSink(500)
    count_list_scan_segment(c, on_card, rows_per_batch=16)
    count_list_scan_segment(c, on_host, rows_per_batch=16, device="cpu")
    assert np.array_equal(on_card.mat, on_host.mat)


@pytest.mark.cuda
def test_auto_builds_on_the_card(cuda, tmp_path):
    """``count_to_store("auto", ...)`` with the default device counts through
    the segment_hist kernel, into the same store bytes as auto on the host."""
    c = synthetic_zipf_collection(300, vocab=5000, mean_len=40, seed=3)
    before = SEGMENT_HIST.launches
    _, card = count_to_store("auto", c, str(tmp_path / "card"))
    assert SEGMENT_HIST.launches > before
    assert card.meta["source"] == "plan:list-scan-segment"
    _, host = count_to_store("auto", c, str(tmp_path / "host"), device="cpu")
    for name in SEGMENT_ARRAYS:
        with open(os.path.join(card.path, name), "rb") as a, \
                open(os.path.join(host.path, name), "rb") as b:
            assert a.read() == b.read(), name
