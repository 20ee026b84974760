"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here but one needs a CUDA device (the hand-written kernels have
no CPU mode) and skips without one; that one runs only where there is no
card, and checks that a build asked onto the card fails there visibly.
This file imports neither JAX nor the reference package, so it runs on a
GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance is 0 throughout (``torch.equal``): integer counts, and float
scores computed with the same accurate ``logf`` and IEEE division on both
sides.
"""

import dataclasses
import glob
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import list_scan  # noqa: E402
from repro_torch.core.cooc import count_to_store, dense_counts  # noqa: E402
from repro_torch.core.list_scan import count_list_scan_segment  # noqa: E402
from repro_torch.core.types import DenseSink  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.data.index import DeviceIndex  # noqa: E402
from repro_torch.data.preprocess import remap_df_descending  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bitpair import KERNEL as BITPAIR  # noqa: E402
from repro_torch.kernels.bitpair import bitpair_cuda  # noqa: E402
from repro_torch.kernels.bitpair import plan as bitpair_plan  # noqa: E402
from repro_torch.kernels.cooc_gram import KERNEL as COOC_GRAM  # noqa: E402
from repro_torch.kernels.cooc_gram import cooc_gram_cuda  # noqa: E402
from repro_torch.kernels.segment_hist import KERNEL as SEGMENT_HIST  # noqa: E402
from repro_torch.kernels.segment_hist import plan as segment_hist_plan  # noqa: E402
from repro_torch.kernels.segment_hist import segment_hist_cuda  # noqa: E402
from repro_torch.kernels.topk_gather import KERNEL as TOPK_GATHER  # noqa: E402
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


def _rows_stream(rng, rows, lens, vocab):
    """Tokens of ``rows`` in that order, ``lens`` each, ids Zipf-shaped."""
    seg = np.repeat(np.asarray(rows), lens)
    ids = (rng.zipf(1.1, size=len(seg)) - 1) % vocab
    return ids, seg


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
def test_segment_hist_window_leaves_and_reenters(cuda, misaligned):
    """Rows 0, 1, 5, 0, 2, 63 in turn, each longer than a block's span, so
    the window moves forward and the stream then falls back behind it;
    with ``misaligned`` both streams start 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(11)
    ids, seg = _rows_stream(rng, [0, 1, 5, 0, 2, 63], 300_000, 65_536)
    ids[::1001] = -1
    ids, seg = _on(cuda, ids, seg)
    if misaligned:
        ids, seg = ids[1:], seg[1:]
    hits = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = segment_hist_cuda(ids, seg, num_rows=64, vocab=65_536, hits=hits)
    assert torch.equal(got, ref.segment_hist_ref(ids, seg, 64, 65_536))
    assert 0 < int(hits) <= int((ids >= 0).sum())


@pytest.mark.cuda
def test_segment_hist_counts_hits_of_a_one_row_stream(cuda):
    """Every token of one row inside the window's columns is a hit."""
    n = 5_000_000
    p = segment_hist_plan(64, 65_536, n)
    ids, seg = _on(cuda, np.arange(n) % p.H, np.full(n, 7))
    hits = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = segment_hist_cuda(ids, seg, num_rows=64, vocab=65_536, hits=hits)
    assert torch.equal(got, ref.segment_hist_ref(ids, seg, 64, 65_536))
    assert int(hits) == n


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [False, True])
def test_segment_hist_list_scan_stream_into_a_holding_grid(cuda, lower):
    """A real batch stream (sorted rows, Zipf ids) accumulated into a grid
    that already holds counts, as a batch split over several launches is."""
    c = synthetic_zipf_collection(3000, vocab=20_000, mean_len=230, seed=6)
    idx = DeviceIndex.from_collection(c, cuda)
    lo, hi = (300, 1400) if lower else (0, 64)
    ids, seg = next(list_scan._device_chunks(idx, lo, hi, 1 << 26, lower=lower))
    vocab = hi if lower else c.vocab_size
    rng = np.random.default_rng(3)
    start = torch.from_numpy(
        rng.integers(0, 1000, (hi - lo, vocab)).astype(np.int32)).to(cuda)
    got = segment_hist_cuda(ids, seg, num_rows=hi - lo, vocab=vocab, out=start.clone())
    want = ref.segment_hist_ref(ids, seg, hi - lo, vocab, out=start.clone())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 33, 625])
@pytest.mark.parametrize("m,n", [(1, 1), (256, 256), (70, 130)])
def test_bitpair_split_words(cuda, m, n, w):
    """Calls whose plan splits the words over S > 1 slices (at W = 1 the
    plan keeps one slice: every slice holds a word), off the diagonal and
    on it."""
    assert bitpair_plan(m, n, w, False).slices > 1 or w == 1
    rng = np.random.default_rng(m + n + w)
    ti = torch.from_numpy(rng.integers(0, 2**32, (m, w), dtype=np.uint32).view(np.int32)).to(cuda)
    tj = torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32).view(np.int32)).to(cuda)
    assert torch.equal(bitpair_cuda(ti, tj), ref.bitpair_popcount_ref(ti, tj))
    assert torch.equal(bitpair_cuda(tj, tj), ref.bitpair_popcount_ref(tj, tj))


@pytest.mark.cuda
@pytest.mark.parametrize("m,w", [(70, 625), (70, 1), (200, 63), (4096, 63)])
def test_bitpair_diagonal_mirrors(cuda, m, w):
    """One tensor twice: only the tiles tn >= tm run, mirrored into the
    lower triangle; ragged M leaves a partial last tile."""
    rng = np.random.default_rng(m * w)
    t = torch.from_numpy(rng.integers(0, 2**32, (m, w), dtype=np.uint32).view(np.int32)).to(cuda)
    got = bitpair_cuda(t, t)
    assert torch.equal(got, ref.bitpair_popcount_ref(t, t))
    assert torch.equal(got, got.t())


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


def _serving_tile(dev, B, L, seed, fill=0.6):
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random((B, L)) < fill, rng.integers(0, 1 << 20, (B, L)), -1)
    return _on(
        dev, ids, np.where(ids >= 0, rng.integers(1, 40, (B, L)), 0),
        rng.integers(1, 500, B), np.where(ids >= 0, rng.integers(1, 500, (B, L)), 1),
    )


def _assert_topk_equal(tile, num_docs, score, k):
    gi, gs = topk_gather_cuda(*tile, num_docs=num_docs, score=score, k=k)
    wi, ws = ref.topk_gather_ref(*tile, num_docs=num_docs, score=score, k=k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws), (score, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 1000, 65_536])
@pytest.mark.parametrize("score", SCORES)
def test_topk_gather_serving_tile_equals_plain(cuda, score, k):
    """The serving shape: 64 rows of 65,536 slots (clusters of 8 blocks)."""
    tile = _serving_tile(cuda, 64, 65_536, seed=k)
    tile[0][5] = -1  # an all-padding row
    _assert_topk_equal(tile, 1_000_000, score, k)


@pytest.mark.cuda
@pytest.mark.parametrize("score", SCORES)
def test_topk_gather_ties_across_slices(cuda, score):
    """Row 0: every score equal, so ties straddle every slice of the
    cluster. Row 1: the k-th score ties on both sides of slice boundaries
    (8,192 slots a slice). Row 2: all padding."""
    B, L = 3, 65_536
    ids = np.tile(np.arange(L), (B, 1))
    ids[2] = -1
    cnts = np.where(ids >= 0, 3, 0)
    cnts[1, ::97] = 9
    for edge in (8192, 16_384, 57_344):
        cnts[1, edge - 40:edge + 40] = 5
    tile = _on(cuda, ids, cnts, np.full(B, 7), np.where(ids >= 0, 11, 1))
    above = int((cnts[1] == 9).sum())
    for k in (1, 10, above + 1, above + 60, above + 200, 30_000, L):
        _assert_topk_equal(tile, 5000, score, k)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 1000, 65_536, 150_001])
@pytest.mark.parametrize("score", SCORES)
def test_topk_gather_row_lengths(cuda, score, L):
    """Rows of any length: one block (L = 8, 1,000), clusters whose last
    slice is short, and L = 150,001, where keys are recomputed from the
    tile each pass and, at k = L, winner lists go to scratch."""
    tile = _serving_tile(cuda, 4, L, seed=L, fill=0.9)
    for k in sorted({1, min(L, 10), min(L, 1000), L}):
        _assert_topk_equal(tile, 123_457, score, k)


@pytest.mark.cuda
def test_topk_gather_pmi_zero_scores(cuda):
    """c·D == df_t·df_n scores +0.0 (log 1): such slots tie in column order
    with each other, between positive and negative scores."""
    L = 20_000
    rng = np.random.default_rng(9)
    cnts = rng.integers(1, 8, (2, L))
    df_n = rng.integers(1, 8, (2, L))
    zero = rng.random((2, L)) < 0.3
    df_n[zero] = 50 * cnts[zero]  # c 100 == 2 * 50 c
    tile = _on(cuda, np.tile(np.arange(L), (2, 1)), cnts, [2, 2], df_n)
    s = ref.score_tile(*tile, num_docs=100, score="pmi")
    assert int((s == 0).sum()) == int(zero.sum())
    for k in (1, 100, int((s > 0).sum(dim=1).max()) + 50, L):
        _assert_topk_equal(tile, 100, "pmi", k)


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
@pytest.mark.parametrize(
    "d,m,n,p",
    [(1001, 1000, 777, 0.3), (2047, 528, 272, 0.3), (1250, 1024, 1024, 0.1),
     (2048, 128, 8192, 0.05), (2048, 256, 256, 1.0)],
)
def test_cooc_gram_tensor_core_shapes(cuda, d, m, n, p):
    """Ragged D, M and N (byte-copied and 16-byte-copied tiles), the
    cooc_run head tile, the skinny MULTI-SCAN product and all-ones tiles,
    where every count is D."""
    rng = np.random.default_rng(d + m + n)
    bi = torch.from_numpy((rng.random((d, m)) < p).astype(np.uint8)).to(cuda)
    bj = torch.from_numpy((rng.random((d, n)) < p).astype(np.uint8)).to(cuda)
    got = cooc_gram_cuda(bi, bj)
    assert torch.equal(got, ref.cooc_gram_ref(bi, bj))
    if p == 1.0:
        assert bool((got == d).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(2048, 1024), (2048, 2048), (700, 1000)])
def test_cooc_gram_one_tensor_diagonal(cuda, d, m):
    """One tensor passed twice (the FREQ-SPLIT head): diagonal blocks read
    their rows from the staged column tile."""
    rng = np.random.default_rng(d * m)
    t = torch.from_numpy((rng.random((d, m)) < 0.2).astype(np.uint8)).to(cuda)
    assert torch.equal(cooc_gram_cuda(t, t), ref.cooc_gram_ref(t, t))


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


class _KeySink:
    """Records every ``emit_keys`` call in order."""

    def __init__(self):
        self.keys, self.counts = [], []

    def emit_keys(self, keys, counts):
        self.keys.append(np.asarray(keys).copy())
        self.counts.append(np.asarray(counts).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("launch_tokens", [1 << 26, 3000])
def test_list_scan_segment_on_a_gapped_vocabulary_equals_the_host(
    cuda, monkeypatch, launch_tokens
):
    """Ids spread with gaps over a WT10G-sized vocabulary: the card's loop
    over the live terms emits the host's keys and counts, call for call."""
    monkeypatch.setattr(list_scan, "LAUNCH_TOKENS", launch_tokens)
    V = 5_750_000
    c = synthetic_zipf_collection(300, vocab=4000, mean_len=60, seed=6)
    c = dataclasses.replace(c, terms=(c.terms.astype(np.int64) * 1_409 + 17)
                            .astype(np.int32), vocab_size=V)
    on_card, on_host = _KeySink(), _KeySink()
    before = SEGMENT_HIST.launches
    stats = count_list_scan_segment(c, on_card, rows_per_batch=64)
    assert SEGMENT_HIST.launches > before
    assert stats == count_list_scan_segment(c, on_host, rows_per_batch=64, device="cpu")
    assert len(on_card.keys) == len(on_host.keys) > 1
    for got, want in zip(on_card.keys + on_card.counts, on_host.keys + on_host.counts):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert bool((np.diff(np.concatenate(on_card.keys)) > 0).all())


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


@pytest.mark.cuda
def test_two_card_workers_answer_like_the_engine(cuda, tmp_path):
    """A two-worker server on ``device="cuda"``: every answer equals the
    in-process engine's on the card bit for bit (both run the same
    kernel), and each worker launched ``topk_gather`` in its own process."""
    from repro_torch.store import CoocServer, QueryEngine, Store, TopKRequest

    c = synthetic_zipf_collection(400, vocab=2000, mean_len=40, seed=6)
    store, _ = count_to_store("list-scan-segment", c, str(tmp_path / "s"))
    engine = QueryEngine(Store.open(store.path))
    rng = np.random.default_rng(6)
    reqs = [TopKRequest(rng.integers(0, 2000, size=16), k=10, score=score)
            for score in SCORES for _ in range(4)]
    with CoocServer(store.path, workers=2, routing=True) as server:
        got = server.client().execute(reqs, timeout=120.0)
    for req, (ids, scores) in zip(reqs, got):
        want_ids, want_scores = engine.topk(req.terms, k=10, score=req.score)
        assert np.array_equal(ids, want_ids)
        assert scores.tobytes() == want_scores.tobytes()
    stats = server.stats()
    assert stats["workers_lost"] == 0 and stats["resilience"]["respawns"] == 0
    assert [w["device"] for w in stats["per_worker"]] == ["cuda", "cuda"]
    assert all(w["kernel_launches"]["topk_gather"] > 0 for w in stats["per_worker"])


@pytest.mark.cuda
def test_stream_seals_on_the_card_equal_a_batch_build(cuda, tmp_path):
    """Seals on the card (``list-scan-segment``, the device's own method)
    launch ``segment_hist`` and compact into the bytes of a batch build."""
    from repro_torch.store import Store
    from repro_torch.stream import QueueSource, StreamConfig, StreamIngestor

    c = synthetic_zipf_collection(300, vocab=3000, mean_len=60, seed=8)
    store = Store.create(str(tmp_path / "live"), 3000)
    src = QueueSource()
    src.push_collection(c)
    src.close()
    before = SEGMENT_HIST.launches
    summary = StreamIngestor(store, src, StreamConfig(seal_docs=64),
                             source_id="q").run()
    assert summary["method"] == "list-scan-segment" and summary["seals_this_run"] == 5
    assert SEGMENT_HIST.launches > before
    store.refresh()
    store.compact()
    _, host = count_to_store("list-scan", c, str(tmp_path / "host"), device="cpu")
    for name in SEGMENT_ARRAYS:
        with open(os.path.join(store.segments[0].path, name), "rb") as a, \
                open(os.path.join(host.path, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.cuda
def test_follow_in_process_shares_the_card(cuda, tmp_path):
    """``serve(workers=0, follow=...)``: the ingest thread's seals launch
    ``segment_hist`` and the serving thread's queries ``topk_gather`` on
    the same device; the followed documents all land in the store."""
    from repro_torch.launch.cooc_serve import serve
    from repro_torch.stream import collection_to_feed

    feed = str(tmp_path / "feed.txt")
    fed = synthetic_zipf_collection(200, vocab=2000, mean_len=40, seed=9)
    collection_to_feed(feed, fed)
    hist0, topk0 = SEGMENT_HIST.launches, TOPK_GATHER.launches
    stats = serve(docs=300, vocab=2000, store_path=str(tmp_path / "s"),
                  queries=256, batch=32, score="pmi", follow=feed)
    assert SEGMENT_HIST.launches > hist0 and TOPK_GATHER.launches > topk0
    assert stats["stream"]["healthy"] and stats["stream"]["device"] == "cuda"
    assert stats["stream"]["cursor"]["docs"] == fed.num_docs
    assert stats["num_docs"] == 300 + fed.num_docs


@pytest.mark.cuda
def test_parallel_ingest_on_the_card_equals_the_serial_card_build(cuda, tmp_path):
    """``ParallelExecutor(2)`` with ``device="cuda"``: each spawned worker
    counts in its own CUDA context (its own ``segment_hist`` launches, from
    its report), and the store's bytes equal the serial card build's."""
    from repro_torch.core.plan import CountJob, ParallelExecutor, Planner, PlanExecutor

    c = synthetic_zipf_collection(400, vocab=6000, mean_len=40, seed=12)

    def build(root, executor):
        job = CountJob(collection=c, output="store", out_path=str(root / "store"),
                       method="list-scan-segment", num_shards=6, dense_vocab_cap=1,
                       memory_budget_pairs=4096)
        return executor.execute(Planner().plan(job), out_dir=str(root / "wd"))

    serial = build(tmp_path / "serial", PlanExecutor())
    par = build(tmp_path / "par", ParallelExecutor(num_workers=2))
    for name in SEGMENT_ARRAYS:
        with open(os.path.join(serial.segment.path, name), "rb") as a, \
                open(os.path.join(par.segment.path, name), "rb") as b:
            assert a.read() == b.read(), name
    per = par.summary["per_worker"]
    assert [w["exitcode"] for w in per] == [0, 0] and par.summary["parent_shards"] == 0
    for w in per:
        assert w["device"] == "cuda"
        assert w["shards"] == 0 or w["kernel_launches"]["segment_hist"] > 0


def test_parallel_ingest_on_a_host_without_a_card_fails_visibly(tmp_path):
    """``device="cuda"`` where there is no card: each spawned worker dies
    resolving its device, and the parent's drain of the left-over shards
    raises ``DeviceError`` on the job's device — no shard is counted on the
    host, and no worker reports."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the workers would reach it")
    from repro_torch.core.plan import CountJob, ParallelExecutor, Planner
    from repro_torch.device import DeviceError

    c = synthetic_zipf_collection(120, vocab=6000, mean_len=20, seed=12)
    plan = Planner().plan(CountJob(
        collection=c, output="store", out_path=str(tmp_path / "store"),
        method="list-scan-segment", num_shards=4, dense_vocab_cap=1))
    assert plan.method_kwargs["device"] == "cuda"
    wd = tmp_path / "wd"
    t0 = time.monotonic()
    with pytest.raises(DeviceError, match="no CUDA device"):
        ParallelExecutor(num_workers=2).execute(plan, out_dir=str(wd))
    assert time.monotonic() - t0 < 60  # the ready barrier stops at dead workers
    assert glob.glob(str(wd / "spill" / "shard_*")) == []
    assert glob.glob(str(wd / "spill" / "**" / "*.bin"), recursive=True) == []
    assert os.listdir(wd / "workers") == []


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_distributed_gram_on_ranks_sharing_the_card(cuda, shape):
    """A world of 2 or 4 ranks on the card: each rank's products run
    ``cooc_gram`` there (its own launches) and both schedules give the
    exact Gram. With fewer cards than ranks the world is gloo, the ranks
    share ``cuda:0`` and their blocks travel through host copies; with a
    card for each rank it is NCCL, on device blocks, with no copy."""
    from repro_torch.core.distributed import gram_on_world

    rng = np.random.default_rng(sum(shape))
    B = (rng.random((600, 256)) < 0.15).astype(np.uint8)
    want = B.T.astype(np.int64) @ B.astype(np.int64)
    out = gram_on_world(B, shape, ("data", "model"), device="cuda")
    for sched, C in out["C"].items():
        assert np.array_equal(C, want), sched
    nccl = torch.cuda.device_count() >= len(out["ranks"])
    for r in out["ranks"]:
        assert r["backend"] == ("nccl" if nccl else "gloo")
        assert r["device"] == (f"cuda:{r['rank']}" if nccl else "cuda")
        assert r["kernel_launches"]["cooc_gram"] > 0
        for sched in ("allgather", "ring"):
            copies = r["schedules"][sched]["counters"].get("dist.host_copies", 0)
            assert (copies == 0) if nccl else (copies > 0), (sched, copies)


@pytest.mark.cuda
def test_minicpm3_decode_step_at_full_width_on_the_card_equals_the_host(cuda):
    """MiniCPM3-4B at full width cut to 2 layers, float32 with TF32 off:
    prefill, then one ``decode_step`` on the card and on the host with the
    same weights; logits and the written cache within max abs 1e-3. The LM
    path is plain PyTorch, so this holds the card's library kernels
    (cuBLAS, the reductions) to the host's."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import transformer as LM

    cfg = dataclasses.replace(get_spec("minicpm3-4b").model, n_layers=2, dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        host = LM.TransformerLM(cfg, "cpu")
        host.load_state_dict(card.state_dict())
        B, P = 2, 16
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P + 1))
        out = []
        for model, dev in ((card, cuda), (host, torch.device("cpu"))):
            t = torch.from_numpy(tokens.astype(np.int32)).to(dev)
            with torch.inference_mode():
                _, pre = LM.prefill(model, t[:, :P], cfg)
                cache = LM.init_cache(cfg, B, P + 1, dev)
                for name, c in cache.items():
                    c[:, :, :P] = pre[name]
                logits, cache = LM.decode_step(model, cache, t[:, P:], P, cfg)
            out.append((logits.cpu(), {n: c.cpu() for n, c in cache.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, cc), (lh, ch) = out
    assert torch.isfinite(lc).all()
    assert (lc - lh).abs().max().item() < 1e-3
    for name in cc:
        assert (cc[name] - ch[name]).abs().max().item() < 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["graphsage-reddit", "dien"])
def test_gnn_and_ranker_smoke_forward_on_the_card_equals_the_host(cuda, arch):
    """The smoke GraphSAGE (full-graph forward on a sampler graph, edges
    scattered by ``index_add_`` in no fixed order on the card) and the
    smoke DIEN (GRU and AUGRU loops), float32 with TF32 off: the same
    weights on the card and the host (init plus N(0, 0.05^2) on every leaf,
    so that biases count and the logits stand at least 100 times above the
    gate), logits within max abs 1e-4."""
    from repro_torch.configs import get_spec
    from repro_torch.data.sampler import random_graph
    from repro_torch.models import gnn, recsys

    cfg = get_spec(arch).smoke()
    rng = np.random.default_rng(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if arch == "dien":
            card = recsys.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
            host = recsys.Ranker(cfg, "cpu")
            items = rng.integers(-1, cfg.n_items, (16, cfg.seq_len))
            batch = {"hist_items": items, "hist_cats": np.where(items < 0, -1, items % cfg.n_cats),
                     "target_item": rng.integers(0, cfg.n_items, 16),
                     "target_cat": rng.integers(0, cfg.n_cats, 16)}

            def run(model, dev):
                b = {k: torch.from_numpy(v.astype(np.int32)).to(dev) for k, v in batch.items()}
                return recsys.dien_forward(model, b, cfg)
        else:
            card = gnn.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
            host = gnn.GraphSAGE(cfg, "cpu")
            g = random_graph(300, 4, seed=0)
            dst = np.repeat(np.arange(300), np.diff(g.indptr))
            ei = np.stack([g.indices, dst]).astype(np.int32)
            feats = rng.normal(size=(300, cfg.d_in)).astype(np.float32)

            def run(model, dev):
                return gnn.forward_full_graph(model, torch.from_numpy(feats).to(dev),
                                              torch.from_numpy(ei).to(dev), cfg)
        noise = torch.Generator(device=cuda).manual_seed(1)
        with torch.no_grad():
            for p in card.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=noise, device=cuda))
        host.load_state_dict(card.state_dict())
        with torch.inference_mode():
            lc, lh = run(card, cuda).cpu(), run(host, torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.isfinite(lc).all()
    assert lh.abs().max().item() >= 100 * 1e-4
    assert (lc - lh).abs().max().item() < 1e-4


def _train_state_leaves(state):
    from repro_torch.checkpoint import flatten
    from repro_torch.convert import train_state_tree

    out = []
    for name, leaf in flatten(train_state_tree(*state)):
        out += [(f"{name}[{i}]", t) for i, t in enumerate(leaf)] if isinstance(leaf, list) \
            else [(name, leaf)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "dien"])
def test_one_train_step_on_the_card_equals_the_host(cuda, arch):
    """One step of ``make_lm_train_step`` on the smoke DeepSeek-V3 (MLA,
    MoE with a shared expert, the MTP head) with ``pick_optimizer``'s
    AdamW, or of ``make_recsys_train_step`` on the smoke DIEN with SGD
    (whose first momentum is the gradient itself), float32 with TF32 off,
    from the same weights on the card and the host: the metrics, every
    parameter and every optimizer-state leaf within max abs 1e-4 (DIEN's
    weights at init plus N(0, 0.05^2), so that its gradients reach 100
    times the gate). AdamW's first step moves DeepSeek's parameters by its
    learning rate, 1.5e-7, so its clipped gradients are held too: each leaf
    within 1e-3 of that leaf's largest host entry, the largest reaching 100
    times the 1e-4 gate."""
    from repro_torch.configs import get_spec
    from repro_torch.launch import train as TR
    from repro_torch.models import recsys
    from repro_torch.models import transformer as LM
    from repro_torch.optim import sgd

    cfg = get_spec(arch).smoke()
    rng = np.random.default_rng(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if arch == "dien":
            card = recsys.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
            with torch.no_grad():
                noise = torch.Generator(device=cuda).manual_seed(1)
                for p in card.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=noise, device=cuda))
            host = recsys.Ranker(cfg, "cpu")
            items = rng.integers(-1, cfg.n_items, (16, cfg.seq_len))
            batch = {"hist_items": items, "hist_cats": np.where(items < 0, -1, items % cfg.n_cats),
                     "target_item": rng.integers(0, cfg.n_items, 16),
                     "target_cat": rng.integers(0, cfg.n_cats, 16),
                     "label": rng.integers(0, 2, 16)}

            def make():
                return sgd(0.1), TR.make_recsys_train_step
        else:
            card = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
            host = LM.TransformerLM(cfg, "cpu")
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24))}

            def make():
                return TR.pick_optimizer(cfg.num_params())[0], TR.make_lm_train_step
        host.load_state_dict(card.state_dict())
        out = []
        for model, dev in ((card, cuda), (host, torch.device("cpu"))):
            opt, factory = make()
            grads = {}

            def update(g, st, p, opt=opt, grads=grads):
                grads.update({k: torch.stack(v) if isinstance(v, list) else v.clone()
                              for k, v in g.items()})
                return opt.update(g, st, p)

            opt = dataclasses.replace(opt, update=update)
            b = {k: torch.from_numpy(v.astype(np.int32)).to(dev) for k, v in batch.items()}
            state, metrics = factory(cfg, opt)((model, opt.init(model.param_tree())), b)
            out.append((_train_state_leaves(state), {k: float(v) for k, v in metrics.items()},
                        grads))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, mc, gc), (lh, mh, gh) = out
    assert set(mc) == set(mh) and all(np.isfinite(v) for v in mc.values())
    assert max(abs(mc[k] - mh[k]) for k in mh) < 1e-4, (mc, mh)
    assert [n for n, _ in lc] == [n for n, _ in lh]
    for (name, a), (_, b) in zip(lc, lh):
        assert (a.detach().cpu().double() - b.detach().double()).abs().max().item() < 1e-4, name
    if arch == "dien":
        assert max(b.abs().max().item() for n, b in lh if n.startswith("1/mu/")) >= 100 * 1e-4
    else:
        assert list(gc) == list(gh)
        for name, g in gh.items():
            err = (gc[name].cpu().double() - g.double()).abs().max().item()
            assert err <= 1e-3 * g.abs().max().item(), (name, err)
        assert max(g.abs().max().item() for g in gh.values()) >= 100 * 1e-4


@pytest.mark.cuda
def test_smoke_olmoe_moe_ffn_ep_on_two_ranks_sharing_the_card_equals_the_host(cuda):
    """The smoke OLMoE's MoE layer expert-parallel on a (1, 2) gloo world
    whose ranks share the card (collectives through host copies), against
    the same world on the host: output and gradients."""
    from repro_torch.configs import get_spec
    from repro_torch.launch.moe_ep import moe_ep_on_world

    cfg = get_spec("olmoe-1b-7b").smoke()
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    rng = np.random.default_rng(5)
    p = {"router": rng.normal(size=(d, E)) * (2 / d) ** 0.5,
         "w_in": rng.normal(size=(E, d, f)) * (2 / d) ** 0.5,
         "w_gate": rng.normal(size=(E, d, f)) * (2 / d) ** 0.5,
         "w_out": rng.normal(size=(E, f, d)) * (2 / f) ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 32, d)).astype(np.float32)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, aux_weight=0.01)
    card = moe_ep_on_world(p, x, (1, 2), device="cuda", **kw)
    host = moe_ep_on_world(p, x, (1, 2), device="cpu", **kw)
    scale = np.abs(host["y"]).max()
    assert scale > 0.1
    assert np.abs(card["y"] - host["y"]).max() <= 1e-4 * scale
    assert abs(card["aux"] - host["aux"]) <= 1e-5
    for k, g in host["grads"].items():
        assert np.abs(card["grads"][k] - g).max() <= 1e-4 * max(1.0, np.abs(g).max()), k


@pytest.mark.cuda
def test_tail_hist_share_on_the_card_equals_the_plain_version(cuda):
    """One rank's share of ``cooc-wt10g/tail_hist``: 524,288 postings (of
    8,388,608 over 16 data ranks) into 256 × 65,536."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L, rows, V = 8_388_608 // 16, 256, 65_536
    seg = torch.sort(torch.randint(0, rows, (L,), generator=g, device=cuda,
                                   dtype=torch.int32)).values
    ids = torch.randint(0, V, (L,), generator=g, device=cuda, dtype=torch.int32)
    got = ops.segment_hist(ids, seg, num_rows=rows, vocab=V)
    want = ref.segment_hist_ref(ids, seg, rows, V)
    assert torch.equal(got, want) and int(got.sum()) == L
