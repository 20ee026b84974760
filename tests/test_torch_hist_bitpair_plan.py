"""The schedules of the ``segment_hist`` and ``bitpair`` kernels, on the CPU.

Neither CUDA kernel runs here, so this file checks what they rest on,
against the plain versions (``segment_hist_ref``, ``bitpair_popcount_ref``)
and the JAX package's Pallas kernels (interpret mode):

* a numpy model of the windowed histogram (``csrc/segment_hist.cu``): each
  block's span, its R x H window starting at the span's first row, window
  moves when a whole step lies past the window, flushes, and the global
  overflow of every other token;
* a numpy model of ``bitpair``'s schedule (``csrc/bitpair.cu``): output
  tiles x word slices, and on one tensor passed twice only the tiles with
  tile_n >= tile_m, mirrored at the write;
* the two launch plans (``kernels.segment_hist.plan``,
  ``kernels.bitpair.plan``): their shared-memory and grid limits, and that
  every token, and every word of every output pair, is covered exactly
  once.

The kernels themselves are held to their plain versions on the card in
``test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.list_scan import _device_chunks  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.data.index import DeviceIndex  # noqa: E402
from repro_torch.kernels import bitpair as bp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import segment_hist as sh  # noqa: E402


# ------------------------------------------------------------ segment_hist
def model_hist(ids, seg, num_rows, vocab, R, H, span, step):
    """The windowed histogram as the kernel runs it, block by block and
    step by step. Returns ``(grid, hits, moves)``."""
    out = np.zeros((num_rows, vocab), dtype=np.int64)
    hits = moves = 0
    n = len(ids)

    def flush(win, r0):
        rows = np.nonzero(win.any(axis=1))[0]
        assert (r0 + rows < num_rows).all(), "a window row past the grid"
        for i in rows:
            out[r0 + i, :H] += win[i]
        win[:] = 0

    for begin in range(0, n, span):
        end = min(n, begin + span)
        win = np.zeros((R, H), dtype=np.int64)
        r0 = int(np.clip(seg[begin], 0, num_rows - 1))
        for s0 in range(begin, end, step):
            v = ids[s0:min(end, s0 + step)].astype(np.int64)
            r = seg[s0:min(end, s0 + step)].astype(np.int64)
            ok = (v >= 0) & (r >= 0) & (r < num_rows) & (v < vocab)
            v, r = v[ok], r[ok]
            if R * H and bool((r - r0 >= R).all()):  # the step is past the window
                flush(win, r0)
                moves += 1
                if len(r):
                    r0 = int(r.min())
            d = r - r0
            inside = (d >= 0) & (d < R) & (v < H)
            np.add.at(win, (d[inside], v[inside]), 1)
            np.add.at(out, (r[~inside], v[~inside]), 1)
            hits += int(inside.sum())
        flush(win, r0)
    return out, hits, moves


def _want(ids, seg, num_rows, vocab):
    """The plain version and the Pallas kernel (interpret), which must agree."""
    plain = ref.segment_hist_ref(torch.from_numpy(ids), torch.from_numpy(seg),
                                 num_rows, vocab).numpy()
    pallas = np.asarray(jops.segment_hist(ids, seg, num_rows=num_rows, vocab=vocab))
    assert np.array_equal(plain, pallas)
    return plain


def _sorted_stream(rng, lens, vocab, zipf=1.1):
    """Rows 0.. with ``lens[r]`` tokens each, in row order; ids Zipf-shaped
    over [0, vocab)."""
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    ids = (rng.zipf(zipf, size=len(seg)) - 1) % vocab
    return ids.astype(np.int32), seg


def _hist_cases():
    rng = np.random.default_rng(0)
    cases = {}
    # rows of 5..60 tokens cross windows of 2 rows and spans of 64 tokens
    cases["sorted, rows cross windows"] = (
        *_sorted_stream(rng, rng.integers(5, 60, 40), 300), 40, 300, 2, 64, 64, 8)
    # one row longer than several spans, then short rows
    cases["one row longer than a span"] = (
        *_sorted_stream(rng, [500, 3, 7, 2], 100), 4, 100, 2, 32, 128, 16)
    # most ids at or past H: the overflow path
    ids, seg = _sorted_stream(rng, rng.integers(20, 40, 10), 1000, zipf=1.01)
    cases["columns >= H"] = (ids, seg, 10, 1000, 3, 16, 96, 32)
    cases["unsorted random seg"] = (
        rng.integers(-1, 200, 3000).astype(np.int32),
        rng.integers(-1, 30, 3000).astype(np.int32), 30, 200, 4, 64, 512, 64)
    cases["all padding"] = (
        np.full(700, -1, np.int32), np.full(700, -1, np.int32), 5, 50, 2, 32, 256, 64)
    # negative padding other than -1, ids past vocab, rows past the grid,
    # and a span that starts on an out-of-grid row
    ids, seg = _sorted_stream(rng, rng.integers(10, 30, 12), 80)
    ids[::7] = 80 + ids[::7]
    ids[3::11] = -5
    seg[5::13] = 12 + seg[5::13]
    seg[::64] = 1000
    cases["out-of-grid entries"] = (ids, seg, 12, 80, 2, 40, 64, 16)
    return cases


HIST_CASES = _hist_cases()


@pytest.mark.parametrize("name", sorted(HIST_CASES))
def test_windowed_histogram_model_equals_plain_and_pallas(name):
    ids, seg, num_rows, vocab, R, H, span, step = HIST_CASES[name]
    got, hits, moves = model_hist(ids, seg, num_rows, vocab, R, H, span, step)
    assert np.array_equal(got, _want(ids, seg, num_rows, vocab))
    valid = (ids >= 0) & (seg >= 0) & (seg < num_rows) & (ids < vocab)
    assert 0 <= hits <= int(valid.sum())
    if name == "sorted, rows cross windows":
        assert moves > 0 and hits > 0
    if name == "all padding":
        assert hits == 0


def test_windowed_histogram_model_accumulates_into_out():
    ids, seg, num_rows, vocab, R, H, span, step = HIST_CASES["sorted, rows cross windows"]
    once, _, _ = model_hist(ids, seg, num_rows, vocab, R, H, span, step)
    start = torch.from_numpy(once.astype(np.int32))
    plain = ref.segment_hist_ref(torch.from_numpy(ids), torch.from_numpy(seg),
                                 num_rows, vocab, out=start.clone()).numpy()
    assert np.array_equal(once + once, plain)


def _list_scan_stream(lower=False):
    """A real batch stream: the strict-upper (or strict-lower) tokens of
    primaries [0, 16) of a small Zipf collection, as the callers emit them."""
    c = synthetic_zipf_collection(300, vocab=2000, mean_len=60, seed=1)
    idx = DeviceIndex.from_collection(c, torch.device("cpu"))
    lo, hi = (64, 200) if lower else (0, 16)
    ids, seg = next(_device_chunks(idx, lo, hi, 1 << 26, lower=lower))
    vocab = hi if lower else c.vocab_size
    return ids.numpy(), seg.numpy(), hi - lo, vocab


@pytest.mark.parametrize("lower", [False, True])
def test_windowed_histogram_model_with_the_plan_on_a_list_scan_stream(lower, monkeypatch):
    """The plan's window on a real stream; the stream is shorter than the
    launches that take a window, so that threshold is lifted here."""
    monkeypatch.setattr(sh, "MIN_WINDOW_TOKENS", 0)
    ids, seg, num_rows, vocab = _list_scan_stream(lower)
    p = sh.plan(num_rows, vocab, len(ids))
    assert p.R * p.H > 0
    got, hits, _ = model_hist(ids, seg, num_rows, vocab, p.R, p.H, p.span, 4 * p.threads)
    assert np.array_equal(got, _want(ids, seg, num_rows, vocab))
    assert hits > len(ids) // 2  # the window catches the Zipf head


def test_windowed_histogram_model_with_small_steps_on_a_list_scan_stream():
    """The same stream with steps of 64 tokens, spans of 4,096 and a
    window of one row, so that windows move inside spans."""
    ids, seg, num_rows, vocab = _list_scan_stream()
    got, _, moves = model_hist(ids, seg, num_rows, vocab, 1, 512, 4096, 64)
    assert moves > 0
    assert np.array_equal(got, _want(ids, seg, num_rows, vocab))


# the shapes the card times: path 1's head batch, path 2's and cooc_run's
# first tail batches, and small and one-step streams
PLAN_SHAPES = [
    (64, 65_536, 1 << 26), (64, 65_536, 33_569_684), (3615, 4639, 67_108_796),
    (3615, 4639, 423_169), (64, 65_536, 1_000_000), (64, 65_536, 5000),
    (1, 1, 1), (3, 70_000, 4096), (2**31 - 1, 10, 10**10), (7, 2**40, 123_457),
]


@pytest.mark.parametrize("num_rows,vocab,n", PLAN_SHAPES)
def test_segment_hist_plan_limits_and_cover(num_rows, vocab, n):
    p = sh.plan(num_rows, vocab, n)
    assert p.threads in (sh.THREADS, sh.NARROW_THREADS) and p.span % (4 * p.threads) == 0
    assert p.blocks >= 1 and (p.blocks <= sh.SMS or p.R * p.H == 0) and p.blocks < 2**31
    # the spans cover [0, n) once: every block has tokens, the last ends at n
    assert (p.blocks - 1) * p.span < n <= p.blocks * p.span
    assert p.R * p.H <= sh.WINDOW_CELLS <= 227 * 1024 // 4  # a block's shared memory
    if p.R * p.H:
        assert p.R <= num_rows and sh.MIN_H <= p.H <= min(vocab, sh.MAX_H)
        assert p.R * p.H <= p.span  # flushing costs at most a cell a token
    else:
        assert p.R == p.H == 0


def test_segment_hist_plan_of_the_head_batch():
    assert sh.plan(64, 65_536, 1 << 26) == sh.Plan(R=2, H=16_384, span=512_000,
                                                   blocks=132, threads=1024)


def test_segment_hist_plan_gives_short_launches_no_window():
    """A launch of fewer tokens than one step a block on every SM takes no
    window: its zeroing and flushes would cost more than they save."""
    t = sh.MIN_WINDOW_TOKENS
    assert t == sh.SMS * sh.STEP
    short, full = sh.plan(64, 65_536, t - 1), sh.plan(64, 65_536, t)
    assert short.R == short.H == 0 and full.R * full.H > 0
    # one step a block, so that the global atomics spread over the SMs
    assert short.threads == sh.NARROW_THREADS and short.span == 4 * sh.NARROW_THREADS


def test_segment_hist_plan_refuses_empty_input():
    with pytest.raises(ValueError):
        sh.plan(64, 65_536, 0)


# ----------------------------------------------------------------- bitpair
def _tile_of(k, p, same):
    """Block k's output tile (tm, tn), decoded as the kernel decodes it."""
    if not same:
        return divmod(k, p.tiles_n)
    i = int((math.sqrt(8.0 * k + 1.0) - 1.0) / 2.0)
    while i * (i + 1) // 2 > k:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= k:
        i += 1
    return k - i * (i + 1) // 2, i


def model_bitpair(a, b, same):
    """``bitpair`` under its plan: every (tile, slice) block adds its partial
    into ``out`` (and its mirror off the diagonal when ``same``). Returns
    ``(out, cover)``: cover[m, n] counts the words added into out[m, n]."""
    M, W = a.shape
    N = b.shape[0]
    p = bp.plan(M, N, W, same)
    T = bp.TILE
    out = np.zeros((M, N), dtype=np.int64)
    cover = np.zeros((M, N), dtype=np.int64)
    seen = set()
    for k in range(p.tiles):
        tm, tn = _tile_of(k, p, same)
        assert (tm, tn) not in seen and (not same or tn >= tm)
        seen.add((tm, tn))
        ms, ns = slice(tm * T, min(M, tm * T + T)), slice(tn * T, min(N, tn * T + T))
        for s in range(p.slices):
            w_lo, w_hi = s * W // p.slices, (s + 1) * W // p.slices
            assert w_lo < w_hi  # every slice holds a word
            both = a[ms, None, w_lo:w_hi] & b[None, ns, w_lo:w_hi]
            part = np.unpackbits(both.view(np.uint8), axis=-1).sum(axis=-1, dtype=np.int64)
            out[ms, ns] += part
            cover[ms, ns] += w_hi - w_lo
            if same and tm != tn:
                out[ns, ms] += part.T
                cover[ns, ms] += w_hi - w_lo
    return out, cover


def _want_bitpair(a, b):
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    plain = ref.bitpair_popcount_ref(ta, tb).numpy()
    pallas = np.asarray(jops.bitpair_popcount(a, b))
    assert np.array_equal(plain, pallas)
    return plain


@pytest.mark.parametrize(
    "m,n,w,same",
    [(70, 130, 33, False), (5, 9, 3, False), (200, 64, 129, False),
     (1, 1, 1, False), (3, 2, 2, False), (1, 1, 1, True),  # S capped at W
     (70, 70, 33, True), (130, 130, 5, True), (200, 200, 61, True)],
)
def test_bitpair_schedule_model_equals_plain_and_pallas(m, n, w, same):
    rng = np.random.default_rng(m * 1000 + n + w)
    a = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    a[:, ::3] = 0
    b = a if same else rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    got, cover = model_bitpair(a, b, same)
    assert (cover == w).all()  # every word of every pair added exactly once
    assert np.array_equal(got, _want_bitpair(a, b))
    if w <= 2:
        assert bp.plan(m, n, w, same).slices == w  # one slice a word


@pytest.mark.parametrize(
    "M,N,W,same",
    [(256, 256, 625, False), (256, 256, 625, True), (256, 256, 63, False),
     (256, 256, 63, True), (1, 1, 1, False), (70, 70, 33, True),
     (4096, 4096, 625, True), (100_000, 100_000, 10, False), (64, 3_000_000, 2, False)],
)
def test_bitpair_plan_limits_and_cover(M, N, W, same):
    p = bp.plan(M, N, W, same)
    tm, tn = -(-M // bp.TILE), -(-N // bp.TILE)
    assert p.tiles == (tm * (tm + 1) // 2 if same else tm * tn)
    assert p.tiles_n == tn and 1 <= p.tiles <= bp.MAX_TILES
    assert 1 <= p.slices <= min(W, bp.MAX_SLICES)
    assert p.blocks >= bp.MIN_BLOCKS or p.slices == W  # fills the card where W allows
    # the slices cover [0, W) once, each with at least one word
    edges = [s * W // p.slices for s in range(p.slices + 1)]
    assert edges[0] == 0 and edges[-1] == W
    assert all(lo < hi for lo, hi in zip(edges, edges[1:]))


def test_bitpair_plan_of_a_list_pairs_block():
    """A 256 x 256 x 625 call launches at least 2 x 132 blocks; its
    diagonal counterpart computes 10 of the 16 tiles."""
    off, diag = bp.plan(256, 256, 625, False), bp.plan(256, 256, 625, True)
    assert off.blocks >= 264 and diag.blocks >= 264
    assert (off.tiles, diag.tiles) == (16, 10)


def test_bitpair_triangle_decode_is_exact_far_out():
    """The kernel's square-root decode of the tiles tn >= tm stays exact
    at tile counts near the grid's limit."""
    p = bp.plan(64 * 65_000, 64 * 65_000, 1, True)
    for k in (0, 1, 2, p.tiles // 2, p.tiles - 2, p.tiles - 1):
        tm, tn = _tile_of(k, p, True)
        assert 0 <= tm <= tn < 65_000 and tn * (tn + 1) // 2 + tm == k


def test_bitpair_plan_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError):
        bp.plan(70, 71, 3, True)
    with pytest.raises(ValueError):
        bp.plan(64 * 2**17, 64 * 2**17, 1, False)
