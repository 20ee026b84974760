"""The port's cooc_gram and bitpair against the JAX package's, on the same
inputs.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's ``kernels.ops`` runs each kernel's plain PyTorch version;
the JAX side runs its Pallas kernels with ``interpret=True`` and its jnp
oracles, as its own tests do. Tolerance is 0: both compute integer counts.
The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bitpair import bitpair_cuda  # noqa: E402
from repro_torch.kernels.cooc_gram import cooc_gram_cuda  # noqa: E402


def _tiles(seed, d, m, n, p=0.15):
    rng = np.random.default_rng(seed)
    return (
        (rng.random((d, m)) < p).astype(np.uint8),
        (rng.random((d, n)) < p).astype(np.uint8),
    )


def _words(a):
    """numpy uint32 bitmaps as the int32 tensor the port carries them in."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


# ---------------------------------------------------------------- cooc_gram
@pytest.mark.parametrize(
    "d,m,n",
    [(1, 1, 1), (8, 16, 16), (100, 50, 70), (256, 128, 128), (300, 130, 257),
     (512, 256, 384)],
)
def test_cooc_gram_matches_jax(d, m, n):
    bi, bj = _tiles(d + m + n, d, m, n)
    got = ops.cooc_gram(torch.from_numpy(bi), torch.from_numpy(bj))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    pallas = np.asarray(jops.cooc_gram(bi.astype(np.float32), bj.astype(np.float32)))
    want = bi.T.astype(np.int64) @ bj.astype(np.int64)
    assert np.array_equal(got.numpy(), pallas.astype(np.int64))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,m", [(700, 200), (2048, 96), (1250, 1000)])
def test_cooc_gram_one_tile_twice_matches_jax_oracle(d, m):
    """A diagonal tile (one tensor passed twice), as the FREQ-SPLIT head and
    the diagonal LIST-BLOCKS tiles pass it."""
    bi, _ = _tiles(d, d, m, 1, p=0.3)
    t = torch.from_numpy(bi)
    got = ops.cooc_gram(t, t).numpy()
    want = np.asarray(jref.cooc_gram_ref(jnp.asarray(bi, jnp.float32),
                                          jnp.asarray(bi, jnp.float32)))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, got.T)


@pytest.mark.parametrize("d,m,n", [(40, 0, 5), (40, 5, 0), (0, 6, 7), (33, 9, 9)])
def test_cooc_gram_empty_and_zero_tiles(d, m, n):
    """An empty M (``freq-split`` with head=0), an empty N, no documents, and
    all-zero tiles."""
    bi = np.zeros((d, m), np.uint8)
    bj = np.zeros((d, n), np.uint8)
    got = ops.cooc_gram(torch.from_numpy(bi), torch.from_numpy(bj))
    assert tuple(got.shape) == (m, n) and got.dtype == torch.int32
    assert not got.any()
    want = jref.cooc_gram_ref(jnp.asarray(bi, jnp.float32), jnp.asarray(bj, jnp.float32))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cooc_gram_plain_version_accepts_any_01_dtype():
    bi, bj = _tiles(3, 64, 32, 20, p=0.2)
    want = ops.cooc_gram(torch.from_numpy(bi), torch.from_numpy(bj))
    for dtype in (torch.float32, torch.int8, torch.int32, torch.bool):
        got = ref.cooc_gram_ref(torch.from_numpy(bi).to(dtype), torch.from_numpy(bj).to(dtype))
        assert torch.equal(got, want), dtype


def test_cooc_gram_plain_version_refuses_2_24_documents():
    tall = torch.zeros((1 << 24, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2\\^24"):
        ref.cooc_gram_ref(tall, tall)


# ----------------------------------------------------------------- bitpair
@pytest.mark.parametrize(
    "m,n,w",
    [(1, 1, 1), (5, 9, 3), (64, 64, 128), (70, 130, 200), (128, 64, 257)],
)
def test_bitpair_matches_jax(m, n, w):
    rng = np.random.default_rng(m * 1000 + n + w)
    wi = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    wj = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    got = ops.bitpair_popcount(_words(wi), _words(wj))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    pallas = np.asarray(jops.bitpair_popcount(wi, wj))
    oracle = np.asarray(jref.bitpair_popcount_ref(jnp.asarray(wi), jnp.asarray(wj)))
    assert np.array_equal(got.numpy(), pallas)
    assert np.array_equal(got.numpy(), oracle)


def test_bitpair_against_set_intersection():
    """Bitmaps built from explicit posting lists: popcount == |A ∩ B|."""
    rng = np.random.default_rng(42)
    n_docs, n_terms = 1000, 12
    W = (n_docs + 31) // 32
    posts = [np.unique(rng.integers(0, n_docs, size=rng.integers(1, 200)))
             for _ in range(n_terms)]
    bits = np.zeros((n_terms, W), dtype=np.uint32)
    for t, ds in enumerate(posts):
        np.bitwise_or.at(bits[t], ds // 32, np.uint32(1) << (ds % 32).astype(np.uint32))
    got = ops.bitpair_popcount(_words(bits), _words(bits)).numpy()
    for a in range(n_terms):
        for b in range(n_terms):
            assert got[a, b] == len(np.intersect1d(posts[a], posts[b]))
    assert np.array_equal(got, np.asarray(jops.bitpair_popcount(bits, bits)))


def test_bitpair_zero_words_and_empty_shapes():
    zeros = _words(np.zeros((4, 8), dtype=np.uint32))
    assert not ops.bitpair_popcount(zeros, zeros).any()
    no_words = _words(np.zeros((3, 0), dtype=np.uint32))
    assert not ops.bitpair_popcount(no_words, no_words).any()
    empty = _words(np.zeros((0, 8), dtype=np.uint32))
    assert tuple(ops.bitpair_popcount(empty, zeros).shape) == (0, 4)


def test_bitpair_plain_version_in_chunks_matches_jax():
    """Enough words that the plain version takes rows of ``rows_i`` in
    several chunks."""
    rng = np.random.default_rng(9)
    wi = rng.integers(0, 2**32, size=(40, 2000), dtype=np.uint32)
    wj = rng.integers(0, 2**32, size=(300, 2000), dtype=np.uint32)
    got = ops.bitpair_popcount(_words(wi), _words(wj)).numpy()
    want = np.asarray(jref.bitpair_popcount_ref(jnp.asarray(wi), jnp.asarray(wj)))
    assert np.array_equal(got, want)


def test_popcount32_of_edge_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xF0F0F0F0,
                      0x12345678], dtype=np.uint32)
    got = ref.popcount32(_words(words)).numpy()
    want = [bin(int(w)).count("1") for w in words]
    assert got.tolist() == want


# ------------------------------------------------------ card-only wrappers
def test_wrappers_take_only_cuda_tensors():
    """The CUDA wrappers raise on a CPU tensor instead of falling back:
    only ``kernels.ops`` sends a CPU tensor to the plain version."""
    tile = torch.zeros((4, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        cooc_gram_cuda(tile, tile)
    words = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bitpair_cuda(words, words)
