// bitpair: posting-list intersection sizes over bit-packed bitmaps, as
// AND plus population count.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitpair.py
// (`bitpair_kernel`, body `_bitpair_kernel`), which forms the whole
// (blk_m, blk_n, blk_w) AND intermediate on the VPU and reduces it into a
// VMEM-resident int32 tile over a sequential word grid axis.
//
// Computes out[m, n] += sum_w popcount(a[m, w] & b[n, w]) for 32-bit words
// a (M, W) and b (N, W), row-major (one term's bitmap per row, bit d of
// word w set iff the term occurs in document 32 w + d), into a zeroed int32
// out (M, N): exact below 2^31 set bits per pair.
//
// Bound on this card: operations. Each word pair costs one AND, one
// `__popc` and one add, and `__popc` issues at a quarter of the int32 rate,
// about 16 a clock per SM: M N W / (132 x 16 x clock) against the bytes
// 4 (M W + N W + M N) / 3.35 TB/s, and for a 256 x 256 block of
// LIST-PAIRS at W = 625 the popcounts take twenty times longer than the
// bytes. One block per 64 x 64 output tile left such a call 16 blocks for
// 132 SMs.
//
// Design: the word axis is split too. The grid is output tiles x S word
// slices, with S chosen by `plan()` in kernels/bitpair.py so that a call
// fills the card (this file derives none of it). A block of 128 threads
// walks its slice in stages of 32 words staged in shared memory word-major
// (rows padded by 4 words), and each thread keeps an 8 x 4 block of int32
// sums in registers: per word two 16-byte shared loads of its 8 rows and
// one of its 4 columns feed 32 AND + popcount + add. The partial tile then
// goes through shared memory so that consecutive threads add consecutive
// output words into `out` with integer `atomicAdd` (exact, and the same in
// any order). When a and b are one tensor (the diagonal blocks of
// LIST-PAIRS) the grid holds only the tiles with tile_n >= tile_m: each
// adds its partial into its own place and, off the diagonal, into its
// mirror, so half the popcounts give the full square. Ragged M, N and W are
// masked while staging and writing.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // output tile edge (terms); kernels/bitpair.py TILE
constexpr int KW = 32;        // words per stage
constexpr int PAD = 4;        // row padding, in words (keeps 16-byte rows)
constexpr int THREADS = 128;  // 8 x 16 threads, 8 x 4 outputs each

// Stage words [w0, w0 + KW) of rows [r0, r0 + TILE) of the (rows, W)
// matrix src into dst[w][m], 0 outside the matrix and past w_hi.
// Neighbouring threads read neighbouring words of one row.
__device__ __forceinline__ void stage_rows(const uint32_t* __restrict__ src,
                                           int64_t rows, int64_t W,
                                           int64_t r0, int64_t w0,
                                           int64_t w_hi,
                                           uint32_t (*dst)[TILE + PAD]) {
  for (int e = threadIdx.x; e < KW * TILE; e += THREADS) {
    const int w = e % KW;
    const int m = e / KW;
    const int64_t r = r0 + m;
    const int64_t col = w0 + w;
    dst[w][m] = (r < rows && col < w_hi) ? src[r * W + col] : 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
bitpair_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int64_t M, int64_t N, int64_t W, int32_t* __restrict__ out,
               int same, int64_t tiles_n) {
  __shared__ __align__(16) uint32_t stage[2][KW][TILE + PAD];
  // slice blockIdx.y of gridDim.y <= W: at least one word
  const int64_t w_lo = (int64_t)blockIdx.y * W / gridDim.y;
  const int64_t w_hi = ((int64_t)blockIdx.y + 1) * W / gridDim.y;

  int64_t tm, tn;
  if (same) {
    // blockIdx.x enumerates the pairs tn >= tm as tn (tn + 1) / 2 + tm
    const int64_t k = blockIdx.x;
    int64_t i = (int64_t)((sqrt(8.0 * (double)k + 1.0) - 1.0) / 2.0);
    while (i * (i + 1) / 2 > k) --i;
    while ((i + 1) * (i + 2) / 2 <= k) ++i;
    tn = i;
    tm = k - i * (i + 1) / 2;
  } else {
    tm = blockIdx.x / tiles_n;
    tn = blockIdx.x % tiles_n;
  }
  const int64_t m0 = tm * TILE;
  const int64_t n0 = tn * TILE;
  const bool one_tile = same && tm == tn;
  const int tx = threadIdx.x % 16;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / 16;  // rows 8 ty .. 8 ty + 7
  uint32_t(*sa)[TILE + PAD] = stage[0];
  uint32_t(*sb)[TILE + PAD] = one_tile ? stage[0] : stage[1];
  int32_t acc[8][4] = {};

  for (int64_t w0 = w_lo; w0 < w_hi; w0 += KW) {
    stage_rows(a, M, W, m0, w0, w_hi, sa);
    if (!one_tile) stage_rows(b, N, W, n0, w0, w_hi, sb);
    __syncthreads();
    // words past w_hi were staged as 0; round the count up to the unroll
    const int64_t left = w_hi - w0;
    const int nq = left >= KW ? KW : (int)((left + 3) & ~3);
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(&sa[q][8 * ty]);
      const uint4 a1 = *reinterpret_cast<const uint4*>(&sa[q][8 * ty + 4]);
      const uint4 bv = *reinterpret_cast<const uint4*>(&sb[q][4 * tx]);
      const uint32_t ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(ar[i] & br[j]);
    }
    __syncthreads();
  }

  // the partial tile through shared memory (stride TILE + 1: the mirrored
  // pass reads a column without bank conflicts), then coalesced atomics
  int32_t(*part)[TILE + 1] = reinterpret_cast<int32_t(*)[TILE + 1]>(&stage[0][0][0]);
  static_assert(TILE * (TILE + 1) <= 2 * KW * (TILE + PAD), "partial tile fits");
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[8 * ty + i][4 * tx + j] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE;
    const int c = e % TILE;
    const int32_t v = part[r][c];
    if (v != 0 && m0 + r < M && n0 + c < N)
      atomicAdd(out + (m0 + r) * N + n0 + c, v);
    if (same && !one_tile) {  // the mirror: out[n0 + r][m0 + c] = part[c][r]
      const int32_t t = part[c][r];
      if (t != 0 && n0 + r < N && m0 + c < M)
        atomicAdd(out + (n0 + r) * N + m0 + c, t);
    }
  }
}

}  // namespace

// Launch `tiles` x `slices` blocks: output tiles (tiles_n per tile row, or
// with `same` the tiles tn >= tm in the order the kernel decodes), each
// split into `slices` <= W word slices. `out` must be zeroed.
extern "C" int bitpair_launch(const void* a, const void* b, int64_t M,
                              int64_t N, int64_t W, void* out, int same,
                              int64_t tiles, int64_t tiles_n, int64_t slices,
                              void* stream) {
  if (M <= 0 || N <= 0 || W <= 0) return (int)cudaSuccess;
  if (slices < 1 || slices > W || slices > 65535 || tiles < 1 ||
      tiles >= (1ll << 31))
    return (int)cudaErrorInvalidValue;  // every slice must hold a word
  const dim3 grid((unsigned)tiles, (unsigned)slices);
  bitpair_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, M, N, W, (int32_t*)out, same,
      tiles_n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
