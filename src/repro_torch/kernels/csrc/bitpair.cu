// bitpair: posting-list intersection sizes over bit-packed bitmaps, as
// AND plus population count.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitpair.py
// (`bitpair_kernel`, body `_bitpair_kernel`), which forms the whole
// (blk_m, blk_n, blk_w) AND intermediate on the VPU and reduces it into a
// VMEM-resident int32 tile over a sequential word grid axis.
//
// Computes out[m, n] = sum_w popcount(a[m, w] & b[n, w]) for 32-bit words
// a (M, W) and b (N, W), row-major (one term's bitmap per row, bit d of
// word w set iff the term occurs in document 32 w + d), into int32
// out (M, N): exact below 2^31 set bits per pair. Every output element is
// written, so the caller need not zero `out`.
//
// Bound on this card: operations. Each word pair costs one AND, one
// `__popc` and one add, and `__popc` issues at a quarter of the int32 rate,
// about 16 a clock per SM: M N W / (132 x 16 x clock) against the bytes
// 4 (M W + N W + M N) / 3.35 TB/s, and for a 256 x 256 block of
// LIST-PAIRS at W = 625 the popcounts take twenty times longer than the
// bytes. Design: one block of 256 threads owns a 64 x 64 output tile and
// walks W in stages of 32 words. A stage of both operands is staged in
// shared memory word-major (rows padded by 4 words so that staging stores
// spread over the banks), each thread keeps a 4 x 4 block of int32 sums in
// registers and reads its 4 rows and 4 columns as one 16-byte shared load
// each per word, so the inner loop is 16 AND + popcount + add per two
// shared loads. Ragged M, N and W are masked while staging and writing.
// When a and b are one tensor (the diagonal blocks of LIST-PAIRS) a
// diagonal block stages its rows once. Cutting popcounts (the lower
// triangle of diagonal blocks, skipping all-zero words) is the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // output tile edge (terms)
constexpr int KW = 32;        // words per stage
constexpr int PAD = 4;        // row padding, in words (keeps 16-byte rows)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// Stage words [w0, w0 + KW) of rows [r0, r0 + TILE) of the (rows, W)
// matrix src into dst[w][m], 0 outside the matrix. Neighbouring threads
// read neighbouring words of one row.
__device__ __forceinline__ void stage_rows(const uint32_t* __restrict__ src,
                                           int64_t rows, int64_t W,
                                           int64_t r0, int64_t w0,
                                           uint32_t (*dst)[TILE + PAD]) {
  for (int e = threadIdx.x; e < KW * TILE; e += THREADS) {
    const int w = e % KW;
    const int m = e / KW;
    const int64_t r = r0 + m;
    const int64_t col = w0 + w;
    dst[w][m] = (r < rows && col < W) ? src[r * W + col] : 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
bitpair_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int64_t M, int64_t N, int64_t W, int32_t* __restrict__ out,
               int same) {
  __shared__ __align__(16) uint32_t sa[KW][TILE + PAD];
  __shared__ __align__(16) uint32_t sb[KW][TILE + PAD];
  const int64_t m0 = (int64_t)blockIdx.y * TILE;
  const int64_t n0 = (int64_t)blockIdx.x * TILE;
  const bool one_tile = same && m0 == n0;
  const int tx = threadIdx.x % 16;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / 16;  // rows 4 ty .. 4 ty + 3
  int32_t acc[4][4] = {};

  for (int64_t w0 = 0; w0 < W; w0 += KW) {
    stage_rows(a, M, W, m0, w0, sa);
    if (!one_tile) stage_rows(b, N, W, n0, w0, sb);
    __syncthreads();
    const uint32_t(*tb)[TILE + PAD] = one_tile ? sa : sb;
#pragma unroll 4
    for (int q = 0; q < KW; ++q) {
      const uint4 av = *reinterpret_cast<const uint4*>(&sa[q][4 * ty]);
      const uint4 bv = *reinterpret_cast<const uint4*>(&tb[q][4 * tx]);
      const uint32_t ar[4] = {av.x, av.y, av.z, av.w};
      const uint32_t br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(ar[i] & br[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + 4 * tx + j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int bitpair_launch(const void* a, const void* b, int64_t M,
                              int64_t N, int64_t W, void* out, int same,
                              void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((N + TILE - 1) / TILE),
                  (unsigned)((M + TILE - 1) / TILE));
  bitpair_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, M, N, W, (int32_t*)out, same);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
