// cooc_gram: the exact co-occurrence Gram C = b_i^T b_j over 0/1 incidence
// tiles, in integers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cooc_gram.py
// (`cooc_gram_kernel`, body `_gram_kernel`), which runs the product on the
// MXU in float32 with the (blk_m, blk_n) output tile resident in VMEM over a
// sequential contraction grid axis, and is exact only below 2^24 documents
// per call.
//
// Computes out[m, n] = sum_d a[d, m] * b[d, n] for uint8 a (D, M) and
// b (D, N), both row-major (document-major, the layout the host tile
// builder writes), into int32 out (M, N): exact below 2^31 documents.
// Every output element is written, so the caller need not zero `out`.
//
// Bound on this card: for the tiles the counting methods stream (D <= 2048,
// M, N <= 1024) the inputs and the output are a few MB, so the bound is
// the int8 tensor-core rate (2 M N D operations at 1,979 TOP/s) about as
// much as bytes. This kernel does not reach for it: it runs on the integer
// pipes, 4 multiply-adds per `__dp4a`, far below the tensor cores. Design:
// one block of 256 threads owns a 64 x 64 output tile and walks D in
// stages of 64 documents. A stage is staged in shared memory transposed
// and packed, so that one 32-bit word holds 4 documents of one term; each
// thread then keeps a 4 x 4 block of int32 sums in registers and reads its
// 4 rows and 4 columns as one 16-byte shared load each per word. Ragged D,
// M and N are masked while staging and writing, never padded by the host.
// When a and b are one tensor (the diagonal tiles of LIST-BLOCKS, the
// FREQ-SPLIT head) a diagonal block stages its tile once. Tensor cores
// (`wgmma` on int8), TMA and a pipelined ring of stages are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;       // output tile edge (terms)
constexpr int KD = 64;         // documents per stage
constexpr int KW = KD / 4;     // packed words per term per stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

// Stage documents [d0, d0 + KD) of terms [col0, col0 + TILE) of the
// (D, width) matrix src into dst[q][m]: byte b of dst[q][m] is
// src[d0 + 4q + b, col0 + m], 0 outside the matrix. Neighbouring threads
// read neighbouring terms of one document row.
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ src,
                                           int64_t D, int64_t width,
                                           int64_t d0, int64_t col0,
                                           uint32_t (*dst)[TILE]) {
  for (int e = threadIdx.x; e < KW * TILE; e += THREADS) {
    const int q = e / TILE;
    const int m = e % TILE;
    const int64_t col = col0 + m;
    uint32_t word = 0;
    if (col < width) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t d = d0 + 4 * q + b;
        if (d < D) word |= (uint32_t)src[d * width + col] << (8 * b);
      }
    }
    dst[q][m] = word;
  }
}

__global__ void __launch_bounds__(THREADS)
cooc_gram_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 int64_t D, int64_t M, int64_t N, int32_t* __restrict__ out,
                 int same) {
  __shared__ __align__(16) uint32_t sa[KW][TILE];
  __shared__ __align__(16) uint32_t sb[KW][TILE];
  const int64_t m0 = (int64_t)blockIdx.y * TILE;
  const int64_t n0 = (int64_t)blockIdx.x * TILE;
  const bool one_tile = same && m0 == n0;
  const int tx = threadIdx.x % 16;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / 16;  // rows 4 ty .. 4 ty + 3
  unsigned acc[4][4] = {};

  for (int64_t d0 = 0; d0 < D; d0 += KD) {
    stage_tile(a, D, M, d0, m0, sa);
    if (!one_tile) stage_tile(b, D, N, d0, n0, sb);
    __syncthreads();
    const uint32_t(*tb)[TILE] = one_tile ? sa : sb;
#pragma unroll 4
    for (int q = 0; q < KW; ++q) {
      const uint4 av = *reinterpret_cast<const uint4*>(&sa[q][4 * ty]);
      const uint4 bv = *reinterpret_cast<const uint4*>(&tb[q][4 * tx]);
      const unsigned ar[4] = {av.x, av.y, av.z, av.w};
      const unsigned br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
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
      if (n < N) out[m * N + n] = (int32_t)acc[i][j];
    }
  }
}

}  // namespace

extern "C" int cooc_gram_launch(const void* a, const void* b, int64_t D,
                                int64_t M, int64_t N, void* out, int same,
                                void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((N + TILE - 1) / TILE),
                  (unsigned)((M + TILE - 1) / TILE));
  cooc_gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, D, M, N, (int32_t*)out, same);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
