// cooc_gram: the exact co-occurrence Gram C = b_i^T b_j over 0/1 incidence
// tiles, in integers, on the tensor cores.
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
// Bound on this card: for the square tiles (D <= 2048, M, N <= 1024) the
// u8 tensor-core rate (2 M N D operations at 1,979 TOP/s) and the bytes
// (inputs read once, the int32 output written once, at 3.35 TB/s) are
// within a factor of 1.3 of each other; the skinny MULTI-SCAN product
// (M = 128, N = V) is bound by bytes.
//
// Design: `wgmma.mma_async` m64n128k32 with u8 operands and s32
// accumulators (exact for 0/1; the first product of a block ignores the
// accumulators instead of zeroing them, so no ordinary instruction writes
// them while products are in flight). A block owns a (64 WG) x 128 output
// tile, one warpgroup of 128 threads per 64 rows (WG = 2 when that still
// gives a block to every SM, and for M <= 128, so that b is streamed once;
// else WG = 1, so a 1024 x 1024 output is 128 blocks), and walks D in
// stages of 128 documents. wgmma takes 8-bit operands only K-major
// (documents contiguous per term), but the tiles are document-major and TMA
// does not transpose bytes. So a stage is copied raw with 16-byte
// `cp.async` (zero-filled past D) into a ring of four stages, then
// transposed by the block's threads, 16 documents x 4 terms at a time with
// byte permutes, into the K-major core-matrix layout (8 terms x 16
// documents per 128-byte core matrix, no swizzle) that the descriptors
// describe, double-buffered: the transpose of stage s+1 and the copies of
// the stages after it run while the tensor cores multiply stage s. Widths
// that are not multiples of 16 bytes are copied a byte at a time instead.
// When a and b are one tensor and a block's rows lie inside its columns
// (diagonal tiles of LIST-BLOCKS, the FREQ-SPLIT head) the A operand is
// read from the staged B tile. Ragged D, M and N are masked in the kernel,
// never padded by the host; D = 0 writes zeros without a product.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KD = 128;   // documents per stage (four k32 products)
constexpr int BN = 128;   // output columns per block (the wgmma's n)
constexpr int NRAW = 4;   // raw stages in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// byte offset between core matrices adjacent along K (leading) and along
// M/N (stride), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

#define ACC8(i)                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128, s32, in the warpgroup's registers) = A (64 x 32) B^T + (acc ?
// d : 0), both u8 and K-major in shared memory
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Copy documents [d0, d0 + KD) of terms [col0, col0 + width_tile) of the
// (D, width) matrix src into dst (KD rows of width_tile bytes), zero outside
// the matrix. VEC: 16-byte cp.async (width and src 16-byte aligned);
// otherwise byte loads.
template <bool VEC, int TW, int NT>
__device__ __forceinline__ void load_raw(const uint8_t* __restrict__ src,
                                         int64_t D, int64_t width, int64_t d0,
                                         int64_t col0, uint8_t* dst) {
  if constexpr (VEC) {
    constexpr int CH = TW / 16;
    for (int c = threadIdx.x; c < KD * CH; c += NT) {
      const int r = c / CH, ch = c % CH;
      const int64_t d = d0 + r, col = col0 + 16 * ch;
      const bool valid = d < D && col < width;
      cp_async16(dst + r * TW + 16 * ch, valid ? src + d * width + col : src,
                 valid);
    }
  } else {
    for (int e = threadIdx.x; e < KD * TW; e += NT) {
      const int r = e / TW, m = e % TW;
      const int64_t d = d0 + r, col = col0 + m;
      dst[e] = (d < D && col < width) ? src[d * width + col] : (uint8_t)0;
    }
  }
}

// raw (KD x R bytes, document-major) -> K-major core matrices: the 16
// documents [16 g, 16 g + 16) of term r are the 16 bytes at
// g R 16 + r 16. Job j transposes documents 16 g.. of terms 4 mc..4 mc + 3.
template <int R>
__device__ __forceinline__ void transpose_job(const uint8_t* raw, uint8_t* km,
                                              int job) {
  constexpr int MC = R / 4;
  const int g = job / MC, mc = job % MC;
  const uint8_t* src = raw + 16 * g * R + 4 * mc;
  uint32_t o[4][4];  // o[j][q]: term 4 mc + j, documents 16 g + 4 q ..
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src + (4 * q + 0) * R);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + (4 * q + 1) * R);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + (4 * q + 2) * R);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + (4 * q + 3) * R);
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
    const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
    o[0][q] = __byte_perm(t0, t1, 0x5410);
    o[1][q] = __byte_perm(t0, t1, 0x7632);
    o[2][q] = __byte_perm(t2, t3, 0x5410);
    o[3][q] = __byte_perm(t2, t3, 0x7632);
  }
  uint8_t* dst = km + g * R * 16 + 4 * mc * 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(dst + 16 * j) =
        make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
}

template <int WG, bool VEC>
__global__ void __launch_bounds__(128 * WG)
    cooc_gram_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ b, int64_t D, int64_t M,
                     int64_t N, int32_t* __restrict__ out, int same) {
  constexpr int BM = 64 * WG;
  constexpr int NT = 128 * WG;
  constexpr int RAW_A = KD * BM, RAW = KD * (BM + BN);
  constexpr int KM_A = KD * BM, KM = KD * (BM + BN);
  constexpr int JOBS_A = (KD / 16) * (BM / 4), JOBS_B = (KD / 16) * (BN / 4);
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* raw = smem;              // NRAW x [a: KD x BM | b: KD x BN]
  uint8_t* km = smem + NRAW * RAW;  // 2 x [a K-major | b K-major]

  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  // a == b and rows [m0, m0 + BM) inside columns [n0, n0 + BN): read the A
  // operand from the B tile
  const bool share = same && m0 >= n0 && m0 + BM <= n0 + BN;
  const int64_t stages = (D + KD - 1) / KD;
  const int wg = threadIdx.x / 128;

  auto load = [&](int64_t s) {
    if (s < stages) {
      uint8_t* r = raw + (s % NRAW) * RAW;
      if (!share) load_raw<VEC, BM, NT>(a, D, M, s * KD, m0, r);
      load_raw<VEC, BN, NT>(b, D, N, s * KD, n0, r + RAW_A);
    }
    if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::);
  };

  int32_t d[64];  // set by the first product (D >= 1), which ignores it

#pragma unroll
  for (int s = 0; s < NRAW - 1; ++s) load(s);

  for (int64_t s = 0; s < stages; ++s) {
    load(s + NRAW - 1);
    if constexpr (VEC) asm volatile("cp.async.wait_group %0;\n" ::"n"(NRAW - 1));
    __syncthreads();  // stage s is in raw; stage s - 2's products are done
    const uint8_t* r = raw + (s % NRAW) * RAW;
    uint8_t* k = km + (s & 1) * KM;
    for (int j = threadIdx.x; j < JOBS_A + JOBS_B; j += NT) {
      if (j < JOBS_A) {
        if (!share) transpose_job<BM>(r, k, j);
      } else {
        transpose_job<BN>(r + RAW_A, k + KM_A, j - JOBS_A);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage s is K-major, visible to the tensor cores

    const uint8_t* kb = k + KM_A;
    const uint8_t* ka = share ? kb + (m0 - n0 + 64 * wg) * 16 : k + 64 * wg * 16;
    const uint32_t lbo_a = (share ? BN : BM) * 16;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < KD / 32; ++t)
      wgmma_u8(d, make_desc(ka + 2 * t * lbo_a, lbo_a, 128),
               make_desc(kb + 2 * t * BN * 16, BN * 16, 128), s > 0 || t > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  // accumulator layout: warp w of the warpgroup holds rows 16 w + lane / 4
  // and that + 8; register 4 j + {0, 1} columns 8 j + 2 (lane % 4) + {0, 1}
  // of the first row, 4 j + {2, 3} of the second
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int64_t r0 = m0 + 64 * wg + 16 * w + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t c = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t rr = r0 + 8 * h;
      if (rr >= M) continue;
      int32_t* o = out + rr * N + c;
      if (c + 1 < N && N % 2 == 0) {
        *reinterpret_cast<int2*>(o) = make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      } else {
        if (c < N) o[0] = d[4 * j + 2 * h];
        if (c + 1 < N) o[1] = d[4 * j + 2 * h + 1];
      }
    }
  }
}

template <int WG, bool VEC>
cudaError_t launch(const void* a, const void* b, int64_t D, int64_t M,
                   int64_t N, void* out, int same, cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  constexpr int smem = NRAW * KD * (BM + BN) + 2 * KD * (BM + BN);
  auto kern = cooc_gram_kernel<WG, VEC>;
  // once per instantiation: its shared memory does not depend on the call
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  kern<<<grid, 128 * WG, smem, stream>>>((const uint8_t*)a, (const uint8_t*)b,
                                         D, M, N, (int32_t*)out, same);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace

extern "C" int cooc_gram_launch(const void* a, const void* b, int64_t D,
                                int64_t M, int64_t N, void* out, int same,
                                void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (D <= 0)  // no document: every count is 0, and there is no product
    return (int)cudaMemsetAsync(out, 0, (size_t)(M * N) * 4, (cudaStream_t)stream);
  if ((M + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = M % 16 == 0 && N % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(b) % 16) == 0;
  const int64_t blocks2 = ((M + 127) / 128) * ((N + BN - 1) / BN);
  const bool wide = M > 64 && (M <= 128 || blocks2 >= sm_count());
  if (wide)
    return (int)(vec ? launch<2, true>(a, b, D, M, N, out, same, s)
                     : launch<2, false>(a, b, D, M, N, out, same, s));
  return (int)(vec ? launch<1, true>(a, b, D, M, N, out, same, s)
                   : launch<1, false>(a, b, D, M, N, out, same, s));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
