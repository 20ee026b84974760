// topk_gather: score a padded (B, L) candidate tile and select each row's
// top k, lowest column first among equal scores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_gather.py
// (`_topk_gather`, body `_topk_gather_kernel`): score the tile, then k
// unrolled rounds of masked row-max with `lax.top_k`'s tie rule.
//
// Scores, op for op as the reference scorer (store/query.py `_score_topk`):
//   count: int32 c, 0 in padding slots;
//   pmi:   logf((c * D) / (df_t * df_n)) in float32, -inf in padding slots;
//   dice:  2c / (df_t + df_n) with the add in int32, -inf in padding slots.
// Built without fast math: `logf` and `/` are the accurate versions, so the
// scores match the plain PyTorch version on the card bit for bit.
//
// Bound on this card: bytes. The tile is read once (12 B L + 4 B bytes) and
// the (B, k) ids and scores written once (8 B k) over 3.35 TB/s. Design: one
// block of 256 threads per row. A scoring pass writes the row's scores into a
// scratch row with an explicit per-slot "retired" flag; then k rounds of a
// block-wide argmax over the slots not yet retired (a strided scan per
// thread, warp shuffles, one shared-memory step across warps) retire one
// winner each. The flag reproduces the reference's `alive` mask: writing a
// fill value over a retired slot instead would break the tie order among the
// -inf padding slots. k is a runtime argument, so the kernel is O(k L) per
// row: right at serving k, slow at k in the thousands. The scratch row stays
// in L2 between rounds for L up to a few hundred thousand; a radix select
// that keeps the tie rule is the next step.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Score { kCount = 0, kPmi = 1, kDice = 2 };

template <int SCORE>
struct ScoreOf {
  using T = float;
  __device__ static T lowest() { return -INFINITY; }
};
template <>
struct ScoreOf<kCount> {
  using T = int32_t;
  __device__ static T lowest() { return INT_MIN; }
};

template <int SCORE>
__device__ __forceinline__ typename ScoreOf<SCORE>::T score_slot(
    int32_t id, int32_t c, int32_t dft, int32_t dfn, float num_docs) {
  if constexpr (SCORE == kCount) {
    return id >= 0 ? c : 0;
  } else {
    float s;
    if constexpr (SCORE == kPmi) {
      s = logf(((float)c * num_docs) / ((float)dft * (float)dfn));
    } else {
      s = 2.0f * (float)c / (float)(dft + dfn);
    }
    return id >= 0 ? s : -INFINITY;
  }
}

// (s, col) beats (bs, bc): a larger score, or an equal one at a lower column
template <typename T>
__device__ __forceinline__ bool beats(T s, int col, T bs, int bc) {
  return s > bs || (s == bs && col < bc);
}

template <int SCORE>
__global__ void __launch_bounds__(kThreads)
    topk_gather_kernel(const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ cnts,
                       const int32_t* __restrict__ df_t,
                       const int32_t* __restrict__ df_n, int32_t L, int32_t k,
                       float num_docs, typename ScoreOf<SCORE>::T* scratch,
                       uint8_t* retired, int32_t* __restrict__ out_ids,
                       typename ScoreOf<SCORE>::T* __restrict__ out_s) {
  using T = typename ScoreOf<SCORE>::T;
  const int64_t row = (int64_t)blockIdx.x * L;
  ids += row;
  cnts += row;
  df_n += row;
  scratch += row;
  retired += row;
  out_ids += (int64_t)blockIdx.x * k;
  out_s += (int64_t)blockIdx.x * k;
  const int32_t dft = df_t[blockIdx.x];

  for (int j = threadIdx.x; j < L; j += kThreads) {
    scratch[j] = score_slot<SCORE>(ids[j], cnts[j], dft, df_n[j], num_docs);
    retired[j] = 0;
  }
  __syncthreads();

  __shared__ T warp_s[kWarps];
  __shared__ int warp_c[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int round = 0; round < k; ++round) {
    T bs = ScoreOf<SCORE>::lowest();
    int bc = INT_MAX;
    for (int j = threadIdx.x; j < L; j += kThreads) {
      if (retired[j]) continue;
      const T s = scratch[j];
      if (beats(s, j, bs, bc)) {
        bs = s;
        bc = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oc = __shfl_down_sync(0xffffffffu, bc, off);
      if (beats(os, oc, bs, bc)) {
        bs = os;
        bc = oc;
      }
    }
    if (lane == 0) {
      warp_s[warp] = bs;
      warp_c[warp] = bc;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < kWarps ? warp_s[lane] : ScoreOf<SCORE>::lowest();
      bc = lane < kWarps ? warp_c[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const T os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oc = __shfl_down_sync(0xffffffffu, bc, off);
        if (beats(os, oc, bs, bc)) {
          bs = os;
          bc = oc;
        }
      }
      if (lane == 0) {
        // k <= L and each round retires one slot, so a winner always exists
        out_ids[round] = ids[bc];
        out_s[round] = bs;
        retired[bc] = 1;
      }
    }
    __syncthreads();
  }
}

template <int SCORE>
cudaError_t launch(const void* ids, const void* cnts, const void* df_t,
                   const void* df_n, int32_t B, int32_t L, int32_t k,
                   float num_docs, void* scratch, void* retired, void* out_ids,
                   void* out_s, cudaStream_t stream) {
  using T = typename ScoreOf<SCORE>::T;
  topk_gather_kernel<SCORE><<<B, kThreads, 0, stream>>>(
      (const int32_t*)ids, (const int32_t*)cnts, (const int32_t*)df_t,
      (const int32_t*)df_n, L, k, num_docs, (T*)scratch, (uint8_t*)retired,
      (int32_t*)out_ids, (T*)out_s);
  return cudaGetLastError();
}

}  // namespace

// score: 0 count, 1 pmi, 2 dice. Returns a cudaError_t (0 on success).
extern "C" int topk_gather_launch(const void* ids, const void* cnts,
                                  const void* df_t, const void* df_n,
                                  int32_t B, int32_t L, int32_t k,
                                  int32_t score, float num_docs, void* scratch,
                                  void* retired, void* out_ids, void* out_s,
                                  void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (k < 1 || k > L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (score) {
    case kCount:
      return (int)launch<kCount>(ids, cnts, df_t, df_n, B, L, k, num_docs,
                                 scratch, retired, out_ids, out_s, s);
    case kPmi:
      return (int)launch<kPmi>(ids, cnts, df_t, df_n, B, L, k, num_docs,
                               scratch, retired, out_ids, out_s, s);
    case kDice:
      return (int)launch<kDice>(ids, cnts, df_t, df_n, B, L, k, num_docs,
                                scratch, retired, out_ids, out_s, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
