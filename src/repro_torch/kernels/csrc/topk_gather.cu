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
// Bound on this card: bytes. The tile is read once (12 B L + 4 B per row)
// and the (B, k) ids and scores written once (8 B k) over 3.35 TB/s.
//
// Design: one pass over the tile, a radix select, the row split over a
// thread-block cluster of C <= 8 blocks (C = ceil(L / 8192), so B = 64 rows
// of L = 65,536 are 512 blocks, one wave on 132 SMs). Each block scores its
// slice of S slots once, from device memory, into a 32-bit order key per
// slot kept in shared memory: the score mapped so that unsigned order is
// score order, with -0.0 and +0.0 one key (`order_key`, the same map as
// ref.order_key).
//   1. Select: four passes of 8 bits find T, the k-th largest key of the
//      row. Each pass counts the keys that match the digits chosen so far
//      into one 256-bin histogram per warp (shared-memory atomics; per-warp
//      copies keep skewed rows, where most keys share a digit, from queueing
//      on one counter), sums them per block, and the cluster's blocks sum
//      each other's block histograms through distributed shared memory and
//      all pick the same digit. The cost does not depend on k.
//   2. Take: every slot with key > T, and the first slots with key == T in
//      column order until k are taken. The last pass's histograms already
//      hold each slice's count of keys == T, so a block knows the ties of
//      the slices before it; only the slice in which the ties run out ranks
//      its own in column order (warp ballots).
//   3. Order: a winner is the unique 64-bit value (~key << 32 | column);
//      ascending order of these is score descending, lowest column first.
//      Each block sorts its own winners (a bitonic sort in shared memory;
//      steps of stride <= 32 stay within a warp and wait only for it). A
//      winner's place in the output is its index in its block's list plus,
//      for every other block of the cluster, a binary search of that
//      block's sorted list (copied locally where it fits). Ids and scores
//      are written at those places.
// Rows of any L are masked in the kernel. Where a slice is too long for
// shared memory the keys are recomputed from the tile at each pass instead
// of kept; where a block's winner list is too long for shared memory it
// lives in a scratch buffer of B C W 8-byte entries that the wrapper
// allocates (W: the list's capacity, a power of two >= min(k, S)). The
// wrapper (kernels/topk_gather.py `plan`) picks C, S, W and where each
// array lives, and holds the limits that decide it; each placement is its
// own instantiation.

#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Score { kCount = 0, kPmi = 1, kDice = 2 };
enum Flag { kKeysInSmem = 1, kListInSmem = 2 };

template <int SCORE>
struct ScoreOf {
  using T = float;
};
template <>
struct ScoreOf<kCount> {
  using T = int32_t;
};

template <int SCORE>
__device__ __forceinline__ typename ScoreOf<SCORE>::T score_slot(
    int32_t id, int32_t c, int32_t dft, int32_t dfn, float num_docs) {
  if constexpr (SCORE == kCount) {
    return id >= 0 ? c : 0;
  } else {
    if (id < 0) return -INFINITY;  // padding: skip the division and log
    if constexpr (SCORE == kPmi) {
      return logf(((float)c * num_docs) / ((float)dft * (float)dfn));
    } else {
      return 2.0f * (float)c / (float)(dft + dfn);
    }
  }
}

// unsigned order of the key == order of the score; -0.0 and +0.0 share a
// key, and every NaN takes the largest key (torch.sort's place for NaN)
__device__ __forceinline__ uint32_t order_key(int32_t s) {
  return (uint32_t)s ^ 0x80000000u;
}
__device__ __forceinline__ uint32_t order_key(float s) {
  if (s != s) return 0xffffffffu;
  uint32_t b = __float_as_uint(s);
  if ((b & 0x7fffffffu) == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ void from_key(uint32_t k, int32_t* s) {
  *s = (int32_t)(k ^ 0x80000000u);
}
__device__ __forceinline__ void from_key(uint32_t k, float* s) {
  *s = __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// #{i < n : list[i] < x}, list ascending
__device__ __forceinline__ int lower_bound(const uint64_t* list, int n,
                                           uint64_t x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (list[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <int SCORE, int FLAGS>
__global__ void __launch_bounds__(kThreads)
    topk_gather_kernel(const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ cnts,
                       const int32_t* __restrict__ df_t,
                       const int32_t* __restrict__ df_n, int32_t L, int32_t k,
                       float num_docs, int32_t S, int32_t W, int vec,
                       uint64_t* scratch, int32_t* __restrict__ out_ids,
                       typename ScoreOf<SCORE>::T* __restrict__ out_s) {
  using T = typename ScoreOf<SCORE>::T;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  __shared__ uint32_t hist[2][kBins];
  __shared__ uint32_t whist[kWarps][kBins];
  __shared__ uint32_t total[kBins];
  __shared__ uint32_t warp_eq[kWarps];
  __shared__ uint32_t s_digit, s_krem, s_nlist;
  __shared__ uint32_t s_nlists[kMaxCluster];
  extern __shared__ __align__(16) unsigned char dyn[];

  constexpr bool keys_smem = FLAGS & kKeysInSmem;
  constexpr bool list_smem = FLAGS & kListInSmem;
  uint32_t* skeys = reinterpret_cast<uint32_t*>(dyn);
  const size_t key_bytes = keys_smem ? (((size_t)S * 4 + 15) & ~(size_t)15) : 0;
  uint64_t* list = list_smem
                       ? reinterpret_cast<uint64_t*>(dyn + key_bytes)
                       : scratch + (row * C + rank) * (int64_t)W;

  const int64_t base = row * L;
  const int lo = rank * S;
  const int n = max(0, min(S, L - lo));  // this block's slots
  const int32_t dft = df_t[row];
  const int32_t* ids_s = ids + base + lo;
  const int32_t* cnts_s = cnts + base + lo;
  const int32_t* dfn_s = df_n + base + lo;

  auto key_of_slot = [&](int i) -> uint32_t {
    return order_key(score_slot<SCORE>(ids_s[i], cnts_s[i], dft, dfn_s[i],
                                       num_docs));
  };
  auto key_at = [&](int i) -> uint32_t {
    return keys_smem ? skeys[i] : key_of_slot(i);
  };

  // ---- score the slice once: 12 B a slot from device memory -------------
  if (keys_smem) {
    if (vec) {  // n and the slice's start are multiples of 4 slots
      for (int q = tid; q < n / 4; q += kThreads) {
        const int4 vi = reinterpret_cast<const int4*>(ids_s)[q];
        const int4 vc = reinterpret_cast<const int4*>(cnts_s)[q];
        const int4 vd = reinterpret_cast<const int4*>(dfn_s)[q];
        uint4 kq;
        kq.x = order_key(score_slot<SCORE>(vi.x, vc.x, dft, vd.x, num_docs));
        kq.y = order_key(score_slot<SCORE>(vi.y, vc.y, dft, vd.y, num_docs));
        kq.z = order_key(score_slot<SCORE>(vi.z, vc.z, dft, vd.z, num_docs));
        kq.w = order_key(score_slot<SCORE>(vi.w, vc.w, dft, vd.w, num_docs));
        reinterpret_cast<uint4*>(skeys)[q] = kq;
      }
    } else {
      for (int i = tid; i < n; i += kThreads) skeys[i] = key_of_slot(i);
    }
  }

  // ---- 1. radix select of the k-th largest key over the cluster ---------
  uint32_t prefix = 0, krem = (uint32_t)k;
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    uint32_t* h = hist[pass & 1];
    for (int w = 0; w < kWarps; ++w) whist[w][tid] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      uint32_t key = 0;
      bool take = false;
      if (i < n) {
        key = key_at(i);
        take = (key & hi_mask) == prefix;
      }
      if (take) atomicAdd(&whist[warp][(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    {
      uint32_t t = 0;
      for (int w = 0; w < kWarps; ++w) t += whist[w][tid];
      h[tid] = t;
    }
    cluster.sync();  // every block's histogram of this pass is complete
    uint32_t sum = 0;
    for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(h, r)[tid];
    total[tid] = sum;
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 255 - 8l down to 248 - 8l (descending digits)
      uint32_t own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) own += total[255 - 8 * lane - j];
      uint32_t incl = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      uint32_t above = incl - own;
      if (above < krem && krem <= incl) {
        for (int j = 0; j < 8; ++j) {
          const int d = 255 - 8 * lane - j;
          if (krem <= above + total[d]) {
            s_digit = (uint32_t)d;
            s_krem = krem - above;
            break;
          }
          above += total[d];
        }
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    krem = s_krem;
  }
  const uint32_t T_key = prefix;  // the k-th largest key of the row
  const uint32_t need_eq = krem;  // slots with key == T_key to take

  // ---- 2. take the winners, ties in column order across the cluster -----
  // The last pass's histograms count each slice's keys == T_key in bin
  // T_key & 0xff, so the ties before this slice are the lower ranks' counts.
  const uint32_t* last = hist[1];  // pass 3's
  const uint32_t d_last = T_key & 0xffu;
  uint32_t eq_base = 0;
  for (int r = 0; r < rank; ++r)
    eq_base += cluster.map_shared_rank(last, r)[d_last];
  const uint32_t eq_here = last[d_last];
  // only the slice where the ties run out needs their column order
  const bool cut = eq_base < need_eq && need_eq < eq_base + eq_here;
  const bool all_eq = eq_base + eq_here <= need_eq;
  const int chunk = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int w_lo = min(n, warp * chunk);
  const int w_hi = min(n, w_lo + chunk);
  if (cut) {
    uint32_t eq = 0;
    for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
      const int i = i0 + lane;
      eq += __popc(__ballot_sync(kFull, i < w_hi && key_at(i) == T_key));
    }
    if (lane == 0) warp_eq[warp] = eq;
  }
  if (tid == 0) s_nlist = 0;
  __syncthreads();
  if (cut)
    for (int w = 0; w < warp; ++w) eq_base += warp_eq[w];
  for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
    const int i = i0 + lane;
    uint32_t key = 0;
    if (i < w_hi) key = key_at(i);
    const bool gt = i < w_hi && key > T_key;
    const bool eq = i < w_hi && key == T_key;
    bool take = gt || (eq && all_eq);
    if (cut) {
      const unsigned eq_mask = __ballot_sync(kFull, eq);
      take = take || (eq && eq_base + __popc(eq_mask & lt_mask) < need_eq);
      eq_base += __popc(eq_mask);
    }
    const unsigned take_mask = __ballot_sync(kFull, take);
    uint32_t pos = 0;
    if (lane == 0 && take_mask)
      pos = atomicAdd(&s_nlist, (uint32_t)__popc(take_mask));
    pos = __shfl_sync(kFull, pos, 0);
    if (take)
      list[pos + __popc(take_mask & lt_mask)] =
          ((uint64_t)(~key) << 32) | (uint32_t)(lo + i);
  }
  __syncthreads();

  // ---- 3. order the winners: (~key << 32 | column) ascending -----------
  const int nl = (int)s_nlist;  // <= min(k, n) <= W
  const int64_t out_row = row * k;
  auto emit = [&](uint64_t x, int pos) {
    T s;
    from_key(~(uint32_t)(x >> 32), &s);
    out_ids[out_row + pos] = ids[base + (int32_t)(uint32_t)x];
    out_s[out_row + pos] = s;
  };
  int P = 1;
  while (P < nl) P <<= 1;
  for (int i = nl + tid; i < P; i += kThreads) list[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t a = list[i], b = list[j];
        if ((a > b) == ((i & size) == 0)) {
          list[i] = b;
          list[j] = a;
        }
      }
      // a step of stride <= 32 keeps to each warp's own 64 entries: when
      // this one and the next do, the warp need not wait for the block
      const int next = stride > 1 ? stride >> 1 : size;
      if (stride > 32 || next > 32) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  cluster.sync();  // every block's list is sorted
  if (tid < C) s_nlists[tid] = *cluster.map_shared_rank(&s_nlist, tid);
  __syncthreads();
  // the keys are spent: where the other blocks' lists fit in their
  // place, copy them there once, so that the searches read local memory
  uint32_t total_other = 0;
  for (int r = 0; r < C; ++r) total_other += r == rank ? 0 : s_nlists[r];
  const bool local = keys_smem && list_smem && total_other * 8 <= key_bytes;
  uint64_t* copies = reinterpret_cast<uint64_t*>(dyn);
  if (local) {
    uint32_t off = 0;
    for (int r = 0; r < C; ++r) {
      if (r == rank) continue;
      const uint64_t* other = cluster.map_shared_rank(list, r);
      for (int i = tid; i < (int)s_nlists[r]; i += kThreads)
        copies[off + i] = other[i];
      off += s_nlists[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < nl; i += kThreads) {
    const uint64_t x = list[i];
    int pos = i;
    uint32_t off = 0;
    for (int r = 0; r < C; ++r) {
      if (r == rank || s_nlists[r] == 0) continue;
      const uint64_t* other =
          local       ? copies + off
          : list_smem ? cluster.map_shared_rank(list, r)
                      : scratch + (row * C + r) * (int64_t)W;
      pos += lower_bound(other, (int)s_nlists[r], x);
      off += s_nlists[r];
    }
    emit(x, pos);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Lifts one instantiation's dynamic shared-memory limit to what the card
// allows a block, once per process: a launch that asks for more than that
// then fails on its own.
template <int SCORE, int FLAGS>
cudaError_t allow_smem() {
  static const cudaError_t e = [] {
    auto kern = topk_gather_kernel<SCORE, FLAGS>;
    int dev = 0, most = 0;
    cudaFuncAttributes fa;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess)
      r = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (r == cudaSuccess) r = cudaFuncGetAttributes(&fa, kern);
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - (int)fa.sharedSizeBytes);
    return r;
  }();
  return e;
}

template <int SCORE, int FLAGS>
cudaError_t launch_as(const void* ids, const void* cnts, const void* df_t,
                   const void* df_n, int32_t B, int32_t L, int32_t k,
                   float num_docs, int32_t C, int32_t S, int32_t W,
                   void* scratch, void* out_ids, void* out_s,
                   cudaStream_t stream) {
  using T = typename ScoreOf<SCORE>::T;
  cudaError_t e = allow_smem<SCORE, FLAGS>();
  if (e != cudaSuccess) return e;
  const size_t key_bytes =
      (FLAGS & kKeysInSmem) ? (((size_t)S * 4 + 15) & ~(size_t)15) : 0;
  const int vec = ((reinterpret_cast<uintptr_t>(ids) |
                    reinterpret_cast<uintptr_t>(cnts) |
                    reinterpret_cast<uintptr_t>(df_n)) % 16 == 0) &&
                  L % 4 == 0 && S % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = key_bytes + ((FLAGS & kListInSmem) ? (size_t)W * 8 : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, topk_gather_kernel<SCORE, FLAGS>,
                         (const int32_t*)ids, (const int32_t*)cnts,
                         (const int32_t*)df_t, (const int32_t*)df_n, L, k,
                         num_docs, S, W, vec, (uint64_t*)scratch,
                         (int32_t*)out_ids, (T*)out_s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int SCORE>
cudaError_t launch(const void* ids, const void* cnts, const void* df_t,
                   const void* df_n, int32_t B, int32_t L, int32_t k,
                   float num_docs, int32_t C, int32_t S, int32_t W,
                   int32_t flags, void* scratch, void* out_ids, void* out_s,
                   cudaStream_t stream) {
  switch (flags) {
    case kKeysInSmem | kListInSmem:
      return launch_as<SCORE, kKeysInSmem | kListInSmem>(
          ids, cnts, df_t, df_n, B, L, k, num_docs, C, S, W, scratch, out_ids,
          out_s, stream);
    case kListInSmem:
      return launch_as<SCORE, kListInSmem>(ids, cnts, df_t, df_n, B, L, k,
                                           num_docs, C, S, W, scratch, out_ids,
                                           out_s, stream);
    case 0:
      return launch_as<SCORE, 0>(ids, cnts, df_t, df_n, B, L, k, num_docs, C,
                                 S, W, scratch, out_ids, out_s, stream);
    default:  // keys in shared memory leave room there for the lists
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// score: 0 count, 1 pmi, 2 dice. C blocks of S slots each cover a row;
// W is the winner list's capacity (a power of two >= min(k, S)); flags: 1
// keys in shared memory (else recomputed each pass), 2 winner lists in
// shared memory (else in scratch, B C W uint64), so 3, 2 or 0. Returns a
// cudaError_t (0 on success).
extern "C" int topk_gather_launch(const void* ids, const void* cnts,
                                  const void* df_t, const void* df_n,
                                  int32_t B, int32_t L, int32_t k,
                                  int32_t score, float num_docs, int32_t C,
                                  int32_t S, int32_t W, int32_t flags,
                                  void* scratch, void* out_ids, void* out_s,
                                  void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (k < 1 || k > L) return (int)cudaErrorInvalidValue;
  if (C < 1 || C > kMaxCluster || S < 1 || (int64_t)C * S < L)
    return (int)cudaErrorInvalidValue;
  if (W < (k < S ? k : S) || (W & (W - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (!(flags & kListInSmem) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * C >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (score) {
    case kCount:
      return (int)launch<kCount>(ids, cnts, df_t, df_n, B, L, k, num_docs, C,
                                 S, W, flags, scratch, out_ids, out_s, s);
    case kPmi:
      return (int)launch<kPmi>(ids, cnts, df_t, df_n, B, L, k, num_docs, C, S,
                               W, flags, scratch, out_ids, out_s, s);
    case kDice:
      return (int)launch<kDice>(ids, cnts, df_t, df_n, B, L, k, num_docs, C,
                                S, W, flags, scratch, out_ids, out_s, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
