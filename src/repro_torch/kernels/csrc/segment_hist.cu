// segment_hist: the LIST-SCAN accumulator as a windowed shared-memory
// histogram.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_cooc.py
// (`segment_hist_kernel`, body `_segment_hist_kernel`), which recasts the
// histogram as a one-hot x one-hot bf16 matmul on the MXU because a TPU has
// no fast scatter, and is exact only below 2^24 per cell.
//
// Computes out[r, v] += #{l : seg[l] == r && ids[l] == v} over flat int32
// streams; entries with ids < 0 or seg < 0 are padding, and anything outside
// [0, num_rows) x [0, vocab) is skipped, so the kernel never writes out of
// bounds. The caller zeroes `out` (or passes a grid that earlier launches
// accumulated into).
//
// Bound on this card: bytes. Each token reads 8 bytes (id + segment) once,
// and each grid cell the batch makes nonzero is read and written once (the
// caller zeroed the grid): (8 L + 8 nonzero cells) bytes over 3.35 TB/s.
// What held the first version (one global `atomicAdd` per token) at 15% of
// that bound is contention: the stream is Zipf-shaped and both callers emit
// `seg` in non-decreasing order, so every block hammered the head columns of
// the same one or two rows in L2.
//
// Design: each block takes one contiguous span of the stream and keeps a
// private int32 window in dynamic shared memory, rows [r0, r0 + R) x
// columns [0, H). r0 starts at the row of the span's first token. A token
// inside the window is counted with a shared-memory `atomicAdd`, any other
// token with a global one, so any stream is counted right, sorted or not.
// When every token of a block-wide step lies past the window's last row,
// the window moves: a barrier, its nonzero cells are added into the grid
// with global atomics and zeroed, and r0 becomes the step's lowest row. At
// the end of the span the window is flushed once more. Integer atomics keep
// the result exact below 2^31 per cell and independent of launch order.
// A step of 4 x blockDim tokens is read by coalesced 4-byte loads
// (evict-first), a warp's 32 consecutive tokens at a time, and so is each
// of its atomics: a document's suffix comes in ascending ids, so those
// tokens' global atomics fall on few sectors of the grid. The next step's
// loads are issued before the current step is counted. The window shape (R, H), the span, the block
// count and the block size come from `plan()` in kernels/segment_hist.py;
// this file derives none of them. A launch shorter than one 4,096-token
// step a block on every SM takes no window (R = H = 0): it runs narrow
// blocks on one step each, which spreads its global atomics over the SMs. What the window catches, as the kernel's own hit counter
// read it on the H100 (chip_smoke.py, PERF.md): 85.2% of the tokens of the
// WT10G-shaped collection's first head batch (2^26 tokens into 64 x
// 65,536, window 2 x 16,384), 87.7% of its df-remapped first FREQ-SPLIT
// tail batch (3,615 x 4,639, window 29 x 1,129).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Read this thread's four tokens of the step at `base`: base + k blockDim
// + threadIdx.x for k < 4 (-1 past `end`), so that a warp's loads, and its
// atomics, take 32 consecutive tokens at a time.
__device__ __forceinline__ void load4(const int32_t* __restrict__ ids,
                                      const int32_t* __restrict__ seg,
                                      int64_t base, int64_t end, int4& v,
                                      int4& r) {
  const int64_t l = base + threadIdx.x;
  const int64_t d = blockDim.x;
  v.x = l < end ? __ldcs(ids + l) : -1;
  v.y = l + d < end ? __ldcs(ids + l + d) : -1;
  v.z = l + 2 * d < end ? __ldcs(ids + l + 2 * d) : -1;
  v.w = l + 3 * d < end ? __ldcs(ids + l + 3 * d) : -1;
  r.x = l < end ? __ldcs(seg + l) : -1;
  r.y = l + d < end ? __ldcs(seg + l + d) : -1;
  r.z = l + 2 * d < end ? __ldcs(seg + l + 2 * d) : -1;
  r.w = l + 3 * d < end ? __ldcs(seg + l + 3 * d) : -1;
}

// Add the window's nonzero cells into rows [r0, r0 + R) of the grid and
// zero them. Cells of rows past num_rows are never counted, so stay 0.
__device__ __forceinline__ void flush(int32_t* win, int R, int H, int32_t r0,
                                      int32_t* __restrict__ out,
                                      int64_t vocab) {
  const int cells = R * H;
  if (cells == 0) return;
  int row = threadIdx.x / H;
  int col = threadIdx.x % H;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t c = win[i];
    if (c != 0) {
      atomicAdd(out + (int64_t)(r0 + row) * vocab + col, c);
      win[i] = 0;
    }
    col += blockDim.x;
    while (col >= H) {
      col -= H;
      ++row;
    }
  }
}

__global__ void __launch_bounds__(1024)
segment_hist_kernel(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ seg, int64_t n,
                    int32_t* __restrict__ out, int32_t num_rows, int64_t vocab,
                    int R, int H, int64_t span,
                    unsigned long long* __restrict__ hits) {
  extern __shared__ int32_t win[];
  __shared__ int32_t s_next;
  const int64_t begin = (int64_t)blockIdx.x * span;
  const int64_t end = begin + span < n ? begin + span : n;
  const int64_t step = 4 * (int64_t)blockDim.x;
  // the first step's loads and the window's first row are in flight while
  // the window is zeroed
  int4 v, r;
  load4(ids, seg, begin, end, v, r);
  int32_t r0 = R * H != 0 ? seg[begin] : 0;
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) win[i] = 0;
  if (threadIdx.x == 0) s_next = INT_MAX;
  unsigned long long my_hits = 0;
  __syncthreads();
  // r0 stays a row of the grid, so r - r0 fits in 32 bits for any valid r
  r0 = r0 < 0 ? 0 : (r0 >= num_rows ? num_rows - 1 : r0);

  for (int64_t base = begin; base < end; base += step) {
    int4 nv = make_int4(-1, -1, -1, -1), nr = nv;
    if (base + step < end)
      load4(ids, seg, base + step, end, nv, nr);
    const int32_t tv[4] = {v.x, v.y, v.z, v.w};
    const int32_t tr[4] = {r.x, r.y, r.z, r.w};
    bool ok[4];
    bool past = true;
    int32_t lowest = INT_MAX;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ok[k] = tv[k] >= 0 && tr[k] >= 0 && tr[k] < num_rows && tv[k] < vocab;
      if (ok[k]) {
        past = past && tr[k] - r0 >= R;
        lowest = tr[k] < lowest ? tr[k] : lowest;
      }
    }
    // (R * H is the same in every thread, so all or none reach the barrier)
    if (R * H != 0 && __syncthreads_and(past)) {  // the step is past the window
      flush(win, R, H, r0, out, vocab);
      atomicMin(&s_next, lowest);
      __syncthreads();
      if (s_next != INT_MAX) r0 = s_next;  // else the step was all padding
      __syncthreads();
      if (threadIdx.x == 0) s_next = INT_MAX;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!ok[k]) continue;
      const unsigned dr = (unsigned)(tr[k] - r0);
      if (dr < (unsigned)R && tv[k] < H) {
        atomicAdd(win + dr * H + tv[k], 1);
        ++my_hits;
      } else {
        atomicAdd(out + (int64_t)tr[k] * vocab + tv[k], 1);
      }
    }
    v = nv;
    r = nr;
  }
  if (R * H != 0) {
    __syncthreads();
    flush(win, R, H, r0, out, vocab);
  }

  if (hits != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      my_hits += __shfl_down_sync(0xffffffffu, my_hits, o);
    if ((threadIdx.x & 31) == 0 && my_hits != 0) atomicAdd(hits, my_hits);
  }
}

}  // namespace

// Launch one block of `threads` per span of `span` tokens (`blocks` spans
// cover the stream), each with an R x H int32 window. `hits`, when not
// null, gains the number of tokens counted in a window.
extern "C" int segment_hist_launch(const void* ids, const void* seg, int64_t n,
                                   void* out, int32_t num_rows, int64_t vocab,
                                   int32_t R, int32_t H, int64_t span,
                                   int64_t blocks, int32_t threads,
                                   void* hits, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (blocks * span < n || (blocks - 1) * span >= n || H > vocab)
    return (int)cudaErrorInvalidValue;  // the plan must cover the stream
  const size_t smem = (size_t)R * H * sizeof(int32_t);
  static size_t smem_set = 48 * 1024;  // what a launch may ask without the attribute
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  segment_hist_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)seg, n, (int32_t*)out, num_rows,
      vocab, R, H, span, (unsigned long long*)hits);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
