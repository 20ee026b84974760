// segment_hist: the LIST-SCAN accumulator as an integer-atomic histogram.
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
// Bound on this card: bytes. Each token reads 8 bytes (id + segment) once
// and the int32 grid is written once: (8 L + 4 rows V) bytes over 3.35 TB/s.
// Design: a grid-stride loop, one token per thread per step, coalesced
// 4-byte loads of both streams, and one `atomicAdd` into the grid in device
// memory (resolved in L2). Integer atomics make the result exact below 2^31
// per cell and independent of launch order. The grid is indexed in int64,
// so rows x vocab may exceed 2^31. Contention on the head columns of the
// first primary batch is the known cost; privatising tiles in shared memory
// is the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segment_hist_kernel(const int32_t* __restrict__ ids,
                                    const int32_t* __restrict__ seg,
                                    int64_t n, int32_t* __restrict__ out,
                                    int32_t num_rows, int64_t vocab) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; l < n;
       l += stride) {
    const int32_t v = ids[l];
    const int32_t r = seg[l];
    if (v < 0 || r < 0 || r >= num_rows || (int64_t)v >= vocab) continue;
    atomicAdd(out + (int64_t)r * vocab + v, 1);
  }
}

}  // namespace

extern "C" int segment_hist_launch(const void* ids, const void* seg, int64_t n,
                                   void* out, int32_t num_rows, int64_t vocab,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // two waves of 132 SMs x 8 resident blocks of 256 threads; the loop in
  // the kernel covers the rest of the stream
  if (blocks > 132 * 16) blocks = 132 * 16;
  segment_hist_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)seg, n, (int32_t*)out, num_rows,
      vocab);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
