// window_degree for Hopper (sm_90a): per-row count of padded edge times
// inside a half-open window.
//
// Replaces the TPU kernel `window_degree_pallas` / `_kernel` in
// src/repro/kernels/window_degree/kernel.py (pallas_call at line 34).  For
// every row r of a (B, D) int32 time tile it writes
//   out[r] = #{ j : lo[r] < t[r, j] <= hi[r] }
// as int32.  Padding slots hold PAD_T = INT32_MIN, which fails
// `t > lo` for every representable window, so they never count.
//
// Bound on an H100: the bytes.  Each input is read once and each output
// written once, B * (4 * D + 12) bytes, against B * D compare-and-adds.
//
// Design (a first, simple kernel): one warp per row, grid-stride over
// rows; the lanes stride over the row's D entries, so neighbouring lanes
// read neighbouring words, and the per-lane counts are summed with one
// warp reduction.  The TPU kernel's VMEM row blocks have no counterpart;
// the ragged B edge is the row loop's own bound, nothing is padded.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr long long kMaxBlocks = 1 << 16;

__global__ void window_degree_kernel(const int32_t* __restrict__ t,
                                     const int32_t* __restrict__ lo,
                                     const int32_t* __restrict__ hi,
                                     int32_t* __restrict__ out, int64_t n_rows,
                                     int d) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * (blockDim.x >> 5);
  // the row is uniform across the warp, so the full-mask reduction is safe
  for (int64_t row = warp; row < n_rows; row += stride) {
    const int32_t l = lo[row], h = hi[row];
    const int32_t* tr = t + row * d;
    int cnt = 0;
    for (int j = lane; j < d; j += 32) {
      const int32_t v = tr[j];
      cnt += (v > l && v <= h) ? 1 : 0;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) out[row] = cnt;
  }
}

}  // namespace

extern "C" int window_degree_launch(const void* t, const void* lo,
                                    const void* hi, void* out,
                                    long long n_rows, int d, void* stream) {
  if (n_rows <= 0) return 0;
  if (d < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  window_degree_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)t, (const int32_t*)lo, (const int32_t*)hi,
      (int32_t*)out, (int64_t)n_rows, d);
  return (int)cudaGetLastError();
}
