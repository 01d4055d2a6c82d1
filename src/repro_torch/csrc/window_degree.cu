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
// Design: a persistent grid (a few blocks per SM) whose warps walk the
// rows.  A group of G lanes reads a row (G the largest power of two, at
// most 32, not above the row's vector count), so a narrow row is one
// group's and a warp covers 32 / G consecutive rows: one contiguous span
// of the tile.  Where every row starts 16-byte aligned (D % 4 == 0 and an
// aligned base) the lanes read int4 vectors, else single words; each lane
// starts kUnroll row groups' loads before it counts any, so several loads
// are in flight per thread (loading one row group at a time where the
// rows do not fill the grid, as at (16,384, 128), measured 1.3x slower on
// an H100).  Each group sums with shuffles, and its first lane stores the
// row's count.  The ragged B edge is the row loop's own bound, nothing is
// padded.  Launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // row groups a warp loads before it counts them
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int in_window(int32_t v, int32_t l, int32_t h) { return (v > l && v <= h) ? 1 : 0; }

// V words a load (1 or 4); G lanes a row
template <int V>
__global__ void __launch_bounds__(kThreads) window_degree_kernel(
    const int32_t* __restrict__ t, const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int32_t* __restrict__ out, int64_t n_rows, int d, int group) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / group;
  const int slot = lane / group;
  const int g_lane = lane - slot * group;
  const int nv = d / V;  // vectors a row (V divides D)
  const int64_t warp = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t stride = n_warps * rows_per_warp;
  // the loop bound is uniform across the warp, so the shuffles are safe
  for (int64_t base = warp * rows_per_warp; base < n_rows; base += kUnroll * stride) {
    int cnt[kUnroll];
    int64_t row[kUnroll];
    int32_t l[kUnroll], h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = base + u * stride + slot;
      cnt[u] = 0;
      const bool ok = row[u] < n_rows;
      l[u] = ok ? lo[row[u]] : 0;
      h[u] = ok ? hi[row[u]] : 0;
    }
    for (int v0 = 0; v0 < nv; v0 += group) {
      const int v = v0 + g_lane;
      if (V == 4) {
        int4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = (row[u] < n_rows && v < nv)
                     ? reinterpret_cast<const int4*>(t + row[u] * d)[v]
                     : make_int4(INT32_MIN, INT32_MIN, INT32_MIN, INT32_MIN);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          cnt[u] += in_window(x[u].x, l[u], h[u]) + in_window(x[u].y, l[u], h[u]) +
                    in_window(x[u].z, l[u], h[u]) + in_window(x[u].w, l[u], h[u]);
        }
      } else {
        int32_t x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = (row[u] < n_rows && v < nv) ? t[row[u] * d + v] : INT32_MIN;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) cnt[u] += in_window(x[u], l[u], h[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int c = cnt[u];
      for (int off = group >> 1; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off, group);
      if (g_lane == 0 && row[u] < n_rows) out[row[u]] = c;
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (!counts[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace

extern "C" int window_degree_launch(const void* t, const void* lo,
                                    const void* hi, void* out,
                                    long long n_rows, int d, void* stream) {
  if (n_rows <= 0) return 0;
  if (d < 0) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && ((uintptr_t)t & 15) == 0;
  const int nv = vec ? d / 4 : d;
  int group = 1;
  while (group < 32 && 2 * group <= nv) group <<= 1;
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / group) * kUnroll;
  long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t *tp = (const int32_t*)t, *lp = (const int32_t*)lo, *hp = (const int32_t*)hi;
  int32_t* op = (int32_t*)out;
  if (vec) {
    window_degree_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(tp, lp, hp, op, (int64_t)n_rows, d, group);
  } else {
    window_degree_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(tp, lp, hp, op, (int64_t)n_rows, d, group);
  }
  return (int)cudaGetLastError();
}
