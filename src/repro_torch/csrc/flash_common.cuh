// Pieces shared by the three paths of flash_attention.cu: the masking
// constant, 8-wide loads and stores in float32 or bfloat16, and the
// sm_90 mbarrier and bulk-copy (TMA) instructions as inline PTX.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kDPL = 8;  // head dims per lane on the CUDA-core paths

// lanes of a row's group on the CUDA-core paths: hd / 8 rounded up to a
// power of two, so that the xor shuffles stay inside the group (16 at hd
// 80, zamba2-2.7b's, of which the last 6 hold no dims and add zeros)
template <int HD>
__host__ __device__ constexpr int group_lanes() {
  return HD / kDPL <= 2 ? 2 : HD / kDPL <= 4 ? 4 : HD / kDPL <= 8 ? 8 : 16;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Visibility, the reference's own (src/repro/models/layers.py:151-152,
// 163-164): key j is visible to row i iff j < S, j <= i when causal, and
// i - j < window when a window is given (window 0: none; a window only
// comes with the causal mask).  The two helpers below give the tiles a
// block visits, exactly those that hold a visible pair.

// the `tile`-key tiles [*first, *end) that rows [r0, r0 + rows) (those
// below T) see: from the tile holding r0 - window + 1, to the one holding
// the last row's last key
__host__ __device__ inline void key_tile_range(int r0, int rows, int t_len, int s_len, int causal, int window,
                                               int tile, int* first, int* end) {
  const int r1 = r0 + rows < t_len ? r0 + rows : t_len;  // past the last row
  const int k_end = causal && r1 < s_len ? r1 : s_len;
  const int k_first = window > 0 && r0 - window + 1 > 0 ? r0 - window + 1 : 0;
  *first = k_first / tile;
  const int e = ceil_div(k_end, tile);
  *end = e > *first ? e : *first;
}

// the `tile`-row tiles [*first, *end) whose rows see a key of keys [j0,
// j0 + keys) (those below S): causal, from the tile holding j0 to the one
// holding the last key + window - 1; every tile when full; none (both
// ceil(T / tile)) when no row does
__host__ __device__ inline void row_tile_range(int j0, int keys, int t_len, int s_len, int causal, int window,
                                               int tile, int* first, int* end) {
  const int n = ceil_div(t_len, tile);
  if (!causal) {
    *first = 0;
    *end = n;
    return;
  }
  if (j0 >= t_len) {
    *first = *end = n;
    return;
  }
  *first = j0 / tile;
  const int j1 = j0 + keys < s_len ? j0 + keys : s_len;  // past the last key
  const int e = window > 0 && ceil_div(j1 - 1 + window, tile) < n ? ceil_div(j1 - 1 + window, tile) : n;
  *end = e > *first ? e : *first;
}

// the pair (row, key) is visible: the mask every path applies element-wise
__host__ __device__ __forceinline__ bool visible(int row, int key, int s_len, int causal, int window) {
  return key < s_len && (!causal || key <= row) && (window == 0 || row - key < window);
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load8(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ static void store8(float* p, const float* in) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static void load8(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store8(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy;
// a __syncthreads() must follow before another thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one contiguous global -> shared copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace flash
