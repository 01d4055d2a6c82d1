// The backward of flash_attention's long paths (every shape that is not
// the short path's: T or S above 32, or a short shape whose slabs do not
// fit): the gradients dQ, dK, dV of o = softmax(q k^T / sqrt(hd)) v,
// causal (optionally under a sliding window) or full, GQA, T != S,
// float32 or bfloat16, hd 16/32/64/80/128.
// qwen2-1.5b's training launch is here: B = 4, T = S = 4,096, H = 12
// query heads over K = 2 kv heads of 128, bf16, causal.
//
// Not a TPU kernel's counterpart: the Pallas kernel has no VJP, and the
// JAX package's train step differentiates XLA's attention
// (src/repro/models/layers.py:108).  It is the gradient of this port's
// forward kernel, so that the LM's train step runs every layer's
// attention through hand-written kernels both ways.
//
// What it computes, per batch element, query head h and row i, with P
// recomputed from the forward's row logsumexp (lse, float32, (B, H, T)):
//   p_ij  = exp(scale * q_i . k_j - lse_i) over the visible keys, else 0
//           (key j visible to row i iff j < S, j <= i when causal, and
//           i - j < window under a window)
//   D_i   = dO_i . O_i
//   dS_ij = p_ij (dO_i . v_j - D_i)
//   dQ_i  = scale * sum_j dS_ij k_j
//   dK_j  = scale * sum_{h in the group, i} dS_ij q_i,   dV_j = sum p_ij dO_i
// with k_j, v_j of kv head h / G.  Sums in float32; outputs in q's type.
//
// Bound: the operations.  Counted work is 5 products of 2 * hd flops per
// visible (row, key) pair: at the training launch 402.75 M pairs over
// its 48 (b, h), 0.52 TFLOP, 0.521 ms at the bf16 tensor-core peak (989
// TFLOP/s on an H100 SXM).  Deterministic (no atomics: two
// launches give the same bits), three kernels a call:
//   1. the row pass: D = rowsum(dO * O) (on the wgmma route also each
//      row's lse in base 2) into a float32 scratch the wrapper allocates
//      (a lane group of hd / 8 lanes per row);
//   2. dQ: a block per (b, query head, tile of query rows); it loops over
//      the key tiles its rows can see (causal: up to the diagonal),
//      recomputes P and dS and sums dS K;
//   3. dK and dV: a block per (b, kv head, tile of keys); it loops over
//      the G query heads of the group and over the query tiles that can
//      see its keys (causal: from the tile's first key on), recomputes P
//      and dS and sums P^T dO and dS^T Q.  The group's sum stays in the
//      block.
// Recomputing P in both passes costs 7 products where an atomic dQ would
// cost 5; that is the price of the fixed summation order.
//
// Two routes for passes 2 and 3, fixed by the dtype and head size:
//   "wgmma" (bf16 at hd 64, 80 or 128): the FlashAttention-3 backward (Shah
//          et al., 2024) with its dQ atomics replaced by a pass of its
//          own.  Only wgmma reaches the tensor cores' full rate, and they
//          idle while a tile loads, so both passes are warp-specialised:
//          384 threads, a producer warpgroup (24 registers by setmaxnreg;
//          one thread issues every copy) that keeps TMA tiles in flight
//          through a 2-stage mbarrier ring, and two consumer warpgroups
//          (240 registers each, no spill) that run the products on 64 rows
//          (keys in pass 3) each.  Tensor maps read q, k, v and dO in place
//          in their (B, L, heads, hd) layouts with the 128-byte swizzle;
//          rows past T and keys past S arrive as zeros and are masked by
//          index, only on tiles that cross the end of T or S or the
//          diagonal (the others take a loop without the mask's selects).
//          - Pass 1 writes (B, H, ceil(T / 64), 2, 64): a 64-row tile's
//            lse * log2(e), then its D, zeros past T (lse past T is never
//            read), so that one 512-byte bulk copy brings a stage's rows.
//          - Pass 3: a block per (b, kv head, tile of 128 keys), K and V
//            loaded once; Q and dO tiles of 64 rows stream through the
//            ring.  Per stage each consumer runs S^T = K Q^T and
//            dP^T = V dO^T (m64n64k16, both from shared memory), forms
//            P^T while dP^T runs, rounded to bf16 as the forward rounds P
//            (the accumulator layout of S^T, keys as rows, is the A
//            operand layout of the next product), issues dV += P^T dO,
//            forms dS^T while it runs, then dK += dS^T Q (A from
//            registers, B MN-major).  dK and dV (128 registers at hd 128)
//            are written once, scaled.
//          - Pass 2: a block per (b, query head, tile of 128 rows), Q and
//            dO loaded once; K and V tiles of 128 keys stream through the
//            ring.  Per stage S = Q K^T and dP = dO V^T (m64n128k16), P
//            formed while dP runs, then dQ += dS K with dS in registers and
//            K MN-major.
//          P = 2^(s * scale * log2(e) - lse * log2(e)) by ex2.approx.ftz
//          alone: the exponent, the mask and dS are the CUDA-core work
//          that the tensor cores wait on, and exp2f adds range handling
//          around the special-function unit to it.
//          Both passes start with their heaviest tiles (causal: the
//          earliest key tiles, the latest query tiles), and their tile
//          loops are row_tile_range and key_tile_range
//          (flash_common.cuh), which the .cu entry
//          flash_attention_bwd_tiles reports: under a window a dK/dV
//          block stops at the last row that sees its keys and a dQ block
//          starts at its first visible key tile, and only tiles that
//          cross the window's lower edge take the masked loop.
//          Head size 80 runs the hd-128 layout over tensor maps that
//          declare 80 dims: TMA fills dims 80-127 with zeros, the score
//          products take the 5 k-steps of the 80 dims, the dV, dK and dQ
//          products both 64-dim boxes, and the epilogues store 80 dims.
//   "simt" (the rest: float32, and bf16 at hd 16 or 32): the CUDA cores,
//          a lane group of hd / 8 lanes per row (rounded up to a power of
//          two: 16 at hd 80, 6 of them idle) holding 8 dims each, the
//          other side staged 32 rows at a time into shared memory as
//          float32; scores formed as the forward's simt path forms them
//          (q scaled first, 8-dim partial products, xor shuffles).
#pragma once

#include "flash_common.cuh"
#include "flash_hopper.cuh"
#include "flash_short_bwd.cuh"

#include <type_traits>

namespace flash {

constexpr int kLongThreads = 128;
constexpr int kSimtRows = 32;  // rows of the staged side on the simt route
constexpr float kLog2eBwd = 1.4426950408889634f;

// ---- pass 1: D = rowsum(dO * O), (B, T, H, hd) rows -> (B, H, T) ----
template <typename T, int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
                        int n_rows, int t_len, int n_heads) {
  constexpr int L = group_lanes<HD>();  // lanes a row; the first HD / 8 hold its dims
  const int r = blockIdx.x * (kLongThreads / L) + threadIdx.x / L;
  const int sub = threadIdx.x % L;
  const bool ok = r < n_rows;
  float a[kBwdDPL], b[kBwdDPL];
  if (ok && sub < HD / kBwdDPL) {
    Io<T>::load8(o + (size_t)r * HD + sub * kBwdDPL, a);
    Io<T>::load8(dout + (size_t)r * HD + sub * kBwdDPL, b);
  } else {
#pragma unroll
    for (int x = 0; x < kBwdDPL; ++x) a[x] = b[x] = 0.f;
  }
  const float d = group_dot<L>(b, a);
  if (ok && sub == 0) {
    const int h = r % n_heads, i = (r / n_heads) % t_len, e = r / (n_heads * t_len);
    dsum[((size_t)e * n_heads + h) * t_len + i] = d;
  }
}

// ---- simt route, pass 2: dQ.  Block = (b, h, tile of R rows) ----
template <typename T, int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_simt_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dsum, T* __restrict__ dq, int t_len, int s_len, int n_heads,
                         int group, int kv_heads, int causal, int window, float scale, int q_tiles) {
  constexpr int LD = HD / kBwdDPL;      // chunks of 8 dims a row
  constexpr int L = group_lanes<HD>();  // lanes a row, the last L - LD idle
  constexpr int R = kLongThreads / L;   // query rows a block
  __shared__ __align__(16) float ks[kSimtRows * HD];
  __shared__ __align__(16) float vs[kSimtRows * HD];
  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  const int sub = threadIdx.x % L;
  const bool lane_ok = sub < LD;  // idle lanes hold zeros and store nothing
  const int sub_c = lane_ok ? sub : 0;
  const int i_raw = tile * R + threadIdx.x / L;
  const bool ok = i_raw < t_len;
  const int i = ok ? i_raw : t_len - 1;  // lanes past the last row compute on it and store nothing
  const size_t off = (((size_t)b * t_len + i) * n_heads + h) * HD + sub_c * kBwdDPL;
  float qf[kBwdDPL], dof[kBwdDPL], acc[kBwdDPL];
#pragma unroll
  for (int x = 0; x < kBwdDPL; ++x) qf[x] = dof[x] = acc[x] = 0.f;
  if (lane_ok) {
    Io<T>::load8(q + off, qf);
    Io<T>::load8(dout + off, dof);
  }
#pragma unroll
  for (int x = 0; x < kBwdDPL; ++x) qf[x] *= scale;
  const float lr = lse[(size_t)bh * t_len + i];
  const float dd = dsum[(size_t)bh * t_len + i];
  int kt_first, kt_end;  // the key tiles the block's rows see
  key_tile_range(tile * R, R, t_len, s_len, causal, window, kSimtRows, &kt_first, &kt_end);
  const int kv_end = kt_end * kSimtRows < s_len ? kt_end * kSimtRows : s_len;
  for (int j0 = kt_first * kSimtRows; j0 < kv_end; j0 += kSimtRows) {
    __syncthreads();  // every row is done with the previous tile
    for (int c = threadIdx.x; c < kSimtRows * LD; c += kLongThreads) {
      const int jj = c / LD, ch = c % LD, j = j0 + jj;
      float kx[kBwdDPL], vx[kBwdDPL];
      if (j < s_len) {
        const size_t ko = (((size_t)b * s_len + j) * kv_heads + kh) * HD + ch * kBwdDPL;
        Io<T>::load8(k + ko, kx);
        Io<T>::load8(v + ko, vx);
      } else {
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) kx[x] = vx[x] = 0.f;
      }
      Io<float>::store8(ks + jj * HD + ch * kBwdDPL, kx);
      Io<float>::store8(vs + jj * HD + ch * kBwdDPL, vx);
    }
    __syncthreads();
    const int n = min(kSimtRows, kv_end - j0);
    for (int jj = 0; jj < n; ++jj) {
      float kx[kBwdDPL], vx[kBwdDPL];
      Io<float>::load8(ks + jj * HD + sub_c * kBwdDPL, kx);
      Io<float>::load8(vs + jj * HD + sub_c * kBwdDPL, vx);
      const float sc = group_dot<L>(qf, kx);
      const float dp = group_dot<L>(dof, vx);
      const int j = j0 + jj;
      const float p = visible(i, j, s_len, causal, window) ? expf(sc - lr) : 0.f;
      const float ds = p * (dp - dd);
#pragma unroll
      for (int x = 0; x < kBwdDPL; ++x) acc[x] = fmaf(ds, kx[x], acc[x]);
    }
  }
  if (ok && lane_ok) {
#pragma unroll
    for (int x = 0; x < kBwdDPL; ++x) acc[x] *= scale;
    Io<T>::store8(dq + off, acc);
  }
}

// ---- simt route, pass 3: dK, dV.  Block = (b, kv head, tile of R keys) ----
template <typename T, int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_simt_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int t_len,
                          int s_len, int n_heads, int group, int kv_heads, int causal, int window, float scale,
                          int k_tiles) {
  constexpr int LD = HD / kBwdDPL;      // chunks of 8 dims a row
  constexpr int L = group_lanes<HD>();  // lanes a row, the last L - LD idle
  constexpr int R = kLongThreads / L;   // keys a block
  __shared__ __align__(16) float qs[kSimtRows * HD];
  __shared__ __align__(16) float dos[kSimtRows * HD];
  __shared__ float ls[kSimtRows], dsm[kSimtRows];
  const int tile = blockIdx.x % k_tiles;
  const int bkh = blockIdx.x / k_tiles;
  const int b = bkh / kv_heads, kh = bkh % kv_heads;
  const int sub = threadIdx.x % L;
  const bool lane_ok = sub < LD;  // idle lanes hold zeros and store nothing
  const int sub_c = lane_ok ? sub : 0;
  const int j_raw = tile * R + threadIdx.x / L;
  const bool ok = j_raw < s_len;
  const int j = ok ? j_raw : s_len - 1;
  const size_t off = (((size_t)b * s_len + j) * kv_heads + kh) * HD + sub_c * kBwdDPL;
  float kf[kBwdDPL], vf[kBwdDPL], dka[kBwdDPL], dva[kBwdDPL];
#pragma unroll
  for (int x = 0; x < kBwdDPL; ++x) kf[x] = vf[x] = dka[x] = dva[x] = 0.f;
  if (lane_ok) {
    Io<T>::load8(k + off, kf);
    Io<T>::load8(v + off, vf);
  }
  // the rows that see any of the block's keys: from its first key (causal)
  // to its last key + window - 1
  const int i_begin = causal ? tile * R : 0;
  const int j_last = min(s_len, tile * R + R) - 1;
  const int i_end = window > 0 && j_last + window < t_len ? j_last + window : t_len;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kh * group + gi;
    const size_t bh = (size_t)b * n_heads + h;
    for (int i0 = i_begin; i0 < i_end; i0 += kSimtRows) {
      __syncthreads();  // every key is done with the previous rows
      for (int c = threadIdx.x; c < kSimtRows * LD; c += kLongThreads) {
        const int ii = c / LD, ch = c % LD, i = i0 + ii;
        float qx[kBwdDPL], dx[kBwdDPL];
        if (i < t_len) {
          const size_t qo = (((size_t)b * t_len + i) * n_heads + h) * HD + ch * kBwdDPL;
          Io<T>::load8(q + qo, qx);
          Io<T>::load8(dout + qo, dx);
        } else {
#pragma unroll
          for (int x = 0; x < kBwdDPL; ++x) qx[x] = dx[x] = 0.f;
        }
        Io<float>::store8(qs + ii * HD + ch * kBwdDPL, qx);
        Io<float>::store8(dos + ii * HD + ch * kBwdDPL, dx);
      }
      for (int c = threadIdx.x; c < kSimtRows; c += kLongThreads) {
        const int i = i0 + c;
        ls[c] = i < t_len ? lse[bh * t_len + i] : 0.f;
        dsm[c] = i < t_len ? dsum[bh * t_len + i] : 0.f;
      }
      __syncthreads();
      const int n = min(kSimtRows, i_end - i0);
      for (int ii = 0; ii < n; ++ii) {
        float qx[kBwdDPL], qsc[kBwdDPL], dx[kBwdDPL];
        Io<float>::load8(qs + ii * HD + sub_c * kBwdDPL, qx);
        Io<float>::load8(dos + ii * HD + sub_c * kBwdDPL, dx);
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) qsc[x] = qx[x] * scale;
        const float sc = group_dot<L>(qsc, kf);
        const float dp = group_dot<L>(dx, vf);
        const float p = visible(i0 + ii, j, s_len, causal, window) ? expf(sc - ls[ii]) : 0.f;
        const float ds = p * (dp - dsm[ii]);
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) {
          dva[x] = fmaf(p, dx[x], dva[x]);
          dka[x] = fmaf(ds, qx[x], dka[x]);
        }
      }
    }
  }
  if (ok && lane_ok) {
#pragma unroll
    for (int x = 0; x < kBwdDPL; ++x) dka[x] *= scale;
    Io<T>::store8(dk + off, dka);
    Io<T>::store8(dv + off, dva);
  }
}

// ---- wgmma route (bf16 at hd 64 or 128) ----

constexpr int kBwdThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kBwdStages = 2;     // ring stages of both passes
constexpr int kKeyTile = 128;     // keys of a dK/dV block, 64 a consumer warpgroup
constexpr int kRowStage = 64;     // query rows of a dK/dV ring stage (and of a row-pass tile)
constexpr int kRowTile = 128;     // query rows of a dQ block, 64 a consumer warpgroup
constexpr int kKeyStage = 128;    // keys of a dQ ring stage
constexpr int kStatFloats = 2 * kRowStage;  // a row tile's lse * log2(e), then its D


// ---- wgmma route, pass 1: each row's lse * log2(e) and D = rowsum(dO * O),
// (B, T, H, hd) rows -> (B, H, n_q, 2, 64) float32, rows past T zeros ----
template <int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_rowdot_tiled(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, float* __restrict__ stats, int n_rows, int t_len,
                              int n_heads, int n_q) {
  constexpr int L = group_lanes<HD>();  // lanes a row; the first HD / 8 hold its dims
  const int r = blockIdx.x * (kLongThreads / L) + threadIdx.x / L;  // over (B, n_q * 64, H)
  const int sub = threadIdx.x % L;
  const int t_pad = n_q * kRowStage;
  const int h = r % n_heads, i = (r / n_heads) % t_pad, e = r / (n_heads * t_pad);
  const bool in = r < n_rows && i < t_len;
  float a[kBwdDPL], b[kBwdDPL];
  if (in && sub < HD / kBwdDPL) {
    const size_t off = (((size_t)e * t_len + i) * n_heads + h) * HD + sub * kBwdDPL;
    Io<__nv_bfloat16>::load8(o + off, a);
    Io<__nv_bfloat16>::load8(dout + off, b);
  } else {
#pragma unroll
    for (int x = 0; x < kBwdDPL; ++x) a[x] = b[x] = 0.f;
  }
  const float d = group_dot<L>(b, a);
  if (r < n_rows && sub == 0) {
    const size_t bh = (size_t)e * n_heads + h;
    float* row = stats + (bh * n_q + i / kRowStage) * kStatFloats + i % kRowStage;
    row[0] = in ? lse[bh * t_len + i] * kLog2eBwd : 0.f;
    row[kRowStage] = d;
  }
}

// acc (64 x N) = A B^T on the tensor cores, hd / 16 steps of m64nNk16 (5
// at hd 80: the zero dims past 80 are not summed):
// A the warpgroup's 64 rows (from row a_row0) of a K-major tile of a_rows
// rows at a, B a K-major tile of N rows at bt (b_rows rows a box column)
template <int HD, int N>
__device__ __forceinline__ void ss_products(float* acc, uint32_t a, int a_rows, int a_row0, uint32_t bt, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 dims into the 128-byte swizzled row
    const uint64_t da = smem_desc(a + (kk / 4) * a_rows * 128 + a_row0 * 128 + off, 16, 1024);
    const uint64_t db = smem_desc(bt + (kk / 4) * b_rows * 128 + off, 16, 1024);
    if constexpr (N == 128) {
      wgmma_ss_n128(acc, da, db, kk > 0);
    } else {
      wgmma_ss_n64(acc, da, db, kk > 0);
    }
  }
}

// acc (64 x box_dims(hd)) += A B on the tensor cores: A (64 x 16 KS) in
// registers as KS k-steps of 16, B the first 16 KS rows of an MN-major tile
// of b_rows rows at bt (8-row groups of 1024 bytes, a k-step two of them);
// at hd 80 the second box's dims past 80 are zeros and sum to zeros
template <int HD, int KS>
__device__ __forceinline__ void rs_products(float* acc, const uint32_t (*a)[4], uint32_t bt, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int c = 0; c < box_dims<HD>() / 64; ++c)
      wgmma_rs_n64_tb(acc + 32 * c, a[kk], smem_desc(bt + c * b_rows * 128 + kk * 2048, 1024, 1024));
  }
}

// N / 2 accumulator values as the A operand of N / 16 k-steps of 16: the
// accumulator layout of one product is the A layout of the next
template <int N>
__device__ __forceinline__ void pack_a(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = pack_bf16(acc[8 * kk + 2 * x], acc[8 * kk + 2 * x + 1]);
  }
}

// 2^x by the special-function unit alone (subnormal results flush to 0),
// without exp2f's range handling around it
__device__ __forceinline__ float bwd_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared memory of pass 3: K and V of the block's 128 keys, then the ring's
// Q, dO and row-stat stages, then the barriers; every tile 1024-aligned
template <int HD>
struct DkvSmem {
  static constexpr int kKvBytes = kKeyTile * box_dims<HD>() * 2;    // K or V
  static constexpr int kRowBytes = kRowStage * box_dims<HD>() * 2;  // a Q or dO stage
  static constexpr int kK = 0;
  static constexpr int kV = kKvBytes;
  static constexpr int kQ = 2 * kKvBytes;                       // stage st at kQ + st * kRowBytes
  static constexpr int kDo = kQ + kBwdStages * kRowBytes;
  static constexpr int kStat = kDo + kBwdStages * kRowBytes;    // stage st at kStat + st * 4 * kStatFloats
  static constexpr int kBar = kStat + kBwdStages * 4 * kStatFloats;
  static constexpr int kBytes = kBar + 64 + 1024;               // barriers, and room to align the base
};

// pass 3 on the tensor cores: block = (b, kv head, tile of 128 keys), the
// earliest (heaviest, causal) key tiles first
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel_wgmma_dkv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int t_len, int s_len, int n_heads, int group,
                           int kv_heads, int causal, int window, float scale, int n_bkh) {
  using L = DkvSmem<HD>;
  constexpr int HP = box_dims<HD>();  // the accumulators' dims: hd over whole boxes
  constexpr int CB = HP / 64;         // 128-byte-wide boxes across hd
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base + L::kK, sv = base + L::kV, sq = base + L::kQ, sdo = base + L::kDo;
  const uint32_t sstat = base + L::kStat;
  const float* stat_ptr = reinterpret_cast<const float*>(smem_raw + (sstat - raw));
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8;                 // kBwdStages of them
  const uint32_t bar_empty = bar_full + 8 * kBwdStages;

  const int kt = blockIdx.x / n_bkh;
  const int bkh = blockIdx.x % n_bkh;
  const int b = bkh / kv_heads, kh = bkh % kv_heads;
  const int j0 = kt * kKeyTile;
  const int n_q = ceil_div(t_len, kRowStage);
  int q_first, q_end;  // the 64-row query tiles whose rows see the block's keys
  row_tile_range(j0, kKeyTile, t_len, s_len, causal, window, kRowStage, &q_first, &q_end);
  const int per_head = q_end - q_first;
  const int n_iters = group * per_head;  // (query head, query tile) stages, head-major

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup: one thread issues every copy ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_iters > 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKvBytes);
      for (int c = 0; c < CB; ++c) {
        tma_load_4d(sk + c * kKeyTile * 128, &tm_k, bar_kv, c * 64, kh, j0, b);
        tma_load_4d(sv + c * kKeyTile * 128, &tm_v, bar_kv, c * 64, kh, j0, b);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int h = kh * group + it / per_head, qt = q_first + it % per_head;
        const int st = it % kBwdStages;
        if (it >= kBwdStages) mbar_wait(bar_empty + 8 * st, ((it / kBwdStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kRowBytes + 4 * kStatFloats);
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(sq + st * L::kRowBytes + c * kRowStage * 128, &tm_q, full, c * 64, h, qt * kRowStage, b);
          tma_load_4d(sdo + st * L::kRowBytes + c * kRowStage * 128, &tm_do, full, c * 64, h, qt * kRowStage, b);
        }
        bulk_g2s(sstat + st * 4 * kStatFloats, stats + ((size_t)(b * n_heads + h) * n_q + qt) * kStatFloats,
                 4 * kStatFloats, full);
      }
    }
  } else {  // ---- consumer warpgroup cw holds keys j0 + 64 cw .. + 63 ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, quad = lane % 4;
    const int kw0 = j0 + 64 * cw;
    const int key0 = kw0 + 16 * warp + lane / 4;  // and key0 + 8
    const float sl2 = scale * kLog2eBwd;
    float dk_acc[HP / 2], dv_acc[HP / 2];
#pragma unroll
    for (int x = 0; x < HP / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
    // per stage, in two groups: S^T = K Q^T and dP^T = V dO^T (64 keys x
    // 64 rows each); P^T is formed while dP^T runs and dV += P^T dO while
    // dS^T is formed; then dK += dS^T Q
    float s_acc[32], p_acc[32];
    uint32_t pa[4][4], da[4][4];
    if (n_iters > 0) mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int i0 = (q_first + it % per_head) * kRowStage;
      const int st = it % kBwdStages;
      const uint32_t qst = sq + st * L::kRowBytes, dost = sdo + st * L::kRowBytes;
      const float* stat = stat_ptr + st * kStatFloats;
      const bool need_mask = i0 + kRowStage > t_len || kw0 + 64 > s_len || (causal && kw0 + 63 > i0) ||
                             (window > 0 && i0 + 63 - kw0 >= window);
      mbar_wait(bar_full + 8 * st, (it / kBwdStages) & 1);
      wgmma_fence();
      ss_products<HD, 64>(s_acc, sk, kKeyTile, 64 * cw, qst, kRowStage);
      wgmma_commit();
      ss_products<HD, 64>(p_acc, sv, kKeyTile, 64 * cw, dost, kRowStage);
      wgmma_commit();
      wgmma_wait1();  // S^T done
      fence_regs<32>(s_acc);

      // P^T: element 4 i + e is key key0 + 8 (e >> 1), row i0 + 8 i + 2 quad + (e & 1)
      if (!need_mask) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * i + 2 * quad);
#pragma unroll
          for (int e = 0; e < 4; ++e) s_acc[4 * i + e] = bwd_exp2(s_acc[4 * i + e] * sl2 - ((e & 1) ? l2.y : l2.x));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * i + 2 * quad);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * i + e;
            const int row = i0 + 8 * i + 2 * quad + (e & 1), key = key0 + 8 * (e >> 1);
            const bool vis = row < t_len && visible(row, key, s_len, causal, window);
            s_acc[idx] = vis ? bwd_exp2(s_acc[idx] * sl2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
          }
        }
      }
      pack_a<64>(s_acc, pa);  // P^T in bf16, the stage's rows as k
      wgmma_fence();
      fence_regs<HP / 2>(dv_acc);
      rs_products<HD, 4>(dv_acc, pa, dost, kRowStage);  // dV += P^T dO, B MN-major
      wgmma_commit();
      wgmma_wait1();  // dP^T done
      fence_regs<32>(p_acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 dd = *reinterpret_cast<const float2*>(stat + kRowStage + 8 * i + 2 * quad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * i + e;
          p_acc[idx] = s_acc[idx] * (p_acc[idx] - ((e & 1) ? dd.y : dd.x));  // dS^T
        }
      }
      pack_a<64>(p_acc, da);
      wgmma_fence();
      fence_regs<HP / 2>(dk_acc);
      rs_products<HD, 4>(dk_acc, da, qst, kRowStage);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HP / 2>(dv_acc);
      fence_regs<HP / 2>(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // ---- epilogue: dK * scale and dV in bf16, keys < S ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= s_len) continue;
      const size_t o = (((size_t)b * s_len + key) * kv_heads + kh) * HD;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (64 * c + 8 * i >= HD) continue;  // the zero dims past hd 80
          const int idx = 32 * c + 4 * i + 2 * r;
          const int d = 64 * c + 8 * i + 2 * quad;
          *reinterpret_cast<__nv_bfloat162*>(dk + o + d) =
              __floats2bfloat162_rn(dk_acc[idx] * scale, dk_acc[idx + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + o + d) = __floats2bfloat162_rn(dv_acc[idx], dv_acc[idx + 1]);
        }
      }
    }
  }
}

// shared memory of pass 2: Q and dO of the block's 128 rows, then the
// ring's K and V stages, then the barriers; every tile 1024-aligned
template <int HD>
struct DqSmem {
  static constexpr int kRowBytes = kRowTile * box_dims<HD>() * 2;  // Q or dO
  static constexpr int kKvBytes = kKeyStage * box_dims<HD>() * 2;  // a K or V stage
  static constexpr int kQ = 0;
  static constexpr int kDo = kRowBytes;
  static constexpr int kK = 2 * kRowBytes;              // stage st at kK + st * kKvBytes
  static constexpr int kV = kK + kBwdStages * kKvBytes;
  static constexpr int kBar = kV + kBwdStages * kKvBytes;
  static constexpr int kBytes = kBar + 64 + 1024;
};

// pass 2 on the tensor cores: block = (b, query head, tile of 128 rows),
// the latest (heaviest, causal) row tiles first
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel_wgmma_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int t_len, int s_len,
                          int n_heads, int group, int causal, int window, float scale, int n_mtiles, int n_bh) {
  using L = DqSmem<HD>;
  constexpr int HP = box_dims<HD>();
  constexpr int CB = HP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ, sdo = base + L::kDo, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kBwdStages;

  const int mt = n_mtiles - 1 - (int)(blockIdx.x / n_bh);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  const int m0 = mt * kRowTile;
  int j_first, j_end;  // the 128-key tiles the block's rows see
  key_tile_range(m0, kRowTile, t_len, s_len, causal, window, kKeyStage, &j_first, &j_end);
  const int n_tiles = j_end - j_first;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * L::kRowBytes);
      for (int c = 0; c < CB; ++c) {
        tma_load_4d(sq + c * kRowTile * 128, &tm_q, bar_q, c * 64, h, m0, b);
        tma_load_4d(sdo + c * kRowTile * 128, &tm_do, bar_q, c * 64, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBwdStages;
        if (j >= kBwdStages) mbar_wait(bar_empty + 8 * st, ((j / kBwdStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kKvBytes);
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(sk + st * L::kKvBytes + c * kKeyStage * 128, &tm_k, full, c * 64, kh, (j_first + j) * kKeyStage,
                      b);
          tma_load_4d(sv + st * L::kKvBytes + c * kKeyStage * 128, &tm_v, full, c * 64, kh, (j_first + j) * kKeyStage,
                      b);
        }
      }
    }
  } else {  // ---- consumer warpgroup cw holds rows m0 + 64 cw .. + 63 ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, quad = lane % 4;
    const int r0 = m0 + 64 * cw;
    const int row0 = r0 + 16 * warp + lane / 4;  // and row0 + 8
    const int n_q = ceil_div(t_len, kRowStage);
    const float sl2 = scale * kLog2eBwd;
    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float* tile = stats + ((size_t)bh * n_q + row / kRowStage) * kStatFloats + row % kRowStage;
      lse2[r] = row < t_len ? tile[0] : 0.f;
      dd[r] = row < t_len ? tile[kRowStage] : 0.f;
    }
    float dq_acc[HP / 2];
#pragma unroll
    for (int x = 0; x < HP / 2; ++x) dq_acc[x] = 0.f;
    // per key tile, in two groups: S = Q K^T and dP = dO V^T (64 rows x
    // 128 keys each); P is formed while dP runs; then dQ += dS K
    float s_acc[kKeyStage / 2], p_acc[kKeyStage / 2];
    uint32_t da[kKeyStage / 16][4];
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kBwdStages;
      const uint32_t kst = sk + st * L::kKvBytes, vst = sv + st * L::kKvBytes;
      const int kb = (j_first + j) * kKeyStage;
      const bool need_mask = kb + kKeyStage > s_len || r0 + 64 > t_len || (causal && kb + kKeyStage - 1 > r0) ||
                             (window > 0 && r0 + 63 - kb >= window);
      mbar_wait(bar_full + 8 * st, (j / kBwdStages) & 1);
      wgmma_fence();
      ss_products<HD, kKeyStage>(s_acc, sq, kRowTile, 64 * cw, kst, kKeyStage);
      wgmma_commit();
      ss_products<HD, kKeyStage>(p_acc, sdo, kRowTile, 64 * cw, vst, kKeyStage);
      wgmma_commit();
      wgmma_wait1();  // S done
      fence_regs<kKeyStage / 2>(s_acc);

      // P: element 4 i + e is row row0 + 8 (e >> 1), key kb + 8 i + 2 quad + (e & 1)
      if (!need_mask) {
#pragma unroll
        for (int idx = 0; idx < kKeyStage / 2; ++idx) s_acc[idx] = bwd_exp2(s_acc[idx] * sl2 - lse2[(idx >> 1) & 1]);
      } else {
#pragma unroll
        for (int i = 0; i < kKeyStage / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * i + e;
            const int key = kb + 8 * i + 2 * quad + (e & 1), row = row0 + 8 * (e >> 1);
            const bool vis = row < t_len && visible(row, key, s_len, causal, window);
            s_acc[idx] = vis ? bwd_exp2(s_acc[idx] * sl2 - lse2[e >> 1]) : 0.f;
          }
        }
      }
      wgmma_wait0();  // dP done
      fence_regs<kKeyStage / 2>(p_acc);
#pragma unroll
      for (int idx = 0; idx < kKeyStage / 2; ++idx) s_acc[idx] *= p_acc[idx] - dd[(idx >> 1) & 1];  // dS
      pack_a<kKeyStage>(s_acc, da);
      wgmma_fence();
      fence_regs<HP / 2>(dq_acc);
      rs_products<HD, kKeyStage / 16>(dq_acc, da, kst, kKeyStage);  // dQ += dS K, K MN-major
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HP / 2>(dq_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // ---- epilogue: dQ * scale in bf16, rows < T ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t_len) continue;
      __nv_bfloat16* out = dq + (((size_t)b * t_len + row) * n_heads + h) * HD;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (64 * c + 8 * i >= HD) continue;  // the zero dims past hd 80
          const int idx = 32 * c + 4 * i + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + 64 * c + 8 * i + 2 * quad) =
              __floats2bfloat162_rn(dq_acc[idx] * scale, dq_acc[idx + 1] * scale);
        }
      }
    }
  }
}

// the route of a long backward: true for the tensor cores (bf16 at hd 64,
// 80 or 128), false for the CUDA cores
template <typename T, int HD>
constexpr bool long_bwd_wgmma() {
  return std::is_same<T, __nv_bfloat16>::value && (HD == 64 || HD == 80 || HD == 128);
}

// the wgmma route's three kernels on stream st
template <int HD>
int launch_long_bwd_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                          const float* lse, void* dq, void* dk, void* dv, float* stats, int b, int t, int s, int h,
                          int kvh, int causal, int window, float scale, cudaStream_t st) {
  using B16 = __nv_bfloat16;
  CUtensorMap q_rows, do_rows, k_keys, v_keys;  // pass 3: 64-row stages, the block's 128 keys
  CUtensorMap q_tile, do_tile, k_stage, v_stage;  // pass 2: the block's 128 rows, 64-key stages
  if (!make_map(&q_rows, q, b, t, h, HD, kRowStage) || !make_map(&do_rows, dout, b, t, h, HD, kRowStage) ||
      !make_map(&k_keys, k, b, s, kvh, HD, kKeyTile) || !make_map(&v_keys, v, b, s, kvh, HD, kKeyTile) ||
      !make_map(&q_tile, q, b, t, h, HD, kRowTile) || !make_map(&do_tile, dout, b, t, h, HD, kRowTile) ||
      !make_map(&k_stage, k, b, s, kvh, HD, kKeyStage) || !make_map(&v_stage, v, b, s, kvh, HD, kKeyStage)) {
    return kErrTensorMap;
  }
  constexpr int L = group_lanes<HD>();
  const int n_q = ceil_div(t, kRowStage);
  const long long n_rows = (long long)b * n_q * kRowStage * h;
  const int rpb = kLongThreads / L;
  flash_bwd_kernel_rowdot_tiled<HD><<<(unsigned)((n_rows + rpb - 1) / rpb), kLongThreads, 0, st>>>(
      (const B16*)o, (const B16*)dout, lse, stats, (int)n_rows, t, h, n_q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kdq = flash_bwd_kernel_wgmma_dq<HD>;
  auto kdkv = flash_bwd_kernel_wgmma_dkv<HD>;
  constexpr int smem_dq = DqSmem<HD>::kBytes, smem_dkv = DkvSmem<HD>::kBytes;
  if ((err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv)) != cudaSuccess)
    return (int)err;
  const int n_mtiles = ceil_div(t, kRowTile), n_ktiles = ceil_div(s, kKeyTile);
  kdq<<<(unsigned)((long long)n_mtiles * b * h), kBwdThreads, smem_dq, st>>>(
      q_tile, k_stage, v_stage, do_tile, stats, (B16*)dq, t, s, h, h / kvh, causal, window, scale, n_mtiles, b * h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kdkv<<<(unsigned)((long long)n_ktiles * b * kvh), kBwdThreads, smem_dkv, st>>>(
      q_rows, k_keys, v_keys, do_rows, stats, (B16*)dk, (B16*)dv, t, s, h, h / kvh, kvh, causal, window, scale,
      b * kvh);
  return (int)cudaGetLastError();
}

// the three kernels of a long backward on stream st; dsum is a float32
// scratch of 2 * B * H * ceil(T / 64) * 64 floats: (B, H, T) on the simt
// route, (B, H, ceil(T / 64), 2, 64) on the wgmma route.  Returns the
// first launch error.
template <typename T, int HD>
int launch_long_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, float* dsum, int b, int t, int s, int h, int kvh, int causal,
                    int window, float scale, cudaStream_t st) {
  if constexpr (long_bwd_wgmma<T, HD>()) {
    return launch_long_bwd_wgmma<HD>(q, k, v, o, dout, lse, dq, dk, dv, dsum, b, t, s, h, kvh, causal, window, scale,
                                     st);
  } else {
    constexpr int L = group_lanes<HD>();
    const int g = h / kvh;
    const int n_rows = b * t * h;
    const int rpb = kLongThreads / L;
    flash_bwd_kernel_rowdot<T, HD><<<(n_rows + rpb - 1) / rpb, kLongThreads, 0, st>>>(
        (const T*)o, (const T*)dout, dsum, n_rows, t, h);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int r = kLongThreads / L;
    const int q_tiles = (t + r - 1) / r, k_tiles = (s + r - 1) / r;
    flash_bwd_kernel_simt_dq<T, HD><<<(unsigned)((long long)q_tiles * b * h), kLongThreads, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq, t, s, h, g, kvh, causal, window,
        scale, q_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_kernel_simt_dkv<T, HD><<<(unsigned)((long long)k_tiles * b * kvh), kLongThreads, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, t, s, h, g, kvh, causal,
        window, scale, k_tiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace flash
