// The backward of flash_attention's long paths (every shape that is not
// the short path's: T or S above 32, or a short shape whose slabs do not
// fit): the gradients dQ, dK, dV of o = softmax(q k^T / sqrt(hd)) v,
// causal or full, GQA, T != S, float32 or bfloat16, hd 16/32/64/128.
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
//           (key j visible to row i iff j < S, and j <= i when causal)
//   D_i   = dO_i . O_i
//   dS_ij = p_ij (dO_i . v_j - D_i)
//   dQ_i  = scale * sum_j dS_ij k_j
//   dK_j  = scale * sum_{h in the group, i} dS_ij q_i,   dV_j = sum p_ij dO_i
// with k_j, v_j of kv head h / G.  Sums in float32; outputs in q's type.
//
// Bound: the operations.  Counted work is 5 products of 2 * hd flops per
// visible (row, key) pair; at the training launch 0.52 TFLOP against the
// bf16 tensor-core peak.  Design, simple first, deterministic (no
// atomics: two launches give the same bits), three kernels a call:
//   1. D = rowsum(dO * O) into a float32 (B, H, T) scratch the wrapper
//      allocates (a lane group of hd / 8 lanes per row);
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
//   "mma"  (bf16 at hd 64 or 128): warp-level mma.sync.m16n8k16 on the
//          tensor cores, bf16 operands and float32 sums.  Tiles of 64
//          rows and 64 keys, one warp per 16 rows (keys in pass 3), staged
//          into shared memory with rows padded by 16 bytes so that
//          ldmatrix reads them without bank conflicts.  P and dS stay in
//          registers: the accumulator layout of one product is the A
//          operand layout of the next.  P and dS are rounded to bf16 for
//          the products, as the forward rounds P.
//   "simt" (the rest: float32, and bf16 at hd 16 or 32): the CUDA cores,
//          a lane group of hd / 8 lanes per row holding 8 dims each, the
//          other side staged 32 rows at a time into shared memory as
//          float32; scores formed as the forward's simt path forms them
//          (q scaled first, 8-dim partial products, xor shuffles).
// wgmma, TMA and warp specialisation are left for later work.
#pragma once

#include "flash_common.cuh"
#include "flash_short_bwd.cuh"

#include <type_traits>

namespace flash {

constexpr int kLongThreads = 128;
constexpr int kSimtRows = 32;  // rows of the staged side on the simt route
constexpr int kMmaTile = 64;   // rows and keys of a tile on the mma route
constexpr float kLog2eBwd = 1.4426950408889634f;

// ---- pass 1: D = rowsum(dO * O), (B, T, H, hd) rows -> (B, H, T) ----
template <typename T, int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
                        int n_rows, int t_len, int n_heads) {
  constexpr int L = HD / kBwdDPL;
  const int r = blockIdx.x * (kLongThreads / L) + threadIdx.x / L;
  const int sub = threadIdx.x % L;
  const bool ok = r < n_rows;
  float a[kBwdDPL], b[kBwdDPL];
  if (ok) {
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
                         int group, int kv_heads, int causal, float scale, int q_tiles) {
  constexpr int L = HD / kBwdDPL;
  constexpr int R = kLongThreads / L;  // query rows a block
  __shared__ __align__(16) float ks[kSimtRows * HD];
  __shared__ __align__(16) float vs[kSimtRows * HD];
  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  const int sub = threadIdx.x % L;
  const int i_raw = tile * R + threadIdx.x / L;
  const bool ok = i_raw < t_len;
  const int i = ok ? i_raw : t_len - 1;  // lanes past the last row compute on it and store nothing
  const size_t off = (((size_t)b * t_len + i) * n_heads + h) * HD + sub * kBwdDPL;
  float qf[kBwdDPL], dof[kBwdDPL], acc[kBwdDPL];
  Io<T>::load8(q + off, qf);
  Io<T>::load8(dout + off, dof);
#pragma unroll
  for (int x = 0; x < kBwdDPL; ++x) {
    qf[x] *= scale;
    acc[x] = 0.f;
  }
  const float lr = lse[(size_t)bh * t_len + i];
  const float dd = dsum[(size_t)bh * t_len + i];
  const int t_last = min(t_len - 1, tile * R + R - 1);
  const int kv_end = causal ? min(s_len, t_last + 1) : s_len;
  for (int j0 = 0; j0 < kv_end; j0 += kSimtRows) {
    __syncthreads();  // every row is done with the previous tile
    for (int c = threadIdx.x; c < kSimtRows * L; c += kLongThreads) {
      const int jj = c / L, ch = c % L, j = j0 + jj;
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
      Io<float>::load8(ks + jj * HD + sub * kBwdDPL, kx);
      Io<float>::load8(vs + jj * HD + sub * kBwdDPL, vx);
      const float sc = group_dot<L>(qf, kx);
      const float dp = group_dot<L>(dof, vx);
      const int j = j0 + jj;
      const float p = (!causal || j <= i) ? expf(sc - lr) : 0.f;
      const float ds = p * (dp - dd);
#pragma unroll
      for (int x = 0; x < kBwdDPL; ++x) acc[x] = fmaf(ds, kx[x], acc[x]);
    }
  }
  if (ok) {
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
                          int s_len, int n_heads, int group, int kv_heads, int causal, float scale, int k_tiles) {
  constexpr int L = HD / kBwdDPL;
  constexpr int R = kLongThreads / L;  // keys a block
  __shared__ __align__(16) float qs[kSimtRows * HD];
  __shared__ __align__(16) float dos[kSimtRows * HD];
  __shared__ float ls[kSimtRows], dsm[kSimtRows];
  const int tile = blockIdx.x % k_tiles;
  const int bkh = blockIdx.x / k_tiles;
  const int b = bkh / kv_heads, kh = bkh % kv_heads;
  const int sub = threadIdx.x % L;
  const int j_raw = tile * R + threadIdx.x / L;
  const bool ok = j_raw < s_len;
  const int j = ok ? j_raw : s_len - 1;
  const size_t off = (((size_t)b * s_len + j) * kv_heads + kh) * HD + sub * kBwdDPL;
  float kf[kBwdDPL], vf[kBwdDPL], dka[kBwdDPL], dva[kBwdDPL];
  Io<T>::load8(k + off, kf);
  Io<T>::load8(v + off, vf);
#pragma unroll
  for (int x = 0; x < kBwdDPL; ++x) dka[x] = dva[x] = 0.f;
  const int i_begin = causal ? tile * R : 0;  // the first row that sees any of the block's keys
  for (int gi = 0; gi < group; ++gi) {
    const int h = kh * group + gi;
    const size_t bh = (size_t)b * n_heads + h;
    for (int i0 = i_begin; i0 < t_len; i0 += kSimtRows) {
      __syncthreads();  // every key is done with the previous rows
      for (int c = threadIdx.x; c < kSimtRows * L; c += kLongThreads) {
        const int ii = c / L, ch = c % L, i = i0 + ii;
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
      const int n = min(kSimtRows, t_len - i0);
      for (int ii = 0; ii < n; ++ii) {
        float qx[kBwdDPL], qsc[kBwdDPL], dx[kBwdDPL];
        Io<float>::load8(qs + ii * HD + sub * kBwdDPL, qx);
        Io<float>::load8(dos + ii * HD + sub * kBwdDPL, dx);
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) qsc[x] = qx[x] * scale;
        const float sc = group_dot<L>(qsc, kf);
        const float dp = group_dot<L>(dx, vf);
        const float p = (!causal || j <= i0 + ii) ? expf(sc - ls[ii]) : 0.f;
        const float ds = p * (dp - dsm[ii]);
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) {
          dva[x] = fmaf(p, dx[x], dva[x]);
          dka[x] = fmaf(ds, qx[x], dka[x]);
        }
      }
    }
  }
  if (ok) {
#pragma unroll
    for (int x = 0; x < kBwdDPL; ++x) dka[x] *= scale;
    Io<T>::store8(dk + off, dka);
    Io<T>::store8(dv + off, dva);
  }
}

// ---- mma route: warp-level tensor-core products (bf16 in, float32 sums) ----

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// C (16 x 8, float32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// the A operand of k-step kk from two accumulator tiles of 16 x 8 (n
// blocks 2 kk and 2 kk + 1): the accumulator layout is the A layout
__device__ __forceinline__ void acc_to_a(float (*c)[4], int kk, uint32_t* a) {
  a[0] = pack2_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int HD>
struct MmaSmem {
  static constexpr int kLd = HD + 8;                       // a row, padded by 16 bytes
  static constexpr int kTile = kMmaTile * kLd;             // elements of one staged tile
  static constexpr int kBytes = 4 * kTile * 2 + 2 * kMmaTile * 4;  // four tiles, and two float rows
};

// rows [0, n_valid) of a tile of kMmaTile rows from device memory (row r
// at src + r * stride) into padded shared memory; rows past n_valid are
// zeros
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, size_t stride,
                                           int n_valid) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < kMmaTile * CH; c += kLongThreads) {
    const int r = c / CH, x = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + x * 8);
    *reinterpret_cast<uint4*>(dst + r * MmaSmem<HD>::kLd + x * 8) = val;
  }
}

// pass 2 on the tensor cores: block = (b, h, tile of 64 rows), one warp
// per 16 rows; heaviest (latest causal) tiles first
template <int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_mma_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int t_len, int s_len, int n_heads, int group, int kv_heads,
                        int causal, float scale, int q_tiles, int n_bh) {
  using M = MmaSmem<HD>;
  constexpr int LD = M::kLd;
  extern __shared__ __align__(16) unsigned char smem_lbwd[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_lbwd);
  __nv_bfloat16* dos = qs + M::kTile;
  __nv_bfloat16* ks = dos + M::kTile;
  __nv_bfloat16* vs = ks + M::kTile;
  const int m_tile = q_tiles - 1 - (int)(blockIdx.x / n_bh);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  const int i0 = m_tile * kMmaTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  stage_rows<HD>(qs, q + (((size_t)b * t_len + i0) * n_heads + h) * HD, (size_t)n_heads * HD, t_len - i0);
  stage_rows<HD>(dos, dout + (((size_t)b * t_len + i0) * n_heads + h) * HD, (size_t)n_heads * HD, t_len - i0);
  float lse2[2], dd[2];
  int row_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_i[r] = i0 + warp * 16 + g + 8 * r;
    const bool in = row_i[r] < t_len;
    lse2[r] = in ? lse[(size_t)bh * t_len + row_i[r]] * kLog2eBwd : 0.f;
    dd[r] = in ? dsum[(size_t)bh * t_len + row_i[r]] : 0.f;
  }
  const float sl2 = scale * kLog2eBwd;
  float dq_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const uint32_t qs_a = smem_u32(qs), dos_a = smem_u32(dos), ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  // lane offsets of the three ldmatrix patterns (in elements)
  const int a_off = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;             // A: 16 rows x 16
  const int b_off = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;  // B from [n][k], 2 n blocks
  const int bt_off = (lane % 16) * LD + (lane / 16) * 8;                         // B from [k][n], 2 n blocks

  const int n_keys = causal ? min(s_len, i0 + kMmaTile) : s_len;
  for (int j0 = 0; j0 < n_keys; j0 += kMmaTile) {
    __syncthreads();  // the previous key tile is done with (and the row tiles are staged)
    stage_rows<HD>(ks, k + (((size_t)b * s_len + j0) * kv_heads + kh) * HD, (size_t)kv_heads * HD, s_len - j0);
    stage_rows<HD>(vs, v + (((size_t)b * s_len + j0) * kv_heads + kh) * HD, (size_t)kv_heads * HD, s_len - j0);
    __syncthreads();
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(qs_a + 2 * (a_off + kk * 16), aq);
      ldsm_x4(dos_a + 2 * (a_off + kk * 16), ado);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(ks_a + 2 * (b_off + np * 16 * LD + kk * 16), bk);
        ldsm_x4(vs_a + 2 * (b_off + np * 16 * LD + kk * 16), bv);
        mma_16816(sc[2 * np], aq, bk[0], bk[1]);
        mma_16816(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma_16816(dp[2 * np], ado, bv[0], bv[1]);
        mma_16816(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }
    const bool need_mask = j0 + kMmaTile > s_len || (causal && j0 + kMmaTile > i0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + n * 8 + 2 * t4 + (e & 1);
        const bool vis = !need_mask || (key < s_len && (!causal || key <= row_i[e >> 1]));
        const float p = vis ? exp2f(sc[n][e] * sl2 - lse2[e >> 1]) : 0.f;
        sc[n][e] = p * (dp[n][e] - dd[e >> 1]);  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(sc, kk, a);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(ks_a + 2 * (bt_off + kk * 16 * LD + np * 16), bk);
        mma_16816(dq_acc[2 * np], a, bk[0], bk[1]);
        mma_16816(dq_acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_i[r] >= t_len) continue;
    __nv_bfloat16* out = dq + (((size_t)b * t_len + row_i[r]) * n_heads + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dq_acc[n][2 * r] * scale, dq_acc[n][2 * r + 1] * scale);
  }
}

// pass 3 on the tensor cores: block = (b, kv head, tile of 64 keys), one
// warp per 16 keys; the rows of a staged query tile are taken 32 at a time
// (two sub-steps), which keeps S^T and dP^T at 16 registers each beside
// the dK and dV sums; heaviest (earliest causal) tiles first
template <int HD>
__global__ void __launch_bounds__(kLongThreads)
flash_bwd_kernel_mma_dkv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_len, int s_len,
                         int n_heads, int group, int kv_heads, int causal, float scale, int n_bkh) {
  using M = MmaSmem<HD>;
  constexpr int LD = M::kLd;
  constexpr int NQ = 32;  // rows a sub-step
  extern __shared__ __align__(16) unsigned char smem_lbwd[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_lbwd);
  __nv_bfloat16* vs = ks + M::kTile;
  __nv_bfloat16* qs = vs + M::kTile;
  __nv_bfloat16* dos = qs + M::kTile;
  float* ls = reinterpret_cast<float*>(dos + M::kTile);
  float* dsm = ls + kMmaTile;
  const int tile = blockIdx.x / n_bkh;
  const int bkh = blockIdx.x % n_bkh;
  const int b = bkh / kv_heads, kh = bkh % kv_heads;
  const int j0 = tile * kMmaTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  stage_rows<HD>(ks, k + (((size_t)b * s_len + j0) * kv_heads + kh) * HD, (size_t)kv_heads * HD, s_len - j0);
  stage_rows<HD>(vs, v + (((size_t)b * s_len + j0) * kv_heads + kh) * HD, (size_t)kv_heads * HD, s_len - j0);
  int key_j[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_j[r] = j0 + warp * 16 + g + 8 * r;
  const float sl2 = scale * kLog2eBwd;
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const uint32_t ks_a = smem_u32(ks), vs_a = smem_u32(vs), qs_a = smem_u32(qs), dos_a = smem_u32(dos);
  const int a_off = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int b_off = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int bt_off = (lane % 16) * LD + (lane / 16) * 8;

  const int i_begin = causal ? j0 : 0;  // tiles are aligned: rows before j0 see none of the keys
  for (int gi = 0; gi < group; ++gi) {
    const int h = kh * group + gi;
    const size_t bh = (size_t)b * n_heads + h;
    for (int i0 = i_begin; i0 < t_len; i0 += kMmaTile) {
      __syncthreads();  // the previous rows are done with (and the key tiles are staged)
      stage_rows<HD>(qs, q + (((size_t)b * t_len + i0) * n_heads + h) * HD, (size_t)n_heads * HD, t_len - i0);
      stage_rows<HD>(dos, dout + (((size_t)b * t_len + i0) * n_heads + h) * HD, (size_t)n_heads * HD, t_len - i0);
      for (int c = threadIdx.x; c < kMmaTile; c += kLongThreads) {
        const int i = i0 + c;
        ls[c] = i < t_len ? lse[bh * t_len + i] * kLog2eBwd : 0.f;
        dsm[c] = i < t_len ? dsum[bh * t_len + i] : 0.f;
      }
      __syncthreads();
      const bool need_mask = i0 + kMmaTile > t_len || j0 + kMmaTile > s_len || (causal && i0 < j0 + kMmaTile);
#pragma unroll
      for (int qb = 0; qb < kMmaTile; qb += NQ) {
        if (i0 + qb >= t_len) break;  // uniform across the block
        float st[NQ / 8][4], dpt[NQ / 8][4];  // S^T, dP^T: 16 keys x NQ rows a warp
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t ak[4], av[4];
          ldsm_x4(ks_a + 2 * (a_off + kk * 16), ak);
          ldsm_x4(vs_a + 2 * (a_off + kk * 16), av);
#pragma unroll
          for (int np = 0; np < NQ / 16; ++np) {
            uint32_t bq[4], bo[4];
            ldsm_x4(qs_a + 2 * (b_off + (qb + np * 16) * LD + kk * 16), bq);
            ldsm_x4(dos_a + 2 * (b_off + (qb + np * 16) * LD + kk * 16), bo);
            mma_16816(st[2 * np], ak, bq[0], bq[1]);
            mma_16816(st[2 * np + 1], ak, bq[2], bq[3]);
            mma_16816(dpt[2 * np], av, bo[0], bo[1]);
            mma_16816(dpt[2 * np + 1], av, bo[2], bo[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = qb + n * 8 + 2 * t4 + (e & 1);  // the row within the staged tile
            const int i = i0 + c, key = key_j[e >> 1];
            const bool vis = !need_mask || (i < t_len && key < s_len && (!causal || key <= i));
            const float p = vis ? exp2f(st[n][e] * sl2 - ls[c]) : 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - dsm[c]);  // dS^T
          }
        }
#pragma unroll
        for (int kq = 0; kq < NQ / 16; ++kq) {
          uint32_t ap[4], ads[4];
          acc_to_a(st, kq, ap);
          acc_to_a(dpt, kq, ads);
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            uint32_t bo[4], bq[4];
            ldsm_x4_t(dos_a + 2 * (bt_off + (qb + kq * 16) * LD + np * 16), bo);
            ldsm_x4_t(qs_a + 2 * (bt_off + (qb + kq * 16) * LD + np * 16), bq);
            mma_16816(dv_acc[2 * np], ap, bo[0], bo[1]);
            mma_16816(dv_acc[2 * np + 1], ap, bo[2], bo[3]);
            mma_16816(dk_acc[2 * np], ads, bq[0], bq[1]);
            mma_16816(dk_acc[2 * np + 1], ads, bq[2], bq[3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key_j[r] >= s_len) continue;
    const size_t o = (((size_t)b * s_len + key_j[r]) * kv_heads + kh) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// the route of a long backward: true for the tensor cores (bf16 at hd 64
// or 128), false for the CUDA cores
template <typename T, int HD>
constexpr bool long_bwd_mma() {
  return std::is_same<T, __nv_bfloat16>::value && (HD == 64 || HD == 128);
}

// the three kernels of a long backward on stream st; dsum is a float32
// (B, H, T) scratch.  Returns the first launch error.
template <typename T, int HD>
int launch_long_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, float* dsum, int b, int t, int s, int h, int kvh, int causal,
                    float scale, cudaStream_t st) {
  constexpr int L = HD / kBwdDPL;
  const int g = h / kvh;
  const int n_rows = b * t * h;
  const int rpb = kLongThreads / L;
  flash_bwd_kernel_rowdot<T, HD><<<(n_rows + rpb - 1) / rpb, kLongThreads, 0, st>>>(
      (const T*)o, (const T*)dout, dsum, n_rows, t, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (long_bwd_mma<T, HD>()) {
    using B16 = __nv_bfloat16;
    constexpr int smem = MmaSmem<HD>::kBytes;
    auto kdq = flash_bwd_kernel_mma_dq<HD>;
    auto kdkv = flash_bwd_kernel_mma_dkv<HD>;
    if ((err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return (int)err;
    const int q_tiles = (t + kMmaTile - 1) / kMmaTile, k_tiles = (s + kMmaTile - 1) / kMmaTile;
    kdq<<<(unsigned)((long long)q_tiles * b * h), kLongThreads, smem, st>>>(
        (const B16*)q, (const B16*)k, (const B16*)v, (const B16*)dout, lse, dsum, (B16*)dq, t, s, h, g, kvh,
        causal, scale, q_tiles, b * h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    kdkv<<<(unsigned)((long long)k_tiles * b * kvh), kLongThreads, smem, st>>>(
        (const B16*)q, (const B16*)k, (const B16*)v, (const B16*)dout, lse, dsum, (B16*)dk, (B16*)dv, t, s, h,
        g, kvh, causal, scale, b * kvh);
  } else {
    const int r = kLongThreads / L;
    const int q_tiles = (t + r - 1) / r, k_tiles = (s + r - 1) / r;
    flash_bwd_kernel_simt_dq<T, HD><<<(unsigned)((long long)q_tiles * b * h), kLongThreads, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq, t, s, h, g, kvh, causal, scale,
        q_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_kernel_simt_dkv<T, HD><<<(unsigned)((long long)k_tiles * b * kvh), kLongThreads, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, t, s, h, g, kvh, causal,
        scale, k_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash
