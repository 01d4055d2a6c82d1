// The backward of flash_attention's short path (flash_short.cuh): the
// gradients dQ, dK, dV of o = softmax(q k^T / sqrt(hd)) v for T <= 32 and
// S <= 32, causal or full, GQA, float32 or bfloat16.  FraudGT's training
// shape is here: B = 256 edges, T = S = 17, H = K = 8, hd 16, float32,
// causal.
//
// Not a TPU kernel's counterpart: the JAX package has no attention
// backward kernel (its fit differentiates the XLA attention).  It is the
// gradient of this port's forward kernel, so that FraudGT.fit runs every
// block's attention through hand-written kernels both ways.
//
// What it computes, per batch element, head h and query row i, with P
// recomputed from the forward's row logsumexp (lse, float32, (B, H, T)):
//   p_ij = exp(scale * q_i . k_j - lse_i) over the visible keys (0 masked)
//   D_i  = dO_i . O_i
//   dP_ij = dO_i . v_j,   dS_ij = p_ij (dP_ij - D_i)
//   dQ_i = scale * sum_j dS_ij k_j
//   dK_j = scale * sum_{h in the group, i} dS_ij q_i,  dV_j = sum p_ij dO_i
// with k_j, v_j of kv head h / G.  Sums in float32; outputs in q's type.
//
// Bound: the bytes at FraudGT's shape (about 5 slabs of 8.7 KB read and 3
// written per element against 17 x 17 x 8 pairs of ~4 x 16 flops each).
// Design, simple first: one block per batch element and all its heads, as
// the forward's short path.  The block stages its Q and dO rows and the K
// and V rows as float32 in shared memory with 16-byte loads by every
// thread (O is read once per row from device memory), the row lse, and
// then runs two passes over the staged rows:
//   A. a lane group of hd / 8 lanes per query row: D, then for every key
//      p, dP, dS and the dQ sum; dQ is stored, D kept in shared memory;
//   B. a lane group per key row of each kv head: for every query row of
//      every head of its group, p, dP and dS again, the dV and dK sums.
// Scores are formed as the forward forms them (q scaled first, the same
// 8-dim partial products and xor shuffles), so p matches the forward's.
// dK and dV are summed over the GQA group inside the block, in a fixed
// order: no atomics, the same bits on every run.  When one element's rows
// do not fit in shared memory (long GQA groups at wide heads), the block
// takes its heads in chunks: whole kv groups where one fits, else equal
// parts of a group whose dK and dV sums carry over in shared memory.
#pragma once

#include <atomic>

#include "flash_common.cuh"

namespace flash {

constexpr int kBwdDPL = 8;             // head dims a lane holds
constexpr int kBwdMaxThreads = 512;    // threads a block, at most
constexpr int kBwdSmemMax = 232448;    // shared memory a block can use (227 KB)

// bytes of shared memory for a chunk of hc query heads over nk kv heads:
// Q and dO rows (T * hc each), K and V rows and the dK and dV sums
// (S * nk each), all float32, and the lse and D of each query row
__host__ __device__ inline long long bwd_smem_bytes(int t, int s, int hc, int nk, int hd) {
  return 4LL * ((2LL * t * hc + 4LL * s * nk) * hd + 2LL * t * hc);
}

// the query heads a block takes at a time: all of them where they fit,
// else the most whole kv groups that fit, else the largest divisor of the
// group size that fits (always: at T = S = 32 and hd 128 one head needs
// 96.5 KB)
inline int bwd_chunk_heads(int t, int s, int h, int kvh, int hd) {
  const int g = h / kvh;
  for (int nk = kvh; nk >= 1; --nk)
    if (bwd_smem_bytes(t, s, nk * g, nk, hd) <= kBwdSmemMax) return nk * g;
  for (int hc = g; hc >= 1; --hc)
    if (g % hc == 0 && bwd_smem_bytes(t, s, hc, 1, hd) <= kBwdSmemMax) return hc;
  return 0;
}

// a dot product of 8 dims per lane summed across the row's lane group,
// in the forward's order (two interleaved half-sums, then xor shuffles);
// every lane of the warp must call it
template <int L>
__device__ __forceinline__ float group_dot(const float* a, const float* b) {
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int i = 0; i < kBwdDPL; i += 2) {
    d0 = fmaf(a[i], b[i], d0);
    d1 = fmaf(a[i + 1], b[i + 1], d1);
  }
  float d = d0 + d1;
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  return d;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdMaxThreads)
flash_bwd_kernel_short(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                       T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len,
                       int n_heads, int group, int kv_heads, int causal, float scale, int hc) {
  constexpr int L = HD / kBwdDPL;  // lanes per row
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.x;
  const bool whole = hc >= group;  // chunks of whole kv groups
  const int cap_rows = t_len * hc;
  const int cap_keys = s_len * (whole ? hc / group : 1);
  float* qs = sm;                        // (cap_rows, HD)
  float* dos = qs + cap_rows * HD;       // (cap_rows, HD)
  float* ks = dos + cap_rows * HD;       // (cap_keys, HD)
  float* vs = ks + cap_keys * HD;        // (cap_keys, HD)
  float* dks = vs + cap_keys * HD;       // (cap_keys, HD) dK sums
  float* dvs = dks + cap_keys * HD;      // (cap_keys, HD) dV sums
  float* lses = dvs + cap_keys * HD;     // (cap_rows,)
  float* ds = lses + cap_rows;           // (cap_rows,) D
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int sub = tid % L;
  const int slots = nthr / L;
  const int warp_row0 = (tid / 32) * (32 / L);  // the first slot of this warp

  for (int c = tid; c < 2 * cap_keys * HD; c += nthr) dks[c] = 0.f;  // dks, dvs
  for (int h0 = 0; h0 < n_heads; h0 += hc) {
    const int hn = min(hc, n_heads - h0);
    const int kh0 = h0 / group;
    const int nk = whole ? hn / group : 1;
    const int rows = t_len * hn, keys = s_len * nk;
    __syncthreads();  // the previous chunk is done with the staging
    // stage: query row r is head h0 + r / T, query r % T; key row c is kv
    // head kh0 + c / S, key c % S
    for (int c = tid; c < rows * L; c += nthr) {
      const int r = c / L, part = c % L;
      const size_t off = (((size_t)e * t_len + r % t_len) * n_heads + h0 + r / t_len) * HD + part * kBwdDPL;
      float x[kBwdDPL];
      Io<T>::load8(q + off, x);
      Io<float>::store8(qs + r * HD + part * kBwdDPL, x);
      Io<T>::load8(dout + off, x);
      Io<float>::store8(dos + r * HD + part * kBwdDPL, x);
    }
    for (int r = tid; r < rows; r += nthr)
      lses[r] = lse[((size_t)e * n_heads + h0 + r / t_len) * t_len + r % t_len];
    for (int c = tid; c < keys * L; c += nthr) {
      const int kr = c / L, part = c % L;
      const size_t off = (((size_t)e * s_len + kr % s_len) * kv_heads + kh0 + kr / s_len) * HD + part * kBwdDPL;
      float x[kBwdDPL];
      Io<T>::load8(k + off, x);
      Io<float>::store8(ks + kr * HD + part * kBwdDPL, x);
      Io<T>::load8(v + off, x);
      Io<float>::store8(vs + kr * HD + part * kBwdDPL, x);
    }
    __syncthreads();

    // A: a lane group per query row.  A warp whose first row is past the
    // last leaves; lanes past the last row compute on it and store nothing.
    for (int r0 = 0; r0 < rows; r0 += slots) {
      if (r0 + warp_row0 >= rows) break;
      int r = r0 + tid / L;
      const bool ok = r < rows;
      if (!ok) r = rows - 1;
      const int i = r % t_len;
      const int kk = whole ? (r / t_len) / group : 0;
      const size_t off = (((size_t)e * t_len + i) * n_heads + h0 + r / t_len) * HD + sub * kBwdDPL;
      float qf[kBwdDPL], dof[kBwdDPL], of[kBwdDPL], acc[kBwdDPL];
      Io<float>::load8(qs + r * HD + sub * kBwdDPL, qf);
      Io<float>::load8(dos + r * HD + sub * kBwdDPL, dof);
      Io<T>::load8(o + off, of);
#pragma unroll
      for (int x = 0; x < kBwdDPL; ++x) {
        qf[x] *= scale;
        acc[x] = 0.f;
      }
      const float dd = group_dot<L>(dof, of);
      const float lr = lses[r];
      for (int j = 0; j < s_len; ++j) {
        float kf[kBwdDPL], vf[kBwdDPL];
        Io<float>::load8(ks + (kk * s_len + j) * HD + sub * kBwdDPL, kf);
        Io<float>::load8(vs + (kk * s_len + j) * HD + sub * kBwdDPL, vf);
        const float sc = group_dot<L>(qf, kf);
        const float dp = group_dot<L>(dof, vf);
        const float p = (!causal || j <= i) ? expf(sc - lr) : 0.f;
        const float dsij = p * (dp - dd);
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) acc[x] = fmaf(dsij, kf[x], acc[x]);
      }
      if (ok) {
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) acc[x] *= scale;
        Io<T>::store8(dq + off, acc);
        if (sub == 0) ds[r] = dd;
      }
    }
    __syncthreads();

    // B: a lane group per key row; every kv head's key rows take the same
    // number of heads (its group, or the chunk), so the loops are uniform
    // across a warp
    const int n_h = whole ? group : hn;
    for (int c0 = 0; c0 < keys; c0 += slots) {
      if (c0 + warp_row0 >= keys) break;
      int kr = c0 + tid / L;
      const bool ok = kr < keys;
      if (!ok) kr = keys - 1;
      const int j = kr % s_len;
      const int hr0 = whole ? (kr / s_len) * group : 0;
      float kf[kBwdDPL], vf[kBwdDPL], dka[kBwdDPL], dva[kBwdDPL];
      Io<float>::load8(ks + kr * HD + sub * kBwdDPL, kf);
      Io<float>::load8(vs + kr * HD + sub * kBwdDPL, vf);
#pragma unroll
      for (int x = 0; x < kBwdDPL; ++x) dka[x] = dva[x] = 0.f;
      for (int gi = 0; gi < n_h; ++gi) {
        for (int i = 0; i < t_len; ++i) {
          const int r = (hr0 + gi) * t_len + i;
          float qf[kBwdDPL], qsc[kBwdDPL], dof[kBwdDPL];
          Io<float>::load8(qs + r * HD + sub * kBwdDPL, qf);
          Io<float>::load8(dos + r * HD + sub * kBwdDPL, dof);
#pragma unroll
          for (int x = 0; x < kBwdDPL; ++x) qsc[x] = qf[x] * scale;
          const float sc = group_dot<L>(qsc, kf);
          const float dp = group_dot<L>(dof, vf);
          const float p = (!causal || j <= i) ? expf(sc - lses[r]) : 0.f;
          const float dsij = p * (dp - ds[r]);
#pragma unroll
          for (int x = 0; x < kBwdDPL; ++x) {
            dva[x] = fmaf(p, dof[x], dva[x]);
            dka[x] = fmaf(dsij, qf[x], dka[x]);
          }
        }
      }
      if (ok) {
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) {
          dks[kr * HD + sub * kBwdDPL + x] += dka[x] * scale;
          dvs[kr * HD + sub * kBwdDPL + x] += dva[x];
        }
      }
    }
    __syncthreads();

    // the dK and dV of every kv head whose group this chunk finished
    if (whole || (h0 + hn) % group == 0) {
      for (int c = tid; c < keys * L; c += nthr) {
        const int kr = c / L, part = c % L;
        const size_t off = (((size_t)e * s_len + kr % s_len) * kv_heads + kh0 + kr / s_len) * HD + part * kBwdDPL;
        float* a = dks + kr * HD + part * kBwdDPL;
        float* b = dvs + kr * HD + part * kBwdDPL;
        Io<T>::store8(dk + off, a);
        Io<T>::store8(dv + off, b);
#pragma unroll
        for (int x = 0; x < kBwdDPL; ++x) a[x] = b[x] = 0.f;
      }
    }
  }
}

template <typename T, int HD>
int launch_short_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                     const float* lse, void* dq, void* dk, void* dv, int b, int t, int s, int h, int kvh,
                     int causal, float scale, cudaStream_t st) {
  constexpr int L = HD / kBwdDPL;
  const int hc = bwd_chunk_heads(t, s, h, kvh, HD);
  if (hc == 0) return (int)cudaErrorInvalidConfiguration;
  const int g = h / kvh;
  const int nk = hc >= g ? hc / g : 1;
  const size_t smem = (size_t)bwd_smem_bytes(t, s, hc, nk, HD);
  // one pass over the larger of the row and key sets where 512 threads
  // allow, in whole warps
  const int lanes = (t * hc > s * nk ? t * hc : s * nk) * L;
  const int threads = (lanes < kBwdMaxThreads ? (lanes + 31) / 32 * 32 : kBwdMaxThreads);
  auto kern = flash_bwd_kernel_short<T, HD>;
  static std::atomic<size_t> smem_set{0};  // the largest dynamic shared memory granted so far
  if (smem > 48 * 1024 && smem > smem_set.load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set.store(smem, std::memory_order_relaxed);
  }
  kern<<<b, threads, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, (T*)dq,
                                 (T*)dk, (T*)dv, t, s, h, g, kvh, causal, scale, hc);
  return (int)cudaGetLastError();
}

}  // namespace flash
