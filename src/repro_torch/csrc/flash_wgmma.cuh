// Path B of flash_attention.cu: long bfloat16 sequences on the tensor
// cores, at hd 64, 80 or 128 (an FA3-shaped forward).
//
// Bound: the operations, 4 * hd flops per visible (row, key) pair against
// the tensor cores' bf16 peak (989 TFLOP/s on an H100 SXM); only wgmma
// reaches that rate, so both products run there.
//
// A block owns kBM = 128 query rows of one (b, h): two consumer
// warpgroups of 64 rows each and one producer warp (288 threads).  The
// producer's lane 0 loads the block's Q once and then keeps K and V tiles
// of kBN = 128 keys in flight through a 2-stage mbarrier ring, each a TMA
// box of a 4-d tensor map over the (B, L, heads, hd) strides, so that kv
// head h / G is read in place and keys past S (or rows past T) arrive as
// zeros without crossing into the next batch element.  Boxes are 64 dims
// (128 bytes) wide with the 128-byte swizzle; hd 128 takes two per tile.
// Per key tile each consumer warpgroup:
//   - S = Q K^T by wgmma (bf16 in, float32 accumulate; Q and K K-major
//     from shared memory), hd / 16 steps of m64n128k16;
//   - the online softmax in registers in float32 with the Pallas guards
//     (masked scores NEG; probabilities of scores <= NEG / 2 zeroed;
//     alpha = exp(min(m - m_new, 0))), in base 2 with log2(e) folded into
//     the score scale; each row's 32 values a thread holds are reduced
//     across the 4 lanes of its quad, the row sum l only at the end;
//   - P to bf16 in registers: the accumulator layout of S is the A
//     operand layout of the next product, so no shared memory is used;
//   - O += P V by wgmma with P from registers and V MN-major from shared
//     memory (m64n64k16, one per 64 dims of hd), then releases the stage.
// Causal blocks stop at the last key tile their last row sees, and under
// a sliding window start at the tile that holds their first row's first
// key (first row - window + 1): at zamba2's and mixtral's prefill (T =
// 32,768, window 4,096) a block visits at most 33 of up to 256 tiles
// (key_tile_range, reported by the .cu's flash_attention_fwd_tiles).
// Only tiles that cross the diagonal, the end of S or the window's lower
// edge are masked.
// Head size 80 (zamba2-2.7b's) runs the hd-128 layout: its tensor maps
// declare 80 dims, so TMA fills dims 80-127 of the second 64-dim box
// with zeros, which add nothing to the scores or the sums; S = Q K^T takes
// the 5 k-steps of the 80 dims, O += P V both boxes (1.6 x the products
// needed there), and the epilogue stores the 80 dims.  The score scale is
// applied to the float32 scores rather than to q (scaling the bf16 q in
// place would round it again); the two agree to float32 rounding.  Blocks
// start with the heaviest query tiles, so that the causal tail is short.
// With a logsumexp pointer the epilogue also writes each row's float32
// logsumexp of the scaled, masked scores: (m + log2(l)) * ln 2, from the
// base-2 running max m and the float32 sum l (lane 0 of each quad).  That
// is a separate instance (kLse), so a forward-only launch runs the same
// code as before the logsumexp existed.
// The wgmma, descriptor and tensor-map helpers are in flash_hopper.cuh,
// shared with the long backward's wgmma route.
#pragma once

#include "flash_hopper.cuh"

namespace flash {

constexpr int kBM = 128;  // query rows a block
constexpr int kBN = 128;  // keys a tile
constexpr int kWgStages = 2;
constexpr int kWgThreads = 288;  // two consumer warpgroups and a producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgSmem {
  static constexpr int kColBlocks = box_dims<HD>() / 64;  // 128-byte-wide boxes across hd
  static constexpr int kQBytes = kBM * box_dims<HD>() * 2;
  static constexpr int kTileBytes = kBN * box_dims<HD>() * 2;  // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kWgStages * kTileBytes;
  static constexpr int kBytes = kBarOff + 64 + 1024;   // barriers, and room to align the base to 1024
};

template <int HD, bool kLse>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int t_len,
                       int s_len, int n_heads, int group, int causal, int window, float scale_log2, int n_mtiles,
                       int n_bh) {
  using L = WgSmem<HD>;
  constexpr int HP = box_dims<HD>();  // the accumulator's dims: hd over whole boxes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::kQBytes;                          // stage st: sk + st * tile
  const uint32_t sv = sk + kWgStages * L::kTileBytes;
  const uint32_t bar_q = base + L::kBarOff;
  const uint32_t bar_full = bar_q + 8;                             // kWgStages of them
  const uint32_t bar_empty = bar_full + 8 * kWgStages;

  const int m_tile = n_mtiles - 1 - (int)(blockIdx.x / n_bh);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  const int m0 = m_tile * kBM;
  int j_first, j_end;  // the key tiles the block's rows see
  key_tile_range(m0, kBM, t_len, s_len, causal, window, kBN, &j_first, &j_end);
  const int n_tiles = j_end - j_first;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kColBlocks; ++c) tma_load_4d(sq + c * kBM * 128, &tm_q, bar_q, c * 64, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kWgStages;
        const int kb = (j_first + j) * kBN;
        if (j >= kWgStages) mbar_wait(bar_empty + 8 * st, ((j / kWgStages) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kTileBytes);
        for (int c = 0; c < L::kColBlocks; ++c) {
          tma_load_4d(sk + st * L::kTileBytes + c * kBN * 128, &tm_k, bar_full + 8 * st, c * 64, kh, kb, b);
          tma_load_4d(sv + st * L::kTileBytes + c * kBN * 128, &tm_v, bar_full + 8 * st, c * 64, kh, kb, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows m0 + 64 wg .. + 63 ----
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int row0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const int wg_first_row = m0 + 64 * wg;
  float o_acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) o_acc[i] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kWgStages;
    mbar_wait(bar_full + 8 * st, (j / kWgStages) & 1);
    const uint32_t kst = sk + st * L::kTileBytes, vst = sv + st * L::kTileBytes;

    float s_acc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 dims into the 128-byte swizzled row
      const uint64_t da = smem_desc(sq + (kk / 4) * kBM * 128 + wg * 64 * 128 + off, 16, 1024);
      const uint64_t db = smem_desc(kst + (kk / 4) * kBN * 128 + off, 16, 1024);
      wgmma_ss_n128(s_acc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<kBN / 2>(s_acc);

    // scores in base 2; mask where the tile crosses the diagonal, S or
    // the window's lower edge (the warpgroup's last row, 63 past its
    // first, sees no key below its own minus window - 1)
    const int kb = (j_first + j) * kBN;
    const bool need_mask = kb + kBN > s_len || (causal && kb + kBN - 1 > wg_first_row) ||
                           (window > 0 && wg_first_row + 63 - kb >= window);
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        float sv2 = s_acc[idx] * scale_log2;
        if (need_mask) {
          const int key = kb + 8 * i + 2 * quad + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (!visible(row, key, s_len, causal, window)) sv2 = kNeg;
        }
        s_acc[idx] = sv2;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], sv2);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      alpha[r] = exp2f(fminf(m_r[r] - m_new[r], 0.f));
      m_r[r] = m_new[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const float p = s_acc[idx] > 0.5f * kNeg ? exp2f(s_acc[idx] - m_new[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        s_acc[idx] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < HP / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[4 * i + e] *= alpha[e >> 1];
    }
    // P as the A operand: k-step kk covers keys 16 kk .. 16 kk + 15
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
    }
    wgmma_fence();
    fence_regs<HP / 2>(o_acc);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < L::kColBlocks; ++c) {
        // V MN-major: 8-key groups of 1024 bytes; a k-step is two of them
        const uint64_t db = smem_desc(vst + c * kBN * 128 + kk * 2048, 1024, 1024);
        wgmma_rs_n64_tb(o_acc + 32 * c, pa[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<HP / 2>(o_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

  // ---- epilogue: o = acc / max(l, 1e-30) in bf16, rows < T ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    if constexpr (kLse) {
      const int row = row0 + 8 * r;
      if (quad == 0 && row < t_len)
        lse[((size_t)b * n_heads + h) * t_len + row] = (m_r[r] + log2f(l_r[r])) * 0.6931471805599453f;
    }
    l_r[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < t_len) {
      __nv_bfloat16* orow = o + (((size_t)b * t_len + row) * n_heads + h) * HD;
#pragma unroll
      for (int c = 0; c < L::kColBlocks; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (64 * c + 8 * i >= HD) continue;  // the zero dims past hd 80
          const int idx = 32 * c + 4 * i + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * i + 2 * quad) =
              __floats2bfloat162_rn(o_acc[idx] * l_r[r], o_acc[idx + 1] * l_r[r]);
        }
      }
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int b, int t, int s, int h, int kvh,
                 int causal, int window, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, t, h, HD, kBM) || !make_map(&tk, k, b, s, kvh, HD, kBN) ||
      !make_map(&tv, v, b, s, kvh, HD, kBN)) {
    return kErrTensorMap;
  }
  auto kern = lse != nullptr ? flash_fwd_kernel_wgmma<HD, true> : flash_fwd_kernel_wgmma<HD, false>;
  const int smem = WgSmem<HD>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_mtiles = (t + kBM - 1) / kBM;
  const long long blocks = (long long)n_mtiles * b * h;
  kern<<<(unsigned)blocks, kWgThreads, smem, st>>>(tq, tk, tv, (__nv_bfloat16*)o, lse, t, s, h, h / kvh, causal,
                                                   window, scale * kLog2e, n_mtiles, b * h);
  return (int)cudaGetLastError();
}

}  // namespace flash
