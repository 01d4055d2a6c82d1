// flash_attention for Hopper (sm_90a): fused attention forward with an
// online softmax, causal (key j visible to query i iff j <= i) or full,
// and under the causal mask optionally a sliding window (key j visible to
// row i only if i - j < window: the JAX LM's mask, src/repro/models/
// layers.py:151-152, 163-164, which mixtral and zamba2 attend with).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py (pallas_call at line 72,
// body at lines 31-59) together with its wrapper `flash_attention` in
// src/repro/kernels/flash_attention/ops.py.  It computes, per batch b,
// query head h and query row i,
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(hd)) v[b, j, h / G]
// over the visible keys j < S, with G = H / K query heads per kv head
// (GQA).  The arithmetic is the Pallas body's: q is scaled first, masked
// scores are set to NEG = -1e30, probabilities of scores <= NEG / 2 are
// zeroed (a fully masked tile then leaves the running max, sum and
// accumulator as they were), alpha = exp(min(m - m_new, 0)), sums in
// float32, and the output is acc / max(l, 1e-30) in q's type (float32 or
// bfloat16).
//
// What is not carried over from the TPU: the Pallas wrapper repeats the
// K/V heads and transposes to (B*H, T, hd), and zero-pads T and S to its
// blocks.  Here every path reads q, k, v and writes o in place in their
// (B, T, H, hd) / (B, S, K, hd) layouts, reads kv head h / G directly, and
// masks keys j >= S itself; nothing is padded or repeated, so causal rows
// i >= S see exactly the S keys (where the Pallas wrapper's zero keys
// would leak in).  The tiles are the kernel's own: the result does not
// depend on the wrapper's block arguments.
//
// One launch per call, on one of three paths chosen by shape alone
// (`plan`, mirrored by `plan` in kernels/flash_attention/ops.py):
//   A "short" (flash_short.cuh): T <= 32 and S <= 32 where two stages of
//     one batch element's slabs fit in shared memory; float32 or bf16.
//     FraudGT's shape.  Bound by the bytes; bulk copies into a ring.
//   B "wgmma" (flash_wgmma.cuh): bf16 at hd 64, 80 or 128 otherwise (hd
//     80 on the hd-128 tiles).  Bound by the operations; TMA tiles and
//     wgmma on the tensor cores.
//   C "simt" (below): everything else (float32 beyond path A, bf16 at hd
//     16 or 32 beyond it, float32 at hd 80 at every T), on the CUDA cores.
// Head size 80 (zamba2-2.7b's 2,560 / 32) never takes path A.  Under a
// window, paths B and C visit only the key tiles that hold a visible pair
// (flash::key_tile_range: from the tile of the block's first row minus
// window - 1; flash_attention_fwd_tiles reports path B's), and path A
// masks the rest of its one tile.
// A refused launch (shared memory, occupancy, tensor-map encoding)
// returns its error and nothing runs; no path falls back to another.
//
// Training: on every path the launch can also write the rows' float32
// logsumexp of the scaled, masked scores (B, H, T), and
// flash_attention_bwd_launch computes dQ, dK, dV from it: for path A's
// shapes with flash_short_bwd.cuh (its "ring" route where two stages of
// an element's slabs fit, its "chunked" route otherwise;
// `flash_attention_bwd_route`), for every other shape with
// flash_long_bwd.cuh (its "wgmma" route for bf16 at hd 64, 80 or 128,
// its "simt" route otherwise; `bwd_plan`), under the forward's mask and
// window.  A forward-only call passes no logsumexp pointer and writes
// none.
//
// Path C.  A lane group of hd / 8 lanes, rounded up to a power of two
// (16 at hd 80, the last 6 holding zeros), holds one query row: each
// lane keeps 8 of its dims of q and of the accumulator in registers, and
// a score is a dot product of 8 products per lane summed across the group
// with xor shuffles.  A block of 128 threads holds 128 / lanes rows.
// Key and value rows are staged, 32 keys at a time, into shared memory as
// float32 and read by every row of the block.  Short problems (T <= R / 2)
// pack several (b, h) problems into one block; long ones give each block
// one problem's tile of R rows.  Causal blocks stop at the last key their
// last row can see, and windowed ones start at the first key their first
// row can see.  Its products run on the CUDA cores, so at long
// sequences it sits far above the operations bound.  With a logsumexp
// pointer, lane 0 of each row's group writes m + log(l) (q was scaled
// first, so m is in the scores' own units).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or the refusal) so that the wrapper can raise.

#include "flash_common.cuh"
#include "flash_short.cuh"
#include "flash_long_bwd.cuh"
#include "flash_short_bwd.cuh"
#include "flash_wgmma.cuh"

#include <type_traits>

namespace {

using flash::Io;
using flash::kDPL;
using flash::kNeg;

constexpr int kThreads = 128;
constexpr int kBK = 32;   // keys per shared-memory tile
constexpr int kSmemBudget = 48 * 1024;

enum Path { kShort = 0, kWgmma = 1, kSimt = 2 };
enum BwdPath { kBwdShort = 0, kBwdWgmma = 1, kBwdSimt = 2 };

// dtype: 0 = float32, 1 = bfloat16
int plan(int b, int t, int s, int h, int kvh, int hd, int dtype, int causal) {
  (void)b;
  (void)causal;
  if (hd != 80 && flash::short_fits(t, s, h, kvh, hd, dtype == 1 ? 2 : 4)) return kShort;
  if (dtype == 1 && (hd == 64 || hd == 80 || hd == 128)) return kWgmma;
  return kSimt;
}

// the backward's path: the short kernel for path A's shapes, else the long
// kernels' wgmma route for bf16 at hd 64 or 128, else their simt route
int bwd_plan(int b, int t, int s, int h, int kvh, int hd, int dtype, int causal) {
  if (plan(b, t, s, h, kvh, hd, dtype, causal) == kShort) return kBwdShort;
  return dtype == 1 && (hd == 64 || hd == 80 || hd == 128) ? kBwdWgmma : kBwdSimt;
}

// grid: n_groups * q_tiles blocks; block x covers problems
// [bh0, bh0 + pb) and, in each, the query rows [tile * rpp, tile * rpp + rpp)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, int n_bh,
                 int t_len, int s_len, int n_heads, int group, int kv_heads,
                 int causal, int window, float scale, int pb, int rpp, int q_tiles) {
  constexpr int G = HD / kDPL;              // chunks of 8 dims a row (2..16)
  constexpr int GL = flash::group_lanes<HD>();  // lanes a row: G rounded up to a power of two
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (pb, kBK, HD)
  float* vs = ks + pb * kBK * HD;               // (pb, kBK, HD)

  const int tile = blockIdx.x % q_tiles;
  const int bh0 = (blockIdx.x / q_tiles) * pb;
  const int r = threadIdx.x / GL;
  const int sub = threadIdx.x % GL;
  const bool lane_ok = sub < G;  // lanes past the row's dims hold zeros and store nothing
  const int sub_c = lane_ok ? sub : 0;
  int p = r / rpp;
  const int t = tile * rpp + r % rpp;
  const bool row_ok = p < pb && bh0 + p < n_bh && t < t_len;
  if (p >= pb) p = pb - 1;  // idle lanes compute on a staged problem and store nothing

  float qf[kDPL];
  float acc[kDPL];
#pragma unroll
  for (int e = 0; e < kDPL; ++e) {
    qf[e] = 0.f;
    acc[e] = 0.f;
  }
  int64_t q_off = 0;
  if (row_ok && lane_ok) {
    const int bh = bh0 + p;
    q_off = (((int64_t)(bh / n_heads) * t_len + t) * n_heads + bh % n_heads) * HD + sub * kDPL;
    Io<T>::load8(q + q_off, qf);
#pragma unroll
    for (int e = 0; e < kDPL; ++e) qf[e] *= scale;
  }
  // the key tiles the block's rows see: causal blocks stop at their last
  // row's last key, windowed ones start at the tile of their first row's
  int kt_first, kt_end;
  flash::key_tile_range(tile * rpp, rpp, t_len, s_len, causal, window, kBK, &kt_first, &kt_end);

  float m = kNeg, l = 0.f;
  for (int j0 = kt_first * kBK; j0 < kt_end * kBK; j0 += kBK) {
    __syncthreads();  // every row is done with the previous tile
    const int n_chunks = pb * kBK * G;
    for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
      const int pp = c / (kBK * G);
      const int jj = (c / G) % kBK;
      const int ch = c % G;
      const int j = j0 + jj;
      const int bhp = bh0 + pp;
      float kv8[kDPL], vv8[kDPL];
      if (bhp < n_bh && j < s_len) {
        const int kh = (bhp % n_heads) / group;
        const int64_t off = (((int64_t)(bhp / n_heads) * s_len + j) * kv_heads + kh) * HD + ch * kDPL;
        Io<T>::load8(k + off, kv8);
        Io<T>::load8(v + off, vv8);
      } else {
#pragma unroll
        for (int e = 0; e < kDPL; ++e) kv8[e] = vv8[e] = 0.f;
      }
      const int dst = (pp * kBK + jj) * HD + ch * kDPL;
      Io<float>::store8(ks + dst, kv8);
      Io<float>::store8(vs + dst, vv8);
    }
    __syncthreads();

    const float* kr = ks + p * kBK * HD + sub_c * kDPL;
    const float* vr = vs + p * kBK * HD + sub_c * kDPL;
    float sc[kBK];
    float mt = kNeg;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      float kk[kDPL];
      Io<float>::load8(kr + jj * HD, kk);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) d = fmaf(qf[e], kk[e], d);
#pragma unroll
      for (int off = GL / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      sc[jj] = flash::visible(t, j0 + jj, s_len, causal, window) ? d : kNeg;
      mt = fmaxf(mt, sc[jj]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(fminf(m - m_new, 0.f));
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[e] *= alpha;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float pj = sc[jj] > 0.5f * kNeg ? expf(sc[jj] - m_new) : 0.f;
      ps += pj;
      float vv[kDPL];
      Io<float>::load8(vr + jj * HD, vv);
#pragma unroll
      for (int e = 0; e < kDPL; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
    }
    l = l * alpha + ps;
    m = m_new;
  }
  if (row_ok && lane_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float out[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) out[e] = acc[e] * inv;
    Io<T>::store8(o + q_off, out);
    if (lse != nullptr && sub == 0) lse[(size_t)(bh0 + p) * t_len + t] = m + logf(l);
  }
}

template <typename T, int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int b, int t,
           int s, int h, int kvh, int causal, int window, float scale, cudaStream_t st) {
  constexpr int R = kThreads / flash::group_lanes<HD>();  // query rows per block
  const int pb_max = kSmemBudget / (2 * kBK * HD * (int)sizeof(float));
  const int n_bh = b * h;
  int pb = 1, rpp = R, q_tiles = (t + R - 1) / R;
  if (2 * t <= R) {  // pack whole short problems into a block
    pb = R / t < pb_max ? R / t : pb_max;
    rpp = t;
    q_tiles = 1;
  }
  const long long blocks = (long long)((n_bh + pb - 1) / pb) * q_tiles;
  const size_t smem = 2 * (size_t)pb * kBK * HD * sizeof(float);
  flash_fwd_kernel<T, HD><<<(unsigned)blocks, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, n_bh, t, s, h, h / kvh,
      kvh, causal, window, scale, pb, rpp, q_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_path(int path, const void* q, const void* k, const void* v, void* o, float* lse, int b, int t, int s,
                int h, int kvh, int causal, int window, float scale, cudaStream_t st) {
  if constexpr (HD != 80) {  // the short path takes no hd 80: plan never sends it there
    if (path == kShort)
      return flash::launch_short<T, HD>(q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value && (HD == 64 || HD == 80 || HD == 128)) {
    if (path == kWgmma) return flash::launch_wgmma<HD>(q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
  }
  if (path != kSimt) return (int)cudaErrorInvalidValue;
  return launch_simt<T, HD>(q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
}

template <typename T>
int launch_hd(int path, const void* q, const void* k, const void* v, void* o, float* lse, int b, int t, int s,
              int h, int kvh, int hd, int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_path<T, 16>(path, q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
    case 32: return launch_path<T, 32>(path, q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
    case 64: return launch_path<T, 64>(path, q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
    case 80: return launch_path<T, 80>(path, q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
    case 128: return launch_path<T, 128>(path, q, k, v, o, lse, b, t, s, h, kvh, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
int launch_bwd_path(int path, const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, void* dq, void* dk, void* dv, float* dsum, int b, int t, int s, int h, int kvh,
                    int causal, int window, float scale, cudaStream_t st) {
  if constexpr (HD != 80) {
    if (path == kBwdShort)
      return flash::launch_short_bwd<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, b, t, s, h, kvh, causal, window,
                                            scale, st);
  }
  if (path == kBwdShort) return (int)cudaErrorInvalidValue;
  return flash::launch_long_bwd<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, dsum, b, t, s, h, kvh, causal, window,
                                       scale, st);
}

template <typename T>
int launch_bwd_hd(int path, const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, void* dq, void* dk, void* dv, float* dsum, int b, int t, int s, int h, int kvh,
                  int hd, int causal, int window, float scale, cudaStream_t st) {
#define FLASH_BWD_CASE(HD_)                                                                                       \
  case HD_:                                                                                                      \
    return launch_bwd_path<T, HD_>(path, q, k, v, o, dout, lse, dq, dk, dv, dsum, b, t, s, h, kvh, causal, window, \
                                   scale, st);
  switch (hd) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

template <typename T>
long long short_bwd_grid_hd(int b, int t, int s, int h, int kvh, int hd) {
  switch (hd) {
    case 16: return flash::short_bwd_grid<T, 16>(b, t, s, h, kvh);
    case 32: return flash::short_bwd_grid<T, 32>(b, t, s, h, kvh);
    case 64: return flash::short_bwd_grid<T, 64>(b, t, s, h, kvh);
    case 128: return flash::short_bwd_grid<T, 128>(b, t, s, h, kvh);
    default: return -1;
  }
}

}  // namespace

static bool valid(int b, int t, int s, int h, int kvh, int hd, int dtype) {
  return b > 0 && t > 0 && s > 0 && h > 0 && kvh > 0 && h % kvh == 0 &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 128) && (dtype == 0 || dtype == 1);
}

// a window (> 0) comes only with the causal mask, and every row must see a
// key: row T - 1 sees none when T > S + window - 1
static bool valid_window(int t, int s, int causal, int window) {
  return window == 0 || (window > 0 && causal && t <= s + window - 1);
}

// the path a launch at this shape takes: 0 short, 1 wgmma, 2 simt; -1 if
// the shape is refused
extern "C" int flash_attention_plan(int b, int t, int s, int h, int kvh, int hd, int dtype, int causal) {
  return valid(b, t, s, h, kvh, hd, dtype) ? plan(b, t, s, h, kvh, hd, dtype, causal) : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  window: the
// sliding window (key j visible to row i only if i - j < window), 0 for
// none.  lse, when not null, receives the rows' float32 logsumexp in (B,
// H, T), on every path.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int dtype, int b, int t, int s, int h,
                                      int kvh, int hd, int causal, int window,
                                      float scale, void* stream) {
  if (!valid(b, t, s, h, kvh, hd, dtype) || !valid_window(t, s, causal, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int path = plan(b, t, s, h, kvh, hd, dtype, causal);
  if (dtype == 0) return launch_hd<float>(path, q, k, v, o, lse, b, t, s, h, kvh, hd, causal, window, scale, st);
  return launch_hd<__nv_bfloat16>(path, q, k, v, o, lse, b, t, s, h, kvh, hd, causal, window, scale, st);
}

// the query heads a backward block takes at a time at this shape (all of
// them where one element's rows fit in shared memory); 0 if the shape is
// not the short path's and has no backward
extern "C" int flash_attention_bwd_chunk(int b, int t, int s, int h, int kvh, int hd, int dtype) {
  if (!valid(b, t, s, h, kvh, hd, dtype) || plan(b, t, s, h, kvh, hd, dtype, 1) != kShort) return 0;
  return flash::bwd_chunk_heads(t, s, h, kvh, hd);
}

// the short backward's route at this shape: 0 "ring" (its stage count in
// *stages), 1 "chunked" (*stages = 0); -1 where the shape is refused or
// its backward is not the short one
extern "C" int flash_attention_bwd_route(int b, int t, int s, int h, int kvh, int hd, int dtype, int causal,
                                         int* stages) {
  if (!valid(b, t, s, h, kvh, hd, dtype) || bwd_plan(b, t, s, h, kvh, hd, dtype, causal) != kBwdShort) return -1;
  *stages = flash::ring_stages(t, s, h, kvh, hd, dtype == 1 ? 2 : 4);
  return *stages > 0 ? 0 : 1;
}

// the blocks a short-backward launch at this shape runs on this card: the
// ring's persistent grid, min(B, the blocks resident), or B on the chunked
// route; -1 where the shape is refused, is not the short backward's, or
// the card refuses its configuration
extern "C" long long flash_attention_bwd_grid(int b, int t, int s, int h, int kvh, int hd, int dtype) {
  if (!valid(b, t, s, h, kvh, hd, dtype) || plan(b, t, s, h, kvh, hd, dtype, 1) != kShort) return -1;
  return dtype == 0 ? short_bwd_grid_hd<float>(b, t, s, h, kvh, hd)
                    : short_bwd_grid_hd<__nv_bfloat16>(b, t, s, h, kvh, hd);
}

// the backward's path at this shape: 0 short, 1 wgmma, 2 simt; -1 if the
// shape is refused
extern "C" int flash_attention_bwd_plan(int b, int t, int s, int h, int kvh, int hd, int dtype, int causal) {
  return valid(b, t, s, h, kvh, hd, dtype) ? bwd_plan(b, t, s, h, kvh, hd, dtype, causal) : -1;
}

// the backward of the forward at any shape it takes: dq (B, T, H, hd), dk
// and dv (B, S, K, hd) in the inputs' dtype, from q, k, v, the forward's o
// and lse, and the output gradient dout, under the forward's mask and
// window.  dsum is a float32 scratch of 2 * B * H * ceil(T / 64) * 64
// floats for the long paths (unused, and may be null, on the short one).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                          const void* dout, const float* lse, void* dq, void* dk, void* dv,
                                          float* dsum, int dtype, int b, int t, int s, int h, int kvh, int hd,
                                          int causal, int window, float scale, void* stream) {
  if (!valid(b, t, s, h, kvh, hd, dtype) || !valid_window(t, s, causal, window)) return (int)cudaErrorInvalidValue;
  const int path = bwd_plan(b, t, s, h, kvh, hd, dtype, causal);
  if (path != kBwdShort && dsum == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_hd<float>(path, q, k, v, o, dout, lse, dq, dk, dv, dsum, b, t, s, h, kvh, hd, causal, window,
                                scale, st);
  return launch_bwd_hd<__nv_bfloat16>(path, q, k, v, o, dout, lse, dq, dk, dv, dsum, b, t, s, h, kvh, hd, causal,
                                      window, scale, st);
}

// the wgmma route's tile loops at this shape (a pure function of T, S, the
// mask and the window): [q_first[kt], q_end[kt]) the 64-row query tiles
// that the dK/dV block of 128-key tile kt visits (both ceil(T / 64) when
// none), for the ceil(S / 128) key tiles; [k_first[mt], k_end[mt]) the
// 128-key tiles that the dQ block of 128-row query tile mt visits, for
// the ceil(T / 128) row tiles.  Returns -1 for a refused length or window.
extern "C" int flash_attention_bwd_tiles(int t, int s, int causal, int window, int* q_first, int* q_end,
                                         int* k_first, int* k_end) {
  if (t <= 0 || s <= 0 || !valid_window(t, s, causal, window)) return -1;
  for (int kt = 0; kt < flash::ceil_div(s, flash::kKeyTile); ++kt)
    flash::row_tile_range(kt * flash::kKeyTile, flash::kKeyTile, t, s, causal, window, flash::kRowStage,
                          q_first + kt, q_end + kt);
  for (int mt = 0; mt < flash::ceil_div(t, flash::kRowTile); ++mt)
    flash::key_tile_range(mt * flash::kRowTile, flash::kRowTile, t, s, causal, window, flash::kKeyStage,
                          k_first + mt, k_end + mt);
  return 0;
}

// the wgmma forward's tile loop at this shape: [first[mt], end[mt]) the
// 128-key tiles that the block of 128-row query tile mt visits, for the
// ceil(T / 128) row tiles.  Returns -1 for a refused length or window.
extern "C" int flash_attention_fwd_tiles(int t, int s, int causal, int window, int* first, int* end) {
  if (t <= 0 || s <= 0 || !valid_window(t, s, causal, window)) return -1;
  for (int mt = 0; mt < flash::ceil_div(t, flash::kBM); ++mt)
    flash::key_tile_range(mt * flash::kBM, flash::kBM, t, s, causal, window, flash::kBN, first + mt, end + mt);
  return 0;
}
