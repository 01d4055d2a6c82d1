// The backward of flash_attention's short path (flash_short.cuh): the
// gradients dQ, dK, dV of o = softmax(q k^T / sqrt(hd)) v for T <= 32 and
// S <= 32, causal (optionally under a sliding window: the visible keys
// of row i are max(0, i - window + 1) .. i) or full, GQA, float32 or
// bfloat16, hd 16, 32, 64 or 128.  FraudGT's training
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
// Deterministic: no atomics, every sum in a fixed order, so two launches
// give the same bits.
//
// Bound: the bytes.  Each batch element reads five slabs (Q, dO, O of
// T * H * hd, K, V of S * K * hd) and its lse, and writes three, against
// about 10 * hd flops per visible pair: at FraudGT's shape 44,064 bytes
// in and 26,112 out against 1,224 visible pairs of 160 flops.
//
// Two routes, a pure function of the shape (`short_bwd_route`, mirrored
// by `short_bwd_route` in kernels/flash_attention/ops.py):
//
// "ring", where two stages of one element's slabs fit in shared memory
// beside its p/dS buffer (every shape of FraudGT's).  The design of the
// forward's short path: persistent blocks (as many as fit on the card,
// one or two an SM) walk over the batch with a stride of the grid; one
// thread copies each element's slabs and lse with cp.async.bulk into a
// stage of an mbarrier ring of kRingStages stages, so the next elements'
// copies are in flight while this one computes.  A stage's first-pass
// rows (below) come on a barrier of their own, with k, v and the lse, so
// that phase 1 starts on them while the rest of the element arrives: the
// one overlap left where the grid covers the batch (B = 256).  The
// element then takes two phases over its staged rows, a group of 4 lanes
// per row (8 at hd 128), each lane holding interleaved chunks of 4 dims,
// so that a quarter-warp's 16-byte loads of whole rows fall on distinct
// banks (with one lane a row, eight rows 64 bytes apart would pile four
// deep on each bank).  Passes over the rows alternate their direction,
// so that under the mask a lane's long and short loops pair up:
//   1. a group per query row (query-major, so a warp's rows share their
//      query and their loop under the mask): D from the staged dO and O, then
//      for each visible key only (causal: j <= i; the masked pairs are
//      never formed) p, dP and dS, the dQ sum in registers, and p and dS
//      into a float2 buffer in shared memory (rows S | 1 apart, so that
//      neither phase's accesses pile on one bank); dQ is stored from
//      registers;
//   2. a group per key row (key-major): over the heads of its kv group in
//      order and the rows that see it (causal: i >= j, from the last row
//      down, so the lanes of a warp read one row at a time), the dV and
//      dK sums from the buffer and the staged rows; stored from registers.
// So each visible pair's p and dS are formed once.  The float32 sums run
// on the CUDA cores: at hd 16 tensor cores would not move the bytes
// bound, and TF32 would not hold the 1e-5 tolerance.  The lse comes in
// the stage's bulk copy where its 4 * H * T bytes keep 16-byte alignment
// (H * T a multiple of 4, FraudGT's 136), else each row reads it from
// device memory.
//
// "chunked", where two stages do not fit (T = S = 32 with several heads
// of 128, long GQA groups at hd 64): one block per batch element and all
// its heads.  The block stages its Q and dO rows and the
// K and V rows as float32 in shared memory with 16-byte loads by every
// thread (O is read once per row from device memory), the row lse, and
// then runs two passes over the staged rows:
//   A. a lane group of hd / 8 lanes per query row: D, then for every key
//      p, dP, dS and the dQ sum; dQ is stored, D kept in shared memory;
//   B. a lane group per key row of each kv head: for every query row of
//      every head of its group, p, dP and dS again, the dV and dK sums.
// dK and dV are summed over the GQA group inside the block, in a fixed
// order.  When one element's rows do not fit in shared memory, the block
// takes its heads in chunks: whole kv groups where one fits, else equal
// parts of a group whose dK and dV sums carry over in shared memory.
//
// A launch the card refuses returns its error; no route stands in for
// another.
#pragma once

#include <atomic>

#include "flash_common.cuh"

namespace flash {

constexpr int kBwdSmemMax = 232448;    // shared memory a block can use (227 KB)

// ---- the ring route ---------------------------------------------------

constexpr int kRingStages = 2;        // ring depth, where it fits
constexpr int kRingMaxThreads = 512;  // threads a block, at most
constexpr int kRingHeader = 128;      // bytes of barriers before the p/dS buffer

// lanes that hold a row: 4 (8 at hd 128), so that a lane holds hd / 4L
// chunks of 4 dims, interleaved: chunk c of lane `sub` is dims
// (c * L + sub) * 4 .. + 3, and the lanes of a warp read whole rows with
// no two of a quarter-warp's 16-byte loads on one bank
__host__ __device__ constexpr int ring_lanes(int hd) { return hd == 128 ? 8 : 4; }

__host__ __device__ inline long long ring_round(long long bytes) { return (bytes + 127) / 128 * 128; }

// bytes of one stage: one element's q, dO, o, k and v slabs in the inputs'
// type, then its lse, rounded up to 128
__host__ __device__ inline long long ring_stage_bytes(int t, int s, int h, int kvh, int hd, int size) {
  return ring_round((3LL * t * h + 2LL * s * kvh) * hd * size + 4LL * h * t);
}

// bytes of the p/dS buffer: a float2 for every (head, row, key), the rows
// S | 1 float2s apart
__host__ __device__ inline long long ring_pds_bytes(int t, int s, int h) {
  return ring_round(8LL * h * t * (s | 1));
}

// the ring's stages at this shape: kRingStages where they fit beside the
// buffer, else as many as fit; 0 (the chunked route) where two do not
inline int ring_stages(int t, int s, int h, int kvh, int hd, int size) {
  const long long room = kBwdSmemMax - kRingHeader - ring_pds_bytes(t, s, h);
  const long long n = room / ring_stage_bytes(t, s, h, kvh, hd, size);
  return n < 2 ? 0 : (n < kRingStages ? (int)n : kRingStages);
}

// 4 dims in float32 or bfloat16
template <typename T>
struct Io4;

template <>
struct Io4<float> {
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Io4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(in[0], in[1]);
    h[1] = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// a lane's chunks of a row (see ring_lanes)
template <typename T, int L, int NC>
__device__ __forceinline__ void load_lane(const T* row, int sub, float* out) {
#pragma unroll
  for (int c = 0; c < NC; ++c) Io4<T>::load(row + (c * L + sub) * 4, out + 4 * c);
}

template <typename T, int L, int NC>
__device__ __forceinline__ void store_lane(T* row, int sub, const float* in) {
#pragma unroll
  for (int c = 0; c < NC; ++c) Io4<T>::store(row + (c * L + sub) * 4, in + 4 * c);
}

// a lane's part of a dot product, two interleaved partial sums
template <int N>
__device__ __forceinline__ float dot_lane(const float* a, const float* b) {
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int x = 0; x < N; x += 2) {
    d0 = fmaf(a[x], b[x], d0);
    d1 = fmaf(a[x + 1], b[x + 1], d1);
  }
  return d0 + d1;
}

// the sum over a row's group of L lanes; `mask` names the group's lanes,
// which run the same loops (other groups of the warp may have left)
template <int L>
__device__ __forceinline__ float group_sum(float d, unsigned mask) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) d += __shfl_xor_sync(mask, d, off);
  return d;
}

// the row (or key row) that slot `s` takes in pass `pass` of a set of
// `n_all` taken `slots` at a time: ascending in even passes, descending
// in odd ones, so that under the causal mask a slot's long and short
// loops pair up; -1 where the pass has no row for the slot
__device__ __forceinline__ int ring_slot_row(int s, int pass, int slots, int n_all) {
  const int r0 = pass * slots;
  const int n = min(slots, n_all - r0);
  if (s >= n) return -1;
  return pass & 1 ? r0 + n - 1 - s : r0 + s;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRingMaxThreads)
flash_bwd_kernel_ring(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                      T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int n_b, int t_len, int s_len,
                      int n_heads, int group, int kv_heads, int causal, int window, float scale, int stages,
                      int lse_bulk) {
  constexpr int L = ring_lanes(HD);  // lanes per row
  constexpr int NC = HD / (4 * L);   // chunks of 4 dims a lane holds
  constexpr int N = 4 * NC;          // dims a lane holds
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float2* pds = reinterpret_cast<float2*>(smem + kRingHeader);
  unsigned char* ring = smem + kRingHeader + ring_pds_bytes(t_len, s_len, n_heads);
  const long long stage_bytes = ring_stage_bytes(t_len, s_len, n_heads, kv_heads, HD, (int)sizeof(T));
  const int ld = s_len | 1;
  const int q_elems = t_len * n_heads * HD;
  const int kv_elems = s_len * kv_heads * HD;
  const uint32_t q_bytes = q_elems * sizeof(T), kv_bytes = kv_elems * sizeof(T);
  const uint32_t lse_bytes = 4u * n_heads * t_len;
  const int rows = t_len * n_heads, keys = s_len * kv_heads;
  const int slots = blockDim.x / L;
  // the q, dO and o rows of the first pass of phase 1 (query-major, so the
  // slabs' first rows) arrive on a barrier of their own, with k, v and
  // the lse: that pass starts while the other rows are still in flight
  const int rows_a = min(rows, slots);
  const uint32_t a_bytes = rows_a * HD * sizeof(T);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2 * stages; ++b) mbar_init(smem_u32(bars + b), 1);
    mbar_fence_init();
  }
  __syncthreads();
  // thread 0: element e's slabs (q, dO, o, k, v, and the lse where it
  // keeps its alignment) into stage st, on the stage's two barriers:
  // 2 st (k, v, the lse, the first pass's rows) and 2 st + 1 (the rest)
  auto fetch = [&](int e, int st) {
    const uint32_t bar_a = smem_u32(bars + 2 * st), bar_b = smem_u32(bars + 2 * st + 1);
    const uint32_t dst = smem_u32(ring + st * stage_bytes);
    const T* src[3] = {q + (size_t)e * q_elems, dout + (size_t)e * q_elems, o + (size_t)e * q_elems};
    mbar_expect_tx(bar_a, 3 * a_bytes + 2 * kv_bytes + (lse_bulk ? lse_bytes : 0));
    mbar_expect_tx(bar_b, 3 * (q_bytes - a_bytes));
    bulk_g2s(dst + 3 * q_bytes, k + (size_t)e * kv_elems, kv_bytes, bar_a);
    bulk_g2s(dst + 3 * q_bytes + kv_bytes, v + (size_t)e * kv_elems, kv_bytes, bar_a);
    if (lse_bulk) bulk_g2s(dst + 3 * q_bytes + 2 * kv_bytes, lse + (size_t)e * n_heads * t_len, lse_bytes, bar_a);
    for (int x = 0; x < 3; ++x) bulk_g2s(dst + x * q_bytes, src[x], a_bytes, bar_a);
    if (a_bytes < q_bytes)
      for (int x = 0; x < 3; ++x)
        bulk_g2s(dst + x * q_bytes + a_bytes, src[x] + rows_a * HD, q_bytes - a_bytes, bar_b);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      const int e = blockIdx.x + st * gridDim.x;
      if (e < n_b) fetch(e, st);
    }
  }

  const int slot = threadIdx.x / L, sub = threadIdx.x % L;
  const unsigned gmask = ((1u << L) - 1) << ((threadIdx.x % 32) & ~(L - 1));
  int it = 0;
  for (int e = blockIdx.x; e < n_b; e += gridDim.x, ++it) {
    const int st = it % stages;
    const uint32_t parity = (it / stages) & 1;
    mbar_wait(smem_u32(bars + 2 * st), parity);
    const T* qs = reinterpret_cast<const T*>(ring + st * stage_bytes);
    const T* dos = qs + q_elems;
    const T* os = dos + q_elems;
    const T* ks = os + q_elems;
    const T* vs = ks + kv_elems;
    const float* lses = lse_bulk ? reinterpret_cast<const float*>(vs + kv_elems) : lse + (size_t)e * n_heads * t_len;

    // 1: a lane group per query row, row r = (query r / H, head r % H),
    // so the rows of a warp share their query and their causal loop
    for (int pass = 0; pass * slots < rows; ++pass) {
      if (pass == 1) mbar_wait(smem_u32(bars + 2 * st + 1), parity);  // the rows past the first pass
      const int rs = ring_slot_row(slot, pass, slots, rows);
      if (rs < 0) continue;
      const int i = rs / n_heads, h = rs % n_heads, kh = h / group;
      const int r = i * n_heads + h;  // the row in the slabs
      float qf[N], dof[N], acc[N];
      load_lane<T, L, NC>(dos + r * HD, sub, dof);
      float dd;
      {
        float of[N];
        load_lane<T, L, NC>(os + r * HD, sub, of);
        dd = group_sum<L>(dot_lane<N>(dof, of), gmask);
      }
      load_lane<T, L, NC>(qs + r * HD, sub, qf);
#pragma unroll
      for (int x = 0; x < N; ++x) {
        qf[x] *= scale;
        acc[x] = 0.f;
      }
      const float lr = lses[h * t_len + i];
      const int n_keys = causal ? min(i + 1, s_len) : s_len;
      const int j_first = window > 0 && i - window + 1 > 0 ? i - window + 1 : 0;  // the window's first key
      float2* prow = pds + r * ld;
      for (int j = j_first; j < n_keys; ++j) {
        float kf[N], vf[N];
        load_lane<T, L, NC>(ks + (j * kv_heads + kh) * HD, sub, kf);
        load_lane<T, L, NC>(vs + (j * kv_heads + kh) * HD, sub, vf);
        const float sc = group_sum<L>(dot_lane<N>(qf, kf), gmask);
        const float dp = group_sum<L>(dot_lane<N>(dof, vf), gmask);
        const float p = expf(sc - lr);
        const float ds = p * (dp - dd);
#pragma unroll
        for (int x = 0; x < N; ++x) acc[x] = fmaf(ds, kf[x], acc[x]);
        if (sub == 0) prow[j] = make_float2(p, ds);
      }
#pragma unroll
      for (int x = 0; x < N; ++x) acc[x] *= scale;
      store_lane<T, L, NC>(dq + (size_t)e * q_elems + r * HD, sub, acc);
    }
    mbar_wait(smem_u32(bars + 2 * st + 1), parity);  // phase 2 reads every row
    __syncthreads();  // every p and dS of the element is in the buffer

    // 2: a lane group per key row, key row c = (key c / K, kv head c % K)
    for (int pass = 0; pass * slots < keys; ++pass) {
      const int cs = ring_slot_row(slot, pass, slots, keys);
      if (cs < 0) continue;
      const int j = cs / kv_heads, kh = cs % kv_heads;
      const int c = j * kv_heads + kh;  // the key row in the slabs
      const int i_first = causal ? j : 0;
      const int i_last = window > 0 && j + window - 1 < t_len - 1 ? j + window - 1 : t_len - 1;  // its last row
      float dka[N], dva[N];
#pragma unroll
      for (int x = 0; x < N; ++x) dka[x] = dva[x] = 0.f;
      for (int g = 0; g < group; ++g) {
        const int h = kh * group + g;
        for (int i = i_last; i >= i_first; --i) {
          const int r = i * n_heads + h;
          const float2 pd = pds[r * ld + j];  // (p, dS)
          float qf[N], dof[N];
          load_lane<T, L, NC>(qs + r * HD, sub, qf);
          load_lane<T, L, NC>(dos + r * HD, sub, dof);
#pragma unroll
          for (int x = 0; x < N; ++x) {
            dva[x] = fmaf(pd.x, dof[x], dva[x]);
            dka[x] = fmaf(pd.y, qf[x], dka[x]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < N; ++x) dka[x] *= scale;
      store_lane<T, L, NC>(dk + (size_t)e * kv_elems + c * HD, sub, dka);
      store_lane<T, L, NC>(dv + (size_t)e * kv_elems + c * HD, sub, dva);
    }
    __syncthreads();  // every row is done with stage st and the buffer
    if (threadIdx.x == 0 && e + stages * (int)gridDim.x < n_b) fetch(e + stages * gridDim.x, st);
  }
}

// the ring's launch configuration at this shape: threads (as few passes
// over the rows and keys as kRingMaxThreads allows, as even as whole
// warps make them), dynamic shared memory, and the blocks resident on the
// card; returns a CUDA error or 0
template <typename T, int HD>
int ring_config(int t, int s, int h, int kvh, int stages, int* threads, size_t* smem, long long* resident) {
  constexpr int L = ring_lanes(HD);
  *smem = kRingHeader + ring_pds_bytes(t, s, h) + stages * ring_stage_bytes(t, s, h, kvh, HD, (int)sizeof(T));
  const int lanes = (t * h > s * kvh ? t * h : s * kvh) * L;
  const int passes = (lanes + kRingMaxThreads - 1) / kRingMaxThreads;
  *threads = ((lanes + passes - 1) / passes + 31) / 32 * 32;
  auto kern = flash_bwd_kernel_ring<T, HD>;
  // kept per instance for the last configuration asked: FraudGT's fit asks
  // one three times a step
  static std::atomic<unsigned long long> cache{0};  // smem << 32 | threads << 16 | resident
  const unsigned long long key = ((unsigned long long)*smem << 32) | ((unsigned long long)*threads << 16);
  const unsigned long long hit = cache.load(std::memory_order_relaxed);
  *resident = (hit & ~0xFFFFull) == key ? (long long)(hit & 0xFFFF) : 0;
  if (*resident > 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, *threads, *smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *resident = (long long)sms * per_sm;
  if (*resident < 0xFFFF) cache.store(key | (unsigned long long)*resident, std::memory_order_relaxed);
  return 0;
}

template <typename T, int HD>
int launch_ring_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, int b, int t, int s, int h, int kvh, int causal, int window,
                    float scale, int stages, cudaStream_t st) {
  int threads = 0;
  size_t smem = 0;
  long long resident = 0;
  const int err = ring_config<T, HD>(t, s, h, kvh, stages, &threads, &smem, &resident);
  if (err != 0) return err;
  const int grid = (int)(b < resident ? b : resident);
  const int lse_bulk = (h * t) % 4 == 0 && reinterpret_cast<uintptr_t>(lse) % 16 == 0;
  flash_bwd_kernel_ring<T, HD><<<grid, threads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, (T*)dq, (T*)dk, (T*)dv, b, t, s, h,
      h / kvh, kvh, causal, window, scale, stages, lse_bulk);
  return (int)cudaGetLastError();
}

// the blocks a short-backward launch at this shape runs: the persistent
// grid, min(B, the blocks resident on the card), on the ring route, one
// block an element on the chunked one; negative where the card refuses
template <typename T, int HD>
long long short_bwd_grid(int b, int t, int s, int h, int kvh) {
  const int stages = ring_stages(t, s, h, kvh, HD, (int)sizeof(T));
  if (stages == 0) return b;
  int threads = 0;
  size_t smem = 0;
  long long resident = 0;
  if (ring_config<T, HD>(t, s, h, kvh, stages, &threads, &smem, &resident) != 0) return -1;
  return b < resident ? b : resident;
}

// ---- the chunked route ---------------------------------------------------

constexpr int kBwdDPL = 8;             // head dims a lane holds
constexpr int kBwdMaxThreads = 512;    // threads a block, at most

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
                       int n_heads, int group, int kv_heads, int causal, int window, float scale, int hc) {
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
        const float p = visible(i, j, s_len, causal, window) ? expf(sc - lr) : 0.f;
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
          const float p = visible(i, j, s_len, causal, window) ? expf(sc - lses[r]) : 0.f;
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
int launch_chunked_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                       const float* lse, void* dq, void* dk, void* dv, int b, int t, int s, int h, int kvh,
                       int causal, int window, float scale, cudaStream_t st) {
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
                                 (T*)dk, (T*)dv, t, s, h, g, kvh, causal, window, scale, hc);
  return (int)cudaGetLastError();
}

// one launch of the short backward, on the route `short_bwd_route` names
template <typename T, int HD>
int launch_short_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                     const float* lse, void* dq, void* dk, void* dv, int b, int t, int s, int h, int kvh,
                     int causal, int window, float scale, cudaStream_t st) {
  const int stages = ring_stages(t, s, h, kvh, HD, (int)sizeof(T));
  if (stages > 0)
    return launch_ring_bwd<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, b, t, s, h, kvh, causal, window, scale, stages,
                                  st);
  return launch_chunked_bwd<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, b, t, s, h, kvh, causal, window, scale, st);
}

}  // namespace flash
