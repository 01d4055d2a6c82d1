// Path A of flash_attention.cu: short sequences (T <= 32 and S <= 32),
// float32 or bfloat16, any head size the kernel takes, GQA included.
// FraudGT's only shape is here: B = 1,024 edges, T = S = 17, H = K = 8,
// hd 16, float32, causal.
//
// Bound: the bytes.  Each batch element's q, k and v are contiguous slabs
// (T*H*hd and S*K*hd elements), and the work per element is ~4*hd flops
// per (row, key) pair, far below the bytes at 17 keys.  So the design is
// about moving the slabs: persistent blocks (as many as fit on the card,
// one or two per SM) walk over b; one thread copies each element's three
// slabs into shared memory with cp.async.bulk (1-d TMA, no tensor map)
// completing on an mbarrier, into a ring of up to 3 stages, so that the
// next elements' copies are in flight while this one's softmax runs.
// The output rows go back as 16-byte stores from registers.
//
// Rows are taken head-major (row r is head r / T, query r % T), so the
// rows of one warp mostly share a kv head and read the same key and
// value words, which shared memory broadcasts.  A lane group of
// hd / kShortDPL lanes holds a row (kShortDPL dims of q and of the sum
// each); a score is summed across the group with xor shuffles.  Each row
// forms exactly S scores, held in registers: the whole row fits, so one
// pass over the keys with no running-max rescale.  A row leaves the key
// loops at key S (kKeyGroup keys between exit tests: one measured
// fastest at FraudGT's shape, 4 and 8 slower; tools/flash_variants.py,
// PERF.md), and a score is two interleaved half-sums, so that its product
// chain is half as deep.  The arithmetic is the Pallas body's with the
// whole key range as one tile: q scaled first, masked scores NEG (the
// causal mask and a sliding window: keys S and up never, and key j of row
// i only if j <= i and i - j < window),
// probabilities of scores <= NEG / 2 zeroed, sums in float32, the output
// acc / max(l, 1e-30) in q's type.
//
// For training, the launch may also write each row's float32 logsumexp,
// lse = m + log(l) in (B, H, T), which the backward (flash_short_bwd.cuh)
// recomputes the probabilities from; a null pointer writes nothing.
#pragma once

#include <atomic>

#include "flash_common.cuh"

namespace flash {

constexpr int kShortMaxLen = 32;       // T and S at most this
constexpr int kShortStages = 3;        // ring depth, where it fits
constexpr int kKeyGroup = 1;           // keys a row takes between exit tests
constexpr int kShortDPL = 8;           // head dims a lane holds
constexpr int kShortMaxThreads = 512;  // threads a block, at most
constexpr int kShortHeader = 128;      // bytes of barriers before the slabs
constexpr int kSmemMax = 232448;       // shared memory a block can use (227 KB)

// bytes of one stage: one batch element's q, k and v slabs
__host__ __device__ inline long long short_stage_bytes(int t, int s, int h, int kvh, int hd, int size) {
  return ((long long)t * h + 2LL * s * kvh) * hd * size;
}

// the short path takes a shape when T and S are short and two stages fit
inline bool short_fits(int t, int s, int h, int kvh, int hd, int size) {
  return t <= kShortMaxLen && s <= kShortMaxLen &&
         kShortHeader + 2 * short_stage_bytes(t, s, h, kvh, hd, size) <= kSmemMax;
}

template <typename T>
__device__ __forceinline__ void load_dims(const T* p, float* out) {
#pragma unroll
  for (int c = 0; c < kShortDPL; c += 8) Io<T>::load8(p + c, out + c);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kShortMaxThreads)
flash_fwd_kernel_short(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, float* __restrict__ lse, int n_b, int t_len, int s_len,
                       int n_heads, int group, int kv_heads, int causal, int window, float scale, int stages) {
  constexpr int G = HD / kShortDPL;  // lanes per row
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* slabs = reinterpret_cast<T*>(smem + kShortHeader);
  const int q_elems = t_len * n_heads * HD;
  const int kv_elems = s_len * kv_heads * HD;
  const int stage_elems = q_elems + 2 * kv_elems;
  const uint32_t q_bytes = q_elems * sizeof(T), kv_bytes = kv_elems * sizeof(T);

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(smem_u32(bars + st), 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto fetch = [&](int e, int st) {  // thread 0: element e's slabs into stage st
    const uint32_t bar = smem_u32(bars + st);
    const uint32_t dst = smem_u32(slabs + (size_t)st * stage_elems);
    mbar_expect_tx(bar, q_bytes + 2 * kv_bytes);
    bulk_g2s(dst, q + (size_t)e * q_elems, q_bytes, bar);
    bulk_g2s(dst + q_bytes, k + (size_t)e * kv_elems, kv_bytes, bar);
    bulk_g2s(dst + q_bytes + kv_bytes, v + (size_t)e * kv_elems, kv_bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      const int e = blockIdx.x + st * gridDim.x;
      if (e < n_b) fetch(e, st);
    }
  }

  const int rows = t_len * n_heads;
  const int slots = blockDim.x / G;
  const int sub = threadIdx.x % G;
  int it = 0;
  for (int e = blockIdx.x; e < n_b; e += gridDim.x, ++it) {
    const int st = it % stages;
    mbar_wait(smem_u32(bars + st), (it / stages) & 1);
    const T* qs = slabs + (size_t)st * stage_elems;
    const T* ks = qs + q_elems;
    const T* vs = ks + kv_elems;
    // every lane of a warp runs the same passes (the shuffles need them):
    // a warp with no row left leaves, lanes past the last row compute on
    // it and store nothing
    for (int r0 = 0; r0 < rows; r0 += slots) {
      if (r0 + (int)(threadIdx.x / 32) * (32 / G) >= rows) break;
      int r = r0 + threadIdx.x / G;
      const bool row_ok = r < rows;
      if (!row_ok) r = rows - 1;
      const int hh = r / t_len, t = r % t_len, kh = hh / group;
      float qf[kShortDPL];
      load_dims(qs + (t * n_heads + hh) * HD + sub * kShortDPL, qf);
#pragma unroll
      for (int i = 0; i < kShortDPL; ++i) qf[i] *= scale;
      // keys in groups of kKeyGroup between uniform exit tests, the keys of
      // a group independent of each other (a key past S reads key S - 1
      // and is masked)
      float sc[kShortMaxLen];
      float m = kNeg;
#pragma unroll
      for (int j0 = 0; j0 < kShortMaxLen; j0 += kKeyGroup) {
        if (j0 >= s_len) break;
#pragma unroll
        for (int j = j0; j < j0 + kKeyGroup; ++j) {
          float kk[kShortDPL];
          load_dims(ks + ((j < s_len ? j : s_len - 1) * kv_heads + kh) * HD + sub * kShortDPL, kk);
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int i = 0; i < kShortDPL; i += 2) {
            d0 = fmaf(qf[i], kk[i], d0);
            d1 = fmaf(qf[i + 1], kk[i + 1], d1);
          }
          float d = d0 + d1;
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
          sc[j] = visible(t, j, s_len, causal, window) ? d : kNeg;
          m = fmaxf(m, sc[j]);
        }
      }
      // the Pallas step from the empty state (m = NEG, l = 0, acc = 0) over
      // one tile that holds every key: l = sum p, acc = sum p v
      float l = 0.f, acc[kShortDPL];
#pragma unroll
      for (int i = 0; i < kShortDPL; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < kShortMaxLen; j0 += kKeyGroup) {
        if (j0 >= s_len) break;
#pragma unroll
        for (int j = j0; j < j0 + kKeyGroup; ++j) {
          const float p = sc[j] > 0.5f * kNeg ? expf(sc[j] - m) : 0.f;
          l += p;
          float vv[kShortDPL];
          load_dims(vs + ((j < s_len ? j : s_len - 1) * kv_heads + kh) * HD + sub * kShortDPL, vv);
#pragma unroll
          for (int i = 0; i < kShortDPL; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
        }
      }
      if (row_ok) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
        for (int i = 0; i < kShortDPL; ++i) acc[i] *= inv;
        T* out = o + (size_t)e * q_elems + (t * n_heads + hh) * HD + sub * kShortDPL;
#pragma unroll
        for (int c = 0; c < kShortDPL; c += 8) Io<T>::store8(out + c, acc + c);
        if (lse != nullptr && sub == 0) lse[((size_t)e * n_heads + hh) * t_len + t] = m + logf(l);
      }
    }
    __syncthreads();  // every row is done reading stage st
    if (threadIdx.x == 0 && e + stages * (int)gridDim.x < n_b) fetch(e + stages * gridDim.x, st);
  }
}

template <typename T, int HD>
int launch_short(const void* q, const void* k, const void* v, void* o, float* lse, int b, int t, int s,
                 int h, int kvh, int causal, int window, float scale, cudaStream_t st) {
  const long long stage = short_stage_bytes(t, s, h, kvh, HD, (int)sizeof(T));
  const int stages = (int)((kSmemMax - kShortHeader) / stage) < kShortStages
                         ? (int)((kSmemMax - kShortHeader) / stage)
                         : kShortStages;
  const size_t smem = kShortHeader + stages * stage;
  // as few passes over the rows as kShortMaxThreads allows, as even as
  // whole warps make them
  const int lanes = t * h * (HD / kShortDPL);
  const int passes = (lanes + kShortMaxThreads - 1) / kShortMaxThreads;
  const int threads = ((lanes + passes - 1) / passes + 31) / 32 * 32;
  auto kern = flash_fwd_kernel_short<T, HD>;
  // blocks resident on the card at (threads, smem), kept per instance for
  // the last configuration asked: FraudGT asks one 3,012 times a predict
  static std::atomic<unsigned long long> cache{0};  // smem << 32 | threads << 16 | resident
  const unsigned long long key = ((unsigned long long)smem << 32) | ((unsigned long long)threads << 16);
  unsigned long long hit = cache.load(std::memory_order_relaxed);
  long long resident = (hit & ~0xFFFFull) == key ? (long long)(hit & 0xFFFF) : 0;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = (long long)sms * per_sm;
    if (resident < 0xFFFF) cache.store(key | (unsigned long long)resident, std::memory_order_relaxed);
  }
  const int grid = (int)(b < resident ? b : resident);
  kern<<<grid, threads, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse, b, t, s, h, h / kvh,
                                     kvh, causal, window, scale, stages);
  return (int)cudaGetLastError();
}

}  // namespace flash
