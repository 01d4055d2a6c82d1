// hist_update for Hopper (sm_90a): the GBDT gradient/hessian histogram.
//
// Replaces the TPU kernel `hist_update_pallas` / `_kernel` in
// src/repro/kernels/hist_update/kernel.py (pallas_call at line 42).  On the
// TPU the sum is a one-hot (bn, S) matrix contracted against gh on the
// MXU; on Hopper it is a scatter-reduce, and nothing of the one-hot is
// carried over.  One device template serves two entries, which differ only
// in where an item's key comes from:
//
//   keys  hist_update_launch: item i is (keys[i], gh[i]), i < N; this is
//         the TPU kernel's contract, out[k, c] = sum of gh[i, c] over
//         keys[i] == k, and the GBDT's leaf sums.
//   rows  hist_update_rows_launch: training row i (F uint8 bins, an int32
//         node id, one float2 gh) gives F items, key
//         node[i]*F*B + f*B + xb[i, f] and value gh[i].  This is the GBDT's
//         per-level (node, feature, bin) histogram; the row is read once
//         and the key formed in registers, where the caller used to build
//         (N, F) int32 keys and repeat gh F times in device memory.
//
// Keys outside [0, S) are dropped; the result is (S, 2) float32.
//
// Bound on an H100: the bytes.  keys: N*12 + S*8 bytes against 2N
// additions; rows: N*(F + 12) + S*8 bytes against 2NF additions.  This
// kernel reads gh twice (the max pass below).
//
// Determinism.  Every value is quantised to a fixed-point int64,
// q = rint(x * 2^k), and the int64 sums, whose additions commute, are
// built with atomics; the result is Q * 2^-k rounded to float32 once.  The
// same input gives the same bits on every launch, whatever the grid, the
// cluster size or the order of the atomics.  The scale is chosen per
// column on the card, so no host sync is needed:
//   pass 1  max|gh[:, c]| over the N rows of gh (atomicMax on the float's
//           bits, exact and order-free);
//   k_c     = 61 - L - e_c with N <= 2^L and max|gh[:, c]| < 2^e_c, so the
//           sum of |q| into any key stays below 2^62: no overflow.  N is
//           the number of gh rows; in the rows entry a key takes at most
//           one item of a row, as long as every bin is below B;
//   pass 2  the int64 histogram (below);
//   pass 3  out = float(double(Q) * 2^-k).
// Error bound, per entry with n_k items: half a quantum per item plus the
// roundings of the result,
//   |out - exact| <= n_k * 2^-k_c / 2 + 2^-23 * (sum |x| + n_k * 2^-k_c / 2)
// (`repro_torch.kernels.hist_update.ops.error_bound`, `error_bound_rows`).
// gh must be finite.
//
// Pass 2 privatises the histogram in shared memory at every GBDT level.
// The int64 (S, 2) histogram takes 16 B a key; a thread-block cluster of
// c blocks holds it in their shared memory together (227 KB a block),
// each block one contiguous slice of ceil(S / c) keys.  c is the power of
// two at or above S / 14,528, so that clusters tile the H100's GPCs (of 16
// or 18 SMs) with few SMs idle.  At F = 12 and B = 256 that is c = 1
// for levels 0-2 and 2 / 4 / 8 for levels 3 / 4 / 5 (98,304 keys,
// 1.57 MB).  Each cluster reads its share of the items once and adds
// each one into the owning block's slice through distributed shared
// memory (DSMEM: `mapa` + `red.shared::cluster`, which is also the fast
// way into the block's own slice; see slice_add), between two cluster
// barriers; each
// block then adds the nonzero entries of its slice into the device
// accumulator.  Clusters above 8 blocks are non-portable; the H100 takes
// up to 16, so the shared path holds S up to 232,448 keys.  Above that,
// and only by that shape, the items add straight into the device
// histogram with 64-bit atomics (hist_global_kernel).  A cluster launch
// the card refuses is reported, not replaced by the device-memory path.
//
// Hot keys.  The GBDT's keys are skewed: most transactions have a pattern
// count of 0, so for each (node, feature) one bin takes most rows.  Before
// any atomic, the lanes of a warp that carry the same key combine
// (__match_any_sync, then a tree over the peers by shuffles), and one lane
// adds the peers' sum: a warp whose 32 items share a key issues one atomic,
// not 32 on one address.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes
// the 2-word max scratch and the int64 histogram), and returns
// cudaGetLastError() (or the launch's error) so that a refused launch is
// reported.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;           // one block keeps one SM busy
constexpr int kSmemBytes = 232448;       // 227 KB: the most a block may opt into
constexpr int kKeysPerBlock = kSmemBytes / 16;  // 14,528 int64 (g, h) pairs
constexpr int kMaxCluster = 16;          // non-portable above 8
constexpr unsigned kFull = 0xffffffffu;

// the fixed-point exponent of a column (see the note above)
__device__ int scale_exp(unsigned int max_bits, int log2n) {
  const float m = __uint_as_float(max_bits);
  if (!(m > 0.0f)) return 0;
  int e;
  frexpf(m, &e);  // m < 2^e
  return 61 - log2n - e;
}

__device__ __forceinline__ unsigned long long quantise(float x, double scale) {
  return (unsigned long long)__double2ll_rn((double)x * scale);
}

// item sources: row i of the input gives width() items, all with gh[i]
struct KeySource {  // the keys entry: one item per row, its key read
  const int32_t* __restrict__ keys;
  struct Row {
    int k;
    __device__ int key(int) const { return k; }
  };
  __host__ __device__ int width() const { return 1; }
  __device__ Row row(int64_t i) const { return {keys[i]}; }
};

struct BinSource {  // the rows entry: F items per row, key formed here
  const uint8_t* __restrict__ xb;  // (N, F)
  const int32_t* __restrict__ node;
  int f, b;
  struct Row {
    const uint8_t* bins;
    unsigned base, b;
    // int32 arithmetic that wraps as the plain version's does
    __device__ int key(int j) const { return (int)(base + (unsigned)j * b + bins[j]); }
  };
  __host__ __device__ int width() const { return f; }
  __device__ Row row(int64_t i) const {
    return {xb + i * f, (unsigned)node[i] * (unsigned)(f * b), (unsigned)b};
  }
};

// Calls add(k, q0, q1) once per distinct valid key of each warp step, with
// the sum of the quantised values of the warp's items that carry it.  The
// loop is warp-uniform (all 32 lanes take every step; lanes past n carry
// no item), as __match_any_sync and the shuffles need.
template <class Src, class Add>
__device__ __forceinline__ void for_each_item(const Src& src, const float2* __restrict__ gh,
                                              int64_t n, int s, double sc0, double sc1,
                                              Add add) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n;
       base += stride) {
    const int64_t i = base + lane;
    const bool live = i < n;
    unsigned long long v0 = 0, v1 = 0;
    typename Src::Row row{};
    if (live) {
      const float2 v = gh[i];
      v0 = quantise(v.x, sc0);
      v1 = quantise(v.y, sc1);
      row = src.row(i);
    }
    for (int j = 0; j < src.width(); ++j) {
      int k = live ? row.key(j) : -1;
      if ((unsigned)k >= (unsigned)s) k = -1;  // dropped; never added
      const unsigned peers = __match_any_sync(kFull, k);
      unsigned long long q0 = v0, q1 = v1;
      // tree sum over the peers: in each round a peer adds the partial
      // sum of the next peer above it still holding one, and the odd
      // positions drop out; the lowest peer ends with the total
      unsigned above = peers & ~below & ~(1u << lane);
      unsigned pos = __popc(peers & below);
      while (__any_sync(kFull, above != 0)) {
        const int next = __ffs(above) - 1;
        const unsigned long long t0 = __shfl_sync(kFull, q0, next & 31);
        const unsigned long long t1 = __shfl_sync(kFull, q1, next & 31);
        if (next >= 0) {
          q0 += t0;
          q1 += t1;
        }
        above &= ~__ballot_sync(kFull, pos & 1u);
        pos >>= 1;
      }
      if (k >= 0 && (peers & below) == 0) add(k, q0, q1);
    }
  }
}

// adds v to entry `off` of the slice of cluster block `owner` through
// distributed shared memory, this block's own slice included: on sm_90a a
// 64-bit atomicAdd on this block's shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64), while a 64-bit add to a
// cluster shared address is one native atomic
__device__ __forceinline__ void slice_add(const unsigned long long* sh, unsigned off,
                                          unsigned owner, unsigned long long v) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(sh + off);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(owner));
  asm volatile("red.shared::cluster.add.u64 [%0], %1;" ::"r"(remote), "l"(v) : "memory");
}

template <class Src>
__global__ void __launch_bounds__(kThreads, 1)
    hist_cluster_kernel(Src src, const float2* __restrict__ gh, int64_t n, int s, int per,
                        int log2n, const unsigned int* __restrict__ max_bits,
                        unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sh[];  // this block's (per, 2) slice
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  for (int j = threadIdx.x; j < 2 * per; j += blockDim.x) sh[j] = 0ULL;
  cluster.sync();  // every slice is zero before any block adds into it
  const double sc0 = ldexp(1.0, scale_exp(max_bits[0], log2n));
  const double sc1 = ldexp(1.0, scale_exp(max_bits[1], log2n));
  for_each_item(src, gh, n, s, sc0, sc1,
                [&](int k, unsigned long long q0, unsigned long long q1) {
                  const unsigned owner = (unsigned)k / (unsigned)per;
                  const unsigned off = 2u * ((unsigned)k - owner * (unsigned)per);
                  slice_add(sh, off, owner, q0);
                  slice_add(sh, off + 1u, owner, q1);
                });
  cluster.sync();  // every add into this block's slice has landed
  const int lo = (int)rank * per;
  const int mine = min(per, s - lo);
  for (int j = threadIdx.x; j < 2 * mine; j += blockDim.x) {
    const unsigned long long v = sh[j];
    if (v) atomicAdd(&acc[2 * lo + j], v);
  }
}

template <class Src>
__global__ void hist_global_kernel(Src src, const float2* __restrict__ gh, int64_t n, int s,
                                   int log2n, const unsigned int* __restrict__ max_bits,
                                   unsigned long long* __restrict__ acc) {
  const double sc0 = ldexp(1.0, scale_exp(max_bits[0], log2n));
  const double sc1 = ldexp(1.0, scale_exp(max_bits[1], log2n));
  for_each_item(src, gh, n, s, sc0, sc1,
                [&](int k, unsigned long long q0, unsigned long long q1) {
                  atomicAdd(&acc[2 * k], q0);
                  atomicAdd(&acc[2 * k + 1], q1);
                });
}

__global__ void absmax_kernel(const float2* __restrict__ gh, int64_t n,
                              unsigned int* __restrict__ max_bits) {
  float m0 = 0.0f, m1 = 0.0f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float2 v = gh[i];
    m0 = fmaxf(m0, fabsf(v.x));
    m1 = fmaxf(m1, fabsf(v.y));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, off));
  }
  // non-negative floats order as their bit patterns
  if ((threadIdx.x & 31) == 0) {
    atomicMax(max_bits, __float_as_uint(m0));
    atomicMax(max_bits + 1, __float_as_uint(m1));
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc, int s, int log2n,
                                const unsigned int* __restrict__ max_bits,
                                float* __restrict__ out) {
  const int k0 = scale_exp(max_bits[0], log2n);
  const int k1 = scale_exp(max_bits[1], log2n);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < 2 * s; j += gridDim.x * blockDim.x) {
    const long long q = (long long)acc[j];
    out[j] = (float)ldexp((double)q, -((j & 1) ? k1 : k0));
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <class Src>
cudaError_t launch(Src src, const float2* gh, long long n, int s, void* max_bits, void* acc,
                   void* out, cudaStream_t st) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int log2n = 0;
  while ((1LL << log2n) < n) ++log2n;
  auto* mb = (unsigned int*)max_bits;
  auto* ac = (unsigned long long*)acc;
  const long long items = n * src.width();

  err = cudaMemsetAsync(mb, 0, 2 * sizeof(unsigned int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(ac, 0, (size_t)s * 2 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  long long blocks = ceil_div(n, 256);
  if (blocks > 8LL * n_sm) blocks = 8LL * n_sm;
  absmax_kernel<<<(unsigned)blocks, 256, 0, st>>>(gh, (int64_t)n, mb);

  int c = 1;
  while ((long long)c * kKeysPerBlock < s) c *= 2;
  if (c <= kMaxCluster) {
    auto* kern = hist_cluster_kernel<Src>;
    const int per = (int)ceil_div(s, c);
    const size_t smem = (size_t)per * 16;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess && c > 8) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;  // the card takes no such cluster
    // at least 16 items a thread, so that small inputs flush few slices
    const long long want = ceil_div(items, 16LL * kThreads * c);
    if (want < clusters) clusters = (int)(want < 1 ? 1 : want);
    cfg.gridDim = dim3((unsigned)(clusters * c));
    err = cudaLaunchKernelEx(&cfg, kern, src, gh, (int64_t)n, s, per, log2n,
                             (const unsigned int*)mb, ac);
    if (err != cudaSuccess) return err;
  } else {
    blocks = ceil_div(n, 256);
    if (blocks > 16LL * n_sm) blocks = 16LL * n_sm;
    hist_global_kernel<Src><<<(unsigned)blocks, 256, 0, st>>>(src, gh, (int64_t)n, s, log2n, mb, ac);
  }
  blocks = ceil_div(2LL * s, 256);
  if (blocks > 8LL * n_sm) blocks = 8LL * n_sm;
  finalize_kernel<<<(unsigned)blocks, 256, 0, st>>>(ac, s, log2n, mb, (float*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hist_update_launch(const void* keys, const void* gh, long long n, int s,
                                  void* max_bits, void* acc, void* out, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  return (int)launch(KeySource{(const int32_t*)keys}, (const float2*)gh, n, s, max_bits, acc,
                     out, (cudaStream_t)stream);
}

extern "C" int hist_update_rows_launch(const void* xb, const void* node, const void* gh,
                                       long long n, int f, int b, int s, void* max_bits,
                                       void* acc, void* out, void* stream) {
  if (n <= 0 || s <= 0 || f <= 0) return 0;
  return (int)launch(BinSource{(const uint8_t*)xb, (const int32_t*)node, f, b},
                     (const float2*)gh, n, s, max_bits, acc, out, (cudaStream_t)stream);
}
