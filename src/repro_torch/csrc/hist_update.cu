// hist_update for Hopper (sm_90a): the GBDT gradient/hessian histogram.
//
// Replaces the TPU kernel `hist_update_pallas` / `_kernel` in
// src/repro/kernels/hist_update/kernel.py (pallas_call at line 42).  It
// computes, for k in [0, S) and c in {0, 1},
//   out[k, c] = sum over i with keys[i] == k of gh[i, c]
// as float32; keys outside [0, S) are dropped.  On the TPU the sum is a
// one-hot (bn, S) matrix contracted against gh on the MXU; on Hopper it
// is a scatter-reduce, and nothing of the one-hot is carried over.
//
// Bound on an H100: the bytes.  Each key (4 B) and gh row (8 B) is read
// once and each of the S output pairs (8 B) written once:
// N*12 + S*8 bytes against 2N additions.  This kernel reads gh twice
// (below), so it moves about N*20 bytes.
//
// Determinism.  Float atomics add in an order that changes from launch to
// launch, so two GBDT fits on the same data could split a near tie
// differently.  Here every value is quantised to a fixed-point int64,
// q = rint(x * 2^k), and the int64 sums, whose additions commute, are
// built with atomics; the result is Q * 2^-k rounded to float32 once.  The
// same input gives the same bits on every launch.  The scale is chosen per
// column on the card, so no host sync is needed:
//   pass 1  max|gh[:, c]| over all N rows (atomicMax on the float's bits,
//           exact and order-free);
//   k_c     = 61 - L - e_c with N <= 2^L and max|gh[:, c]| < 2^e_c, so the
//           sum of |q| over all N rows stays below 2^62: no overflow;
//   pass 2  the int64 histogram (see below);
//   pass 3  out = float(double(Q) * 2^-k).
// Error bound, per entry with n_k valid rows: half a quantum per row plus
// the roundings of the result,
//   |out - exact| <= n_k * 2^-k_c / 2 + 2^-23 * (sum |x| + n_k * 2^-k_c / 2)
// (`repro_torch.kernels.hist_update.ops.error_bound`).  gh must be finite.
//
// Pass 2 privatises the histogram in shared memory while S <= 14,336
// (16 B per key, 224 KB of the 227 KB a block may take after the
// opt-in), which covers the GBDT's levels 0-2 at 12 features and 256
// bins (S = 3,072 to 12,288) where the contention is worst: each block
// accumulates its share of the rows there and adds its nonzero entries to
// the device histogram at the end.  Above that (levels 3-5, up to 98,304
// keys) the rows add straight into the device histogram with 64-bit
// atomics; the keys spread over many bins, so contention is low.  The
// ragged N edge is handled by grid-stride loops; nothing is padded.
// Launches on the caller's stream, allocates nothing (the wrapper passes
// the 2-word max scratch and the int64 histogram), and returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemKeys = 14336;
constexpr int kSmemPerSm = 228 * 1024;

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
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  // non-negative floats order as their bit patterns
  if ((threadIdx.x & 31) == 0) {
    atomicMax(max_bits, __float_as_uint(m0));
    atomicMax(max_bits + 1, __float_as_uint(m1));
  }
}

__global__ void hist_smem_kernel(const int32_t* __restrict__ keys,
                                 const float2* __restrict__ gh, int64_t n,
                                 int s, int log2n,
                                 const unsigned int* __restrict__ max_bits,
                                 unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sh[];  // (s, 2)
  for (int j = threadIdx.x; j < 2 * s; j += blockDim.x) sh[j] = 0ULL;
  __syncthreads();
  const double sc0 = ldexp(1.0, scale_exp(max_bits[0], log2n));
  const double sc1 = ldexp(1.0, scale_exp(max_bits[1], log2n));
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int k = keys[i];
    if ((unsigned)k < (unsigned)s) {
      const float2 v = gh[i];
      atomicAdd(&sh[2 * k], quantise(v.x, sc0));
      atomicAdd(&sh[2 * k + 1], quantise(v.y, sc1));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * s; j += blockDim.x) {
    const unsigned long long v = sh[j];
    if (v) atomicAdd(&acc[j], v);
  }
}

__global__ void hist_global_kernel(const int32_t* __restrict__ keys,
                                   const float2* __restrict__ gh, int64_t n,
                                   int s, int log2n,
                                   const unsigned int* __restrict__ max_bits,
                                   unsigned long long* __restrict__ acc) {
  const double sc0 = ldexp(1.0, scale_exp(max_bits[0], log2n));
  const double sc1 = ldexp(1.0, scale_exp(max_bits[1], log2n));
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int k = keys[i];
    if ((unsigned)k < (unsigned)s) {
      const float2 v = gh[i];
      atomicAdd(&acc[2 * k], quantise(v.x, sc0));
      atomicAdd(&acc[2 * k + 1], quantise(v.y, sc1));
    }
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                int s, int log2n,
                                const unsigned int* __restrict__ max_bits,
                                float* __restrict__ out) {
  const int k0 = scale_exp(max_bits[0], log2n);
  const int k1 = scale_exp(max_bits[1], log2n);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < 2 * s;
       j += gridDim.x * blockDim.x) {
    const long long q = (long long)acc[j];
    out[j] = (float)ldexp((double)q, -((j & 1) ? k1 : k0));
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int hist_update_launch(const void* keys, const void* gh,
                                  long long n, int s, void* max_bits,
                                  void* acc, void* out, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (n_sm <= 0) n_sm = 1;
  int log2n = 0;
  while ((1LL << log2n) < n) ++log2n;
  auto* mb = (unsigned int*)max_bits;
  auto* ac = (unsigned long long*)acc;
  auto* k = (const int32_t*)keys;
  auto* g = (const float2*)gh;

  cudaError_t err = cudaMemsetAsync(mb, 0, 2 * sizeof(unsigned int), st);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(ac, 0, (size_t)s * 2 * sizeof(unsigned long long), st);
  }
  if (err != cudaSuccess) return (int)err;
  long long blocks = ceil_div(n, kThreads);
  if (blocks > 8LL * n_sm) blocks = 8LL * n_sm;
  absmax_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(g, (int64_t)n, mb);

  if (s <= kMaxSmemKeys) {
    const int smem = s * 2 * (int)sizeof(unsigned long long);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          hist_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmemKeys * 2 * (int)sizeof(unsigned long long));
      if (err != cudaSuccess) return (int)err;
    }
    int per_sm = kSmemPerSm / (smem + 1024);
    if (per_sm < 1) per_sm = 1;
    if (per_sm > 8) per_sm = 8;
    blocks = ceil_div(n, 16LL * kThreads);
    if (blocks > (long long)per_sm * n_sm) blocks = (long long)per_sm * n_sm;
    hist_smem_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, st>>>(
        k, g, (int64_t)n, s, log2n, mb, ac);
  } else {
    blocks = ceil_div(n, kThreads);
    if (blocks > 16LL * n_sm) blocks = 16LL * n_sm;
    hist_global_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        k, g, (int64_t)n, s, log2n, mb, ac);
  }
  blocks = ceil_div(2LL * s, kThreads);
  if (blocks > 8LL * n_sm) blocks = 8LL * n_sm;
  finalize_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(ac, s, log2n, mb,
                                                        (float*)out);
  return (int)cudaGetLastError();
}
