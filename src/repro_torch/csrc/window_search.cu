// window_search for Hopper (sm_90a): the mining compiler's windowed
// searches on CSR rows, one launch a call.
//
// Replaces no TPU kernel.  The JAX package runs these searches
// (`repro.core.ops.lower_bound`, a `jax.lax.fori_loop`, src/repro/core/
// ops.py:46-68, under `count_window` and `count_id_in_window`) inside
// jitted bucket programs, which XLA compiles into one device program per
// bucket.  Run eagerly, each of their halvings is about a dozen elementwise
// launches over whole query tensors, so one `count_id_in_window` call on
// HI-Small (19 halvings, four searches) is about 900 launches.  This
// kernel runs a whole call in one launch.
//
// For every element of the broadcast query shape it computes, bit for bit
// as the plain version (`repro_torch.core.ops`, equal to the JAX ops):
//
//   two-level (`count_id_in_window`): the row [start, end) of `node` in the
//     (id, t)-sorted CSR; the id run [lb, ub) of `x` in it (lower bounds of
//     x and x + 1 on `ids`); then the ranks a, b of after + 1 and until + 1
//     in the time-sorted run (`t`); count = max(b - a, 0), or 0 where
//     node < 0 or x < 0;
//   one-level (`count_window`): the ranks a, b of after + 1 and until + 1
//     in the row of `node` on the time-sorted row copy (`t`); count =
//     max(b - a, 0), or 0 where node < 0;
//
// and, where asked (the `_pos` forms), the flat rank a of the first
// element in the window.  Each lower bound is the plain loop's: at most
// n_iters halvings, mid = (lo + hi) >> 1 in int32, the gather clamped to
// [0, n_flat - 1], so a row longer than 2^n_iters gives the same partial
// rank; a search stops where lo == hi, where the plain loop's further
// steps change nothing.  `x + 1`, `after + 1` and `until + 1` wrap in
// int32 as the plain version's int32 adds do.  `indptr` is read at
// max(node, 0) and max(node, 0) + 1, clamped to its last entry, as the
// JAX package's gathers clamp.
//
// Operands: node, x, after and until are each a Python int passed by value
// or an int32 tensor read through strides over the output shape (0 on the
// axes it is broadcast along), so a lifted or broadcast view is read in
// place and nothing is materialised per element.  The wrapper drops
// size-1 axes and merges axes that every operand walks contiguously, so
// the rank here is small.  The count output is contiguous; the position
// output has strides of its own (0 on axes its shape lacks: threads that
// share an element write the same value).
//
// Bound on an H100: the bytes, and the latency of the dependent gathers.
// Each halving is one gather from a row; the operands are read once and
// the outputs written once.  The bound used in PERF.md counts the operand
// and output bytes plus one 32-byte sector per halving that this run's
// data needs.
//
// Design: one thread an output element, the whole search in registers, a
// grid-stride loop over int64 element indices.  The four searches of an
// element are dependent chains of gathers; neighbouring threads usually
// search the same row (a broadcast node), so their gathers share sectors
// in L1/L2.  Launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

#define WS_MAX_RANK 8

extern "C" {

// one query operand: a tensor read at ptr + sum(coord[d] * stride[d]), or
// (ptr == NULL) the value `value` everywhere
struct WsOperand {
  const int32_t* ptr;
  long long stride[WS_MAX_RANK];
  int value;
  int pad_;
};

struct WsArgs {
  const int32_t* ids;     // two-level: the id-sorted row ids; unused otherwise
  const int32_t* t;       // the time array the window is ranked on
  long long n_flat;       // entries of ids / t
  const int32_t* indptr;  // CSR row offsets
  long long n_indptr;     // entries of indptr (n_nodes + 1)
  WsOperand node, x, after, until;
  int32_t* out;           // contiguous, `size` elements
  int32_t* pos;           // NULL, or the first in-window rank at pos_stride
  long long pos_stride[WS_MAX_RANK];
  long long size[WS_MAX_RANK];
  long long numel;
  int rank;
  int n_iters;
  int two_level;
  int pad_;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// # of entries of flat[lo:hi) below q, by at most n_iters halvings
__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ flat, int32_t cap, int32_t lo,
                                               int32_t hi, int32_t q, int n_iters) {
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const int32_t mid = wrap_add(lo, hi) >> 1;
    const int32_t v = __ldg(flat + min(max(mid, 0), cap));
    if (v < q) {
      lo = wrap_add(mid, 1);
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int32_t read(const WsOperand& o, long long off) {
  return o.ptr ? __ldg(o.ptr + off) : o.value;
}

__global__ void __launch_bounds__(kThreads) window_search_kernel(const WsArgs a) {
  const int32_t cap = (int32_t)(a.n_flat - 1);
  const long long last = a.n_indptr - 1;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < a.numel; e += step) {
    long long rem = e, o_node = 0, o_x = 0, o_after = 0, o_until = 0, o_pos = 0;
    for (int d = a.rank - 1; d >= 0; --d) {
      const long long n = a.size[d];
      const long long c = rem % n;
      rem /= n;
      o_node += c * a.node.stride[d];
      o_x += c * a.x.stride[d];
      o_after += c * a.after.stride[d];
      o_until += c * a.until.stride[d];
      o_pos += c * a.pos_stride[d];
    }
    const int32_t node = read(a.node, o_node);
    const long long safe = node > 0 ? node : 0;
    const int32_t start = __ldg(a.indptr + (safe < last ? safe : last));
    const int32_t end = __ldg(a.indptr + (safe + 1 < last ? safe + 1 : last));
    const int32_t q_lo = wrap_add(read(a.after, o_after), 1);
    const int32_t q_hi = wrap_add(read(a.until, o_until), 1);
    int32_t lo = start, hi = end;
    bool valid = node >= 0;
    if (a.two_level) {
      const int32_t x = read(a.x, o_x);
      lo = lower_bound(a.ids, cap, start, end, x, a.n_iters);
      hi = lower_bound(a.ids, cap, start, end, wrap_add(x, 1), a.n_iters);
      valid = valid && x >= 0;
    }
    const int32_t ra = lower_bound(a.t, cap, lo, hi, q_lo, a.n_iters);
    const int32_t rb = lower_bound(a.t, cap, lo, hi, q_hi, a.n_iters);
    const int32_t cnt = rb - ra;
    a.out[e] = (valid && cnt > 0) ? cnt : 0;
    if (a.pos) a.pos[o_pos] = ra;
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (!counts[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace

extern "C" int window_search_max_rank() { return WS_MAX_RANK; }

extern "C" int window_search_args_bytes() { return (int)sizeof(WsArgs); }

extern "C" int window_search_launch(const WsArgs* args, void* stream) {
  if (args->numel <= 0) return 0;
  if (args->rank < 0 || args->rank > WS_MAX_RANK || args->n_flat <= 0 || args->n_indptr <= 0 ||
      args->n_iters < 0 || (args->two_level && !args->ids) || !args->t || !args->indptr || !args->out)
    return (int)cudaErrorInvalidValue;
  long long blocks = (args->numel + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  window_search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
