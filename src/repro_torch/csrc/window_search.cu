// window_search for Hopper (sm_90a): the mining compiler's windowed
// searches on CSR rows.  Two entries, one launch a call each.
//
// Replaces no TPU kernel.  The JAX package runs these searches
// (`repro.core.ops.lower_bound`, a `jax.lax.fori_loop`, src/repro/core/
// ops.py:46-68, under `count_window` and `count_id_in_window`) inside
// jitted bucket programs, which XLA compiles into one device program per
// bucket, the hub-tail sweep grid included (a `fori_loop` over the offset
// combinations, src/repro/core/compiler.py:1199-1223).
//
// Entry 1, `window_search_launch`: one windowed search call of
// `repro_torch.core.ops`.  For every element of the broadcast query shape
// it computes, bit for bit as the plain version (equal to the JAX ops):
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
// element in the window.
//
// Entry 2, `window_search_step_launch`: a whole bs1 or bs2 intersect step
// of the compiled plans (`repro_torch.core.compiler`, the eager sequence
// that `kernels/window_search/ref.py::intersect_step_ref` keeps).  For each
// lead element it expands one CSR row (the "x" side) at offsets
// offset + j, j < d * n_sweep (the intersect dim's sweep steps inside the
// launch), keeps the entries inside the x window (lo_x, hi_x] whose id
// differs from every skip operand, and for each kept entry (id, t) counts
// the edges of the searched row (the "s" side) to that id inside the
// search window (lo_s, hi_s], which an ordered step clips to after t (bs1:
// lo = max(lo_s, t)) or before it (bs2: hi = min(hi_s, t - 1), wrapping);
// it writes the int32 sum over the kept entries.  bs1 expands the frontier
// node's row and searches the fixed node's; bs2 the other way round.  An
// entry past its row's end, or of a row whose node is < 0, adds 0, as the
// plain version's `expand` mask makes it.
//
// Each lower bound is the plain loop's: at most n_iters halvings, mid =
// (lo + hi) >> 1 in int32, the gather clamped to [0, n_flat - 1], so a row
// longer than 2^n_iters gives the same partial rank; a search stops where
// lo == hi, where the plain loop's further steps change nothing.  `+ 1`
// and `- 1` wrap in int32 as the plain version's int32 ops do.  `indptr` is
// read at max(node, 0) and max(node, 0) + 1, clamped to its last entry, as
// the JAX package's gathers clamp.
//
// Operands: every query operand is a Python int passed by value or an int32
// tensor read through strides over the output shape (0 on the axes it is
// broadcast along), so a lifted or broadcast view is read in place and
// nothing is materialised per element.  The wrapper drops size-1 axes and
// merges axes that every operand walks contiguously, so the rank here is
// small.  The count output is contiguous; the position output has strides
// of its own (0 on axes its shape lacks: threads that share an element
// write the same value).
//
// Bound on an H100: the bytes, and the latency of the dependent gathers.
// Each halving is one gather from a row; the operands are read once and
// the outputs written once.  The bound in PERF.md counts the operand,
// expanded-row and output bytes plus the distinct 32-byte row sectors that
// this run's data needs.
//
// Design, against that latency:
// - a pair of searches that start from one range (x and x + 1; after + 1
//   and until + 1) reads one value a halving while their ranges agree and
//   two independent ones after: entry 1 as one uniform loop (its lanes
//   part at different halvings), entry 2 as a joined loop, then a split
//   one (few of its lanes search, and most of their pairs never part);
// - in entry 2 every kept entry of a lead element searches one row, so
//   the lead element's group first stages the values at the mids of that
//   row's first L halvings into shared memory with `cp.async` (heap order,
//   2^L - 1 entries, L <= 10), and every search takes those halvings from
//   there.  The mids depend only on (lo, hi) and the comparisons, so the
//   result is the plain loop's bit for bit.  Entry 1 stages nothing: no
//   launch of the mining path gives it a `node` shared by a warp of
//   elements (each element its own row);
// - entry 2 gives each lead element a group of 32-256 threads (the host
//   picks it from d * n_sweep), which walks the expanded row coalesced and
//   reduces its sum with warp shuffles, no atomics;
// - element and offset arithmetic in 32 bits where the launch's element
//   count and every operand offset fit (the host checks), 64 otherwise.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

#define WS_MAX_RANK 8
#define WS_MAX_SKIP 8

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

// one CSR: (id, t)-sorted rows
struct WsCsr {
  const int32_t* ids;
  const int32_t* t;
  const int32_t* indptr;
  long long n_flat;
  long long n_indptr;
};

struct WsStepArgs {
  WsCsr x;                  // the expanded side
  WsCsr s;                  // the searched side
  WsOperand node_x, node_s;
  WsOperand lo_x, hi_x;     // window of the expanded entries' times
  WsOperand lo_s, hi_s;     // window of the searched edges' times
  WsOperand skip[WS_MAX_SKIP];
  int32_t* out;             // contiguous, `size` lead elements
  long long size[WS_MAX_RANK];
  long long numel;          // lead elements
  int offset;               // the first expansion offset
  int width;                // d * n_sweep expansions a lead element
  int rank;
  int n_iters;
  int n_skip;
  int ordered;
  int clip_upper;           // 0: bs1 (lo = max(lo_s, t)); 1: bs2 (hi = min(hi_s, t - 1))
  int group;                // threads a lead element: 32, 64, 128 or 256
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kTreeInts = 1024;  // staged mids a block: 4 KB
constexpr int kUnroll = 4;       // expansions a thread loads at once (entry 2)

__host__ __device__ constexpr int log2_floor(int v) { return v <= 1 ? 0 : 1 + log2_floor(v / 2); }

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t gather(const int32_t* __restrict__ flat, int32_t cap, int32_t i) {
  return __ldg(flat + min(max(i, 0), cap));
}

__device__ __forceinline__ int bit_length(uint32_t v) { return 32 - __clz((int)v); }

// the row [start, end) of `node`, indptr read as the JAX package clamps
__device__ __forceinline__ void row_bounds(const int32_t* __restrict__ indptr, long long n_indptr, int32_t node,
                                           int32_t& start, int32_t& end) {
  const long long last = n_indptr - 1;
  const long long safe = node > 0 ? node : 0;
  start = __ldg(indptr + (safe < last ? safe : last));
  end = __ldg(indptr + (safe + 1 < last ? safe + 1 : last));
}

// The staged tree: the value at the mid of each halving of a search from
// one range, heap order: halving `it` reads tree[h], h = 1 then
// 2h + (v < q).

// lower bounds of q1 and q2 in flat[lo:hi), each by at most n_iters
// halvings of the plain loop.  The two advance together, one halving each
// an iteration, in one loop with no branch on which phase they are in (a
// warp's threads part at different halvings); while their ranges are the
// same they read one value (one gather), after that two independent ones.
__device__ __forceinline__ void lower_bound_pair(const int32_t* __restrict__ flat, int32_t cap, int32_t lo,
                                                 int32_t hi, int32_t q1, int32_t q2, int n_iters, int32_t& r1,
                                                 int32_t& r2) {
  int32_t lo1 = lo, hi1 = hi, lo2 = lo, hi2 = hi;
  for (int it = 0; it < n_iters; ++it) {
    const bool a1 = lo1 < hi1, a2 = lo2 < hi2;
    if (!a1 && !a2) break;
    const bool same = lo1 == lo2 && hi1 == hi2;
    const int32_t m1 = wrap_add(lo1, hi1) >> 1, m2 = wrap_add(lo2, hi2) >> 1;
    int32_t v1 = 0, v2 = 0;
    if (a1) v1 = gather(flat, cap, m1);
    if (a2 && !same) v2 = gather(flat, cap, m2);
    if (same) v2 = v1;
    if (a1) {
      const bool c = v1 < q1;
      lo1 = c ? wrap_add(m1, 1) : lo1;
      hi1 = c ? hi1 : m1;
    }
    if (a2) {
      const bool c = v2 < q2;
      lo2 = c ? wrap_add(m2, 1) : lo2;
      hi2 = c ? hi2 : m2;
    }
  }
  r1 = lo1;
  r2 = lo2;
}

// The same pair as one joined loop that reads one value a halving until
// the two comparisons differ, then a loop of two interleaved searches.
// Entry 2 takes it: there only the lanes whose expansion passed its window
// search, and an id absent from the row keeps x and x + 1 joined to the
// end, so the lighter joined loop wins (1.43 against 1.89 ms at phase 2's
// hub rows on one H100); entry 1, where every lane searches and lanes part at
// different halvings, takes the uniform loop above.
__device__ __forceinline__ void lower_bound_pair_joined(const int32_t* __restrict__ flat, int32_t cap, int32_t lo,
                                                        int32_t hi, int32_t q1, int32_t q2, int n_iters,
                                                        const int32_t* tree, int levels, int32_t& r1, int32_t& r2) {
  uint32_t h = 1;
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const int32_t mid = wrap_add(lo, hi) >> 1;
    const int32_t v = it < levels ? tree[h] : gather(flat, cap, mid);
    const bool c1 = v < q1, c2 = v < q2;
    if (c1 != c2) {  // apart from here on: each search takes its side
      int32_t lo1 = c1 ? wrap_add(mid, 1) : lo, hi1 = c1 ? hi : mid;
      int32_t lo2 = c2 ? wrap_add(mid, 1) : lo, hi2 = c2 ? hi : mid;
      uint32_t h1 = 2 * h + (c1 ? 1 : 0), h2 = 2 * h + (c2 ? 1 : 0);
      for (++it; it < n_iters; ++it) {
        const bool a1 = lo1 < hi1, a2 = lo2 < hi2;
        if (!a1 && !a2) break;
        const int32_t m1 = wrap_add(lo1, hi1) >> 1, m2 = wrap_add(lo2, hi2) >> 1;
        const int32_t v1 = a1 ? (it < levels ? tree[h1] : gather(flat, cap, m1)) : 0;
        const int32_t v2 = a2 ? (it < levels ? tree[h2] : gather(flat, cap, m2)) : 0;
        if (a1) {
          const bool c = v1 < q1;
          lo1 = c ? wrap_add(m1, 1) : lo1;
          hi1 = c ? hi1 : m1;
          h1 = 2 * h1 + (c ? 1 : 0);
        }
        if (a2) {
          const bool c = v2 < q2;
          lo2 = c ? wrap_add(m2, 1) : lo2;
          hi2 = c ? hi2 : m2;
          h2 = 2 * h2 + (c ? 1 : 0);
        }
      }
      r1 = lo1;
      r2 = lo2;
      return;
    }
    lo = c1 ? wrap_add(mid, 1) : lo;
    hi = c1 ? hi : mid;
    h = 2 * h + (c1 ? 1 : 0);
  }
  r1 = lo;
  r2 = lo;
}

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// barrier of one group of GROUP threads (GROUP a multiple of 32): a warp
// syncs itself, a larger group takes named barrier 1 + g
template <int GROUP>
__device__ __forceinline__ void group_sync(int g) {
  if (GROUP == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(GROUP) : "memory");
  }
}

// how many halvings of a search from a row of `len` entries to stage for
// `searches` searches: at most the tree's room, n_iters, the row's depth,
// and about log2 of the searches (2^L - 1 gathers stand in for L gathers
// each of them)
__device__ __forceinline__ int tree_levels(int max_levels, int n_iters, int32_t len, long long searches) {
  if (len <= 0 || searches <= 0) return 0;
  int l = min(max_levels, n_iters);
  l = min(l, bit_length((uint32_t)len));
  return min(l, bit_length((uint32_t)min(searches, 1LL << 30)));
}

// the group's threads gather the values at the mids of the first `levels`
// halvings from (lo0, hi0) into tree[1 .. 2^levels) with cp.async; a node
// whose range is empty is never read and is left alone.  Each thread
// waits for its own copies; the caller's group barrier publishes them.
__device__ __forceinline__ void stage_tree(const int32_t* __restrict__ flat, int32_t cap, int32_t lo0, int32_t hi0,
                                           int levels, int32_t* tree, int lane, int group) {
  const uint32_t n = 1u << levels;
  for (uint32_t h = 1 + lane; h < n; h += group) {
    int32_t lo = lo0, hi = hi0;
    for (int b = bit_length(h) - 2; b >= 0 && lo < hi; --b) {
      const int32_t mid = wrap_add(lo, hi) >> 1;
      if ((h >> b) & 1) {
        lo = wrap_add(mid, 1);
      } else {
        hi = mid;
      }
    }
    if (lo < hi) cp_async4(tree + h, flat + min(max(wrap_add(lo, hi) >> 1, 0), cap));
  }
  cp_async_wait_all();
}

__device__ __forceinline__ int32_t read(const WsOperand& o, long long off) {
  return o.ptr ? __ldg(o.ptr + off) : o.value;
}

// the offsets of the coordinates of element e over `size[0..rank)`, in
// Idx arithmetic, for operands o[0..n)
template <typename Idx, int N>
__device__ __forceinline__ void offsets(Idx e, const long long* size, int rank, const long long* const* strides,
                                        Idx* out) {
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = 0;
  Idx rem = e;
  for (int d = rank - 1; d >= 0; --d) {
    const Idx n = (Idx)size[d];
    const Idx c = rem % n;
    rem /= n;
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] += c * (Idx)strides[k][d];
  }
}

// ---- entry 1: one windowed search call --------------------------------

// one element: the count and (for `pos`) the first in-window rank
template <bool TWO>
__device__ __forceinline__ void search_one(const WsArgs& a, int32_t cap, int32_t node, int32_t start, int32_t end,
                                           int32_t x, int32_t after, int32_t until, int32_t& cnt_out,
                                           int32_t& pos_out) {
  int32_t lo = start, hi = end;
  bool valid = node >= 0;
  const int32_t q_lo = wrap_add(after, 1), q_hi = wrap_add(until, 1);
  int32_t ra, rb;
  if (TWO) {
    lower_bound_pair(a.ids, cap, start, end, x, wrap_add(x, 1), a.n_iters, lo, hi);
    valid = valid && x >= 0;
  }
  lower_bound_pair(a.t, cap, lo, hi, q_lo, q_hi, a.n_iters, ra, rb);
  const int32_t cnt = rb - ra;
  cnt_out = (valid && cnt > 0) ? cnt : 0;
  pos_out = ra;
}

// a thread an element, a grid-stride loop
template <typename Idx, bool TWO>
__global__ void __launch_bounds__(kThreads) window_search_kernel(const WsArgs a) {
  const int32_t cap = (int32_t)(a.n_flat - 1);
  const long long* strides[5] = {a.node.stride, a.x.stride, a.after.stride, a.until.stride, a.pos_stride};
  const Idx numel = (Idx)a.numel;
  const Idx step = (Idx)gridDim.x * kThreads;
  for (Idx e = (Idx)blockIdx.x * kThreads + threadIdx.x; e < numel; e += step) {
    Idx o[5];
    offsets<Idx, 5>(e, a.size, a.rank, strides, o);
    const int32_t node = read(a.node, o[0]);
    int32_t start, end;
    row_bounds(a.indptr, a.n_indptr, node, start, end);
    int32_t cnt, pos;
    search_one<TWO>(a, cap, node, start, end, TWO ? read(a.x, o[1]) : 0, read(a.after, o[2]), read(a.until, o[3]),
                    cnt, pos);
    a.out[e] = cnt;
    if (a.pos) a.pos[o[4]] = pos;
  }
}

// ---- entry 2: a whole bs1 / bs2 intersect step -------------------------

template <int GROUP>
__device__ __forceinline__ uint32_t group_sum(uint32_t v, int g, int lane, uint32_t* partial) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  if (GROUP == 32) return v;
  constexpr int kWarps = GROUP / 32;
  if ((lane & 31) == 0) partial[g * kWarps + lane / 32] = v;
  group_sync<GROUP>(g);
  uint32_t total = 0;
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[g * kWarps + w];
  }
  return total;
}

template <typename Idx, int GROUP>
__global__ void __launch_bounds__(kThreads) window_search_step_kernel(const WsStepArgs a) {
  constexpr int kGroups = kThreads / GROUP;
  constexpr int kTree = kTreeInts / kGroups;
  constexpr int kMaxLevels = log2_floor(kTree);
  constexpr int kOps = 6 + WS_MAX_SKIP;
  __shared__ int32_t trees[kGroups][kTree];
  __shared__ uint32_t partial[kThreads / 32];
  const int g = threadIdx.x / GROUP, lane = threadIdx.x % GROUP;
  int32_t* tree = trees[g];
  const int32_t cap_x = (int32_t)(a.x.n_flat - 1), cap_s = (int32_t)(a.s.n_flat - 1);
  const long long* strides[kOps] = {a.node_x.stride, a.node_s.stride, a.lo_x.stride, a.hi_x.stride,
                                    a.lo_s.stride,   a.hi_s.stride};
#pragma unroll
  for (int k = 0; k < WS_MAX_SKIP; ++k) strides[6 + k] = a.skip[k].stride;
  const Idx numel = (Idx)a.numel;
  const Idx step = (Idx)gridDim.x * kGroups;
  for (Idx e = (Idx)blockIdx.x * kGroups + g; e < numel; e += step) {
    Idx o[kOps];
    offsets<Idx, kOps>(e, a.size, a.rank, strides, o);
    const int32_t node_x = read(a.node_x, o[0]), node_s = read(a.node_s, o[1]);
    const int32_t lo_x = read(a.lo_x, o[2]), hi_x = read(a.hi_x, o[3]);
    const int32_t lo_s = read(a.lo_s, o[4]), hi_s = read(a.hi_s, o[5]);
    int32_t skip[WS_MAX_SKIP];
#pragma unroll
    for (int k = 0; k < WS_MAX_SKIP; ++k) skip[k] = k < a.n_skip ? read(a.skip[k], o[6 + k]) : 0;
    int32_t start_x, end_x, start_s, end_s;
    row_bounds(a.x.indptr, a.x.n_indptr, node_x, start_x, end_x);
    row_bounds(a.s.indptr, a.s.n_indptr, node_s, start_s, end_s);
    const int32_t first = wrap_add(start_x, a.offset);
    // expansions j < span can be in the row: where first + width cannot
    // wrap, exactly those below end - first; else all, each checked
    long long span = 0;
    if (node_x >= 0 && node_s >= 0) {
      span = (long long)first + a.width <= 2147483647LL
                 ? min(max((long long)end_x - first, 0LL), (long long)a.width)
                 : (long long)a.width;
    }
    const int levels = tree_levels(kMaxLevels, a.n_iters, end_s - start_s, span);
    if (levels > 0) {
      stage_tree(a.s.ids, cap_s, start_s, end_s, levels, tree, lane, GROUP);
      group_sync<GROUP>(g);
    }
    uint32_t sum = 0;
    // kUnroll expansions a thread at a time: their times are loaded
    // together, then the ids of those inside the x window
    for (int base = lane; base < span; base += kUnroll * GROUP) {
      int32_t t[kUnroll], id[kUnroll];
      bool keep[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * GROUP;
        const int32_t idx = wrap_add(first, j);
        keep[u] = j < span && idx < end_x;
        t[u] = keep[u] ? __ldg(a.x.t + min(max(idx, 0), cap_x)) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        keep[u] = keep[u] && t[u] > lo_x && t[u] <= hi_x;
        id[u] = keep[u] ? __ldg(a.x.ids + min(max(wrap_add(first, base + u * GROUP), 0), cap_x)) : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool k_ = keep[u] && id[u] >= 0;
#pragma unroll
        for (int k = 0; k < WS_MAX_SKIP; ++k) k_ = k_ && (k >= a.n_skip || id[u] != skip[k]);
        if (!k_) continue;
        int32_t lo = lo_s, hi = hi_s;
        if (a.ordered) {
          if (a.clip_upper) {
            hi = min(hi, wrap_add(t[u], -1));
          } else {
            lo = max(lo, t[u]);
          }
        }
        int32_t lb, ub, ra, rb;
        lower_bound_pair_joined(a.s.ids, cap_s, start_s, end_s, id[u], wrap_add(id[u], 1), a.n_iters, tree, levels,
                                lb, ub);
        lower_bound_pair_joined(a.s.t, cap_s, lb, ub, wrap_add(lo, 1), wrap_add(hi, 1), a.n_iters, nullptr, 0, ra, rb);
        const int32_t cnt = rb - ra;
        sum += cnt > 0 ? (uint32_t)cnt : 0u;
      }
    }
    const uint32_t total = group_sum<GROUP>(sum, g, lane, partial);
    if (lane == 0) a.out[e] = (int32_t)total;
    // the tree and the partial sums are free for the next lead element
    group_sync<GROUP>(g);
  }
}

// one block for every `per_block` items: no cap, so that the hardware
// hands a finished block's SM the next one (a row's or a lead element's
// work varies by orders of magnitude; a capped grid-stride loop would
// leave its slowest threads to finish alone); the grid-stride loops only
// cover a grid past the launch limit
unsigned grid_for(long long work, long long per_block) {
  const long long blocks = (work + per_block - 1) / per_block;
  return (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
}

// the largest offset an operand reaches over `size[0..rank)`
long long max_offset(const long long* stride, const long long* size, int rank) {
  long long m = 0;
  for (int d = 0; d < rank; ++d) m += (size[d] - 1) * (stride[d] < 0 ? -stride[d] : stride[d]);
  return m;
}

constexpr long long kFits32 = 1LL << 31;

template <typename Idx, bool TWO>
void launch_search(const WsArgs& a, cudaStream_t stream) {
  window_search_kernel<Idx, TWO><<<grid_for(a.numel, kThreads), kThreads, 0, stream>>>(a);
}

template <typename Idx>
void launch_step(const WsStepArgs& a, cudaStream_t stream) {
  const unsigned grid = grid_for(a.numel, kThreads / a.group);
  switch (a.group) {
    case 256: window_search_step_kernel<Idx, 256><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: window_search_step_kernel<Idx, 128><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: window_search_step_kernel<Idx, 64><<<grid, kThreads, 0, stream>>>(a); break;
    default: window_search_step_kernel<Idx, 32><<<grid, kThreads, 0, stream>>>(a); break;
  }
}

// whether a launch of these arguments runs in 32-bit index arithmetic:
// its element count and every operand offset below 2^31
bool index32(const WsArgs* a) {
  long long m = a->numel;
  const long long* strides[5] = {a->node.stride, a->x.stride, a->after.stride, a->until.stride, a->pos_stride};
  for (const long long* s : strides) {
    const long long o = max_offset(s, a->size, a->rank);
    m = m > o ? m : o;
  }
  return m < kFits32;
}

bool index32(const WsStepArgs* a) {
  long long m = a->numel;
  const WsOperand* ops[6] = {&a->node_x, &a->node_s, &a->lo_x, &a->hi_x, &a->lo_s, &a->hi_s};
  for (const WsOperand* o : ops) {
    const long long v = max_offset(o->stride, a->size, a->rank);
    m = m > v ? m : v;
  }
  for (int k = 0; k < a->n_skip; ++k) {
    const long long v = max_offset(a->skip[k].stride, a->size, a->rank);
    m = m > v ? m : v;
  }
  return m < kFits32;
}

}  // namespace

extern "C" int window_search_max_rank() { return WS_MAX_RANK; }

extern "C" int window_search_max_skip() { return WS_MAX_SKIP; }

extern "C" int window_search_args_bytes() { return (int)sizeof(WsArgs); }

extern "C" int window_search_step_args_bytes() { return (int)sizeof(WsStepArgs); }

extern "C" int window_search_launch(const WsArgs* args, void* stream) {
  if (args->numel <= 0) return 0;
  if (args->rank < 0 || args->rank > WS_MAX_RANK || args->n_flat <= 0 || args->n_indptr <= 0 ||
      args->n_iters < 0 || (args->two_level && !args->ids) || !args->t || !args->indptr || !args->out)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool i32 = index32(args);
  if (args->two_level) {
    i32 ? launch_search<uint32_t, true>(*args, s) : launch_search<long long, true>(*args, s);
  } else {
    i32 ? launch_search<uint32_t, false>(*args, s) : launch_search<long long, false>(*args, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int window_search_step_launch(const WsStepArgs* args, void* stream) {
  if (args->numel <= 0) return 0;
  const WsCsr* csrs[2] = {&args->x, &args->s};
  for (const WsCsr* c : csrs)
    if (!c->ids || !c->t || !c->indptr || c->n_flat <= 0 || c->n_indptr <= 0) return (int)cudaErrorInvalidValue;
  if (args->rank < 0 || args->rank > WS_MAX_RANK || args->n_iters < 0 || args->n_skip < 0 ||
      args->n_skip > WS_MAX_SKIP || args->width < 0 || !args->out ||
      (args->group != 32 && args->group != 64 && args->group != 128 && args->group != 256))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  index32(args) ? launch_step<uint32_t>(*args, s) : launch_step<long long>(*args, s);
  return (int)cudaGetLastError();
}
