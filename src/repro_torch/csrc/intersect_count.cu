// intersect_count for Hopper (sm_90a): per-row weighted temporal
// intersection count over two padded neighbor tiles.
//
// Replaces the TPU kernel `intersect_count_pallas` / `_kernel` in
// src/repro/kernels/intersect_count/kernel.py (pallas_call at line 83).
// For every row r of a batch B it counts the pairs (i, j) with
//   a_ids[r,i] == b_ids[f,j] >= 0,
//   a_lo < a_t[r,i] <= a_hi,  b_lo < b_t[f,j] <= b_hi,
//   and, when `ordered`, b_t[f,j] > a_t[r,i],
// and writes the count as int32 to out[r].  The b side is the fixed side
// of the mining compiler's query: it has B_fixed rows and row r reads
// fixed row f = r / rep (rep = B / B_fixed, the C-order flattening of the
// query shape (B_fixed, W1, ..., Wk)), so it is never copied per W row.
// Each window bound is a per-row vector, a per-fixed-row vector, or a
// scalar passed by value; a missing a_t (only with the a window
// (INT32_MIN, INT32_MAX] and not ordered) lets every a slot pass.
//
// Bound on an H100: the bytes (each operand read once: the a side at B
// rows, the fixed side at B_fixed rows, the windows at their own length,
// the output written once) or the Da*Db pair tests, whichever is larger.
// The mining and streaming paths launch it at narrow tiles over many rows
// (Da = 1, Db = 4 or 32, up to 2^20 rows), where the bytes bound it; wide
// tiles (hub rows, up to Da + Db = 6,144) are bound by the pair tests.
//
// Two device paths, chosen by `intersect_count_plan(b, da, db)` (the
// wrapper's `ops.plan` mirrors it):
//
// * "rows" (narrow tiles, many rows).  Persistent blocks of 512 threads,
//   two per SM, walk tiles of R consecutive rows (R from a 32 KB budget of
//   operands, cut so that every block gets at least two tiles).  A group
//   of G lanes counts a row: G is a power of two that gives each lane at
//   least 4 pairs and 2 fixed-row slots and the tile's rows no more than
//   the block's threads (G = 1, a thread a row, at both paths' largest
//   launches; up to 128 for Db = 1,024).  The lanes split the fixed row's
//   Db slots, each tests its slots against the row's Da a slots (held in
//   registers where Da = 1), and the group sums with shuffles, or through
//   shared memory where it spans warps.  A row's fixed row comes from
//   32-bit arithmetic on its offset in the tile.  The rows are read where
//   they lie: the a side at consecutive rows, the fixed side (shared by
//   rep consecutive rows) and the windows mostly from cache.  Copying
//   each tile's contiguous spans into a ring of shared memory first
//   (cp.async, 16-byte chunks, the next tiles in flight) measured
//   1.1–1.8x slower on every rows-path shape on an H100; that variant is
//   kept as a source patch in tools/intersect_variants.py, not here.
// * "block" (wide tiles).  Persistent blocks own runs of consecutive
//   rows.  For each row the block stages the fixed row's b tile in shared
//   memory once as 64-bit keys (id << 32 | t + 2^31), a failing slot (id
//   < 0 or outside the b window) a sentinel above every real key; rows
//   that share the fixed row and a b window that is not per row reuse it.
//   Counting: where sorting pays (many a slots against the tile), the
//   block sorts the keys (bitonic, in shared memory) and each a slot
//   counts its id's run, or its part after t = a_t when ordered, with two
//   binary searches: the paper's per-lane sorted-set intersection.
//   Otherwise the block's threads split the a x b pairs and scan the keys.
//   One block-wide reduction per row.
//
// Second entry, `intersect_count_step_launch`: a whole pairwise ("pw")
// step of the compiled plans in one launch.  It replaces no separate TPU
// kernel: it is the reference's jitted pw bucket program
// (src/repro/core/compiler.py: both `ops.expand` calls, the window-1 and
// skip_eq masks, the Pallas cube through `_pallas_pair_count`, the sum,
// and the hub sweep's offsets, a `fori_loop` in the same program) as one
// launch, where the port's eager sequence
// (kernels/intersect_count/ref.py::pair_step_ref) is some forty.  For each
// lead element e of the broadcast lead shape (B, W1, ..., Wk) it expands
// the frontier node's row of CSR a at offsets offset_a + i, i < width_a
// (d_a times the a sweep steps), and the fixed node's row of CSR b at
// offset_b + j, j < width_b, each entry kept where it lies inside its row
// (the row-end mask of `expand`, the start + offset wrapping in int32, the
// gather clamped) and inside its side's window (lo, hi]; an a entry also
// where its id differs from every skip operand.  It counts the kept pairs
// with equal ids (and, `ordered`, t_b > t_a) and writes the sum, taken in
// uint32 so that it wraps as the plain version's int32 sums do.  The
// "edges" form (cycle3's pairwise count_edges) has no a row: the a entry
// is the frontier id itself, with no time and no window.  CSR ids are node
// ids, never negative, so a -1 frontier id never matches.
//
// Bound on an H100: the bytes (the operands, the distinct 32-byte sectors
// of both expanded rows, the output) or the pair compares, whichever is
// larger; at the mining path's shapes (Wa, Wb <= 64, a lead element's
// pairs in the hundreds) the bytes.  The fixed side depends only on the
// seed, which the reference broadcasts to every lead element
// (`tile(y_ids, d_b)`).  Here a block takes a tile of consecutive lead
// elements, which covers one or a few runs of elements that share the
// fixed node, and stages each run's expanded b slice in shared memory
// once: the entries inside the row, and inside window 2 where that window
// is constant along the run, compacted.  A group of G lanes (1..32, a
// power of two from the pairs a lead element has) takes a lead element:
// its lanes split the a entries (read where they lie, coalesced) and the
// staged b entries, and sum with shuffles, no atomics.  A window 2 that
// varies per lead element is applied at compare time.  Where the b slices
// of a tile do not fit the block's shared memory, they are staged a chunk
// of entries at a time.  Element arithmetic is 64-bit; each operand is
// read through its strides (0 along broadcast axes), so a lifted or
// broadcast view is read in place.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it refuses) so
// that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

#define IC_MAX_RANK 8
#define IC_MAX_SKIP 8

extern "C" {

// one lead operand: a tensor read at ptr + sum(coord[d] * stride[d]), or
// (ptr == NULL) the value `value` everywhere
struct IcOperand {
  const int32_t* ptr;
  long long stride[IC_MAX_RANK];
  int value;
  int pad_;
};

// one CSR: (id, t)-sorted rows
struct IcCsr {
  const int32_t* ids;
  const int32_t* t;
  const int32_t* indptr;
  long long n_flat;
  long long n_indptr;
};

struct IcStepArgs {
  IcCsr a;                    // the frontier side (unread by the edges form)
  IcCsr b;                    // the fixed side
  IcOperand node_a, node_b;   // the frontier node (edges form: the frontier id), the fixed node
  IcOperand lo_a, hi_a;       // window 1, on the a entries' times
  IcOperand lo_b, hi_b;       // window 2, on the b entries' times
  IcOperand skip[IC_MAX_SKIP];
  int32_t* out;               // contiguous, `size` lead elements
  long long size[IC_MAX_RANK];
  long long numel;            // lead elements
  long long run;              // consecutive lead elements that share node_b
  int rank;
  int n_skip;
  int ordered;
  int edges;                  // 1: the a entry is node_a itself
  int b_at_stage;             // 1: lo_b, hi_b constant along a run: applied when staging
  int offset_a, width_a;      // a expansions offset_a + i, i < width_a
  int offset_b, width_b;
  int group;                  // lanes a lead element: 1, 2, ..., 32
  int group_a;                // of them, lanes over the a entries (a power of two dividing group)
  int chunk;                  // b entries of a slice staged at once
  int max_slices;             // runs a tile of lead elements can span
};

}  // extern "C"

namespace {

constexpr int kRowsThreads = 512;
constexpr int kRowsBlocksPerSm = 2;        // __launch_bounds__: 64 registers a thread
constexpr int kTileBytes = 32 * 1024;      // operand bytes a rows-path tile aims at
constexpr int kMaxTileRows = 2048;
constexpr int kBlockThreads = 512;
constexpr int kCrossPairs = 4096;        // Da*Db from which a row gets a block
constexpr int kSmemMax = 232448;         // 227 KB, a block's limit on sm_90
constexpr int kMaxDevices = 64;
constexpr unsigned long long kSentinel = ~0ull;

struct Args {
  const int32_t* a_ids;
  const int32_t* a_t;     // null: every a slot passes (a window full, unordered)
  const int32_t* b_ids;   // (B_fixed, Db)
  const int32_t* b_t;
  const int32_t* win[4];  // a_lo, a_hi, b_lo, b_hi; null: the scalar in win_s
  int32_t win_s[4];
  int win_fixed[4];       // 1: one value per fixed row
  int32_t* out;
  int64_t n_rows;
  int64_t rep;            // rows per fixed row
  int da, db, ordered;
};

int rows_row_bytes(int da, int db) { return 8 * da + 8 * db + 16; }

int plan(long long b, int da, int db) {
  (void)b;
  if ((long long)da * db >= kCrossPairs || rows_row_bytes(da, db) > kTileBytes) return 1;
  return 0;
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// ---- the rows path ----------------------------------------------------------

// a tile row's window bound: a scalar, or from the tile's span of the
// bound (per row at the tile row, per fixed row at the tile's fixed row)
__device__ __forceinline__ int32_t win_at(const Args& p, const int32_t* const* w, int k, int lr, int lf) {
  if (!p.win[k]) return p.win_s[k];
  return w[k][p.win_fixed[k] ? lf : lr];
}

// one row's count over the lanes of its group (this lane's share of the
// fixed row's Db slots against every a slot of the row)
__device__ __forceinline__ int32_t count_row(const Args& p, const int32_t* ai, const int32_t* at,
                                             const int32_t* bi, const int32_t* bt, int32_t alo, int32_t ahi,
                                             int32_t blo, int32_t bhi, int g_lane, int group) {
  int32_t cnt = 0;
  if (p.da == 1) {  // both paths' largest launches: the a slot in registers
    const int32_t ida = ai[0], ta = at ? at[0] : 0;
    if (ida < 0 || ta <= alo || ta > ahi) return 0;
    const int32_t lo = p.ordered ? max(blo, ta) : blo;  // tb > lo covers both tests
#pragma unroll 4
    for (int j = g_lane; j < p.db; j += group) {
      const int32_t tb = bt[j];
      cnt += (bi[j] == ida && tb > lo && tb <= bhi) ? 1 : 0;
    }
    return cnt;
  }
  for (int j = g_lane; j < p.db; j += group) {
    const int32_t id = bi[j], tb = bt[j];
    if (id < 0 || tb <= blo || tb > bhi) continue;
    for (int i = 0; i < p.da; ++i) {
      const int32_t ta = at ? at[i] : 0;
      cnt += (ai[i] == id && ta > alo && ta <= ahi && (!p.ordered || tb > ta)) ? 1 : 0;
    }
  }
  return cnt;
}

__global__ void __launch_bounds__(kRowsThreads, kRowsBlocksPerSm)
    intersect_count_rows_kernel(Args p, int tile_rows, int group) {
  __shared__ int32_t row_sum[kRowsThreads / 64];  // rows of more than a warp
  const int64_t n_tiles = (p.n_rows + tile_rows - 1) / tile_rows;
  const int da = p.da, db = p.db;
  const int rows_per_step = kRowsThreads / group;
  const int slot = threadIdx.x / group;
  const int g_lane = threadIdx.x & (group - 1);
  const bool rep_small = p.rep <= (1 << 30);

  // the tile loop's bound is uniform across the block, so every warp's
  // shuffles, reductions and barriers see all of its lanes
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    if (group > 32) {
      if (threadIdx.x < rows_per_step) row_sum[threadIdx.x] = 0;
      __syncthreads();
    }
    const int64_t r0 = t * tile_rows;
    const int n = (int)min64(tile_rows, p.n_rows - r0);
    const int64_t f0 = r0 / p.rep;
    const int64_t rmod = r0 - f0 * p.rep;  // tile row lr reads fixed row f0 + (rmod + lr) / rep
    const int32_t* a_ids = p.a_ids + r0 * da;
    const int32_t* a_t = p.a_t ? p.a_t + r0 * da : nullptr;
    const int32_t* b_ids = p.b_ids + f0 * db;
    const int32_t* b_t = p.b_t + f0 * db;
    const int32_t* w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = p.win[k] ? p.win[k] + (p.win_fixed[k] ? f0 : r0) : nullptr;

    for (int base = 0; base < n; base += rows_per_step) {
      const int lr = base + slot;
      int32_t cnt = 0;
      if (lr < n) {
        const int lf = p.rep == 1 ? lr
                       : rep_small ? (int)((uint32_t)(rmod + lr) / (uint32_t)p.rep)
                                   : (int)((rmod + lr) / p.rep);
        cnt = count_row(p, a_ids + lr * da, a_t ? a_t + lr * da : nullptr, b_ids + lf * db, b_t + lf * db,
                        win_at(p, w, 0, lr, lf), win_at(p, w, 1, lr, lf), win_at(p, w, 2, lr, lf),
                        win_at(p, w, 3, lr, lf), g_lane, group);
      }
      if (group <= 32) {
        for (int off = group >> 1; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off, group);
        if (lr < n && g_lane == 0) p.out[r0 + lr] = cnt;
      } else {
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if ((threadIdx.x & 31) == 0 && lr < n) atomicAdd(&row_sum[slot], cnt);
      }
    }
    if (group > 32) {  // row_sum is complete
      __syncthreads();
      if (threadIdx.x < n) p.out[r0 + threadIdx.x] = row_sum[threadIdx.x];
    }
  }
}

// ---- the block path ---------------------------------------------------------

__device__ __forceinline__ unsigned long long key_of(int32_t id, int32_t t) {
  return ((unsigned long long)(uint32_t)id << 32) | (uint32_t)(t ^ (int32_t)0x80000000);
}

// keys of s[0, n) (sorted) below k; n a power of two
__device__ __forceinline__ int lower_bound(const unsigned long long* s, int n, unsigned long long k) {
  int pos = 0;
  for (int step = n; step > 0; step >>= 1) {
    if (pos + step <= n && s[pos + step - 1] < k) pos += step;
  }
  return pos;
}

__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* warp_sums) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t total = 0;
  if (threadIdx.x < 32) {
    total = threadIdx.x < (blockDim.x >> 5) ? warp_sums[threadIdx.x] : 0;
    total = __reduce_add_sync(0xffffffffu, total);
  }
  __syncthreads();  // warp_sums is free for the next row
  return total;  // valid in thread 0
}

__device__ __forceinline__ int32_t win_row(const Args& p, int k, int64_t r, int64_t f) {
  return p.win[k] ? p.win[k][p.win_fixed[k] ? f : r] : p.win_s[k];
}

// sorting pays where a thread's share of the scan, Da * Db / threads
// pair tests, outlasts the sort's lg (lg + 1) / 2 barrier-separated
// stages over the P = 2^lg keys, each counted as 2 pair tests (the
// crossover measured between (64, 256), where the scan won, and (256,
// 256), where the sort did)
__device__ inline bool sort_pays(int da, int db, int pow2) {
  int lg = 0;
  while ((1 << lg) < pow2) ++lg;
  return (long long)da * db > (long long)kBlockThreads * 2 * lg * (lg + 1) / 2;
}

__global__ void __launch_bounds__(kBlockThreads) intersect_count_block_kernel(Args p, int pow2, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned long long keys[];  // pow2 keys
  __shared__ int32_t warp_sums[32];
  const int da = p.da, db = p.db;
  const bool sorted = sort_pays(da, db, pow2);
  const bool b_win_per_row = (p.win[2] && !p.win_fixed[2]) || (p.win[3] && !p.win_fixed[3]);
  const int64_t r_begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r_end = min64(p.n_rows, r_begin + rows_per_block);
  // the scan's split of the pairs: nb threads over a row's b keys (the
  // fast index, so a warp reads consecutive keys), na over its a slots
  int na = 1;
  while (na < da && na < (int)blockDim.x) na <<= 1;
  const int nb = blockDim.x / na;
  const int ta = threadIdx.x / nb, tb = threadIdx.x - ta * nb;
  int64_t staged = -1;
  for (int64_t r = r_begin; r < r_end; ++r) {
    const int64_t f = r / p.rep;
    const int32_t alo = win_row(p, 0, r, f), ahi = win_row(p, 1, r, f);
    if (f != staged || b_win_per_row) {
      const int32_t blo = win_row(p, 2, r, f), bhi = win_row(p, 3, r, f);
      __syncthreads();  // the last row's reads of the keys are done
      const int32_t* bi = p.b_ids + f * db;
      const int32_t* bt = p.b_t + f * db;
      for (int j = threadIdx.x; j < pow2; j += blockDim.x) {
        unsigned long long k = kSentinel;
        if (j < db) {
          const int32_t id = bi[j], t = bt[j];
          if (id >= 0 && t > blo && t <= bhi) k = key_of(id, t);
        }
        keys[j] = k;
      }
      __syncthreads();
      if (sorted) {
        for (int span = 2; span <= pow2; span <<= 1) {
          for (int j = span >> 1; j > 0; j >>= 1) {
            for (int q = threadIdx.x; q < (pow2 >> 1); q += blockDim.x) {
              const int lo = 2 * q - (q & (j - 1));
              const int hi = lo + j;
              const unsigned long long x = keys[lo], y = keys[hi];
              if ((x > y) == ((lo & span) == 0)) {
                keys[lo] = y;
                keys[hi] = x;
              }
            }
            __syncthreads();
          }
        }
      }
      staged = f;
    }
    const int32_t* ai = p.a_ids + r * da;
    const int32_t* at = p.a_t ? p.a_t + r * da : nullptr;
    int32_t cnt = 0;
    if (sorted) {
      for (int i = threadIdx.x; i < da; i += blockDim.x) {
        const int32_t id = ai[i], t = at ? at[i] : 0;
        if (id < 0 || t <= alo || t > ahi) continue;
        const unsigned long long k_end = (unsigned long long)((uint32_t)id + 1u) << 32;
        const unsigned long long k_begin = p.ordered ? key_of(id, t) + 1 : (unsigned long long)(uint32_t)id << 32;
        cnt += lower_bound(keys, pow2, k_end) - lower_bound(keys, pow2, k_begin);
      }
    } else {
      for (int i = ta; i < da; i += na) {
        const int32_t id = ai[i], t = at ? at[i] : 0;
        if (id < 0 || t <= alo || t > ahi) continue;
        const unsigned long long k_end = (unsigned long long)((uint32_t)id + 1u) << 32;
        const unsigned long long k_begin = p.ordered ? key_of(id, t) + 1 : (unsigned long long)(uint32_t)id << 32;
        for (int j = tb; j < db; j += nb) {
          const unsigned long long k = keys[j];
          cnt += (k >= k_begin && k < k_end) ? 1 : 0;
        }
      }
    }
    const int32_t total = block_sum(cnt, warp_sums);
    if (threadIdx.x == 0) p.out[r] = total;
  }
}

// ---- launch -----------------------------------------------------------------

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

// opt in once per device to the shared memory a kernel may need
template <typename K>
int opt_in(K kernel, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  // the block's limit less what the kernel declares statically
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax - (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return 0;
}

int launch_rows(const Args& p, cudaStream_t stream) {
  // operand bytes a row brings into its tile, the fixed side at its own rate
  double per_row = 4.0 * p.da * (p.a_t ? 2 : 1) + 8.0 * p.db / (double)p.rep;
  for (int k = 0; k < 4; ++k) {
    if (p.win[k]) per_row += p.win_fixed[k] ? 4.0 / (double)p.rep : 4.0;
  }
  long long rows = (long long)(kTileBytes / per_row);
  if (rows > kMaxTileRows) rows = kMaxTileRows;
  // at least two tiles for each block of a grid of kRowsBlocksPerSm an SM
  const long long spread = 2LL * kRowsBlocksPerSm * sm_count();
  const long long cap = (p.n_rows + spread - 1) / spread;
  if (rows > cap) rows = cap;
  if (rows < 1) rows = 1;
  // lanes per row: a power of two, each lane at least 4 pairs and two
  // fixed-row slots, no more lanes than the tile's rows leave threads for
  int group = 1;
  while (group < kRowsThreads && 2 * group <= p.db && 8LL * group <= (long long)p.da * p.db &&
         rows * 2 * group <= kRowsThreads) {
    group <<= 1;
  }
  const int step = kRowsThreads / group;  // rows a block counts at once
  if (rows > step) rows -= rows % step;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_count_rows_kernel, kRowsThreads, 0);
  if (per_sm < 1) per_sm = 1;
  const long long n_tiles = (p.n_rows + rows - 1) / rows;
  long long blocks = (long long)sm_count() * per_sm;
  if (blocks > n_tiles) blocks = n_tiles;
  intersect_count_rows_kernel<<<(unsigned)blocks, kRowsThreads, 0, stream>>>(p, (int)rows, group);
  return (int)cudaGetLastError();
}

int launch_block(const Args& p, cudaStream_t stream) {
  static bool opted[kMaxDevices] = {false};
  int pow2 = 1;
  while (pow2 < p.db) pow2 <<= 1;
  const int smem = pow2 * 8;
  if (smem > kSmemMax - 32 * 4) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int e = opt_in(intersect_count_block_kernel, opted);
    if (e) return e;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_count_block_kernel, kBlockThreads, smem);
  if (per_sm < 1) per_sm = 1;
  long long blocks = (long long)sm_count() * per_sm;
  if (blocks > p.n_rows) blocks = p.n_rows;
  const long long rows_per_block = (p.n_rows + blocks - 1) / blocks;
  blocks = (p.n_rows + rows_per_block - 1) / rows_per_block;
  intersect_count_block_kernel<<<(unsigned)blocks, kBlockThreads, smem, stream>>>(p, pow2, (int64_t)rows_per_block);
  return (int)cudaGetLastError();
}

// ---- the pw step entry --------------------------------------------------------

constexpr int kStepThreads = 256;
constexpr int kStepOps = 6 + IC_MAX_SKIP;  // node_a, node_b, lo_a, hi_a, lo_b, hi_b, skips
constexpr int kSliceInts = 6;              // first, end, span, lo, hi, kept of a staged slice
// the dynamic shared memory a step launch may take: of the 48 KB a block
// has without opting in to more, room left for the kernel's static words
constexpr int kStepSmem = 47 * 1024;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t op_read(const IcOperand& o, long long off) {
  return o.ptr ? __ldg(o.ptr + off) : o.value;
}

// the offsets of element e's coordinates in the first n operands
__device__ __forceinline__ void op_offsets(const IcStepArgs& a, long long e, int n, long long* o) {
  const IcOperand* ops[kStepOps] = {&a.node_a, &a.node_b, &a.lo_a, &a.hi_a, &a.lo_b, &a.hi_b};
#pragma unroll
  for (int k = 0; k < IC_MAX_SKIP; ++k) ops[6 + k] = &a.skip[k];
#pragma unroll
  for (int k = 0; k < kStepOps; ++k) o[k] = 0;
  for (int d = a.rank - 1; d >= 0; --d) {
    const long long c = e % a.size[d];
    e /= a.size[d];
#pragma unroll
    for (int k = 0; k < kStepOps; ++k) {
      if (k < n) o[k] += c * ops[k]->stride[d];
    }
  }
}

// the row [start, end) of `node`, indptr read as the JAX package clamps
__device__ __forceinline__ void row_of(const IcCsr& c, int32_t node, int32_t& start, int32_t& end) {
  const long long last = c.n_indptr - 1;
  const long long safe = node > 0 ? node : 0;
  start = __ldg(c.indptr + (safe < last ? safe : last));
  end = __ldg(c.indptr + (safe + 1 < last ? safe + 1 : last));
}

// the expansion of a row from `offset`: entry j < width sits at flat
// index first + j (int32, wrapping) and is inside the row where that index
// is below `end`.  Entries j >= the returned span are never inside: where
// first + width cannot wrap, exactly those at end - first and on; else
// none are ruled out and each is checked.  A node < 0 expands nothing.
__device__ __forceinline__ int span_of(int32_t node, int32_t start, int32_t end, int offset, int width,
                                       int32_t& first) {
  first = wrap_add(start, offset);
  if (node < 0) return 0;
  if ((long long)first + width <= 2147483647LL) {
    const long long s = (long long)end - first;
    return (int)(s < 0 ? 0 : (s < width ? s : width));
  }
  return width;
}

__global__ void __launch_bounds__(kStepThreads) intersect_count_step_kernel(const __grid_constant__ IcStepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int max_span;
  const int n_slices = a.max_slices, chunk = a.chunk;
  int2* staged = reinterpret_cast<int2*>(smem);  // (id, t) of each slice's kept entries
  int* sl = reinterpret_cast<int*>(staged + (size_t)n_slices * chunk);
  int *sl_first = sl, *sl_end = sl + n_slices, *sl_span = sl + 2 * n_slices, *sl_lo = sl + 3 * n_slices,
      *sl_hi = sl + 4 * n_slices, *sl_kept = sl + 5 * n_slices;
  const int group = a.group, rows = kStepThreads / group;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r_end = min64(r0 + rows, a.numel);
  const long long q0 = r0 / a.run;
  const int n_sl = (int)((r_end - 1) / a.run - q0 + 1);
  const int32_t cap_a = (int32_t)(a.a.n_flat - 1), cap_b = (int32_t)(a.b.n_flat - 1);

  // the tile's slices: each run's fixed row, its expansion and window 2
  if (threadIdx.x == 0) max_span = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < n_sl; s += kStepThreads) {
    long long o[kStepOps];
    op_offsets(a, (q0 + s) * a.run, 6, o);
    const int32_t node = op_read(a.node_b, o[1]);
    int32_t start, end, first;
    row_of(a.b, node, start, end);
    const int span = span_of(node, start, end, a.offset_b, a.width_b, first);
    sl_first[s] = first;
    sl_end[s] = end;
    sl_span[s] = span;
    sl_lo[s] = a.b_at_stage ? op_read(a.lo_b, o[4]) : 0;
    sl_hi[s] = a.b_at_stage ? op_read(a.hi_b, o[5]) : 0;
    if (span > 0) atomicMax(&max_span, span);
  }
  __syncthreads();
  const int spans = max_span;  // the same in every thread: the chunk loop's bound

  // this thread's lead element and its share of the pairs
  const int g = threadIdx.x / group, lane = threadIdx.x % group;
  const int ga = a.group_a, gb = group / ga, la = lane % ga, lb = lane / ga;
  const long long r = r0 + g;
  const bool live = r < r_end;
  int slice = 0, span_a = 0;
  int32_t node_a = -1, first_a = 0, end_a = 0, lo_a = 0, hi_a = 0, lo_b = 0, hi_b = 0;
  int32_t skip[IC_MAX_SKIP];
#pragma unroll
  for (int k = 0; k < IC_MAX_SKIP; ++k) skip[k] = 0;
  if (live) {
    long long o[kStepOps];
    op_offsets(a, r, 6 + a.n_skip, o);
    slice = (int)(r / a.run - q0);
    node_a = op_read(a.node_a, o[0]);
    lo_a = op_read(a.lo_a, o[2]);
    hi_a = op_read(a.hi_a, o[3]);
    lo_b = a.b_at_stage ? (int32_t)0x80000000 : op_read(a.lo_b, o[4]);
    hi_b = a.b_at_stage ? 0x7fffffff : op_read(a.hi_b, o[5]);
#pragma unroll
    for (int k = 0; k < IC_MAX_SKIP; ++k) skip[k] = k < a.n_skip ? op_read(a.skip[k], o[6 + k]) : 0;
    if (a.edges) {
      span_a = node_a >= 0 ? 1 : 0;
    } else {
      int32_t start;
      row_of(a.a, node_a, start, end_a);
      span_a = span_of(node_a, start, end_a, a.offset_a, a.width_a, first_a);
    }
  }
  // an entry kept at staging passed lo_b < t, so t > INT32_MIN: the full
  // window (INT32_MIN, INT32_MAX] then keeps every staged entry
  uint32_t acc = 0;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int c0 = 0; c0 < spans; c0 += chunk) {
    __syncthreads();  // the last chunk's compares are done
    for (int s = threadIdx.x; s < n_sl; s += kStepThreads) sl_kept[s] = 0;
    __syncthreads();
    // stage entries [c0, c0 + chunk) of every slice, the kept ones packed
    // to the front (a warp reserves its kept entries of a slice at once)
    const int total = n_sl * chunk;
    for (int base = warp * 32; base < total; base += kStepThreads) {
      const int f = base + wl;
      const int s = f / chunk, j = c0 + (f - s * chunk);
      bool keep = false;
      int32_t id = 0, t = 0;
      if (f < total && j < sl_span[s]) {
        const int32_t idx = wrap_add(sl_first[s], j);
        if (idx < sl_end[s]) {
          const int32_t ci = min(max(idx, 0), cap_b);
          t = __ldg(a.b.t + ci);
          keep = !a.b_at_stage || (t > sl_lo[s] && t <= sl_hi[s]);
          if (keep) id = __ldg(a.b.ids + ci);
        }
      }
      const unsigned peers = __match_any_sync(0xffffffffu, keep ? s : -1);
      if (keep) {
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (wl == leader) at = atomicAdd(&sl_kept[s], __popc(peers));
        at = __shfl_sync(peers, at, leader) + __popc(peers & ((1u << wl) - 1));
        staged[(size_t)s * chunk + at] = make_int2(id, t);
      }
    }
    __syncthreads();
    if (live) {
      const int n = sl_kept[slice];
      const int2* ys = staged + (size_t)slice * chunk;
      for (int i = la; i < span_a; i += ga) {
        int32_t xid = node_a, lo = lo_b;
        if (!a.edges) {
          const int32_t idx = wrap_add(first_a, i);
          if (!(idx < end_a)) continue;
          const int32_t ci = min(max(idx, 0), cap_a);
          const int32_t xt = __ldg(a.a.t + ci);
          if (!(xt > lo_a && xt <= hi_a)) continue;
          xid = __ldg(a.a.ids + ci);
          bool kept = true;
#pragma unroll
          for (int k = 0; k < IC_MAX_SKIP; ++k) kept = kept && (k >= a.n_skip || xid != skip[k]);
          if (!kept) continue;
          if (a.ordered) lo = max(lo, xt);  // t_b > lo covers window 2 and the order
        }
        for (int j = lb; j < n; j += gb) {
          const int2 y = ys[j];
          acc += (y.x == xid && y.y > lo && y.y <= hi_b) ? 1u : 0u;
        }
      }
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  if (live && lane == 0) a.out[r] = (int32_t)acc;
}

size_t step_smem(const IcStepArgs& a) {
  return (size_t)a.max_slices * a.chunk * sizeof(int2) + (size_t)a.max_slices * kSliceInts * sizeof(int);
}

}  // namespace

// The path a launch at (B, Da, Db) takes: 0 "rows", 1 "block".
extern "C" int intersect_count_plan(long long b, int da, int db) { return plan(b, da, db); }

// windows: a_lo, a_hi, b_lo, b_hi as pointers (null: the scalar in
// win_s) with win_fixed_mask bit k set where bound k has one value per
// fixed row; a_t may be null; b_ids / b_t have n_rows / rep rows.
extern "C" int intersect_count_launch(
    const void* a_ids, const void* a_t, const void* b_ids, const void* b_t,
    const void* a_lo, const void* a_hi, const void* b_lo, const void* b_hi,
    int a_lo_s, int a_hi_s, int b_lo_s, int b_hi_s, int win_fixed_mask,
    void* out, long long n_rows, long long rep, int da, int db, int ordered, void* stream) {
  if (n_rows <= 0) return 0;
  if (da < 1 || db < 1 || rep < 1 || n_rows % rep) return (int)cudaErrorInvalidValue;
  Args p{};
  p.a_ids = (const int32_t*)a_ids;
  p.a_t = (const int32_t*)a_t;
  p.b_ids = (const int32_t*)b_ids;
  p.b_t = (const int32_t*)b_t;
  const void* win[4] = {a_lo, a_hi, b_lo, b_hi};
  const int win_s[4] = {a_lo_s, a_hi_s, b_lo_s, b_hi_s};
  for (int k = 0; k < 4; ++k) {
    p.win[k] = (const int32_t*)win[k];
    p.win_s[k] = win_s[k];
    p.win_fixed[k] = (win_fixed_mask >> k) & 1;
  }
  p.out = (int32_t*)out;
  p.n_rows = n_rows;
  p.rep = rep;
  p.da = da;
  p.db = db;
  p.ordered = ordered;
  const cudaStream_t s = (cudaStream_t)stream;
  return plan(n_rows, da, db) == 0 ? launch_rows(p, s) : launch_block(p, s);
}

// The step entry's limits and argument layout, for the wrapper to check.
extern "C" int intersect_count_max_rank() { return IC_MAX_RANK; }

extern "C" int intersect_count_max_skip() { return IC_MAX_SKIP; }

extern "C" int intersect_count_step_args_bytes() { return (int)sizeof(IcStepArgs); }

extern "C" int intersect_count_step_smem_max() { return kStepSmem; }

// The dynamic shared memory a step launch of these arguments takes.
extern "C" long long intersect_count_step_smem(const IcStepArgs* args) { return (long long)step_smem(*args); }

// One pw step: see the note at the top.  The wrapper picks group,
// group_a, chunk and max_slices (ops.step_plan); this entry checks them.
extern "C" int intersect_count_step_launch(const IcStepArgs* args, void* stream) {
  const IcStepArgs& a = *args;
  if (a.numel <= 0) return 0;
  const bool pow2 = a.group >= 1 && a.group <= 32 && (a.group & (a.group - 1)) == 0 && a.group_a >= 1 &&
                    a.group_a <= a.group && (a.group_a & (a.group_a - 1)) == 0;
  const IcCsr* csrs[2] = {&a.a, &a.b};
  for (int k = a.edges ? 1 : 0; k < 2; ++k) {
    const IcCsr* c = csrs[k];
    if (!c->ids || !c->t || !c->indptr || c->n_flat <= 0 || c->n_indptr <= 0) return (int)cudaErrorInvalidValue;
  }
  if (!pow2 || a.rank < 0 || a.rank > IC_MAX_RANK || a.n_skip < 0 || a.n_skip > IC_MAX_SKIP || !a.out ||
      a.run < 1 || a.chunk < 1 || a.max_slices < 1 || a.width_a < 0 || a.width_b < 0 || a.offset_a < 0 ||
      a.offset_b < 0 || (a.edges && (a.n_skip || a.ordered)))
    return (int)cudaErrorInvalidValue;
  const long long rows = kStepThreads / a.group;
  // the slices a tile of `rows` consecutive lead elements can span
  const long long spanned = (rows + a.run - 2) / a.run + 1;
  if (a.max_slices < (spanned < rows ? spanned : rows)) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(a);
  if (smem > (size_t)kStepSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (a.numel + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  intersect_count_step_kernel<<<(unsigned)blocks, kStepThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
