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
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it refuses) so
// that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

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
