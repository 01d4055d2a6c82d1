#!/usr/bin/env python3
"""Write copies of a checkout's ``src/`` whose ``intersect_count`` kernel
differs in one choice, for ``tools/bench_intersect.py`` to time:

    python3 tools/intersect_variants.py build/ic_variants --kind lanes --src build/parent/src
    python3 tools/intersect_variants.py build/ic_variants --kind tiles --src src
    python3 tools/bench_intersect.py --src build/parent/src --src build/ic_variants/<name>/src ...

``--kind lanes`` varies the lane-group kernel (one group of 1...32 lanes a
row, each warp staging its rows in shared memory and then counting them;
the kernel of ``csrc/intersect_count.cu`` before it had two paths):

- ``span``: each warp copies its rows' tiles as one contiguous span (all
  32 lanes over the rows' consecutive words) instead of each lane group
  reading its own row at the row stride;
- ``ahead2``: each warp stages two batches of rows (``stride`` apart)
  with their loads interleaved before it counts either, so two row
  groups' loads are in flight per warp instead of one;
- ``block_wide``: tiles of at least 4,096 pairs go to a second kernel
  where a block of 256 threads owns a row (both tiles staged once, the
  pairs strided over the block, one block-wide reduction), instead of a
  warp.

``--kind tiles`` varies the two-path kernel (``csrc/intersect_count.cu``
with ``ops.plan``):

- ``staged3`` / ``staged2`` / ``staged1``: the rows path copies each
  tile's contiguous spans into shared memory with ``cp.async`` (16-byte
  chunks) in a ring of 3, 2 or 1 stages and counts from there, instead
  of reading each row's words from device memory where they lie (the
  kernel carries no ring: this file holds its code, ``STAGED_*``);
- ``blocks4``: the rows path launches for four blocks an SM (32
  registers a thread) instead of two (64);
- ``unroll2``: the rows path's loop over a tile's row steps unrolled by
  two, so a thread's loads for two rows can be in flight together;
- ``all_rows`` / ``all_block``: every shape on the rows path, or on the
  block path (where its shared memory allows), whatever ``plan`` says;
- ``scan`` / ``sort``: the block path always counts by a scan of the
  staged b keys (the block's threads split the a x b pairs), or always by
  sorting them and binary-searching each a slot, instead of choosing by
  its cost rule (``sort_pays``).

Each copy goes to ``<out>/<name>/src`` and builds its own library under
``<out>/<name>/build/kernels``.  The copies are experiments, not a
configuration of the package.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

CU = "repro_torch/csrc/intersect_count.cu"

# ---- the lane-group kernel ------------------------------------------------

LANES_STAGE = """      for (int i = g_lane; i < da; i += group) {
        const int32_t id = ai[i], t = at[i];
        s_aid[i] = (id >= 0 && t > alo && t <= ahi) ? id : -1;
        s_at[i] = t;
      }
      for (int j = g_lane; j < db; j += group) {
        const int32_t id = bi[j], t = bt[j];
        s_bid[j] = (id >= 0 && t > blo && t <= bhi) ? id : -2;
        s_bt[j] = t;
      }
    }
    __syncwarp();
"""
SPAN_STAGE = """    }
    {  // the warp's rows are consecutive: copy their tiles as one span
      const int64_t nr = min((int64_t)rows_per_warp, n_rows - base);
      int32_t* wsm = smem + warp * rows_per_warp * 2 * (da + db);
      for (int e = lane; e < nr * da; e += 32) {
        const int r = e / da, i = e - r * da;
        const int64_t g = base * da + e;
        const int32_t id = a_ids[g], t = a_t[g];
        int32_t* s = wsm + r * 2 * (da + db);
        s[i] = (id >= 0 && t > a_lo[base + r] && t <= a_hi[base + r]) ? id : -1;
        s[da + i] = t;
      }
      for (int e = lane; e < nr * db; e += 32) {
        const int r = e / db, j = e - r * db;
        const int64_t g = base * db + e;
        const int32_t id = b_ids[g], t = b_t[g];
        int32_t* s = wsm + r * 2 * (da + db) + 2 * da;
        s[j] = (id >= 0 && t > b_lo[base + r] && t <= b_hi[base + r]) ? id : -2;
        s[db + j] = t;
      }
    }
    __syncwarp();
"""

AHEAD2_KERNEL = r'''__global__ void intersect_count_kernel(
    const int32_t* __restrict__ a_ids, const int32_t* __restrict__ a_t,
    const int32_t* __restrict__ b_ids, const int32_t* __restrict__ b_t,
    const int32_t* __restrict__ a_lo, const int32_t* __restrict__ a_hi,
    const int32_t* __restrict__ b_lo, const int32_t* __restrict__ b_hi,
    int32_t* __restrict__ out, int64_t n_rows, int da, int db, int ordered,
    int group) {
  // two row batches a warp: smem holds 2 * rows_per_warp rows per warp
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int rows_per_warp = 32 / group;
  const int slot = lane / group;
  const int g_lane = lane - slot * group;
  const int per = 2 * (da + db);
  int32_t* s0 = smem + (warp * 2 * rows_per_warp + slot) * per;
  int32_t* s1 = s0 + rows_per_warp * per;
  const int n_pairs = da * db;
  const int64_t stride = (int64_t)gridDim.x * warps * rows_per_warp;
  for (int64_t base = ((int64_t)blockIdx.x * warps + warp) * rows_per_warp;
       base < n_rows; base += 2 * stride) {
    const int64_t r0 = base + slot, r1 = base + stride + slot;
    const bool v0 = r0 < n_rows, v1 = r1 < n_rows;
    const int32_t alo0 = v0 ? a_lo[r0] : 0, ahi0 = v0 ? a_hi[r0] : 0;
    const int32_t blo0 = v0 ? b_lo[r0] : 0, bhi0 = v0 ? b_hi[r0] : 0;
    const int32_t alo1 = v1 ? a_lo[r1] : 0, ahi1 = v1 ? a_hi[r1] : 0;
    const int32_t blo1 = v1 ? b_lo[r1] : 0, bhi1 = v1 ? b_hi[r1] : 0;
    for (int i = g_lane; i < da; i += group) {
      const int32_t id0 = v0 ? a_ids[r0 * da + i] : -1, t0 = v0 ? a_t[r0 * da + i] : 0;
      const int32_t id1 = v1 ? a_ids[r1 * da + i] : -1, t1 = v1 ? a_t[r1 * da + i] : 0;
      s0[i] = (id0 >= 0 && t0 > alo0 && t0 <= ahi0) ? id0 : -1;
      s0[da + i] = t0;
      s1[i] = (id1 >= 0 && t1 > alo1 && t1 <= ahi1) ? id1 : -1;
      s1[da + i] = t1;
    }
    for (int j = g_lane; j < db; j += group) {
      const int32_t id0 = v0 ? b_ids[r0 * db + j] : -2, t0 = v0 ? b_t[r0 * db + j] : 0;
      const int32_t id1 = v1 ? b_ids[r1 * db + j] : -2, t1 = v1 ? b_t[r1 * db + j] : 0;
      s0[2 * da + j] = (id0 >= 0 && t0 > blo0 && t0 <= bhi0) ? id0 : -2;
      s0[2 * da + db + j] = t0;
      s1[2 * da + j] = (id1 >= 0 && t1 > blo1 && t1 <= bhi1) ? id1 : -2;
      s1[2 * da + db + j] = t1;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int32_t* s = k ? s1 : s0;
      const bool valid = k ? v1 : v0;
      int32_t cnt = 0;
      if (valid) {
        int i = g_lane / db;
        int j = g_lane - i * db;
        for (int p = g_lane; p < n_pairs; p += group) {
          const bool eq = s[i] == s[2 * da + j];
          cnt += (eq && (!ordered || s[2 * da + db + j] > s[da + i])) ? 1 : 0;
          j += group;
          if (j >= db) {
            const int q = j / db;
            i += q;
            j -= q * db;
          }
        }
      }
      for (int off = group >> 1; off > 0; off >>= 1) {
        cnt += __shfl_down_sync(0xffffffffu, cnt, off, group);
      }
      if (valid && g_lane == 0) out[k ? r1 : r0] = cnt;
    }
    __syncwarp();
  }
}

}  // namespace
'''
AHEAD2_LAUNCH = (
    ("  const int per_warp = per_row * (32 / group);", "  const int per_warp = 2 * per_row * (32 / group);"),
    ("  if (da < 1 || db < 1 || per_row > kMaxSmemBytes) {", "  if (da < 1 || db < 1 || 2 * per_row > kMaxSmemBytes) {"),
)

BLOCK_WIDE_KERNEL = r'''__global__ void intersect_count_block_kernel(
    const int32_t* __restrict__ a_ids, const int32_t* __restrict__ a_t,
    const int32_t* __restrict__ b_ids, const int32_t* __restrict__ b_t,
    const int32_t* __restrict__ a_lo, const int32_t* __restrict__ a_hi,
    const int32_t* __restrict__ b_lo, const int32_t* __restrict__ b_hi,
    int32_t* __restrict__ out, int64_t n_rows, int da, int db, int ordered) {
  // a block per row: both tiles staged once, pairs strided over the block
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_sums[32];
  int32_t* s_aid = smem;
  int32_t* s_at = s_aid + da;
  int32_t* s_bid = s_at + da;
  int32_t* s_bt = s_bid + db;
  const int n_pairs = da * db;
  const int nt = blockDim.x;
  for (int64_t row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const int32_t alo = a_lo[row], ahi = a_hi[row], blo = b_lo[row], bhi = b_hi[row];
    for (int i = threadIdx.x; i < da; i += nt) {
      const int32_t id = a_ids[row * da + i], t = a_t[row * da + i];
      s_aid[i] = (id >= 0 && t > alo && t <= ahi) ? id : -1;
      s_at[i] = t;
    }
    for (int j = threadIdx.x; j < db; j += nt) {
      const int32_t id = b_ids[row * db + j], t = b_t[row * db + j];
      s_bid[j] = (id >= 0 && t > blo && t <= bhi) ? id : -2;
      s_bt[j] = t;
    }
    __syncthreads();
    int32_t cnt = 0;
    int i = threadIdx.x / db;
    int j = threadIdx.x - i * db;
    for (int p = threadIdx.x; p < n_pairs; p += nt) {
      cnt += (s_aid[i] == s_bid[j] && (!ordered || s_bt[j] > s_at[i])) ? 1 : 0;
      j += nt;
      if (j >= db) {
        const int q = j / db;
        i += q;
        j -= q * db;
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x < 32) {
      int32_t v = threadIdx.x < (nt >> 5) ? warp_sums[threadIdx.x] : 0;
      v = __reduce_add_sync(0xffffffffu, v);
      if (threadIdx.x == 0) out[row] = v;
    }
    __syncthreads();
  }
}

}  // namespace
'''
BLOCK_WIDE_LAUNCH = (
    ("  const int group = group_lanes(da * db);",
     "  if (da * db >= 4096) {\n"
     "    long long blocks = n_rows < kMaxBlocks ? n_rows : kMaxBlocks;\n"
     "    intersect_count_block_kernel<<<(unsigned)blocks, 256, (size_t)per_row, (cudaStream_t)stream>>>(\n"
     "        (const int32_t*)a_ids, (const int32_t*)a_t, (const int32_t*)b_ids,\n"
     "        (const int32_t*)b_t, (const int32_t*)a_lo, (const int32_t*)a_hi,\n"
     "        (const int32_t*)b_lo, (const int32_t*)b_hi, (int32_t*)out,\n"
     "        (int64_t)n_rows, da, db, ordered);\n"
     "    return (int)cudaGetLastError();\n"
     "  }\n"
     "  const int group = group_lanes(da * db);"),
)

NAMESPACE_END = "}  // namespace\n"
KERNEL_START = "__global__ void intersect_count_kernel("


def lanes_variants(cu: str) -> dict:
    start, end = cu.index(KERNEL_START), cu.index(NAMESPACE_END)
    tail = cu[end + len(NAMESPACE_END):]
    return {
        "span": apply(cu, ((LANES_STAGE, SPAN_STAGE),)),
        "ahead2": apply(cu[:start] + AHEAD2_KERNEL + tail, AHEAD2_LAUNCH),
        "block_wide": apply(cu[:end] + BLOCK_WIDE_KERNEL + tail, BLOCK_WIDE_LAUNCH),
    }


# ---- the two-path kernel ---------------------------------------------------

# the rows path's cp.async ring (measured slower than reading rows in
# place, so the shipped kernel has none): its constants, the copy helpers
# and tile layout, the kernel that counts from the ring, and its launch
STAGED_CONSTS = """constexpr bool kStageSpans = true;  // rows path: copy tiles into a ring
constexpr int kStages = 3;          // the ring's depth
constexpr int kStageMaxBytes = 36 * 1024;  // two blocks of kStages stages fit in an SM
"""
STAGED_HELPERS = r'''// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// words of `src` past its 16-byte boundary: the shared copy starts that
// many words into its (16-byte aligned) slot, so both sides line up
__device__ __forceinline__ int shift_of(const int32_t* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

// the block copies n words from src into slot + shift_of(src)
__device__ __forceinline__ void copy_span(int32_t* slot, const int32_t* src, int n) {
  const int s = shift_of(src);
  int32_t* dst = slot + s;
  const int head = min(n, (4 - s) & 3);
  const int chunks = (n - head) >> 2;
  const int tail = n - head - 4 * chunks;
  const int items = head + chunks + tail;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    if (it < head) {
      cp_async4(dst + it, src + it);
    } else if (it < head + chunks) {
      const int w = head + 4 * (it - head);
      cp_async16(dst + w, src + w);
    } else {
      const int w = head + 4 * chunks + (it - head - chunks);
      cp_async4(dst + w, src + w);
    }
  }
}

// ---- the rows path ----------------------------------------------------------

struct Layout {       // word offsets inside one ring stage, and the tiling
  int aid, at, bid, bt, win[4];
  int stage_words;
  int tile_rows, fixed_cap, group;
};

'''
STAGED_KERNEL = r'''__global__ void __launch_bounds__(kRowsThreads, kRowsBlocksPerSm) intersect_count_rows_kernel(Args p, Layout L) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int32_t row_sum[kRowsThreads / 64];  // rows of more than a warp
  const int64_t n_tiles = (p.n_rows + L.tile_rows - 1) / L.tile_rows;
  if ((int64_t)blockIdx.x >= n_tiles) return;
  const int my_tiles = (int)((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int da = p.da, db = p.db, group = L.group;

  // the spans of this block's k-th tile go into ring stage k % kStages,
  // as one cp.async group
  auto fetch = [&](int k) {
    if (kStageSpans && k < my_tiles) {
      const int64_t t = (int64_t)blockIdx.x + (int64_t)k * gridDim.x;
      const int64_t r0 = t * L.tile_rows;
      const int n = (int)min64(L.tile_rows, p.n_rows - r0);
      const int64_t f0 = r0 / p.rep;
      const int nf = (int)((r0 + n - 1) / p.rep - f0 + 1);
      int32_t* st = smem + (k % kStages) * L.stage_words;
      copy_span(st + L.aid, p.a_ids + r0 * da, n * da);
      if (p.a_t) copy_span(st + L.at, p.a_t + r0 * da, n * da);
      copy_span(st + L.bid, p.b_ids + f0 * db, nf * db);
      copy_span(st + L.bt, p.b_t + f0 * db, nf * db);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (p.win[w]) {
          if (p.win_fixed[w]) copy_span(st + L.win[w], p.win[w] + f0, nf);
          else copy_span(st + L.win[w], p.win[w] + r0, n);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);

  const int rows_per_step = kRowsThreads / group;
  const int slot = threadIdx.x / group;
  const int g_lane = threadIdx.x & (group - 1);
  const bool rep_small = p.rep <= (1 << 30);

  for (int k = 0; k < my_tiles; ++k) {
    fetch(k + kStages - 1);
    cp_async_wait<kStages - 1>();
    if (group > 32 && threadIdx.x < rows_per_step) row_sum[threadIdx.x] = 0;
    if (kStageSpans || group > 32) __syncthreads();

    const int64_t t = (int64_t)blockIdx.x + (int64_t)k * gridDim.x;
    const int64_t r0 = t * L.tile_rows;
    const int n = (int)min64(L.tile_rows, p.n_rows - r0);
    const int64_t f0 = r0 / p.rep;
    const int64_t rmod = r0 - f0 * p.rep;  // tile row lr reads fixed row f0 + (rmod + lr) / rep
    const int32_t* st = smem + (k % kStages) * L.stage_words;
    const int32_t* a_ids = p.a_ids + r0 * da;
    const int32_t* a_t = p.a_t ? p.a_t + r0 * da : nullptr;
    const int32_t* b_ids = p.b_ids + f0 * db;
    const int32_t* b_t = p.b_t + f0 * db;
    const int32_t* w[4];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      const int32_t* g = p.win[k2] ? p.win[k2] + (p.win_fixed[k2] ? f0 : r0) : nullptr;
      w[k2] = kStageSpans && g ? st + L.win[k2] + shift_of(g) : g;
    }
    if (kStageSpans) {  // the staged copies, each at its span's offset mod 16
      a_ids = st + L.aid + shift_of(a_ids);
      if (a_t) a_t = st + L.at + shift_of(a_t);
      b_ids = st + L.bid + shift_of(b_ids);
      b_t = st + L.bt + shift_of(b_t);
    }

    // the loop bound is uniform across the block, so every warp's
    // shuffles and reductions see all of its lanes
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
    // the stage is refilled by the next fetch; row_sum is complete
    if (kStageSpans || group > 32) __syncthreads();
    if (group > 32 && threadIdx.x < n) p.out[r0 + threadIdx.x] = row_sum[threadIdx.x];
  }
  cp_async_wait<0>();
}

'''
STAGED_LAUNCH = r'''int round16w(int words) { return (words + 3) & ~3; }

// the ring stage's layout for tiles of `rows` rows
Layout layout_for(const Args& p, int rows, int group) {
  Layout L{};
  const long long cap = (rows - 1) / p.rep + 2;
  L.fixed_cap = (int)(cap < rows ? cap : rows);
  L.tile_rows = rows;
  L.group = group;
  int w = 0;
  auto take = [&](int words) { const int at = w; w += round16w(words + 3); return at; };
  L.aid = take(rows * p.da);
  L.at = p.a_t ? take(rows * p.da) : 0;
  L.bid = take(L.fixed_cap * p.db);
  L.bt = take(L.fixed_cap * p.db);
  for (int k = 0; k < 4; ++k) L.win[k] = p.win[k] ? take(p.win_fixed[k] ? L.fixed_cap : rows) : 0;
  L.stage_words = w;
  return L;
}

int launch_rows(const Args& p, cudaStream_t stream) {
  static bool opted[kMaxDevices] = {false};
  // bytes a row brings into a stage, the fixed side at its own rate
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
  Layout L = layout_for(p, (int)rows, group);
  while (L.stage_words * 4 > kStageMaxBytes && L.tile_rows > 1) L = layout_for(p, L.tile_rows / 2, group);
  if (L.stage_words * 4 > kStageMaxBytes) return (int)cudaErrorInvalidValue;
  const int smem = kStageSpans ? kStages * L.stage_words * 4 : 0;
  if (smem > 48 * 1024) {
    const int e = opt_in(intersect_count_rows_kernel, opted);
    if (e) return e;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_count_rows_kernel, kRowsThreads, smem);
  if (per_sm < 1) per_sm = 1;
  const long long n_tiles = (p.n_rows + L.tile_rows - 1) / L.tile_rows;
  long long blocks = (long long)sm_count() * per_sm;
  if (blocks > n_tiles) blocks = n_tiles;
  intersect_count_rows_kernel<<<(unsigned)blocks, kRowsThreads, smem, stream>>>(p, L);
  return (int)cudaGetLastError();
}

'''
ROWS_KERNEL = ("__global__ void __launch_bounds__(kRowsThreads, kRowsBlocksPerSm)\n    intersect_count_rows_kernel",
               "// ---- the block path")
ROWS_LAUNCH = ("int launch_rows(", "int launch_block(")
TILE_BYTES = "constexpr int kTileBytes = 32 * 1024;      // operand bytes a rows-path tile aims at\n"
ROWS_HEADING = "// ---- the rows path " + "-" * 58 + "\n\n"


def staged(cu: str, stages: int) -> str:
    cu = apply(cu, ((TILE_BYTES, TILE_BYTES + STAGED_CONSTS.replace("kStages = 3", f"kStages = {stages}")),
                    (ROWS_HEADING, STAGED_HELPERS)))
    return between(between(cu, ROWS_KERNEL, STAGED_KERNEL), ROWS_LAUNCH, STAGED_LAUNCH)


PLAN = "int plan(long long b, int da, int db) {\n  (void)b;\n"
SORT_PAYS = "__device__ inline bool sort_pays(int da, int db, int pow2) {\n"
TILES = {
    "blocks4": (("constexpr int kRowsBlocksPerSm = 2;", "constexpr int kRowsBlocksPerSm = 4;"),),
    "unroll2": (("    for (int base = 0; base < n; base += rows_per_step) {",
                 "#pragma unroll 2\n    for (int base = 0; base < n; base += rows_per_step) {"),),
    "all_rows": ((PLAN, PLAN + "  return 0;\n"),),
    "all_block": ((PLAN, PLAN + "  return 1;\n"),),
    "scan": ((SORT_PAYS, SORT_PAYS + "  return false;\n"),),
    "sort": ((SORT_PAYS, SORT_PAYS + "  return true;\n"),),
}


def tiles_variants(cu: str) -> dict:
    return {**{f"staged{n}": staged(cu, n) for n in (3, 2, 1)},
            **{name: apply(cu, edits) for name, edits in TILES.items()}}


def between(cu: str, marks, text: str) -> str:
    """``cu`` with the text from ``marks[0]`` up to ``marks[1]`` replaced."""
    for m in marks:
        if cu.count(m) != 1:
            raise SystemExit(f"intersect_variants.py: {m[:60]!r} is not in the kernel exactly once; "
                             "point --src at a checkout with that kernel")
    return cu[:cu.index(marks[0])] + text + cu[cu.index(marks[1]):]


def apply(cu: str, edits) -> str:
    for old, new in edits:
        if cu.count(old) != 1:
            raise SystemExit(f"intersect_variants.py: {old[:60]!r} is not in the kernel exactly once; "
                             "point --src at a checkout with that kernel")
        cu = cu.replace(old, new)
    return cu


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--src", type=Path, required=True, help="src/ of the checkout to vary")
    ap.add_argument("--kind", choices=("lanes", "tiles"), required=True)
    args = ap.parse_args()
    text = (args.src / CU).read_text()
    variants = lanes_variants(text) if args.kind == "lanes" else tiles_variants(text)
    for name, cu in variants.items():
        dst = args.out / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(args.src, dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "src" / CU).write_text(cu)
        print(name, dst / "src")


if __name__ == "__main__":
    main()
