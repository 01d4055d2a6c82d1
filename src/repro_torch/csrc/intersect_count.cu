// intersect_count for Hopper (sm_90a): per-row weighted temporal
// intersection count over two padded neighbor tiles.
//
// Replaces the TPU kernel `intersect_count_pallas` / `_kernel` in
// src/repro/kernels/intersect_count/kernel.py (pallas_call at line 83).
// For every row r of a batch B it counts the pairs (i, j) with
//   a_ids[r,i] == b_ids[r,j] >= 0,
//   a_lo[r] < a_t[r,i] <= a_hi[r],  b_lo[r] < b_t[r,j] <= b_hi[r],
//   and, when `ordered`, b_t[r,j] > a_t[r,i],
// and writes the count as int32 to out[r].
//
// Bound on an H100: each input byte is read once and each output written
// once, B*(8*Da + 8*Db + 20) bytes, against B*Da*Db pair tests.  At the
// bucket-ladder widths of the mining compiler (Da, Db in {1, 4, ..., 1024})
// the bytes bound it below Da*Db of a few hundred and the pair tests above.
//
// Design (a first, simple kernel; the TPU version's VMEM tiling has no
// counterpart here):
//   * a group of G lanes per row (G = 32, a whole warp, once a row has
//     >= 128 pairs; fewer lanes, down to one, for the tiny tiles of the
//     pairwise count_edges, so a warp works on 32/G rows at once);
//     grid-stride over rows, the ragged B edge handled by the row loop
//     itself, no padding to a block multiple;
//   * the row's two tiles are staged once in shared memory, with the
//     window and the id >= 0 test folded in (a failing slot becomes -1 on
//     the a side and -2 on the b side, so two failing slots never match),
//     so the pair loop reads only shared memory;
//   * the group's lanes stride over the flattened pair index
//     p in [0, Da*Db), so the Da = 1 `count_edges` shape keeps its lanes
//     busy;
//   * an int32 count per lane (a row has at most Da*Db pairs), reduced
//     across the group with __shfl_down_sync.
// Shared memory per block is (threads / G) * (Da + Db) * 8 bytes, kept at
// or under 48 KB so no opt-in to dynamic shared memory is needed
// (Da = Db = 1024 runs 3 warps per block).  Launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() so a refused
// launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxBlocks = 1 << 16;

// lanes per row: a power of two, about 4 pairs per lane for small tiles
int group_lanes(int n_pairs) {
  int g = 1;
  while (g < 32 && 4 * g * 2 <= n_pairs) g <<= 1;
  return g;
}

__global__ void intersect_count_kernel(
    const int32_t* __restrict__ a_ids, const int32_t* __restrict__ a_t,
    const int32_t* __restrict__ b_ids, const int32_t* __restrict__ b_t,
    const int32_t* __restrict__ a_lo, const int32_t* __restrict__ a_hi,
    const int32_t* __restrict__ b_lo, const int32_t* __restrict__ b_hi,
    int32_t* __restrict__ out, int64_t n_rows, int da, int db, int ordered,
    int group) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int rows_per_warp = 32 / group;
  const int slot = lane / group;  // this lane's row within the warp
  const int g_lane = lane - slot * group;
  int32_t* s_aid = smem + (warp * rows_per_warp + slot) * 2 * (da + db);
  int32_t* s_at = s_aid + da;
  int32_t* s_bid = s_at + da;
  int32_t* s_bt = s_bid + db;
  const int n_pairs = da * db;
  const int64_t stride = (int64_t)gridDim.x * warps * rows_per_warp;

  // the loop bound is uniform across the warp (every lane runs the same
  // trips), so the full-mask warp primitives below are safe
  for (int64_t base = ((int64_t)blockIdx.x * warps + warp) * rows_per_warp;
       base < n_rows; base += stride) {
    const int64_t row = base + slot;
    const bool valid = row < n_rows;
    if (valid) {
      const int32_t alo = a_lo[row], ahi = a_hi[row];
      const int32_t blo = b_lo[row], bhi = b_hi[row];
      const int32_t* ai = a_ids + row * da;
      const int32_t* at = a_t + row * da;
      const int32_t* bi = b_ids + row * db;
      const int32_t* bt = b_t + row * db;
      for (int i = g_lane; i < da; i += group) {
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

    int32_t cnt = 0;
    if (valid) {
      int i = g_lane / db;
      int j = g_lane - i * db;
      for (int p = g_lane; p < n_pairs; p += group) {
        const bool eq = s_aid[i] == s_bid[j];
        cnt += (eq && (!ordered || s_bt[j] > s_at[i])) ? 1 : 0;
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
    if (valid && g_lane == 0) out[row] = cnt;
    __syncwarp();  // the next rows overwrite this warp's tiles
  }
}

}  // namespace

extern "C" int intersect_count_launch(
    const void* a_ids, const void* a_t, const void* b_ids, const void* b_t,
    const void* a_lo, const void* a_hi, const void* b_lo, const void* b_hi,
    void* out, long long n_rows, int da, int db, int ordered, void* stream) {
  if (n_rows <= 0) return 0;
  const int per_row = (da + db) * 2 * (int)sizeof(int32_t);
  if (da < 1 || db < 1 || per_row > kMaxSmemBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const int group = group_lanes(da * db);
  const int per_warp = per_row * (32 / group);
  int warps = per_warp > kMaxSmemBytes ? 1 : kMaxSmemBytes / per_warp;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (warps * per_warp > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const long long rows_per_block = (long long)warps * (32 / group);
  long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  intersect_count_kernel<<<(unsigned)blocks, warps * 32,
                           (size_t)warps * per_warp, (cudaStream_t)stream>>>(
      (const int32_t*)a_ids, (const int32_t*)a_t, (const int32_t*)b_ids,
      (const int32_t*)b_t, (const int32_t*)a_lo, (const int32_t*)a_hi,
      (const int32_t*)b_lo, (const int32_t*)b_hi, (int32_t*)out,
      (int64_t)n_rows, da, db, ordered, group);
  return (int)cudaGetLastError();
}
