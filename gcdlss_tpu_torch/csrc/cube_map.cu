// k^3 submanifold neighbor map for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_v2` of gcdlss_tpu/ops/plan_kernel.py (with
// its planning and repair passes `boundary_ranks`, `plan_cube_prepare_v2` and
// `repair_far_pairs_v2`).
//
// Input: the sorted, unique voxel keys of one level as two int32 arrays
// (key_hi = b * FIELD + x, key_lo = y * FIELD + z, coordinates offset into
// [0, FIELD); see gcdlss_tpu_torch/ops/coords.py), sentinel-padded to the
// level capacity `cap`. Output: nbr [cap, k1^3] int32, the row of the voxel
// at offset `offsets[c]` (itertools.product order, z fastest) or -1.
//
// It computes exactly what the join path computes (ops/plan.py,
// `join_neighbor_map`), bit for bit. That path joins the first half of the
// offsets with `encode_coords`' clip to the field, takes the row itself for
// the center, and transposes the first half into the second with a
// scatter-max: nbr[j, kk-1-c] = max{i : nbr[i, c] = j}. Read per row, that is
// (`plan_kernel.cube_direct_rule` states the same in PyTorch):
//   * a row whose x, y and z all lie r = k1 / 2 or more inside the field
//     ("fast": every real voxel) has nbr[i, c] = the row of key_i + offset_c
//     for every c, both halves: no query is clipped, and the only row whose
//     clipped query can land on row i at offset -offset_c is that neighbour;
//   * a row within r of a face of the field ("slow") has, for c < half, the
//     row of the clipped query, and for c > half the largest row among the
//     voxels v with clip(v + offset_{kk-1-c}) = coords_i: per axis, v = a - d
//     inside the field, or the run of values that the clip folds onto a = 0
//     or a = FIELD - 1. At most (r + 1)^3 voxels, each looked up.
// So every row is computed and written whole by the block that owns it: one
// launch, no second pass over the searched half, no atomics, and the result
// does not depend on the order in which blocks run.
//
// What bounds it on the card: the store of the map (69 MB at k1 = 5, cap =
// 138,240: 0.021 ms at 3.35 TB/s); the searches must hide under it. What the
// design does about that:
//   * one search per (row, (dx, dy) column), not per offset: the k1 queries
//     of a column are k1 consecutive keys, so the entries are read from the
//     k1 table rows that follow the column's insertion rank. The center
//     column starts at row i - r without a search. 24 searches a row at
//     k1 = 5, not 62.
//   * short searches, from shared memory. A block owns 128 consecutive rows.
//     Their keys are sorted, and a fast row's queries are key + constant, so
//     for one dx all queries of the block lie between the first fast row's
//     lowest query (dy = dz = -r) and the last fast row's highest. Two
//     searches over the whole table per (block, dx) find that rank range
//     (a warp each, 32 probes a round: 4 rounds of loads, not 18);
//     it is ~128-300 rows wide on a LiDAR level, is staged once as packed
//     64-bit keys, and every (row, column) searches inside it: ~8 steps of
//     shared-memory reads where the earlier kernel took ~18 dependent L2
//     loads. A range wider than its share of the staging pool (no real level
//     has one) is searched in device memory inside the same bounds.
//   * whole-sector stores. A warp's 32 (row, column) items are 32 * k1
//     consecutive ints of the map; they pass through a shared-memory buffer
//     and leave as 128-byte stores.
// There is no window: the TPU's strided two-level count, boundary ranks and
// far-pair repair, which existed to fit VMEM, have no counterpart, and the
// map cannot overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t FIELD = 1 << 15;
constexpr int32_t SENTINEL_HI = 0x7fffffff;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 128;   // consecutive rows owned by a block
constexpr int POOL = 3072;  // staged keys per block, shared by the k1 ranges
constexpr int MAX_K1 = 21;  // largest k1 whose shared memory stays under 48 KB (checked below)
enum { INVALID = 0, FAST = 1, SLOW = 2 };

__device__ __forceinline__ int64_t pack(int32_t hi, int32_t lo) {
  return ((int64_t)hi << 32) | (int64_t)(uint32_t)lo;
}

__device__ __forceinline__ int32_t clip_field(int32_t v) {
  return v < 0 ? 0 : (v > FIELD - 1 ? FIELD - 1 : v);
}

// first position in [lo, hi) of the table with key >= q, else hi
__device__ __forceinline__ int lower_bound_table(const int32_t* __restrict__ key_hi,
                                                 const int32_t* __restrict__ key_lo, int lo,
                                                 int hi, int64_t q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pack(key_hi[mid], key_lo[mid]) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same position, found by the 32 lanes of a warp together: each round
// probes 32 keys that cut [lo, hi) into 33 parts, so a table of 276,480 keys
// takes 4 rounds of loads where the loop above takes 18.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ key_hi,
                                                const int32_t* __restrict__ key_lo, int lo,
                                                int hi, int64_t q, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 32) / 33;
    const int idx = min(lo + (lane + 1) * step - 1, hi - 1);
    const int below = __popc(__ballot_sync(0xffffffffu, pack(key_hi[idx], key_lo[idx]) < q));
    // probes are non-decreasing, so the lanes whose key is below q form a prefix
    const int new_lo = below == 0 ? lo : min(lo + below * step, hi);
    if (below < 32) hi = min(lo + (below + 1) * step - 1, hi - 1);
    lo = new_lo;
  }
  const int idx = lo + lane;
  const bool below = idx < hi && pack(key_hi[idx], key_lo[idx]) < q;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

__device__ __forceinline__ int find_row(const int32_t* __restrict__ key_hi,
                                        const int32_t* __restrict__ key_lo, int cap, int64_t q) {
  const int p = lower_bound_table(key_hi, key_lo, 0, cap, q);
  return (p < cap && pack(key_hi[p], key_lo[p]) == q) ? p : -1;
}

// One entry of a slow row (x, y or z within r of a face of the field).
__device__ int slow_entry(const int32_t* __restrict__ key_hi, const int32_t* __restrict__ key_lo,
                          int cap, int i, int64_t key, int r, int dx, int dy, int dz) {
  const int32_t hi = (int32_t)(key >> 32), lo = (int32_t)key;
  const int32_t bbase = hi & ~(FIELD - 1);  // b * FIELD
  const int32_t x = hi & (FIELD - 1), y = lo >> 15, z = lo & (FIELD - 1);
  if (dx == 0 && dy == 0 && dz == 0) return i;
  if (dx < 0 || (dx == 0 && (dy < 0 || (dy == 0 && dz < 0)))) {  // first half: clipped query
    return find_row(key_hi, key_lo, cap,
                    pack(bbase + clip_field(x + dx), clip_field(y + dy) * FIELD + clip_field(z + dz)));
  }
  // second half: the largest row whose query at offset (-dx, -dy, -dz) lands here
  int best = -1;
  for (int vx = max(0, x - r); vx <= min(FIELD - 1, x + r); ++vx) {
    if (clip_field(vx - dx) != x) continue;
    for (int vy = max(0, y - r); vy <= min(FIELD - 1, y + r); ++vy) {
      if (clip_field(vy - dy) != y) continue;
      for (int vz = max(0, z - r); vz <= min(FIELD - 1, z + r); ++vz) {
        if (clip_field(vz - dz) != z) continue;
        best = max(best, find_row(key_hi, key_lo, cap, pack(bbase + vx, vy * FIELD + vz)));
      }
    }
  }
  return best;
}

// dynamic shared memory of a block: the staged keys, the warps' output
// buffers and the two range ends per dx
constexpr size_t dynamic_smem(int k1) {
  return (size_t)k1 * (POOL / k1) * sizeof(int64_t) + (size_t)WARPS * 32 * k1 * sizeof(int32_t) +
         2 * (size_t)k1 * sizeof(int);
}
// with the kernel's static arrays (own, kind, first_fast, last_fast)
static_assert(dynamic_smem(MAX_K1) + ROWS * (sizeof(int64_t) + 1) + 2 * sizeof(int) <= 48 * 1024,
              "MAX_K1 does not fit into 48 KB of shared memory");

// K1T: k1 at compile time (3, 5), or 0 for k1 from the argument.
template <int K1T>
__global__ void __launch_bounds__(THREADS)
cube_map_kernel(const int32_t* __restrict__ key_hi, const int32_t* __restrict__ key_lo,
                int32_t* __restrict__ nbr, int cap, int k1_arg) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wmax = POOL / k1;
  int64_t* staged = reinterpret_cast<int64_t*>(smem_raw);              // [k1][wmax]
  int32_t* wbuf = reinterpret_cast<int32_t*>(staged + k1 * wmax);      // [WARPS][32 * k1]
  int* rlo = reinterpret_cast<int*>(wbuf + WARPS * 32 * k1);           // [k1] range start
  int* rhi = rlo + k1;                                                 // [k1] range end
  __shared__ int64_t own[ROWS];
  __shared__ uint8_t kind[ROWS];
  __shared__ int first_fast, last_fast;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int r = k1 / 2;
  const int ncols = k1 * k1;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, cap - row0);

  if (tid == 0) {
    first_fast = ROWS;
    last_fast = -1;
  }
  __syncthreads();
  if (tid < nrows) {
    const int32_t hi = key_hi[row0 + tid], lo = key_lo[row0 + tid];
    own[tid] = pack(hi, lo);
    int kd = INVALID;
    if (hi != SENTINEL_HI) {
      const int32_t x = hi & (FIELD - 1), y = lo >> 15, z = lo & (FIELD - 1);
      const bool inside = min(x, min(y, z)) >= r && max(x, max(y, z)) <= FIELD - 1 - r;
      kd = inside ? FAST : SLOW;
      if (inside) {
        atomicMin(&first_fast, tid);
        atomicMax(&last_fast, tid);
      }
    }
    kind[tid] = (uint8_t)kd;
  }
  __syncthreads();
  const bool any_fast = last_fast >= 0;

  // the rank range of the block's queries, per dx: [first position with
  // key >= lowest query, first position with key > highest query)
  if (any_fast) {
    for (int e = warp; e < 2 * k1; e += WARPS) {  // one warp per range end
      const int s = e >> 1;
      const int64_t shift = (int64_t)(s - r) << 32;
      const int64_t q = (e & 1) ? own[last_fast] + shift + (r * FIELD + r) + 1
                                : own[first_fast] + shift - (r * FIELD + r);
      const int pos = warp_lower_bound(key_hi, key_lo, 0, cap, q, lane);
      if (lane == 0) ((e & 1) ? rhi : rlo)[s] = pos;
    }
  }
  __syncthreads();
  if (any_fast) {
    for (int s = 0; s < k1; ++s) {
      const int lo = rlo[s], width = rhi[s] - lo;
      if (width <= wmax) {
        for (int j = tid; j < width; j += THREADS)
          staged[s * wmax + j] = pack(key_hi[lo + j], key_lo[lo + j]);
      }
    }
  }
  __syncthreads();

  const int total = nrows * ncols;
  int32_t* wout = wbuf + warp * 32 * k1;
  int32_t* block_out = nbr + (int64_t)row0 * ncols * k1;
  for (int base = warp * 32; base < total; base += THREADS) {
    const int t = base + lane;
    if (t < total) {
      const int row = t / ncols;
      const int col = t - row * ncols;
      const int s = col / k1;
      const int dy = col - s * k1 - r;
      int32_t* o = wout + lane * k1;
      const int kd = kind[row];
      if (kd == FAST) {
        const int lo = rlo[s], hi = rhi[s];
        const bool in_smem = hi - lo <= wmax;
        const int64_t* sk = staged + s * wmax - lo;  // sk[rank] for rank in [lo, hi)
        const int64_t q0 = own[row] + ((int64_t)(s - r) << 32) + (dy * FIELD - r);
        int m;
        if (col == ncols / 2) {
          m = max(row0 + row - r, lo);  // the center column: rows i - r .. i + r
        } else if (in_smem) {
          int a = lo, b = hi;
          while (a < b) {
            const int mid = (a + b) >> 1;
            if (sk[mid] < q0) a = mid + 1; else b = mid;
          }
          m = a;
        } else {
          m = lower_bound_table(key_hi, key_lo, lo, hi, q0);
        }
        // the k1 queries q0 .. q0 + k1 - 1 are consecutive keys, so a match
        // is one of the k1 table rows from the rank on: row m + j goes to
        // slot key - q0 where that lies in [0, k1)
        for (int dz = 0; dz < k1; ++dz) o[dz] = -1;
        for (int j = 0; j < k1; ++j) {
          if (m + j < hi) {
            const int64_t kv = in_smem ? sk[m + j] : pack(key_hi[m + j], key_lo[m + j]);
            const uint64_t d = (uint64_t)(kv - q0);
            if (d < (uint64_t)k1) o[d] = m + j;
          }
        }
      } else if (kd == SLOW) {
        for (int dz = 0; dz < k1; ++dz)
          o[dz] = slow_entry(key_hi, key_lo, cap, row0 + row, own[row], r, s - r, dy, dz - r);
      } else {
        for (int dz = 0; dz < k1; ++dz) o[dz] = -1;
      }
    }
    __syncwarp();
    const int count = min(32, total - base) * k1;
    int32_t* dst = block_out + (int64_t)base * k1;
    for (int j = lane; j < count; j += 32) dst[j] = wout[j];
    __syncwarp();
  }
}

}  // namespace

// Serves odd k1 from 3 to MAX_K1; another k1 returns cudaErrorInvalidValue.
extern "C" int gcd_cube_map(const void* key_hi, const void* key_lo, void* nbr, int cap, int k1,
                            void* stream) {
  if (k1 < 3 || k1 % 2 != 1 || k1 > MAX_K1) return (int)cudaErrorInvalidValue;
  if (cap > 0) {
    auto kernel = k1 == 3 ? cube_map_kernel<3> : k1 == 5 ? cube_map_kernel<5> : cube_map_kernel<0>;
    kernel<<<(cap + ROWS - 1) / ROWS, THREADS, dynamic_smem(k1), (cudaStream_t)stream>>>(
        (const int32_t*)key_hi, (const int32_t*)key_lo, (int32_t*)nbr, cap, k1);
  }
  return (int)cudaGetLastError();
}
