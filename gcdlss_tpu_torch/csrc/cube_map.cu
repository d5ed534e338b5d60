// k^3 submanifold neighbor map for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_v2` of gcdlss_tpu/ops/plan_kernel.py (with
// its planning and repair passes `boundary_ranks`, `plan_cube_prepare_v2` and
// `repair_far_pairs_v2`).
//
// Input: the sorted, unique voxel keys of one level, packed as int64
// (hi << 32 | lo, see gcdlss_tpu_torch/ops/coords.py), sentinel-padded to
// the level capacity `cap`. Output: nbr [cap, k^3] int32, the row of the
// voxel at offset `offsets[c]` (itertools.product order, z fastest) or -1.
//
// It computes exactly what the join path computes (ops/plan.py,
// `join_neighbor_map`), bit for bit:
//   * columns c < half: query key = encode_coords(coords + offset_c), with
//     encode_coords' clip to the field, looked up by binary search over the
//     whole sorted key array (sentinels sort last and never match a query);
//   * the center column: the row itself where valid;
//   * columns c > half: the transpose of the searched half,
//     nbr[j, kk-1-c] = i wherever nbr[i, c] = j. A second kernel scatters it
//     with atomicMax; the entries are unique except where the clip folds two
//     queries onto one voxel at the field's edge, and there the largest row
//     wins, as in the plain path's scatter-max.
//
// What bounds it on the card: ~log2(cap) dependent loads per (row, column)
// from a key array that fits in L2 (1.1 MB at cap = 138,240), so latency, not
// bandwidth. One thread per (row, column) keeps enough searches in flight to
// hide it. There is no window: the TPU's strided two-level count, boundary
// ranks and far-pair repair, which existed to fit VMEM, have no counterpart,
// and the map cannot overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t FIELD = 1 << 15;
constexpr int32_t COORD_OFFSET = 1 << 14;
constexpr int32_t SENTINEL_HI = 0x7fffffff;
constexpr int THREADS = 256;

__device__ __forceinline__ int32_t clip_field(int32_t v) {
  return v < 0 ? 0 : (v > FIELD - 1 ? FIELD - 1 : v);
}

__global__ void cube_half_kernel(const int64_t* __restrict__ keys, int32_t* __restrict__ nbr,
                                 int cap, int k1) {
  const int kk = k1 * k1 * k1;
  const int half = kk / 2;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= (int64_t)cap * (half + 1)) return;
  const int i = (int)(t / (half + 1));
  const int c = (int)(t % (half + 1));
  const int64_t key = keys[i];
  const int32_t hi = (int32_t)(key >> 32);
  const int32_t lo = (int32_t)(key & 0xffffffffLL);
  const bool valid = hi != SENTINEL_HI;
  int32_t* row = nbr + (int64_t)i * kk;
  if (c == half) {
    row[half] = valid ? i : -1;
    return;
  }
  row[half + 1 + c] = -1;  // filled by cube_transpose_kernel
  if (!valid) {
    row[c] = -1;
    return;
  }
  const int r = k1 / 2;
  const int dx = c / (k1 * k1) - r;
  const int dy = (c / k1) % k1 - r;
  const int dz = c % k1 - r;
  const int32_t b = hi / FIELD;
  const int32_t x = hi % FIELD - COORD_OFFSET;
  const int32_t y = lo / FIELD - COORD_OFFSET;
  const int32_t z = lo % FIELD - COORD_OFFSET;
  const int32_t qhi = b * FIELD + clip_field(x + dx + COORD_OFFSET);
  const int32_t qlo = clip_field(y + dy + COORD_OFFSET) * FIELD + clip_field(z + dz + COORD_OFFSET);
  const int64_t q = ((int64_t)qhi << 32) | (int64_t)qlo;
  int lo_b = 0, hi_b = cap;  // first position with keys[pos] >= q
  while (lo_b < hi_b) {
    const int mid = (lo_b + hi_b) >> 1;
    if (keys[mid] < q) lo_b = mid + 1; else hi_b = mid;
  }
  row[c] = (lo_b < cap && keys[lo_b] == q) ? lo_b : -1;
}

__global__ void cube_transpose_kernel(int32_t* __restrict__ nbr, int cap, int k1) {
  const int kk = k1 * k1 * k1;
  const int half = kk / 2;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= (int64_t)cap * half) return;
  const int i = (int)(t / half);
  const int c = (int)(t % half);
  const int32_t j = nbr[(int64_t)i * kk + c];
  if (j >= 0) atomicMax(&nbr[(int64_t)j * kk + (kk - 1 - c)], i);
}

}  // namespace

extern "C" int gcd_cube_map(const void* keys, void* nbr, int cap, int k1, void* stream) {
  if (cap > 0) {
    const int kk = k1 * k1 * k1;
    const int half = kk / 2;
    const int64_t n1 = (int64_t)cap * (half + 1);
    const int64_t n2 = (int64_t)cap * half;
    cube_half_kernel<<<(unsigned)((n1 + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, (int32_t*)nbr, cap, k1);
    cube_transpose_kernel<<<(unsigned)((n2 + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)nbr, cap, k1);
  }
  return (int)cudaGetLastError();
}
