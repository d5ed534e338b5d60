// k^3 submanifold neighbor map from insertion ranks, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (v1) of gcdlss_tpu/ops/plan_kernel.py,
// with its launcher `cube_neighbor_map_kernel`, its window planning
// `plan_cube_prepare` and its exact fix-up `repair_far_pairs`.
//
// Inputs: the sorted, unique, sentinel-padded int32 keys (key_hi, key_lo)
// of one level, [cap] each; p int32 and has uint8 (bool), [k1^2 - 1, cap],
// the insertion rank and match bit of each row's query in every non-center
// (dx, dy) column, product order with the center skipped
// (gcdlss_tpu_torch/ops/plan.py, `_column_ranks`). Output: nbr [cap, k1^3]
// int32 in the `plan._offsets(k1)` product order (z fastest): column
// col = (dx + r) * k1 + (dy + r) holds slots col * k1 .. col * k1 + k1 - 1.
//
// Row i, column col: query (hi_i + dx, lo_i + dy * FIELD - r), the window's
// lowest z. Keys sort as (b, x, y, z), so the table rows with the query's
// (b, x, y) and z in [z - r, z + r] are consecutive and start at the
// query's insertion rank: read rows base + m, m < k1, inside [0, cap), and
// put each row whose hi equals the query's and whose lo - q_lo lies in
// [0, 2r] into slot lo - q_lo. base is p for a non-center column and
// clip(i - r, 0, cap - 1) for the center, whose query is (hi_i, lo_i - r).
// Sentinel rows, and queries with has = 0, give -1 in every slot.
//
// What bounds it on the card: per (row, column), one rank load and then k1
// key-pair loads that depend on it, from tables that fit in L2 (2.2 MB at
// cap = 276,480), and the store of the map itself (138 MB at k1 = 5,
// cap = 276,480). One thread per (row, column), row-major, so a warp's
// k1-int stores are consecutive and coalesce; the k1 candidate loads are
// independent of each other and unrolled (K1 is a template argument), so
// they are in flight together. There is no window: the TPU's
// VMEM staging, sub-windows, far count and repair have no counterpart, and
// nothing can be dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t FIELD = 1 << 15;
constexpr int32_t SENTINEL_HI = 0x7fffffff;
constexpr int THREADS = 256;

template <int K1>
__global__ void cube_cand_kernel(const int32_t* __restrict__ key_hi,
                                 const int32_t* __restrict__ key_lo,
                                 const int32_t* __restrict__ p,
                                 const uint8_t* __restrict__ has,
                                 int32_t* __restrict__ nbr, int cap) {
  constexpr int R = K1 / 2;
  constexpr int NCOLS = K1 * K1;
  constexpr int CC = NCOLS / 2;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= (int64_t)cap * NCOLS) return;
  const int i = (int)(t / NCOLS);
  const int col = (int)(t % NCOLS);

  int32_t res[K1];
#pragma unroll
  for (int dz = 0; dz < K1; ++dz) res[dz] = -1;

  const int32_t hi = key_hi[i];
  bool live = hi != SENTINEL_HI;
  int base;
  if (col == CC) {
    base = i - R < 0 ? 0 : i - R;
  } else {
    const int64_t s = (int64_t)(col < CC ? col : col - 1) * cap + i;
    live = live && has[s] != 0;
    base = p[s];
  }
  if (live) {
    const int32_t qh = hi + (col / K1 - R);
    const int32_t ql = key_lo[i] + (col % K1 - R) * FIELD - R;
#pragma unroll
    for (int m = 0; m < K1; ++m) {
      const int row = base + m;
      if (row < cap) {
        const int32_t d = key_lo[row] - ql;
        const bool ok = key_hi[row] == qh && d >= 0 && d <= 2 * R;
#pragma unroll
        for (int dz = 0; dz < K1; ++dz) {
          if (ok && d == dz) res[dz] = row;
        }
      }
    }
  }
  int32_t* out = nbr + (int64_t)i * (NCOLS * K1) + col * K1;
#pragma unroll
  for (int dz = 0; dz < K1; ++dz) out[dz] = res[dz];
}

}  // namespace

extern "C" int gcd_cube_cand(const void* key_hi, const void* key_lo, const void* p,
                             const void* has, void* nbr, int cap, int k1, void* stream) {
  if (k1 != 3 && k1 != 5) return (int)cudaErrorInvalidValue;
  if (cap > 0) {
    const int64_t n = (int64_t)cap * k1 * k1;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    const auto* kh = (const int32_t*)key_hi;
    const auto* kl = (const int32_t*)key_lo;
    const auto* pp = (const int32_t*)p;
    const auto* hh = (const uint8_t*)has;
    if (k1 == 3) {
      cube_cand_kernel<3><<<blocks, THREADS, 0, s>>>(kh, kl, pp, hh, (int32_t*)nbr, cap);
    } else {
      cube_cand_kernel<5><<<blocks, THREADS, 0, s>>>(kh, kl, pp, hh, (int32_t*)nbr, cap);
    }
  }
  return (int)cudaGetLastError();
}
