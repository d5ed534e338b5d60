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
// What bounds it on the card: bytes. The map is written once (138 MB at
// k1 = 5, cap = 276,480), p and has read once (26.5 and 6.6 MB there); the
// key table (2.2 MB) stays in L2. Design:
//   - a block owns a tile of TILE_ROWS consecutive rows and all k1^2
//     columns. Phase 1 walks (column, row) with the row fastest, so a
//     warp takes one column and 32 consecutive rows: its p and has reads
//     are one 128-byte and one 32-byte request, and since the ranks of
//     consecutive rows do not decrease within a column, its k1 candidate
//     key loads are nearly coalesced. The rows' own keys are staged once.
//   - results go to a shared tile [TILE_ROWS][k1^3]; the row stride (27 or
//     125 words) is odd, so lanes on consecutive rows meet no bank
//     conflict.
//   - phase 2 writes the tile, one contiguous span of the map, with 16-byte
//     streaming stores (a full tile starts and ends on 16 bytes); the
//     ragged last tile's tail goes in 4-byte stores.
// There is no window: the TPU's VMEM staging, sub-windows, far count and
// repair have no counterpart, and nothing can be dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t FIELD = 1 << 15;
constexpr int32_t SENTINEL_HI = 0x7fffffff;
constexpr int THREADS = 256;

// rows of a block's tile: 64 x 125 x 4 = 32,000 bytes at k1 = 5, 128 x 27 x 4
// = 13,824 at k1 = 3; both multiples of 32 rows and of 16 bytes
template <int K1>
__host__ __device__ constexpr int tile_rows() {
  return K1 == 3 ? 128 : 64;
}

template <int K1>
__global__ void __launch_bounds__(THREADS)
cube_cand_kernel(const int32_t* __restrict__ key_hi, const int32_t* __restrict__ key_lo,
                 const int32_t* __restrict__ p, const uint8_t* __restrict__ has,
                 int32_t* __restrict__ nbr, int cap) {
  constexpr int R = K1 / 2;
  constexpr int NCOLS = K1 * K1;
  constexpr int CC = NCOLS / 2;
  constexpr int K3 = NCOLS * K1;
  constexpr int TR = tile_rows<K1>();
  __shared__ __align__(16) int32_t tile[TR * K3];
  __shared__ int32_t s_hi[TR], s_lo[TR];

  const int i0 = blockIdx.x * TR;
  const int rows = min(TR, cap - i0);
  for (int t = threadIdx.x; t < TR; t += THREADS) {
    s_hi[t] = t < rows ? key_hi[i0 + t] : SENTINEL_HI;
    s_lo[t] = t < rows ? key_lo[i0 + t] : 0;
  }
  __syncthreads();

  for (int item = threadIdx.x; item < NCOLS * TR; item += THREADS) {
    const int col = item / TR;
    const int row = item % TR;
    const int i = i0 + row;
    int32_t res[K1];
#pragma unroll
    for (int dz = 0; dz < K1; ++dz) res[dz] = -1;
    const int32_t hi = s_hi[row];
    bool live = hi != SENTINEL_HI;
    int base = 0;
    if (live) {
      if (col == CC) {
        base = i - R < 0 ? 0 : i - R;
      } else {
        const int64_t s = (int64_t)(col < CC ? col : col - 1) * cap + i;
        live = has[s] != 0;
        base = p[s];
      }
    }
    if (live) {
      const int32_t qh = hi + (col / K1 - R);
      const int32_t ql = s_lo[row] + (col % K1 - R) * FIELD - R;
#pragma unroll
      for (int m = 0; m < K1; ++m) {
        const int cand = base + m;
        if (cand < cap) {
          const int32_t d = key_lo[cand] - ql;
          const bool ok = key_hi[cand] == qh && d >= 0 && d <= 2 * R;
#pragma unroll
          for (int dz = 0; dz < K1; ++dz) {
            if (ok && d == dz) res[dz] = cand;
          }
        }
      }
    }
    int32_t* o = tile + row * K3 + col * K1;
#pragma unroll
    for (int dz = 0; dz < K1; ++dz) o[dz] = res[dz];
  }
  __syncthreads();

  int32_t* dst = nbr + (int64_t)i0 * K3;
  const int n = rows * K3;
  const int n4 = n / 4;
  const int4* src4 = reinterpret_cast<const int4*>(tile);
  int4* dst4 = reinterpret_cast<int4*>(dst);
  for (int q = threadIdx.x; q < n4; q += THREADS) __stcs(dst4 + q, src4[q]);
  for (int q = 4 * n4 + threadIdx.x; q < n; q += THREADS) __stcs(dst + q, tile[q]);
}

template <int K1>
void launch(const int32_t* kh, const int32_t* kl, const int32_t* p, const uint8_t* has,
            int32_t* nbr, int cap, cudaStream_t s) {
  constexpr int TR = tile_rows<K1>();
  cube_cand_kernel<K1><<<(cap + TR - 1) / TR, THREADS, 0, s>>>(kh, kl, p, has, nbr, cap);
}

}  // namespace

// nbr 16-byte aligned (a full tile leaves in 16-byte stores)
extern "C" int gcd_cube_cand(const void* key_hi, const void* key_lo, const void* p,
                             const void* has, void* nbr, int cap, int k1, void* stream) {
  if (k1 != 3 && k1 != 5) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)nbr & 15u) return (int)cudaErrorInvalidValue;
  if (cap > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const auto* kh = (const int32_t*)key_hi;
    const auto* kl = (const int32_t*)key_lo;
    const auto* pp = (const int32_t*)p;
    const auto* hh = (const uint8_t*)has;
    if (k1 == 3)
      launch<3>(kh, kl, pp, hh, (int32_t*)nbr, cap, s);
    else
      launch<5>(kh, kl, pp, hh, (int32_t*)nbr, cap, s);
  }
  return (int)cudaGetLastError();
}
