// Device building blocks shared by the sparse-conv kernels of gather_gemm.cu:
// 16-byte asynchronous copies into shared memory, `ldmatrix` fragment loads,
// the bf16 tensor-core product `mma.sync.m16n8k16` with f32 accumulators, and
// the ordered compaction of a book column's present entries.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and q = lane % 4:
//   A (16 x 16, row):  a0 = (g, 2q..2q+1)      a1 = (g + 8, 2q..2q+1)
//                      a2 = (g, 2q+8..2q+9)    a3 = (g + 8, 2q+8..2q+9)
//   B (16 x 8, col):   b0 = (k 2q..2q+1, n g)  b1 = (k 2q+8..2q+9, n g)
//   C/D (16 x 8):      d0, d1 = (g, 2q..2q+1)  d2, d3 = (g + 8, 2q..2q+1)
// `ldmatrix.x4` reads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and lane t receives the elements
// (t / 4, 2 (t % 4) .. +1) of each, or with `.trans` the elements
// (2 (t % 4) .. +1, t / 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gcd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int COMPACT_ROWS_PER_WARP = 256;

// Appends to (list_v, list_u), from position `cnt` on and in the order of
// the rows, the pairs (v, adj[v, col]) with a present entry among the rows
// v in [seg0, min(seg0 + NW * 256, vend)). Every thread of the block's NW
// warps calls it; it returns the new count to all of them. The caller
// synchronises the block before it reads the lists and before the next call.
template <int NW>
__device__ __forceinline__ int compact_segment(const int32_t* __restrict__ adj, int k, int col,
                                               int seg0, int vend, int cnt, int* list_v,
                                               int* list_u, int* wcount) {
  constexpr int ITER = COMPACT_ROWS_PER_WARP / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int v0 = seg0 + warp * COMPACT_ROWS_PER_WARP + lane;
  int32_t u[ITER];
  uint32_t present[ITER];
  int total = 0;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int v = v0 + i * 32;
    u[i] = v < vend ? adj[(size_t)v * k + col] : -1;
    present[i] = __ballot_sync(0xffffffffu, u[i] >= 0);
    total += __popc(present[i]);
  }
  if (lane == 0) wcount[warp] = total;
  __syncthreads();
  int base = cnt;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = wcount[w];
    if (w < warp) base += c;
    cnt += c;
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    if (u[i] >= 0) {
      const int pos = base + __popc(present[i] & ((1u << lane) - 1u));
      list_v[pos] = v0 + i * 32;
      list_u[pos] = u[i];
    }
    base += __popc(present[i]);
  }
  return cnt;
}

}  // namespace gcd
