// Hopper-only device building blocks (sm_90a), beside `gather_mma.cuh`:
// `mbarrier`s, bulk asynchronous copies global -> shared memory that report
// their bytes to a barrier (the 1-D form of the TMA: no tensor map), and the
// warpgroup product `wgmma.mma_async` with A from registers and B from shared
// memory through a matrix descriptor. `conv_parts.cu` (P3 `tile_gemm`) is
// built on them; nothing here depends on that kernel, so the sparse conv of
// `gather_gemm.cu` can take them too.
//
// mbarrier. A 64-bit object in shared memory with a phase bit. `mbar_init`
// sets the number of arrivals a phase needs; a phase ends when that many
// `mbar_arrive`s have come and every byte announced with
// `mbar_arrive_expect_tx` has landed. `mbar_wait(bar, parity)` returns once
// the barrier's phase bit differs from `parity`: a consumer of a ring waits
// on its full barriers with parity 0, 1, 0, ... per round, the producer on
// the empty barriers with 1, 0, 1, ... (its first wait passes at once). One
// thread initialises, then `fence_barrier_init()` and a block barrier, before
// anyone uses them.
//
// Bulk copy. `bulk_g2s(dst, src, bytes, bar)`: one thread asks for `bytes`
// (a multiple of 16, both addresses 16-byte aligned) to be copied and
// credited to `bar`. The data is visible to the threads that waited on `bar`
// and to `wgmma`.
//
// wgmma (PTX ISA, the chapter on asynchronous warpgroup-level matrix
// operations). The four warps of a warpgroup (threads 128 w .. 128 w + 127)
// multiply a 64 x 16 tile A by a 16 x N tile B into a 64 x N f32 tile D kept
// in registers. Warp w4 of the warpgroup owns rows 16 w4 .. 16 w4 + 15; with
// g = lane / 4 and q = lane % 4:
//   A (registers): the `mma.m16n8k16` A fragment of those 16 rows,
//       a0 = (g, 2q..2q+1)  a1 = (g + 8, 2q..2q+1)
//       a2 = (g, 2q+8..2q+9)  a3 = (g + 8, 2q+8..2q+9),
//     which `ldmatrix_x4` (gather_mma.cuh) loads from row-major shared memory
//     at any 16-byte aligned row address: lane l gives the address of row
//     l % 16, columns 8 (l / 16) .. + 7.
//   D (registers): for each block j of 8 columns,
//       d[4j], d[4j+1] = (g, 8j + 2q..+1)   d[4j+2], d[4j+3] = (g + 8, 8j + 2q..+1).
//   B (shared memory, K-major, 128-byte swizzle): row n of the operand holds
//     64 consecutive values of k in 128 bytes; 8 rows form an atom of 1024
//     bytes, atoms follow each other along n (SBO = 1024), and inside an atom
//     the 16-byte piece p of row r is stored at piece p ^ r: byte
//     (n / 8) * 1024 + (n % 8) * 128 + ((k / 8) ^ (n % 8)) * 16 + (k % 8) * 2.
//     The stage starts on a 1024-byte boundary. A k16 step reads the 32
//     bytes of every row from logical byte 32 * step on: its descriptor is
//     that of the stage with 32 * step added to the address
//     (`wgmma_desc_sw128`).
// Order of use: write or load the registers, `wgmma_fence()`, start the
// wgmmas, `wgmma_commit()`, `wgmma_wait<0>()`; only then may the A registers
// be overwritten (`keep_alive` keeps the compiler from reusing them earlier)
// and the shared-memory stage be released. Registers decide the speed: when
// accumulators and fragments do not fit (ptxas reports C7512, "wgmma
// serialized due to insufficient register resources"), every wgmma waits for
// the one before. A block of 9 to 12 warps leaves a thread 168 registers, a
// block of 8 warps 255.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gcd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase bit of `bar` differs from `parity`. A wait that
// lasts over ~2 s of clock cycles traps: a fault, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// the compiler must treat `r` as read and written here
__device__ __forceinline__ void keep_alive(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle at shared-memory
// address `addr` (the stage's 1024-byte aligned start plus 32 bytes per k16
// step): start address, stride between 8-row atoms 1024 bytes, layout type 1.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[48] += a (64 x 16 bf16, registers) * b (16 x 96 bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// d[64] += a (64 x 16 bf16, registers) * b (16 x 128 bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

}  // namespace gcd
