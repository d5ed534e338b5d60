// The sparse conv taken apart, for Hopper (sm_90a): four component kernels
// that each compute a defined function, so that the cost of one part of the
// gather-GEMM (gather_gemm.cu) can be timed alone and still be checked.
//
// They replace the TPU package's Pallas diagnostics, which time the parts of
// its fused conv with deliberately wrong results:
//   tools/scaffold_bisect_bench.py `run`            (window staging, index reads)
//   tools/kernel_variants_bench.py `mk_kernel`, `mk_onehot`
//   tools/fori_diag_bench.py `mk`                   (dynamic / static accesses)
//   tools/kernel_bisect_bench.py `mk`
//   tools/dma_layout_bench.py `run_tilecp`, `run`   (source layouts, buffering)
//
//   P1 window_sum   out[i, c] = sum_{r < W} x[ws[i] + r, c]
//                   Staging without arithmetic, from x held as [N, C]
//                   (rows), [C, N] (cols) or [N/128, C, 128] (tiles); the
//                   sum is the cheapest consumer that keeps every load
//                   alive. A cluster of 8 blocks takes 8 or 16 consecutive
//                   windows and stages each row of their union once, through
//                   tensor-map copies (one thread asks; a ring of 1 or 2
//                   stages, at most 32 KB together, on mbarriers). Each
//                   thread sums its rows of a segment (the rows between two
//                   consecutive window starts or ends) in registers; each
//                   window adds its segments' sums (details at the kernel).
//                   Bound by bytes: each row of x that some window reads,
//                   once: 0.015 / 0.020 ms at the tool's shapes (an H100
//                   SXM's published 3.35 TB/s at 700 W). The per-block
//                   staging it replaces moved NB * W * C * 2 bytes through L2
//                   (403 / 537 MB at W 2048); the clusters' unions are ~72 /
//                   ~126 MB with sequential starts.
//   P2 gather_sum   out[u, c] = sum_k [nbr[u, k] >= 0] x[nbr[u, k], c]
//                   The gather without the product, one 16-byte piece (8
//                   channels) a lane, 16-byte f32 stores.
//                   dynamic: a row's pieces go to consecutive lanes (16 at
//                   96 channels, 32 at 256). A block stages its contiguous
//                   slice of the book (rows x K int32) once with 16-byte
//                   copies, so no lane loads an index from device memory that
//                   another lane of its row also loads, and moves each row's
//                   present entries to the front of its slice; a lane then
//                   keeps the loads of 4 present rows in flight before it
//                   adds them, and loads nothing for an absent entry. Bound
//                   by bytes: x, the book and out once, 0.054 / 0.064 ms at
//                   the tool's shapes (3.35 TB/s); at 256 channels the 7
//                   present rows a row gathers (0.48 GB) come from L2 at its
//                   rate, ~1.5x that bound.
//                   static: the same loads without the indirection, K * x[u]:
//                   a thread per (row, piece) copies its piece into shared
//                   memory and reads it from there once per offset, 27 reads
//                   of each row, 1.36 / 1.81 GB: bound by shared memory (128
//                   B a clock an SM, 132 SMs, 1.755 GHz: 0.046 / 0.061 ms),
//                   beside device memory's 0.045 / 0.060.
//                   index_only: each row's entries summed in order from the
//                   staged slice, one thread a row: the book's bytes and
//                   nothing more (0.009 / 0.004 ms).
//                   The loop over the offsets runs at run time (rolled) or
//                   is unrolled for K = 27.
//   P3 tile_gemm    out[u] = sum_k x[clip(u + k - K/2, 0, N-1)] @ W[k]
//                   The product without the gather, on the tensor cores
//                   (`wgmma`, hopper_mma.cuh). A block of two warpgroups
//                   owns 256 output rows and up to 128 output columns. The K
//                   shifted A tiles of a block are views of one window of
//                   256 + K - 1 consecutive rows of x: it comes into shared
//                   memory once, one bulk copy per row and 64-channel chunk
//                   (the rows beyond either end of x are copies of row 0 /
//                   N - 1, stored element-wise), and each warp loads its A
//                   fragments from it with `ldmatrix` at a shift of one row
//                   per offset. The slices of W stream through a ring of 3
//                   to 5 stages, each one bulk copy of a slice that
//                   `pack_w_kernel` has laid out as wgmma reads it (K-major,
//                   128-byte swizzle); full / empty `mbarrier`s order the
//                   ring and no block barrier runs in the loop. While a
//                   stage's products run, one thread asks for the slice
//                   three stages on and every warp loads the next stage's
//                   fragments. Ring slots, phase bits and window rows are
//                   counted up, never divided: with two warps a scheduler,
//                   the integer divisions of a per-stage index cost more
//                   than the stage's products.
//                   Bound by operations (2 N K Ci Co on the tensor cores); x
//                   leaves device memory once per block.
//   P4 onehot_conv  out[u] = sum_k x[nbr[u, k]] @ W[k]
//                   The conv with its gather as a product on the tensor
//                   cores (`mma.sync`, K1's instruction). A block owns 128
//                   output rows (8 warps x a 16-row strip) and up to 128
//                   output columns. Per (offset with an entry, 64-channel
//                   chunk) a stage of a ring of 4 holds the window of 128
//                   source rows from the block's smallest present entry,
//                   one tensor-map copy (128-byte swizzle, so `ldmatrix` is
//                   free of bank conflicts; rows beyond x and channels
//                   beyond Ci arrive as zeros), and W's slice, one bulk copy
//                   of an image laid out as each lane's B fragments
//                   (`pack_onehot_w_kernel`). A ninth warp starts the
//                   copies; full / empty `mbarrier`s order the ring, and no
//                   block barrier runs in the loop. Per (strip, stage):
//                   G = onehot(rel) @ window in f32, the one-hot A fragment
//                   built in registers as (rel == column), only the k16
//                   tiles of the window that hold an entry of the strip (a
//                   warp-wide OR), nothing for a strip without an entry; an
//                   entry outside the window has its row of G read from x
//                   directly and is counted in `far` (an integer atomic);
//                   then G's C fragments, packed to bf16 without rounding,
//                   are the A fragments of out += G @ W[k]. No float
//                   atomics: reruns give the same bits. Work at the tool's
//                   shapes (262,144 x 96 / 131,072 x 256, K = 27): G @ W on
//                   the kept strips ~0.20 / 0.62 ms of tensor-core time (P3
//                   x strips kept); windows ~1.2 / 3.1 GB and W slices ~1.2 /
//                   3.1 GB from L2 (0.87 of (block, offset) pairs kept; 256
//                   channels take two column blocks, each staging every
//                   window). K1 computes the same function.
// Every C entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0. Nothing here allocates.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "gather_mma.cuh"
#include "hopper_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// a 16-byte load that the compiler neither removes nor merges with another
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 8 f32 sums as two 16-byte stores marked as written once (evicted first),
// so that they do not push rows of x out of L2
__device__ __forceinline__ void st32_once(float* o, const float* acc) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(acc[0], acc[1], acc[2], acc[3]));
  __stcs(reinterpret_cast<float4*>(o) + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
}

// 8 bf16 values held in a uint4 -> f32
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ------------------------------------------------------------------ P1
//
// A cluster of P1_CL blocks takes P1_CL * wpb consecutive windows, wpb = 1 or
// 2 a block (2 where the card cannot hold the grid's clusters of one window
// a block at once: `p1_windows_per_block`), and stages each row of their
// union once, through the copy engine (tensor-map copies, a ring of
// `buffers` stages on mbarriers, one thread asking). Window i's rows split
// into a head [s, ceil8(s)), a body [ceil8(s), floor8(s + W)) of whole 8-row
// groups and a tail [floor8(s + W), s + W). The bodies' union, a list of at
// most P1_CL * wpb disjoint group-aligned intervals, and the sorted distinct
// body starts and ends (the boundaries; consecutive ones bound a segment) are
// worked out by every block alike. The union's G groups are dealt out in
// order: block b of the cluster stages groups [b G / P1_CL, (b + 1) G /
// P1_CL), in stages that end at every boundary. Each thread keeps its sums
// of the current segment in registers; at a segment's end the block adds its
// threads' sums in a fixed order into the segment's sum, written to the
// scratch rows of the block. After a cluster barrier, each window adds, for
// each segment of its body in order, the blocks' sums of that segment in rank
// order, with its head rows before and its tail rows after, read from x
// directly. Every sum runs in a fixed order: reruns give the same bits.
// `ops/conv_parts.window_schedule_plain` states the same schedule in Python.

constexpr int P1_CL = 8;                   // blocks of a cluster
constexpr int P1_MAX_WPB = 2;              // windows of a block, at most
constexpr int P1_NW = P1_CL * P1_MAX_WPB;  // windows of a cluster, at most
constexpr int P1_MAX_SG = 16;              // groups of 8 rows a stage holds, at most
constexpr int P1_RING_BYTES = 32768;       // bytes of x the ring holds, at most
constexpr int P1_NMAPS = 5;                // tensor maps: copies of 1, 2, 4, 8, 16 groups
constexpr int P1_PART = 8 * THREADS;       // floats of the threads' sums at a segment's end
enum { ROWS = 0, COLS = 1, TILES = 2 };

struct P1Maps {
  CUtensorMap m[P1_NMAPS];  // m[b]: a box of 2^b groups
};

// the cluster's schedule, the same in each of its blocks
struct P1Sched {
  int nu, gt, nbnd;
  int u_lo[P1_NW], u_hi[P1_NW];  // union intervals of rows, group-aligned, sorted, disjoint
  int u_pre[P1_NW + 1];          // union groups before interval m
  int bnd[2 * P1_NW];            // boundaries, sorted, distinct
  int bnd_ug[2 * P1_NW];         // union groups before each boundary
};

__device__ __forceinline__ int p1_body_lo(int s) { return (s + 7) & ~7; }
__device__ __forceinline__ int p1_body_hi(int s, int window) { return (s + window) & ~7; }

// The schedule of the cluster whose nw windows start at window w0, by every
// thread of the block (three block barriers; `tmp`: scratch of 6 P1_NW
// ints). Thread j < nw takes window w0 + j's body and puts it at its rank
// among the live bodies (by start, ties by window). Thread t < 2 nw takes a
// boundary candidate (t < nw: the start of body t, else the end of body
// t - nw) and, if no thread below holds the same value, puts it at its rank
// among the distinct values. Thread 0 merges the sorted bodies (an interval
// opens a piece when it starts after every earlier one ends); thread k < nbnd
// finds the union groups before boundary k.
__device__ void p1_schedule(P1Sched& sc, int* tmp, const int32_t* __restrict__ ws, int nb,
                            int window, int w0, int nw, int tid) {
  int* cand = tmp;                // [2 nw] body starts, then ends; -1: no body
  int* o_lo = tmp + 2 * P1_NW;    // [nw] live bodies by rank
  int* o_hi = tmp + 3 * P1_NW;
  int* first = tmp + 4 * P1_NW;   // [2 nw] the lowest holder of its value
  if (tid < nw) {
    int bl = -1, bh = -1;
    if (w0 + tid < nb) {
      const int s = ws[w0 + tid];
      bl = p1_body_lo(s);
      bh = p1_body_hi(s, window);
      if (bl >= bh) bl = bh = -1;
    }
    cand[tid] = bl;
    cand[nw + tid] = bh;
  }
  __syncthreads();
  if (tid < 2 * nw) {
    const int v = cand[tid];
    bool f = v >= 0;
    for (int t = 0; t < tid; ++t) f = f && cand[t] != v;
    first[tid] = f;
    if (tid < nw && v >= 0) {
      int rank = 0;
      for (int i = 0; i < nw; ++i) rank += cand[i] >= 0 && (cand[i] < v || (cand[i] == v && i < tid));
      o_lo[rank] = v;
      o_hi[rank] = cand[nw + tid];
    }
  }
  __syncthreads();
  if (tid < 2 * nw && first[tid]) {
    const int v = cand[tid];
    int below = 0;
    for (int t = 0; t < 2 * nw; ++t) below += first[t] && cand[t] < v;
    sc.bnd[below] = v;
  }
  if (tid == 0) {
    int n = 0, nbnd = 0;
    for (int t = 0; t < 2 * nw; ++t) {
      n += t < nw && cand[t] >= 0;
      nbnd += first[t];
    }
    int nu = 0;
    for (int q = 0; q < n; ++q) {
      if (nu > 0 && o_lo[q] <= sc.u_hi[nu - 1]) {
        sc.u_hi[nu - 1] = max(sc.u_hi[nu - 1], o_hi[q]);
      } else {
        sc.u_lo[nu] = o_lo[q];
        sc.u_hi[nu] = o_hi[q];
        ++nu;
      }
    }
    sc.u_pre[0] = 0;
    for (int m = 0; m < nu; ++m) sc.u_pre[m + 1] = sc.u_pre[m] + (sc.u_hi[m] - sc.u_lo[m]) / 8;
    sc.nu = nu;
    sc.gt = sc.u_pre[nu];
    sc.nbnd = nbnd;
  }
  __syncthreads();
  if (tid < sc.nbnd) {
    const int v = sc.bnd[tid];
    int m = 0;
    while (v > sc.u_hi[m]) ++m;  // every boundary lies in (or ends) a piece
    sc.bnd_ug[tid] = sc.u_pre[m] + (v - sc.u_lo[m]) / 8;
  }
}

// The next stage of a block's share, from union group g (< g_end): its first
// row, its groups (at most sg; never across an interval's end, a boundary,
// or, in the tiles layout, a 128-row tile) and its first union group. m and
// kb follow the interval and the next boundary.
template <int LAYOUT>
__device__ __forceinline__ void p1_next(const P1Sched& sc, int& m, int& kb, int& g, int g_end,
                                        int sg, int& row0, int& n, int& g0) {
  while (g >= sc.u_pre[m + 1]) ++m;
  while (kb < sc.nbnd && sc.bnd_ug[kb] <= g) ++kb;
  row0 = sc.u_lo[m] + (g - sc.u_pre[m]) * 8;
  n = min(sg, min(g_end, sc.u_pre[m + 1]) - g);
  if (kb < sc.nbnd) n = min(n, sc.bnd_ug[kb] - g);
  if (LAYOUT == TILES) n = min(n, (128 - (row0 & 127)) / 8);
  g0 = g;
  g += n;
}

// rows [row0, row0 + 8 n) of x into `dst`, credited to `bar`: one copy per
// bit of n, the largest first, each landing after the one before. rows
// layout: [8 n][C]; cols and tiles: per copy of 2^b groups, [C][8 * 2^b].
template <int LAYOUT>
__device__ __forceinline__ void p1_fetch(const P1Maps& maps, bf16* dst, int row0, int n, int c,
                                         uint64_t* bar) {
  gcd::mbar_arrive_expect_tx(bar, (uint32_t)(n * 8 * c * (int)sizeof(bf16)));
  for (int b = P1_NMAPS - 1; b >= 0; --b) {
    if (!(n & (1 << b))) continue;
    const uint64_t map = reinterpret_cast<uint64_t>(&maps.m[b]);
    const uint32_t d = gcd::smem_addr(dst), br = gcd::smem_addr(bar);
    if (LAYOUT == ROWS) {
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(d), "l"(map), "r"(0), "r"(row0), "r"(br)
          : "memory");
    } else if (LAYOUT == COLS) {
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(d), "l"(map), "r"(row0), "r"(0), "r"(br)
          : "memory");
    } else {
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(d), "l"(map), "r"(row0 & 127), "r"(0),
          "r"(row0 >> 7), "r"(br)
          : "memory");
    }
    dst += (8 << b) * c;
    row0 += 8 << b;
  }
}

// element (row r, channel ch) of x
template <int LAYOUT>
__device__ __forceinline__ float p1_at(const bf16* __restrict__ x, int n, int c, int r, int ch) {
  const int64_t off = LAYOUT == ROWS   ? (int64_t)r * c + ch
                      : LAYOUT == COLS ? (int64_t)ch * n + r
                                       : ((int64_t)(r >> 7) * c + ch) * 128 + (r & 127);
  return __bfloat162float(x[off]);
}

// Adds this thread's share of a stage of n groups to acc. rows: the stage
// is [8 n][C]; thread (ly, tx) takes rows ly + m lanes of channels 8 tx ..
// 8 tx + 7. cols, tiles: the stage is, per copy of 2^b groups (largest
// first), [C][8 * 2^b]; thread ch takes every group of channel ch, starting
// at a group that depends on ch so that neighbouring channels read other
// banks, each group's 8 rows summed first.
template <int LAYOUT>
__device__ __forceinline__ void p1_accumulate(const bf16* st, int c, int n, int ly, int lanes,
                                              int tx, float* acc) {
  if (LAYOUT == ROWS) {
#pragma unroll 2
    for (int r = ly; r < 8 * n; r += lanes) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(st + r * c + tx * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
  } else {
    int j = tx % n;
    for (int i = 0; i < n; ++i) {
      int done = 0, b = P1_NMAPS - 1;
      for (;; --b) {  // the copy that holds group j
        if (!(n & (1 << b))) continue;
        if (j < done + (1 << b)) break;
        done += 1 << b;
      }
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(st + done * 8 * c + (tx << b) * 8 + (j - done) * 8),
              f);
      acc[0] += ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
      j = j + 1 == n ? 0 : j + 1;
    }
  }
}

// bf16 values of a ring slot: a stage of sg groups, and room for the
// threads' sums at a segment's end, which take the slot just read
__host__ __device__ __forceinline__ int p1_slot_elems(int c, int sg) {
  const int elems = max(sg * 8 * c, 2 * P1_PART);
  return (elems + 63) / 64 * 64;  // 128-byte aligned slots
}

// scratch: float [grid][2 P1_CL wpb - 1][C], the blocks' segment sums
template <int LAYOUT>
__global__ void __cluster_dims__(P1_CL, 1, 1) __launch_bounds__(THREADS)
window_sum_kernel(const __grid_constant__ P1Maps maps, const bf16* __restrict__ x,
                  const int32_t* __restrict__ ws, float* __restrict__ out,
                  float* __restrict__ scratch, int n, int c, int nb, int window, int buffers,
                  int sg, int wpb) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char p1_smem[];
  const int slot_elems = p1_slot_elems(c, sg);
  const int nw = P1_CL * wpb;  // windows of the cluster
  const int nseg = 2 * nw - 1;
  bf16* ring = reinterpret_cast<bf16*>(p1_smem);                         // [buffers][slot]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + buffers * slot_elems);  // [2]
  uint64_t* empty = full + 2;                                             // [2]
  P1Sched& sc = *reinterpret_cast<P1Sched*>(empty + 2);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int b0 = blockIdx.x - rank;  // the cluster's first block
  const int w0 = b0 * wpb;           // and window
  float* seg = scratch + (int64_t)blockIdx.x * nseg * c;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      gcd::mbar_init(full + s, 1);
      gcd::mbar_init(empty + s, THREADS / 32);
    }
    gcd::fence_barrier_init();
  }
  p1_schedule(sc, reinterpret_cast<int*>(ring), ws, nb, window, w0, nw, tid);
  __syncthreads();

  const int g_lo = (int)((int64_t)rank * sc.gt / P1_CL);
  const int g_hi = (int)((int64_t)(rank + 1) * sc.gt / P1_CL);

  // the producer, lane 0 of the last warp: stages j .. j + buffers - 1 in
  // flight; a slot is taken again once every warp has released it
  const bool producer = tid == THREADS - 32;
  int pm = 0, pkb = 0, pg = g_lo;
  if (producer) {
    for (int s = 0; s < buffers && pg < g_hi; ++s) {
      int row0, cnt, g0;
      p1_next<LAYOUT>(sc, pm, pkb, pg, g_hi, sg, row0, cnt, g0);
      p1_fetch<LAYOUT>(maps, ring + s * slot_elems, row0, cnt, c, full + s);
    }
  }

  // rows: thread (ly, tx), `lanes` of them a channel slice; cols, tiles:
  // thread ch < C. Each keeps its sums of the current segment in registers.
  const int c8 = c / 8;
  const int lanes = LAYOUT == ROWS ? THREADS / c8 : 1;
  const int ly = LAYOUT == ROWS ? tid / c8 : 0;
  const int tx = LAYOUT == ROWS ? tid % c8 : tid;
  const bool works = LAYOUT == ROWS ? ly < lanes : tid < c;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const int nbnd = sc.nbnd;
  int k = 0;  // the segment being summed, and the union group it ends at
  int next = nbnd > 1 ? sc.bnd_ug[1] : INT_MAX;

  int cm = 0, ckb = 0, cgp = g_lo;
  for (int j = 0; cgp < g_hi; ++j) {
    int row0, cnt, g0;
    p1_next<LAYOUT>(sc, cm, ckb, cgp, g_hi, sg, row0, cnt, g0);
    while (g0 >= next) {  // the stage lies in a later segment
      ++k;
      next = k + 1 < nbnd ? sc.bnd_ug[k + 1] : INT_MAX;
    }
    const int slot = buffers == 2 ? (j & 1) : 0;
    const uint32_t phase = (uint32_t)((buffers == 2 ? j >> 1 : j) & 1);
    gcd::mbar_wait(full + slot, phase);
    bf16* st = ring + slot * slot_elems;
    if (works) p1_accumulate<LAYOUT>(st, c, cnt, ly, lanes, tx, acc);
    if (g0 + cnt >= next || cgp >= g_hi) {
      // segment k, or the block's share of it, ends with this stage: the
      // threads' sums go into the slot just read, and thread ch < C adds
      // them in lane order into the segment's sum
      float* part = reinterpret_cast<float*>(st);
      __syncthreads();
      if (works) {
        if (LAYOUT == ROWS) {
#pragma unroll
          for (int e = 0; e < 8; ++e) part[ly * c + tx * 8 + e] = acc[e];
        } else {
          part[tid] = acc[0];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before copies refill it
      __syncthreads();
      if (tid < c) {
        float t = 0.f;
        for (int l = 0; l < lanes; ++l) t += part[l * c + tid];
        seg[k * c + tid] = t;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    }
    __syncwarp();
    if ((tid & 31) == 0) gcd::mbar_arrive(empty + slot);
    if (producer && pg < g_hi) {
      gcd::mbar_wait(empty + slot, phase);
      int prow, pcnt, pg0;
      p1_next<LAYOUT>(sc, pm, pkb, pg, g_hi, sg, prow, pcnt, pg0);
      p1_fetch<LAYOUT>(maps, ring + slot * slot_elems, prow, pcnt, c, full + slot);
    }
  }
  cluster.sync();  // every block's segment sums are written

  // the block's windows, one thread a (window, channel)
  const float* cseg = scratch + (int64_t)b0 * nseg * c;
  for (int it = tid; it < wpb * c; it += THREADS) {
    const int win = blockIdx.x * wpb + it / c, ch = it % c;
    if (win >= nb) break;
    const int s = ws[win];
    const int bl = p1_body_lo(s), bh = p1_body_hi(s, window);
    float total = 0.f;
    if (bl >= bh) {
      for (int r = s; r < s + window; ++r) total += p1_at<LAYOUT>(x, n, c, r, ch);
    } else {
      for (int r = s; r < bl; ++r) total += p1_at<LAYOUT>(x, n, c, r, ch);
      int k0 = 0;
      while (sc.bnd[k0] != bl) ++k0;
      for (int kk = k0; sc.bnd[kk] != bh; ++kk) {
        const int u0 = sc.bnd_ug[kk], u1 = sc.bnd_ug[kk + 1];
        float t = 0.f;
        for (int b = 0; b < P1_CL; ++b) {
          const int lo = (int)((int64_t)b * sc.gt / P1_CL);
          const int hi = (int)((int64_t)(b + 1) * sc.gt / P1_CL);
          if (max(u0, lo) < min(u1, hi)) t += cseg[((int64_t)b * nseg + kk) * c + ch];
        }
        total += t;
      }
      for (int r = bh; r < s + window; ++r) total += p1_at<LAYOUT>(x, n, c, r, ch);
    }
    out[(int64_t)win * c + ch] = total;
  }
}

// ------------------------------------------------------------------ P2

constexpr int P2_ROWS = 64;         // rows of a dynamic block, at least: its book slice is staged once
constexpr int P2_DEPTH = 4;         // present rows whose pieces a lane loads before it adds them
constexpr int P2_INDEX_ROWS = 256;  // rows of an index_only block, one thread a row

// a 16-byte shared-memory load that the compiler neither removes nor merges
__device__ __forceinline__ uint4 lds16(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// Book rows [u0, u0 + rows), one contiguous slice of rows * k int32, into
// shared memory: 16-byte cp.async copies when the slice starts on 16 bytes
// (u0 * k is a multiple of 4, so whenever the book does), 4-byte ones for
// the rest. Every thread of the block calls it; the caller synchronises.
__device__ __forceinline__ void stage_book(int32_t* s, const int32_t* __restrict__ nbr, int64_t u0,
                                           int rows, int k, int tid, int nthreads) {
  const int32_t* src = nbr + u0 * k;
  const int n = rows * k;
  int done = 0;
  if (((uintptr_t)src & 15u) == 0) {
    for (int i = tid; i < n / 4; i += nthreads) cp_async16(s + 4 * i, src + 4 * i);
    done = n / 4 * 4;
  }
  for (int i = done + tid; i < n; i += nthreads) s[i] = src[i];
  cp_async_commit();
  cp_async_wait<0>();
}

// index_only: out[u] = sum_k nbr[u, k], one thread a row, the block's slice
// read once from device memory and each row summed from shared memory in
// order. KT = 27: the loop over the offsets unrolled; KT = 0: rolled.
template <int KT>
__global__ void __launch_bounds__(THREADS)
index_sum_kernel(const int32_t* __restrict__ nbr, int32_t* __restrict__ out, int n_out, int k) {
  extern __shared__ __align__(16) int32_t book[];
  const int64_t u0 = (int64_t)blockIdx.x * P2_INDEX_ROWS;
  const int rows = (int)min((int64_t)P2_INDEX_ROWS, n_out - u0);
  stage_book(book, nbr, u0, rows, k, threadIdx.x, THREADS);
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const int32_t* row = book + r * k;  // k odd: the 32 rows of a warp fall into 32 banks
  int32_t s = 0;
  if (KT > 0) {
#pragma unroll
    for (int kq = 0; kq < KT; ++kq) s += row[kq];
  } else {
#pragma unroll 1
    for (int kq = 0; kq < k; ++kq) s += row[kq];
  }
  out[u0 + r] = s;
}

// static: the loads without the indirection. One thread per (row, 16-byte
// piece) of x, in order, so that a warp's loads and stores are contiguous;
// the thread copies its piece into its slot of shared memory and reads it
// from there once per offset. KT = 27: the loop over the offsets unrolled;
// KT = 0: rolled.
template <int KT>
__global__ void __launch_bounds__(THREADS)
static_sum_kernel(const bf16* __restrict__ x, float* __restrict__ out, int n, int k, int c) {
  __shared__ uint4 slot[THREADS];
  const int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (t >= (int64_t)n * (c / 8)) return;
  slot[threadIdx.x] = ld16(x + t * 8);
  float acc[8], f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  auto body = [&]() {
    unpack8(lds16(slot + threadIdx.x), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += f[e];
  };
  if (KT > 0) {
#pragma unroll
    for (int kq = 0; kq < KT; ++kq) body();
  } else {
#pragma unroll 1
    for (int kq = 0; kq < k; ++kq) body();
  }
  st32_once(out + t * 8, acc);
}

// dynamic: the lanes of a row are L = lanes_per_row consecutive lanes (a
// power of two, one 16-byte piece each), a warp takes 32 / L rows at a time
// and a block P2_ROWS or more rows in passes. The block's book slice is
// staged once and each row's present entries moved to its front, 8 at a
// time; then every lane loads its piece of P2_DEPTH present rows before it
// adds them, in offset order (no load for an absent entry), and stores its
// 8 sums as two 16-byte stores. KT = 27: the loop over a row's entries
// unrolled; KT = 0: rolled.
template <int KT>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                  float* __restrict__ out, int n_out, int k, int c, int lanes_per_row,
                  int block_rows) {
  extern __shared__ __align__(16) int32_t p2_book[];  // [block_rows][k], then count
  int* count = p2_book + block_rows * k;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t u0 = (int64_t)blockIdx.x * block_rows;
  const int rows = (int)min((int64_t)block_rows, n_out - u0);
  const int piece = lane % lanes_per_row;
  const int rpw = 32 / lanes_per_row;

  stage_book(p2_book, nbr, u0, rows, k, tid, THREADS);
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) {
    int32_t* row = p2_book + r * k;
    int n = 0;
    for (int k0 = 0; k0 < k; k0 += 8) {  // read 8, then write: no write passes an unread entry
      int32_t e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = k0 + i < k ? row[k0 + i] : -1;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (e[i] >= 0) row[n++] = e[i];
    }
    count[r] = n;
  }
  __syncthreads();

  for (int r0 = warp * rpw; r0 < rows; r0 += (THREADS / 32) * rpw) {
    const int r = r0 + lane / lanes_per_row;
    const bool active = r < rows && piece < c / 8;
    const int n = active ? count[r] : 0;
    const int32_t* js = p2_book + r * k;
    const bf16* xp = x + piece * 8;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    // P2_DEPTH present rows: their loads first, then the adds
    auto group = [&](int e0) {
      uint4 v[P2_DEPTH];
#pragma unroll
      for (int d = 0; d < P2_DEPTH; ++d)
        if (e0 + d < n) v[d] = ld16(xp + (int64_t)js[e0 + d] * c);
#pragma unroll
      for (int d = 0; d < P2_DEPTH; ++d) {
        if (e0 + d < n) {
          float f[8];
          unpack8(v[d], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += f[e];
        }
      }
    };
    if (KT > 0) {
#pragma unroll
      for (int e0 = 0; e0 < KT; e0 += P2_DEPTH) {
        if (e0 >= n) break;
        group(e0);
      }
    } else {
#pragma unroll 1
      for (int e0 = 0; e0 < n; e0 += P2_DEPTH) group(e0);
    }
    if (active) st32_once(out + (u0 + r) * c + piece * 8, acc);
  }
}

// lanes per row: one 16-byte piece each, a power of two
inline int p2_lanes_per_row(int c8) {
  int l = 1;
  while (l < c8) l *= 2;
  return l;
}

constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use on sm_90

// Allows KERNEL the whole of a block's shared memory, once per kernel: a
// call per launch would stand between the caller's timing events and the
// launch.
template <auto KERNEL>
cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  return err;
}

template <int KT>
cudaError_t p2_launch(int blocks, size_t smem, cudaStream_t st, const bf16* x, const int32_t* nbr,
                      float* out, int n_out, int k, int c, int lpr, int block_rows) {
  const cudaError_t err = allow_smem<gather_sum_kernel<KT>>();
  if (err != cudaSuccess) return err;
  gather_sum_kernel<KT><<<blocks, THREADS, smem, st>>>(x, nbr, out, n_out, k, c, lpr, block_rows);
  return cudaSuccess;
}

// ------------------------------------------------------------------ P3, P4

// ---- P3: the shifted-row product on wgmma

constexpr int P3_ROWS = 256;            // output rows of a block: 2 warpgroups x 2 m64 tiles
constexpr int P3_WARPS = 8;             // two warpgroups; 8 warps leave each thread 255 registers
constexpr int P3_THREADS = P3_WARPS * 32;
constexpr int P3_STAGE_K = 64;          // values of k a ring stage has room for (128-byte rows)
constexpr int P3_MAX_STAGES = 5;
constexpr int P3_MAX_CHUNKS = 16;
constexpr int P3_BAR_BYTES = 1024;      // 2 x 5 ring barriers + 16 window barriers; the ring
                                        // behind them starts on a swizzle atom (1024 bytes)
constexpr int P3_SMEM_LIMIT = 232448;   // what a block may use on sm_90

// output columns of a block: one wgmma of that width per m64 tile and k16 step
inline int p3_tile_n(int co) { return co <= 96 ? 96 : 128; }
inline int p3_ci_pad(int ci) { return (ci + 15) & ~15; }
// k16 steps of a chunk: the channels go through the ring in chunks of
// 16 * steps, the largest of 64, 48, 32, 16 that divides them (96 -> 48)
inline int p3_steps(int ci) {
  const int s16 = p3_ci_pad(ci) / 16;
  return s16 % 4 == 0 ? 4 : s16 % 3 == 0 ? 3 : s16 % 2 == 0 ? 2 : 1;
}
inline int p3_chunks(int ci) { return p3_ci_pad(ci) / (16 * p3_steps(ci)); }
// window row pitch in bf16: an odd multiple of 16 bytes over a multiple of 32, so that
// the 8 row addresses of an `ldmatrix` fall into 8 different 16-byte bank groups
inline int p3_pitch(int ci) { return p3_ci_pad(ci) + 8; }

// W [K, Ci, Co] -> wimg [n_tiles][chunks][K] stages of tn x 64 values, each the
// image of a K-major B operand under the 128-byte swizzle (hopper_mma.cuh):
// value (n, k) at byte (n / 8) * 1024 + (n % 8) * 128 + ((k / 8) ^ (n % 8)) * 16
// + (k % 8) * 2, k < depth the chunk's channel; channels beyond Ci, the rest
// of the 64 and columns beyond Co are zeros.
__global__ void __launch_bounds__(THREADS)
pack_w_kernel(const bf16* __restrict__ w, bf16* __restrict__ wimg, int k, int ci, int co, int tn,
              int nchunks, int depth, int64_t total) {
  const int64_t idx = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (idx >= total) return;
  const int stage_elems = tn * P3_STAGE_K;
  const int e = (int)(idx % stage_elems);
  const int64_t sid = idx / stage_elems;
  const int kq = (int)(sid % k);
  const int c = (int)((sid / k) % nchunks);
  const int nt = (int)(sid / ((int64_t)k * nchunks));
  const int r = (e % 512) / 64;  // row of the 8-row atom
  const int n = (e / 512) * 8 + r;
  const int kk = ((((e % 64) / 8) ^ r) * 8) + e % 8;
  const int cc = c * depth + kk;
  const int o = nt * tn + n;
  const bool in = kk < depth && cc < ci && o < co;
  wimg[idx] = in ? w[((int64_t)kq * ci + cc) * co + o] : __float2bfloat16(0.f);
}

// A fragments of one stage for one warp: [k16 step][m64 tile][register]
template <int STEPS>
struct P3Frags {
  uint32_t r[STEPS][2][4];
};

template <int STEPS>
__device__ __forceinline__ void p3_load(P3Frags<STEPS>& fa, const bf16* a, int pitch) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      gcd::ldmatrix_x4(fa.r[ks][mt], a + (size_t)mt * 64 * pitch + ks * 16);
}

template <int BN, int STEPS>
__device__ __forceinline__ void p3_multiply(float (&acc)[2][BN / 2], const P3Frags<STEPS>& fa,
                                            uint32_t b_addr) {
  gcd::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks) {
    const uint64_t desc = gcd::wgmma_desc_sw128(b_addr + ks * 32);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if constexpr (BN == 96) {
        gcd::wgmma_m64n96k16_rs(acc[mt], fa.r[ks][mt], desc);
      } else {
        gcd::wgmma_m64n128k16_rs(acc[mt], fa.r[ks][mt], desc);
      }
    }
  }
  gcd::wgmma_commit();
}

template <int STEPS>
__device__ __forceinline__ void p3_keep(P3Frags<STEPS>& fa) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gcd::keep_alive(fa.r[ks][mt][e]);
}

// BN: output columns of the block (96, 128); STEPS: k16 steps of a chunk.
template <int BN, int STEPS>
__global__ void __launch_bounds__(P3_THREADS, 1)
tile_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wimg,
                 float* __restrict__ out, int n, int k, int ci, int co, int stages) {
  constexpr int DEPTH = 16 * STEPS;  // channels of a chunk
  constexpr int STAGE_ELEMS = BN * P3_STAGE_K;
  constexpr uint32_t STAGE_BYTES = STAGE_ELEMS * sizeof(bf16);
  extern __shared__ __align__(1024) unsigned char p3_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(p3_smem);  // [P3_MAX_STAGES]
  uint64_t* empty = full + P3_MAX_STAGES;                  // [P3_MAX_STAGES]
  uint64_t* winbar = empty + P3_MAX_STAGES;                // [P3_MAX_CHUNKS]
  bf16* ring = reinterpret_cast<bf16*>(p3_smem + P3_BAR_BYTES);  // [stages][STAGE_ELEMS]
  bf16* win = ring + (size_t)stages * STAGE_ELEMS;               // [win_rows][pitch]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ci_pad = (ci + 15) & ~15;
  const int pitch = ci_pad + 8;
  const int nchunks = ci_pad / DEPTH;
  const int win_rows = P3_ROWS + k - 1;
  const int m0 = blockIdx.x * P3_ROWS;
  const int nt = blockIdx.y;
  const int total = nchunks * k;   // ring stages this block consumes
  const int ahead = stages - 2;    // stages requested beyond the one being multiplied

  // ---- the window, once: rows [m0 - K/2, m0 + 256 + K - 1 - K/2) of x
  const int src0 = m0 - k / 2;                  // source row of window row 0
  const int j_lo = max(0, -src0);               // window rows [j_lo, j_hi) lie inside x
  const int j_hi = min(win_rows, n - src0);
  if (tid == 0) {
    for (int s = 0; s < P3_MAX_STAGES; ++s) {
      gcd::mbar_init(full + s, 1);
      gcd::mbar_init(empty + s, P3_WARPS);
    }
    for (int c = 0; c < P3_MAX_CHUNKS; ++c) gcd::mbar_init(winbar + c, 1);
    gcd::fence_barrier_init();
    for (int c = 0; c < nchunks; ++c)
      gcd::mbar_arrive_expect_tx(winbar + c, (uint32_t)min(DEPTH, ci - c * DEPTH) *
                                                 (uint32_t)sizeof(bf16) * (uint32_t)(j_hi - j_lo));
  }
  {
    // the rows beyond either end of x are copies of row 0 / row N - 1, the
    // channels beyond Ci zeros: plain stores, ordered by the block barrier
    const int pieces = ci / 8;  // 16-byte pieces of a row of x
    const int outside = win_rows - (j_hi - j_lo);
    for (int q = tid; q < outside * pieces; q += P3_THREADS) {
      int j = q / pieces;
      if (j >= j_lo) j += j_hi - j_lo;
      const int src = min(max(src0 + j, 0), n - 1);
      const int piece = q % pieces;
      *reinterpret_cast<uint4*>(win + (size_t)j * pitch + piece * 8) =
          *reinterpret_cast<const uint4*>(x + (size_t)src * ci + piece * 8);
    }
    if (ci_pad > ci) {
      for (int j = tid; j < win_rows; j += P3_THREADS)
        *reinterpret_cast<uint4*>(win + (size_t)j * pitch + ci) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  auto copy_window = [&](int c) {  // one bulk copy per row inside x
    const int c0 = c * DEPTH;
    const uint32_t bytes = (uint32_t)min(DEPTH, ci - c0) * sizeof(bf16);
    for (int j = j_lo + tid; j < j_hi; j += P3_THREADS)
      gcd::bulk_g2s(win + (size_t)j * pitch + c0, x + (size_t)(src0 + j) * ci + c0, bytes,
                    winbar + c);
  };
  // Ring positions are counted up, never divided: slot and phase bit of the
  // next slice to ask for (thread 0), of the next stage to load fragments for,
  // and the slot of the next stage to multiply.
  int ask_n = 0, ask_s = 0, ask_ph = 0;
  const bf16* ask_src = wimg + (size_t)nt * total * STAGE_ELEMS;
  auto ask = [&]() {  // the next slice of W into its ring slot; one thread
    if (ask_n >= stages) gcd::mbar_wait(empty + ask_s, ask_ph ^ 1);
    gcd::mbar_arrive_expect_tx(full + ask_s, STAGE_BYTES);
    gcd::bulk_g2s(ring + (size_t)ask_s * STAGE_ELEMS, ask_src, STAGE_BYTES, full + ask_s);
    ask_src += STAGE_ELEMS;
    ++ask_n;
    if (++ask_s == stages) {
      ask_s = 0;
      ask_ph ^= 1;
    }
  };
  copy_window(0);
  if (tid == 0)
    while (ask_n < min(ahead, total)) ask();
  for (int c = 1; c < nchunks; ++c) copy_window(c);

  // ---- warpgroup wg owns rows 128 wg .. 128 wg + 127 of the block
  const int wg = warp / 4;
  const int w4 = warp % 4;
  float acc[2][BN / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[mt][e] = 0.f;

  // this lane's `ldmatrix` row address at offset 0, chunk 0, k16 step 0
  const bf16* a_lane = win + (size_t)(wg * 128 + w4 * 16 + lane % 16) * pitch + (lane / 16) * 8;
  const uint32_t ring_addr = gcd::smem_addr(ring);

  // wait for the next stage (and, at a chunk's first offset, for the window's
  // chunk) and load its A fragments: offset kq reads the window kq rows down
  int ld_s = 0, ld_ph = 0, ld_kq = 0, ld_c = 0;
  const bf16* ld_a = a_lane;
  auto load = [&](P3Frags<STEPS>& fa) {
    if (ld_kq == 0) gcd::mbar_wait(winbar + ld_c, 0);
    gcd::mbar_wait(full + ld_s, ld_ph);
    p3_load<STEPS>(fa, ld_a, pitch);
    ld_a += pitch;
    if (++ld_kq == k) {
      ld_kq = 0;
      ++ld_c;
      ld_a = a_lane + ld_c * DEPTH;
    }
    if (++ld_s == stages) {
      ld_s = 0;
      ld_ph ^= 1;
    }
  };
  // One stage: start its products; while they run, ask for the slice that
  // goes into the slot of the stage before last (free once every warp has
  // left it; thread 0) and load the next stage's fragments into `next`; then
  // wait for the products and release the slot.
  int mm_s = 0;
  auto stage = [&](P3Frags<STEPS>& fa, P3Frags<STEPS>& next, bool last) {
    p3_multiply<BN, STEPS>(acc, fa, ring_addr + (uint32_t)mm_s * STAGE_BYTES);
    if (tid == 0 && ask_n < total) ask();
    __syncwarp();
    if (!last) load(next);
    gcd::wgmma_wait<0>();
    p3_keep<STEPS>(fa);
    if (lane == 0) gcd::mbar_arrive(empty + mm_s);
    if (++mm_s == stages) mm_s = 0;
  };

  P3Frags<STEPS> fa0, fa1;
  load(fa0);
  for (int j = 0; j < total; j += 2) {
    stage(fa0, fa1, j + 1 == total);
    if (j + 1 < total) stage(fa1, fa0, j + 2 == total);
  }

  const int g = lane / 4, q = lane % 4;
  const bool pairs = co % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = m0 + wg * 128 + mt * 64 + w4 * 16 + g + 8 * h;
      if (u >= n) continue;
      float* row = out + (size_t)u * co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = nt * BN + 8 * j + 2 * q;
        const float v0 = acc[mt][4 * j + 2 * h], v1 = acc[mt][4 * j + 2 * h + 1];
        if (pairs && o + 1 < co) {
          *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
        } else {
          if (o < co) row[o] = v0;
          if (o + 1 < co) row[o + 1] = v1;
        }
      }
    }
  }
}

// shared memory of a block, or 0 when not even three stages fit beside the window
inline int p3_smem_bytes(int k, int ci, int co, int* stages) {
  const int window = (P3_ROWS + k - 1) * p3_pitch(ci) * (int)sizeof(bf16);
  const int stage = p3_tile_n(co) * P3_STAGE_K * (int)sizeof(bf16);
  const int fit = (P3_SMEM_LIMIT - P3_BAR_BYTES - window) / stage;
  *stages = fit < P3_MAX_STAGES ? fit : P3_MAX_STAGES;
  if (window > P3_SMEM_LIMIT || fit < 3 || p3_chunks(ci) > P3_MAX_CHUNKS) return 0;
  return P3_BAR_BYTES + *stages * stage + window;
}

template <int BN>
cudaError_t p3_launch(int steps, dim3 grid, int smem, cudaStream_t st, const bf16* x,
                      const bf16* wimg, float* out, int n, int k, int ci, int co, int stages) {
  auto kernel = steps == 4   ? tile_gemm_kernel<BN, 4>
                : steps == 3 ? tile_gemm_kernel<BN, 3>
                : steps == 2 ? tile_gemm_kernel<BN, 2>
                             : tile_gemm_kernel<BN, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, P3_THREADS, smem, st>>>(x, wimg, out, n, k, ci, co, stages);
  return cudaSuccess;
}

// ---- P4: the conv with its gather as a one-hot product, on mma.sync

constexpr int P4_ROWS = 128;   // output rows of a block: 8 warps x one 16-row strip
constexpr int P4_WARPS = 8;    // consumer warps; one more warp starts the copies
constexpr int P4_THREADS = (P4_WARPS + 1) * 32;
constexpr int P4_SUB = 128;    // source rows of a window: 8 k16 tiles
constexpr int P4_CHUNK = 64;   // channels of a chunk: G is 16 x 64 f32 a warp
constexpr int P4_RING = 4;     // (offset, chunk) stages in flight
constexpr int P4_MAX_K = 64;
constexpr int P4_HEAD_BYTES = 1024;  // barriers, window starts, offsets with an entry;
                                     // the stages behind start on a 1024-byte boundary
constexpr int P4_WIN_BYTES = P4_SUB * P4_CHUNK * 2;  // a window chunk: 128 rows of 128 bytes

__host__ __device__ inline int p4_ci16(int ci) { return (ci + 15) & ~15; }
inline int p4_chunks(int ci) { return (p4_ci16(ci) + P4_CHUNK - 1) / P4_CHUNK; }
// n16 column pairs of a block (2, 4, 6 or 8): BN = 16 x that, up to 128 columns
inline int p4_pairs(int co) {
  const int np = (min(co, 128) + 15) / 16;
  return np + (np & 1);
}
inline int p4_smem_bytes(int k, int co) {
  return P4_HEAD_BYTES + P4_RING * (P4_WIN_BYTES + P4_CHUNK * 16 * p4_pairs(co) * 2) +
         P4_ROWS * k * 4;
}

// W [K, Ci, Co] -> wimg [Co tiles][K][chunks][4 k16 steps][NP pairs][32 lanes][8]:
// for each (k16 step, pair of n8 tiles) the `mma.m16n8k16` B fragments of
// all 32 lanes, lane l's 16 bytes at 16 l: {b0, b1} of tile 2p, then of tile
// 2p + 1, b0 = (channels 2q, 2q + 1; column g), b1 = (2q + 8, 2q + 9; g),
// g = l / 4, q = l % 4. Channels beyond Ci (the rest of the last chunk) and
// columns beyond Co are zeros. A warp reads one such fragment pair with one
// 16-byte load a lane, and a (k, chunk) slice of a Co tile is one bulk copy.
__global__ void __launch_bounds__(THREADS)
pack_onehot_w_kernel(const bf16* __restrict__ w, bf16* __restrict__ wimg, int k, int ci, int co,
                     int np, int nchunks, int64_t total) {
  const int64_t idx = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (idx >= total) return;
  const int e = (int)(idx % 8);
  int64_t rest = idx / 8;
  const int l = (int)(rest % 32);
  rest /= 32;
  const int p = (int)(rest % np);
  rest /= np;
  const int s = (int)(rest % 4);
  rest /= 4;
  const int c = (int)(rest % nchunks);
  rest /= nchunks;
  const int kq = (int)(rest % k);
  const int nt = (int)(rest / k);
  const int cc = c * P4_CHUNK + s * 16 + 2 * (l % 4) + (e & 1) + ((e >> 1) & 1) * 8;
  const int o = nt * 16 * np + 8 * (2 * p + (e >> 2)) + l / 4;
  wimg[idx] = cc < ci && o < co ? w[((int64_t)kq * ci + cc) * co + o] : __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + P4_SUB) x channels [c0, c0 + 64) of x through its tensor map
// (128-byte swizzle: the 16-byte piece p of window row r lands at piece
// p ^ (r % 8)); rows beyond N_in and channels beyond Ci arrive as zeros
__device__ __forceinline__ void tma_window(void* dst, const CUtensorMap* map, int c0, int r0,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(gcd::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(gcd::smem_addr(bar))
      : "memory");
}

// NP: n16 column pairs of the block (BN = 16 NP output columns).
template <int NP>
__global__ void __launch_bounds__(P4_THREADS, 1)
onehot_conv_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ x,
                   const int32_t* __restrict__ nbr, const bf16* __restrict__ wimg,
                   float* __restrict__ out, int32_t* __restrict__ far, int n_out, int k, int ci,
                   int co) {
  constexpr int BN = 16 * NP;
  constexpr int W_STAGE = P4_CHUNK * BN;  // bf16 values of W a stage holds
  extern __shared__ __align__(1024) unsigned char p4_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(p4_smem);  // [P4_RING]
  uint64_t* empty = full + P4_RING;                         // [P4_RING]
  int* s_nlist = reinterpret_cast<int*>(empty + P4_RING);
  int* s_start = s_nlist + 1;  // [k]: the window's first row, -1: no entry at that offset
  int* s_list = s_start + k;   // [k]: the offsets with an entry
  unsigned char* win = p4_smem + P4_HEAD_BYTES;                   // [P4_RING][P4_WIN_BYTES]
  bf16* ring = reinterpret_cast<bf16*>(win + P4_RING * P4_WIN_BYTES);  // [P4_RING][W_STAGE]
  int32_t* s_nbr = reinterpret_cast<int32_t*>(ring + P4_RING * W_STAGE);  // [P4_ROWS][k]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * P4_ROWS;
  const int nt = blockIdx.y;
  const int ci16 = p4_ci16(ci);
  const int nchunks = (ci16 + P4_CHUNK - 1) / P4_CHUNK;

  // ---- the block's book slice (rows beyond N_out absent), barriers
  {
    const int64_t base = (int64_t)m0 * k;
    const int64_t total = (int64_t)n_out * k;
    for (int e = tid; e < P4_ROWS * k; e += P4_THREADS)
      s_nbr[e] = base + e < total ? nbr[base + e] : -1;
    if (tid == 0) {
      for (int s = 0; s < P4_RING; ++s) {
        gcd::mbar_init(full + s, 1);
        gcd::mbar_init(empty + s, P4_WARPS);
      }
      gcd::fence_barrier_init();
    }
  }
  __syncthreads();
  // ---- per offset, the window starts at the block's smallest present entry
  // (absent, -1, is the largest unsigned)
  for (int kq = warp; kq < k; kq += P4_WARPS + 1) {
    unsigned m = UINT_MAX;
    for (int r = lane; r < P4_ROWS; r += 32) m = min(m, (unsigned)s_nbr[r * k + kq]);
    m = __reduce_min_sync(0xffffffffu, m);
    if (lane == 0) s_start[kq] = m == UINT_MAX ? -1 : (int)m;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int kq = 0; kq < k; ++kq)
      if (s_start[kq] >= 0) s_list[n++] = kq;
    *s_nlist = n;
  }
  __syncthreads();
  const int nlist = *s_nlist;

  if (warp == P4_WARPS) {
    // ---- the copies, one thread: per (offset with an entry, chunk) a stage of
    // the ring, the window chunk through the tensor map and W's slice as one
    // bulk copy, into a slot the strips have left. Slots and phases counted up.
    if (lane == 0) {
      int s = 0, ph = 0, n = 0;
      const size_t k_stride = (size_t)nchunks * W_STAGE;
      const bf16* w_tile = wimg + (size_t)nt * k * k_stride;
      for (int i = 0; i < nlist; ++i) {
        const int kq = s_list[i];
        for (int c = 0; c < nchunks; ++c) {
          if (n >= P4_RING) gcd::mbar_wait(empty + s, ph ^ 1);
          gcd::mbar_arrive_expect_tx(full + s, P4_WIN_BYTES + W_STAGE * 2);
          tma_window(win + (size_t)s * P4_WIN_BYTES, &xmap, c * P4_CHUNK, s_start[kq], full + s);
          gcd::bulk_g2s(ring + (size_t)s * W_STAGE, w_tile + kq * k_stride + (size_t)c * W_STAGE,
                        W_STAGE * 2, full + s);
          ++n;
          if (++s == P4_RING) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- warp `warp` owns block rows 16 warp .. 16 warp + 15; with g = lane / 4,
  // q = lane % 4 this lane's A / C rows are r_lo = 16 warp + g and r_lo + 8
  const int g = lane / 4, q = lane % 4;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  constexpr uint32_t ONE = 0x3f80u;  // bf16 1.0
  float acc[2 * NP][4];
#pragma unroll
  for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  int far_local = 0;
  int s = 0, ph = 0;

  for (int i = 0; i < nlist; ++i) {
    const int kq = s_list[i];
    const int st = s_start[kq];
    const int j_lo = s_nbr[r_lo * k + kq], j_hi = s_nbr[r_hi * k + kq];
    // window row of each entry; an absent or outside entry matches no column
    const unsigned rel_lo = (unsigned)(j_lo - st), rel_hi = (unsigned)(j_hi - st);
    const bool in_lo = j_lo >= 0 && rel_lo < P4_SUB, in_hi = j_hi >= 0 && rel_hi < P4_SUB;
    const bool far_lo = j_lo >= 0 && !in_lo, far_hi = j_hi >= 0 && !in_hi;
    const bool strip = __any_sync(0xffffffffu, j_lo >= 0 || j_hi >= 0);
    const bool any_far = __any_sync(0xffffffffu, far_lo || far_hi);
    // the k16 tiles of the window that hold an entry of this strip
    const unsigned tiles = __reduce_or_sync(
        0xffffffffu, (in_lo ? 1u << (rel_lo >> 4) : 0u) | (in_hi ? 1u << (rel_hi >> 4) : 0u));
    if (q == 0 && nt == 0) far_local += (int)far_lo + (int)far_hi;

    for (int c = 0; c < nchunks; ++c) {
      gcd::mbar_wait(full + s, ph);
      const int cw = min(P4_CHUNK, ci16 - c * P4_CHUNK);  // a multiple of 16
      if (strip) {
        // G = onehot(rel) @ window[:, chunk]: exact, one non-zero term a value
        float gc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) gc[t][e] = 0.f;
        const unsigned char* wb = win + (size_t)s * P4_WIN_BYTES;
        for (unsigned tl = tiles; tl; tl &= tl - 1) {
          const int kt = __ffs(tl) - 1;
          const unsigned col = kt * 16 + 2 * q;
          uint32_t a[4];
          a[0] = (rel_lo == col ? ONE : 0u) | (rel_lo == col + 1 ? ONE << 16 : 0u);
          a[1] = (rel_hi == col ? ONE : 0u) | (rel_hi == col + 1 ? ONE << 16 : 0u);
          a[2] = (rel_lo == col + 8 ? ONE : 0u) | (rel_lo == col + 9 ? ONE << 16 : 0u);
          a[3] = (rel_hi == col + 8 ? ONE : 0u) | (rel_hi == col + 9 ? ONE << 16 : 0u);
          const int row = kt * 16 + (lane & 15);
          const unsigned char* brow = wb + row * 128;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (16 * p < cw) {
              uint32_t bb[4];
              gcd::ldmatrix_x4_trans(bb, brow + (((2 * p + (lane >> 4)) ^ (row & 7)) << 4));
              gcd::mma_bf16_16816(gc[2 * p], a, bb[0], bb[1]);
              gcd::mma_bf16_16816(gc[2 * p + 1], a, bb[2], bb[3]);
            }
          }
        }
        // entries outside the window: their rows of G read from x directly
        if (any_far) {
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int ch = c * P4_CHUNK + 8 * t + 2 * q;  // even; ch < Ci implies ch + 1 < Ci
            if (8 * t < cw && ch < ci) {
              if (far_lo) {
                const float2 v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)j_lo * ci + ch));
                gc[t][0] = v.x;
                gc[t][1] = v.y;
              }
              if (far_hi) {
                const float2 v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)j_hi * ci + ch));
                gc[t][2] = v.x;
                gc[t][3] = v.y;
              }
            }
          }
          __syncwarp();
        }
        // out += G @ W[k][chunk]: G's C fragments of n8 tiles 2s, 2s + 1 are
        // the A fragment of k16 step s, packed to bf16 without rounding
        const bf16* wst = ring + (size_t)s * W_STAGE;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (16 * ks < cw) {
            const uint32_t a[4] = {pack_bf16x2(gc[2 * ks][0], gc[2 * ks][1]),
                                   pack_bf16x2(gc[2 * ks][2], gc[2 * ks][3]),
                                   pack_bf16x2(gc[2 * ks + 1][0], gc[2 * ks + 1][1]),
                                   pack_bf16x2(gc[2 * ks + 1][2], gc[2 * ks + 1][3])};
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const uint4 bw =
                  *reinterpret_cast<const uint4*>(wst + ((size_t)(ks * NP + p) * 32 + lane) * 8);
              gcd::mma_bf16_16816(acc[2 * p], a, bw.x, bw.y);
              gcd::mma_bf16_16816(acc[2 * p + 1], a, bw.z, bw.w);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) gcd::mbar_arrive(empty + s);
      if (++s == P4_RING) {
        s = 0;
        ph ^= 1;
      }
    }
  }

  far_local = __reduce_add_sync(0xffffffffu, far_local);
  if (lane == 0 && far_local) atomicAdd(far, far_local);
  const bool pairs = co % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = m0 + r_lo + 8 * h;
    if (u >= n_out) continue;
    float* orow = out + (size_t)u * co;
#pragma unroll
    for (int t = 0; t < 2 * NP; ++t) {
      const int o = nt * BN + 8 * t + 2 * q;
      const float v0 = acc[t][2 * h], v1 = acc[t][2 * h + 1];
      if (pairs && o + 1 < co) {
        *reinterpret_cast<float2*>(orow + o) = make_float2(v0, v1);
      } else {
        if (o < co) orow[o] = v0;
        if (o + 1 < co) orow[o + 1] = v1;
      }
    }
  }
}

template <int NP>
cudaError_t p4_launch(dim3 grid, int smem, cudaStream_t st, const CUtensorMap& xmap, const bf16* x,
                      const int32_t* nbr, const bf16* wimg, float* out, int32_t* far, int n_out,
                      int k, int ci, int co) {
  const cudaError_t err = allow_smem<onehot_conv_kernel<NP>>();
  if (err != cudaSuccess) return err;
  onehot_conv_kernel<NP><<<grid, P4_THREADS, smem, st>>>(xmap, x, nbr, wimg, out, far, n_out, k,
                                                         ci, co);
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda);
// null where it is missing
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (PFN_cuTensorMapEncodeTiled_v12000) nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// groups of 8 rows a stage holds: a power of two, the ring's stages together
// at most P1_RING_BYTES of x
int p1_stage_groups(int c, int buffers) {
  int sg = 1;
  while (2 * sg <= P1_MAX_SG && buffers * 2 * sg * 8 * c * (int)sizeof(bf16) <= P1_RING_BYTES)
    sg *= 2;
  return sg;
}

// bytes of shared memory a block of P1 takes: the ring, four barriers and the
// schedule
int p1_smem_bytes(int c, int buffers) {
  return buffers * p1_slot_elems(c, p1_stage_groups(c, buffers)) * (int)sizeof(bf16) +
         4 * (int)sizeof(uint64_t) + (int)sizeof(P1Sched);
}

template <int LAYOUT>
cudaError_t p1_allow() {
  // as many blocks an SM as shared memory holds: the carve-out at its largest
  static const cudaError_t carve = cudaFuncSetAttribute(
      window_sum_kernel<LAYOUT>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  return carve != cudaSuccess ? carve : allow_smem<window_sum_kernel<LAYOUT>>();
}

// Windows a block takes: 1, unless the card cannot hold the grid's clusters
// at once (by its own count), then 2, which halves the clusters and shares
// each union among twice the windows. The count is cached per (layout, C,
// buffers).
template <int LAYOUT>
int p1_windows_per_block(int c, int nb, int buffers, cudaError_t* err) {
  static int resident[33][2];  // clusters the card holds at once; 0: not asked yet
  *err = p1_allow<LAYOUT>();
  if (*err != cudaSuccess) return 0;
  int& held = resident[c / 8][buffers - 1];
  if (!held) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P1_CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = p1_smem_bytes(c, buffers);
    *err = cudaOccupancyMaxActiveClusters(&held, window_sum_kernel<LAYOUT>, &cfg);
    if (*err != cudaSuccess) return 0;
  }
  return (nb + P1_CL - 1) / P1_CL <= held ? 1 : P1_MAX_WPB;
}

// floats of the scratch gcd_window_sum needs: the blocks' segment sums
int64_t p1_scratch_floats(int c, int nb, int wpb) {
  const int64_t grid = (nb + P1_CL * wpb - 1) / (P1_CL * wpb) * P1_CL;
  return grid * (2 * P1_CL * wpb - 1) * c;
}

template <int LAYOUT>
cudaError_t p1_launch(cudaStream_t st, const P1Maps& maps, const bf16* x, const int32_t* ws,
                      float* out, float* scratch, int64_t scratch_floats, int n, int c, int nb,
                      int window, int buffers) {
  cudaError_t err;
  const int wpb = p1_windows_per_block<LAYOUT>(c, nb, buffers, &err);
  if (err != cudaSuccess) return err;
  if (p1_scratch_floats(c, nb, wpb) > scratch_floats) return cudaErrorInvalidValue;
  const int grid = (nb + P1_CL * wpb - 1) / (P1_CL * wpb) * P1_CL;
  window_sum_kernel<LAYOUT><<<grid, THREADS, p1_smem_bytes(c, buffers), st>>>(
      maps, x, ws, out, scratch, n, c, nb, window, buffers, p1_stage_groups(c, buffers), wpb);
  return cudaSuccess;
}

}  // namespace

// x 16-byte aligned, C a multiple of 8 up to 256, buffers 1 or 2; cols: N a
// multiple of 8 (the tensor map's pitch is a multiple of 16 bytes); tiles:
// N a multiple of 128; 0 <= ws[i] <= N - window (not checked)
extern "C" int gcd_window_sum(const void* x, const void* ws, void* out, void* scratch,
                              long long scratch_floats, int n, int c, int nb, int window,
                              int layout, int buffers, void* stream) {
  if (c < 8 || c > 256 || c % 8 || (buffers != 1 && buffers != 2) || window < 1 ||
      window > n || ((uintptr_t)x & 15u) || layout < ROWS || layout > TILES ||
      (layout == COLS && n % 8) || (layout == TILES && n % 128))
    return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    // one map per copy size, 8 << b rows: rows [N][C] as 2-D {C, N}, box
    // {C, rows}; cols [C][N] as 2-D {N, C}, box {rows, C}; tiles
    // [N / 128][C][128] as 3-D {128, C, N / 128}, box {rows, C, 1}. A map
    // whose box is taller than x is never used and left empty.
    P1Maps maps{};
    for (int b = 0; b < P1_NMAPS; ++b) {
      const cuuint32_t h = 8u << b;
      if (layout != TILES && (int)h > n) break;
      const cuuint32_t unit[3] = {1, 1, 1};
      cuuint64_t dims[3], strides[2];
      cuuint32_t box[3];
      int rank = 2;
      if (layout == ROWS) {
        dims[0] = c, dims[1] = n, strides[0] = (cuuint64_t)c * sizeof(bf16);
        box[0] = c, box[1] = h;
      } else if (layout == COLS) {
        dims[0] = n, dims[1] = c, strides[0] = (cuuint64_t)n * sizeof(bf16);
        box[0] = h, box[1] = c;
      } else {
        rank = 3;
        dims[0] = 128, dims[1] = c, dims[2] = n / 128;
        strides[0] = 128 * sizeof(bf16), strides[1] = (cuuint64_t)c * 128 * sizeof(bf16);
        box[0] = h, box[1] = c, box[2] = 1;
      }
      if (encode(&maps.m[b], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(x), dims,
                 strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
    const bf16* xp = (const bf16*)x;
    const int32_t* wp = (const int32_t*)ws;
    float* op = (float*)out;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err =
        layout == ROWS
            ? p1_launch<ROWS>(st, maps, xp, wp, op, (float*)scratch, scratch_floats, n, c, nb, window, buffers)
        : layout == COLS
            ? p1_launch<COLS>(st, maps, xp, wp, op, (float*)scratch, scratch_floats, n, c, nb, window, buffers)
            : p1_launch<TILES>(st, maps, xp, wp, op, (float*)scratch, scratch_floats, n, c, nb, window, buffers);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// windows a block of gcd_window_sum takes for these arguments (1 or 2), and
// the floats of scratch it needs, or minus a CUDA error
extern "C" long long gcd_window_sum_plan(int c, int nb, int layout, int buffers, int want_scratch) {
  if (c < 8 || c > 256 || c % 8 || (buffers != 1 && buffers != 2) || layout < ROWS ||
      layout > TILES || nb < 0)
    return -(long long)cudaErrorInvalidValue;
  cudaError_t err;
  const int wpb = layout == ROWS   ? p1_windows_per_block<ROWS>(c, nb, buffers, &err)
                  : layout == COLS ? p1_windows_per_block<COLS>(c, nb, buffers, &err)
                                   : p1_windows_per_block<TILES>(c, nb, buffers, &err);
  if (err != cudaSuccess) return -(long long)err;
  return want_scratch ? p1_scratch_floats(c, nb, wpb) : wpb;
}

// mode 0: dynamic, 1: static, 2: index_only (out is int32 [n_out]); x 16-byte
// aligned (modes 0, 1), C % 8 == 0, unroll only with k == 27
extern "C" int gcd_gather_sum(const void* x, const void* nbr, void* out, int n_out, int k, int c,
                              int mode, int unroll, void* stream) {
  if (n_out > 0) {
    const bf16* xp = (const bf16*)x;
    const int32_t* np = (const int32_t*)nbr;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (mode == 2) {
      const size_t smem = (size_t)P2_INDEX_ROWS * k * sizeof(int32_t);
      if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
      const int blocks = (n_out + P2_INDEX_ROWS - 1) / P2_INDEX_ROWS;
      if (unroll) {
        err = allow_smem<index_sum_kernel<27>>();
        if (err == cudaSuccess) index_sum_kernel<27><<<blocks, THREADS, smem, st>>>(np, (int32_t*)out, n_out, k);
      } else {
        err = allow_smem<index_sum_kernel<0>>();
        if (err == cudaSuccess) index_sum_kernel<0><<<blocks, THREADS, smem, st>>>(np, (int32_t*)out, n_out, k);
      }
    } else if (mode == 1) {
      if ((uintptr_t)x & 15u) return (int)cudaErrorInvalidValue;
      const int64_t threads = (int64_t)n_out * (c / 8);
      const int blocks = (int)((threads + THREADS - 1) / THREADS);
      if (unroll)
        static_sum_kernel<27><<<blocks, THREADS, 0, st>>>(xp, (float*)out, n_out, k, c);
      else
        static_sum_kernel<0><<<blocks, THREADS, 0, st>>>(xp, (float*)out, n_out, k, c);
      err = cudaSuccess;
    } else {
      const int lpr = p2_lanes_per_row(c / 8);
      const int block_rows = max(P2_ROWS, (THREADS / 32) * (32 / lpr));
      const size_t smem = (size_t)block_rows * (k + 1) * sizeof(int32_t);
      if (smem > SMEM_LIMIT || ((uintptr_t)x & 15u)) return (int)cudaErrorInvalidValue;
      const int blocks = (n_out + block_rows - 1) / block_rows;
      err = (unroll ? p2_launch<27> : p2_launch<0>)(blocks, smem, st, xp, np, (float*)out, n_out,
                                                     k, c, lpr, block_rows);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// bf16 values of the scratch `wimg` that gcd_tile_gemm needs, or -1 when the
// window of 256 + K - 1 rows of Ci channels and three stages do not fit into a
// block's shared memory
extern "C" int gcd_tile_gemm_scratch(int k, int ci, int co) {
  int stages;
  if (k < 1 || ci < 8 || ci % 8 || co < 1 || !p3_smem_bytes(k, ci, co, &stages)) return -1;
  const int tn = p3_tile_n(co);
  const int64_t elems = (int64_t)((co + tn - 1) / tn) * p3_chunks(ci) * k * tn * P3_STAGE_K;
  return elems > INT_MAX ? -1 : (int)elems;
}

// x and wimg 16-byte aligned, Ci % 8 == 0; wimg: gcd_tile_gemm_scratch values
extern "C" int gcd_tile_gemm(const void* x, const void* w, void* wimg, void* out, int n, int k,
                             int ci, int co, void* stream) {
  const int64_t elems = gcd_tile_gemm_scratch(k, ci, co);
  if (elems < 0 || ((uintptr_t)x & 15u) || ((uintptr_t)wimg & 15u)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int tn = p3_tile_n(co);
    const int steps = p3_steps(ci);
    int stages;
    const int smem = p3_smem_bytes(k, ci, co, &stages);
    pack_w_kernel<<<(unsigned)((elems + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        (const bf16*)w, (bf16*)wimg, k, ci, co, tn, p3_chunks(ci), 16 * steps, elems);
    dim3 grid((n + P3_ROWS - 1) / P3_ROWS, (co + tn - 1) / tn);
    cudaError_t err =
        tn == 96 ? p3_launch<96>(steps, grid, smem, st, (const bf16*)x, (const bf16*)wimg,
                                 (float*)out, n, k, ci, co, stages)
                 : p3_launch<128>(steps, grid, smem, st, (const bf16*)x, (const bf16*)wimg,
                                  (float*)out, n, k, ci, co, stages);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// bf16 values of the scratch `wimg` that gcd_onehot_conv needs, or -1 for a
// (K, Ci, Co) it does not serve: K 1 .. 64, Ci a multiple of 8
extern "C" int gcd_onehot_conv_scratch(int k, int ci, int co) {
  if (k < 1 || k > P4_MAX_K || ci < 8 || ci % 8 || co < 1) return -1;
  const int bn = 16 * p4_pairs(co);
  const int64_t elems = (int64_t)((co + bn - 1) / bn) * k * p4_chunks(ci) * P4_CHUNK * bn;
  return elems > INT_MAX ? -1 : (int)elems;
}

// x and wimg 16-byte aligned; wimg: gcd_onehot_conv_scratch values; far: an
// int32 the kernel adds the count of entries outside their window to
extern "C" int gcd_onehot_conv(const void* x, const void* nbr, const void* w, void* wimg, void* out,
                               void* far, int n_in, int n_out, int k, int ci, int co,
                               void* stream) {
  const int64_t elems = gcd_onehot_conv_scratch(k, ci, co);
  if (elems < 0 || ((uintptr_t)x & 15u) || ((uintptr_t)wimg & 15u)) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    // x as a 2-D tensor [N_in rows][Ci channels] of bf16, read in boxes of
    // 128 rows x 64 channels (128-byte rows) under the 128-byte swizzle;
    // what lies outside x arrives as zeros
    CUtensorMap xmap;
    const cuuint64_t dims[2] = {(cuuint64_t)ci, (cuuint64_t)(n_in > 0 ? n_in : 1)};
    const cuuint64_t strides[1] = {(cuuint64_t)ci * sizeof(bf16)};
    const cuuint32_t box[2] = {P4_CHUNK, P4_SUB};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
               unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int np = p4_pairs(co);
    pack_onehot_w_kernel<<<(unsigned)((elems + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        (const bf16*)w, (bf16*)wimg, k, ci, co, np, p4_chunks(ci), elems);
    const dim3 grid((n_out + P4_ROWS - 1) / P4_ROWS, (co + 16 * np - 1) / (16 * np));
    const int smem = p4_smem_bytes(k, co);
    const bf16* xp = (const bf16*)x;
    const int32_t* nb = (const int32_t*)nbr;
    const bf16* wi = (const bf16*)wimg;
    float* op = (float*)out;
    int32_t* fp = (int32_t*)far;
    const cudaError_t err =
        np == 2   ? p4_launch<2>(grid, smem, st, xmap, xp, nb, wi, op, fp, n_out, k, ci, co)
        : np == 4 ? p4_launch<4>(grid, smem, st, xmap, xp, nb, wi, op, fp, n_out, k, ci, co)
        : np == 6 ? p4_launch<6>(grid, smem, st, xmap, xp, nb, wi, op, fp, n_out, k, ci, co)
                  : p4_launch<8>(grid, smem, st, xmap, xp, nb, wi, op, fp, n_out, k, ci, co);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
