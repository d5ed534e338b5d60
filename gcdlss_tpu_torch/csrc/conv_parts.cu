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
//                   Staging without arithmetic: the window goes through
//                   shared memory in chunks of 32 rows with 16-byte cp.async
//                   copies, one or two chunks in flight, from x held as
//                   [N, C] (rows), [C, N] (cols) or [N/128, C, 128] (tiles).
//                   The sum is the cheapest consumer that keeps every load
//                   alive. Bound by bytes: NB * W * C * 2 of them are staged.
//   P2 gather_sum   out[u, c] = sum_k [nbr[u, k] >= 0] x[nbr[u, k], c]
//                   The gather without the product: one thread per (row,
//                   8 channels), 16-byte loads; the row index read from the
//                   book (dynamic), or the row itself (static: the loads
//                   without the indirection); the loop over the offsets
//                   rolled or unrolled. index_only reads the book alone.
//                   Bound by bytes (scattered 16-byte to 512-byte pieces).
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
//                   The conv with the gather as a product: per (block of 64
//                   rows, k) a sub-window of 128 source rows from the block's
//                   smallest present entry is staged, G = onehot(rel) @ sub,
//                   then G @ W[k]. An entry outside the sub-window is read
//                   directly from x inside the kernel: nothing is capped,
//                   poisoned or dropped, and `far` counts those entries.
//                   Bound by operations: the one-hot product alone is twice
//                   the conv's arithmetic on the FMA units.
//
// Every C entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0. Nothing here allocates.

#include <cuda_bf16.h>
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

constexpr int CH = 32;               // rows staged per chunk
constexpr int RED_FLOATS = 2048;     // reduction scratch: lanes * C <= 256 * 8
enum { ROWS = 0, COLS = 1, TILES = 2 };

// element (row r, channel ch) of x in the column layouts
template <int LAYOUT>
__device__ __forceinline__ int64_t col_offset(int n, int c, int r, int ch) {
  return LAYOUT == COLS ? (int64_t)ch * n + r
                        : ((int64_t)(r >> 7) * c + ch) * 128 + (r & 127);
}

// Rows [row0, row0 + CH) of x into `buf`: [CH][c] for ROWS, [c][CH] for COLS
// and TILES. 16-byte cp.async wherever source and run of 8 are aligned, else
// element by element (a window start that is not a multiple of 8).
template <int LAYOUT>
__device__ __forceinline__ void stage_chunk(bf16* buf, const bf16* __restrict__ x, int n, int c,
                                            int row0, int tid) {
  const int groups = CH * c / 8;
  if (LAYOUT == ROWS) {
    const bf16* src = x + (int64_t)row0 * c;
    for (int q = tid; q < groups; q += THREADS) cp_async16(buf + q * 8, src + q * 8);
  } else {
    for (int q = tid; q < groups; q += THREADS) {
      const int ch = q / (CH / 8);
      const int r = row0 + (q % (CH / 8)) * 8;
      bf16* dst = buf + q * 8;
      const int64_t off = col_offset<LAYOUT>(n, c, r, ch);
      if ((r & 7) == 0 && (off & 7) == 0) {
        cp_async16(dst, x + off);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = x[col_offset<LAYOUT>(n, c, r + e, ch)];
      }
    }
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
window_sum_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ ws,
                  float* __restrict__ out, int n, int c, int window, int buffers) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);
  const int chunk = CH * c;  // elements
  float* red = reinterpret_cast<float*>(smem_raw + (size_t)buffers * chunk * sizeof(bf16));
  const int tid = threadIdx.x;
  const int w0 = ws[blockIdx.x];
  const int nchunks = window / CH;

  // ROWS: thread (ty, tx) sums rows ty, ty + lanes, ... of its 8 channels.
  // COLS/TILES: thread sums up to 4 fixed runs of 8 rows of one channel.
  const int c8 = c / 8;
  const int lanes = THREADS / c8;
  const int tx = tid % c8;
  const int ty = tid / c8;
  const int items = c * (CH / 8);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  auto consume = [&](const bf16* buf) {
    float f[8];
    if (LAYOUT == ROWS) {
      if (ty < lanes) {
        for (int r = ty; r < CH; r += lanes) {
          unpack8(*reinterpret_cast<const uint4*>(buf + r * c + tx * 8), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += f[e];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tid + j * THREADS;
        if (q < items) {
          unpack8(*reinterpret_cast<const uint4*>(buf + q * 8), f);
          acc[j] += ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
        }
      }
    }
  };

  if (buffers == 2) {
    stage_chunk<LAYOUT>(bufs, x, n, c, w0, tid);
    cp_async_commit();
    for (int j = 0; j < nchunks; ++j) {
      if (j + 1 < nchunks)
        stage_chunk<LAYOUT>(bufs + ((j + 1) & 1) * chunk, x, n, c, w0 + (j + 1) * CH, tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      consume(bufs + (j & 1) * chunk);
      __syncthreads();
    }
  } else {
    for (int j = 0; j < nchunks; ++j) {
      stage_chunk<LAYOUT>(bufs, x, n, c, w0 + j * CH, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      consume(bufs);
      __syncthreads();
    }
  }

  // partial sums are added in a fixed order: the same result on every run
  if (LAYOUT == ROWS) {
    if (ty < lanes) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[ty * c + tx * 8 + e] = acc[e];
    }
    __syncthreads();
    for (int ch = tid; ch < c; ch += THREADS) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * c + ch];
      out[(int64_t)blockIdx.x * c + ch] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tid + j * THREADS;
      if (q < items) red[q] = acc[j];
    }
    __syncthreads();
    for (int ch = tid; ch < c; ch += THREADS) {
      const float* p = red + ch * (CH / 8);
      out[(int64_t)blockIdx.x * c + ch] = (p[0] + p[1]) + (p[2] + p[3]);
    }
  }
}

// ------------------------------------------------------------------ P2

// KT = 27: the loop over the offsets fully unrolled; KT = 0: rolled, k at run time.
template <int KT, bool STATIC>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                  float* __restrict__ out, int n_out, int k, int c) {
  const int c8 = c / 8;
  const int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  const int64_t u = t / c8;
  const int cg = (int)(t % c8);
  if (u >= n_out) return;
  const int32_t* row = nbr + u * k;
  float acc[8], f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  auto body = [&](int kq) {
    const int32_t j = STATIC ? (int32_t)u : row[kq];
    if (j >= 0) {
      unpack8(ld16(x + (int64_t)j * c + cg * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
  };
  if (KT > 0) {
#pragma unroll
    for (int kq = 0; kq < KT; ++kq) body(kq);
  } else {
#pragma unroll 1
    for (int kq = 0; kq < k; ++kq) body(kq);
  }
  float4* o = reinterpret_cast<float4*>(out + u * c + cg * 8);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
index_sum_kernel(const int32_t* __restrict__ nbr, int32_t* __restrict__ out, int n_out, int k) {
  const int64_t u = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (u >= n_out) return;
  const int32_t* row = nbr + u * k;
  int32_t s = 0;
  if (KT > 0) {
#pragma unroll
    for (int kq = 0; kq < KT; ++kq) s += row[kq];
  } else {
#pragma unroll 1
    for (int kq = 0; kq < k; ++kq) s += row[kq];
  }
  out[u] = s;
}

// ------------------------------------------------------------------ P4's tile helpers, P3, P4

constexpr int TM = 64;  // output rows per block
constexpr int TN = 64;  // output columns per block
constexpr int TK = 32;  // reduction depth per step

// Bs[kk][n] = w[rbase + kk, n0 + n] for kk < rows, zero beyond
__device__ __forceinline__ void load_b_tile(float (*Bs)[TN], const bf16* __restrict__ w,
                                            int64_t rbase, int rows, int n0, int co, int tid) {
#pragma unroll
  for (int i = 0; i < (TK * TN) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int nn = idx % TN;
    const int kk = idx / TN;
    const int o = n0 + nn;
    Bs[kk][nn] = (kk < rows && o < co) ? __bfloat162float(w[(rbase + kk) * co + o]) : 0.f;
  }
}

// acc += As^T @ Bs, 4x4 outputs per thread (gather_gemm_kernel's inner loop)
__device__ __forceinline__ void fma_tile(float (*As)[TM + 1], float (*Bs)[TN],
                                         float (*acc)[4], int tx, int ty) {
#pragma unroll 8
  for (int kk = 0; kk < TK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ out, float (*acc)[4],
                                           int m0, int n0, int n_out, int co, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = m0 + ty + 16 * i;
    if (u >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx + 16 * j;
      if (o < co) out[(int64_t)u * co + o] = acc[i][j];
    }
  }
}

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

constexpr int SUB = 128;  // source rows staged per (block, k)
constexpr int ONEHOT_SMEM_FLOATS = TK * (TM + 1) + TK * TN + SUB * TK + SUB * TM + TM + 4;

__global__ void __launch_bounds__(THREADS)
onehot_conv_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                   const bf16* __restrict__ w, float* __restrict__ out,
                   int32_t* __restrict__ far, int n_in, int n_out, int k, int ci, int co) {
  extern __shared__ __align__(16) float sm[];
  float (*As)[TM + 1] = reinterpret_cast<float (*)[TM + 1]>(sm);
  float (*Bs)[TN] = reinterpret_cast<float (*)[TN]>(sm + TK * (TM + 1));
  float (*Sub)[TK] = reinterpret_cast<float (*)[TK]>(sm + TK * (TM + 1) + TK * TN);
  float (*OHt)[TM] = reinterpret_cast<float (*)[TM]>(sm + TK * (TM + 1) + TK * TN + SUB * TK);
  int* jrow = reinterpret_cast<int*>(sm + TK * (TM + 1) + TK * TN + SUB * TK + SUB * TM);
  int* s_start = jrow + TM;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int q = tid; q < SUB * TM; q += THREADS) (&OHt[0][0])[q] = 0.f;
  int far_local = 0;

  for (int kq = 0; kq < k; ++kq) {
    if (tid == 0) *s_start = INT_MAX;
    __syncthreads();
    int myj = -1;
    if (tid < TM) {
      const int u = m0 + tid;
      if (u < n_out) myj = nbr[(int64_t)u * k + kq];
      jrow[tid] = myj;
      if (myj >= 0) atomicMin(s_start, myj);
    }
    __syncthreads();
    const int start = *s_start;
    __syncthreads();  // every thread has read it before thread 0 resets it
    if (start == INT_MAX) continue;  // no entry at this offset in this block
    const bool inside = myj >= 0 && myj - start < SUB;
    if (inside) OHt[myj - start][tid] = 1.f;
    if (myj >= 0 && !inside) ++far_local;

    for (int c0 = 0; c0 < ci; c0 += TK) {
      // the sub-window's rows [start, start + SUB), channels [c0, c0 + TK)
      for (int q = tid; q < SUB * (TK / 8); q += THREADS) {
        const int s = q / (TK / 8);
        const int g = q % (TK / 8);
        const int src = start + s;
        const int cc = c0 + g * 8;
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
        if (src < n_in && cc < ci) unpack8(ld16(x + (int64_t)src * ci + cc), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) Sub[s][g * 8 + e] = f[e];
      }
      load_b_tile(Bs, w, (int64_t)kq * ci + c0, min(TK, ci - c0), n0, co, tid);
      __syncthreads();

      // G = onehot(rel) @ sub: thread -> rows ty + 16 i, channels tx + 16 j
      float gsum[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) gsum[i][0] = gsum[i][1] = 0.f;
#pragma unroll 8
      for (int s = 0; s < SUB; ++s) {
        const float b0 = Sub[s][tx], b1 = Sub[s][tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = OHt[s][ty + 16 * i];
          gsum[i][0] = fmaf(a, b0, gsum[i][0]);
          gsum[i][1] = fmaf(a, b1, gsum[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty + 16 * i;
        const int j = jrow[m];
        const bool is_far = j >= 0 && j - start >= SUB;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int kk = tx + 16 * jj;
          float v = gsum[i][jj];
          if (is_far) v = (c0 + kk < ci) ? __bfloat162float(x[(int64_t)j * ci + c0 + kk]) : 0.f;
          As[kk][m] = v;
        }
      }
      __syncthreads();
      fma_tile(As, Bs, acc, tx, ty);
      __syncthreads();
    }
    if (inside) OHt[myj - start][tid] = 0.f;
  }
  store_tile(out, acc, m0, n0, n_out, co, tx, ty);
  if (blockIdx.y == 0 && far_local) atomicAdd(far, far_local);
}

}  // namespace

extern "C" int gcd_window_sum(const void* x, const void* ws, void* out, int n, int c, int nb,
                              int window, int layout, int buffers, void* stream) {
  if (nb > 0) {
    const size_t smem = (size_t)buffers * CH * c * sizeof(bf16) + RED_FLOATS * sizeof(float);
    const bf16* xp = (const bf16*)x;
    const int32_t* wp = (const int32_t*)ws;
    cudaStream_t st = (cudaStream_t)stream;
    if (layout == ROWS)
      window_sum_kernel<ROWS><<<nb, THREADS, smem, st>>>(xp, wp, (float*)out, n, c, window, buffers);
    else if (layout == COLS)
      window_sum_kernel<COLS><<<nb, THREADS, smem, st>>>(xp, wp, (float*)out, n, c, window, buffers);
    else
      window_sum_kernel<TILES><<<nb, THREADS, smem, st>>>(xp, wp, (float*)out, n, c, window, buffers);
  }
  return (int)cudaGetLastError();
}

// mode 0: dynamic, 1: static, 2: index_only (out is int32 [n_out])
extern "C" int gcd_gather_sum(const void* x, const void* nbr, void* out, int n_out, int k, int c,
                              int mode, int unroll, void* stream) {
  if (n_out > 0) {
    const bf16* xp = (const bf16*)x;
    const int32_t* np = (const int32_t*)nbr;
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 2) {
      const int blocks = (n_out + THREADS - 1) / THREADS;
      if (unroll)
        index_sum_kernel<27><<<blocks, THREADS, 0, st>>>(np, (int32_t*)out, n_out, k);
      else
        index_sum_kernel<0><<<blocks, THREADS, 0, st>>>(np, (int32_t*)out, n_out, k);
    } else {
      const int64_t threads = (int64_t)n_out * (c / 8);
      const int blocks = (int)((threads + THREADS - 1) / THREADS);
      float* op = (float*)out;
      if (mode == 0 && unroll)
        gather_sum_kernel<27, false><<<blocks, THREADS, 0, st>>>(xp, np, op, n_out, k, c);
      else if (mode == 0)
        gather_sum_kernel<0, false><<<blocks, THREADS, 0, st>>>(xp, np, op, n_out, k, c);
      else if (unroll)
        gather_sum_kernel<27, true><<<blocks, THREADS, 0, st>>>(xp, np, op, n_out, k, c);
      else
        gather_sum_kernel<0, true><<<blocks, THREADS, 0, st>>>(xp, np, op, n_out, k, c);
    }
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

extern "C" int gcd_onehot_conv(const void* x, const void* nbr, const void* w, void* out,
                               void* far, int n_in, int n_out, int k, int ci, int co,
                               void* stream) {
  if (n_out > 0 && co > 0) {
    const size_t smem = ONEHOT_SMEM_FLOATS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(onehot_conv_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n_out + TM - 1) / TM, (co + TN - 1) / TN);
    onehot_conv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (const int32_t*)nbr, (const bf16*)w, (float*)out, (int32_t*)far, n_in,
        n_out, k, ci, co);
  }
  return (int)cudaGetLastError();
}
