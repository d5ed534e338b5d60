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
//                   The product without the gather: the 64x64x32 f32-FMA
//                   tiling of gather_gemm_kernel with its A tile read by
//                   contiguous 16-byte loads at fixed shifts, so that P3
//                   against K1 isolates the indirection and the 2-byte loads.
//                   Bound by operations (f32 FMA, no tensor cores).
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

// ------------------------------------------------------------------ P3, P4

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

__global__ void __launch_bounds__(THREADS)
tile_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 float* __restrict__ out, int n, int k, int ci, int co) {
  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int red = k * ci;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // A tile: thread -> (row m, run of 8 channels g); ci % 8 == 0, so a run
  // never crosses from one offset to the next
  const int m = tid / (TK / 8);
  const int g = tid % (TK / 8);
  const int u = m0 + m;
  for (int r0 = 0; r0 < red; r0 += TK) {
    const int r = r0 + g * 8;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.f;
    if (u < n && r < red) {
      const int kq = r / ci;
      const int cc = r - kq * ci;
      const int src = min(max(u + kq - k / 2, 0), n - 1);
      unpack8(ld16(x + (int64_t)src * ci + cc), f);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) As[g * 8 + e][m] = f[e];
    load_b_tile(Bs, w, r0, min(TK, red - r0), n0, co, tid);
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  store_tile(out, acc, m0, n0, n, co, tx, ty);
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

extern "C" int gcd_tile_gemm(const void* x, const void* w, void* out, int n, int k, int ci,
                             int co, void* stream) {
  if (n > 0 && co > 0) {
    dim3 grid((n + TM - 1) / TM, (co + TN - 1) / TN);
    tile_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)w, (float*)out, n, k, ci, co);
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
