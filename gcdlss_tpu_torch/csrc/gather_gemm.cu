// Gather-GEMM sparse convolution kernels for Hopper (sm_90a): forward, dX and dW.
//
// Replaces the TPU kernels `_fwd_kernel` (K1) and `_bwd_kernel` (K2) of
// gcdlss_tpu/ops/fused_conv.py.
//
// Forward (K1) and dX (the first half of K2):
//     out[u, :] = sum_k x[nbr[u, k], :] @ W[k]          (nbr < 0 contributes 0)
// read as ONE GEMM  out = A @ B  with a reduction dimension of K*Ci, where
//     A[u, r] = x[nbr[u, r / Ci], r % Ci]   (gathered on the fly, never stored)
//     B       = W viewed as [K*Ci, Co]      (W is [K, Ci, Co], row-major)
// The same kernel serves the k=5 stem (Ci = 1: a reduction tile spans 32
// offsets, so no lane idles on a one-channel input), the k=3 submanifold
// books and the k=2 pool books, at any Ci and Co: every load is bounds
// checked, nothing assumes padding to 32 or 128. dX runs it on the adjoint
// book with W transposed to [K, Co, Ci].
//
// dW (the second half of K2):
//     dW[k, c, o] = sum_v x[v, c] * g[adj[v, k], o]
// is a reduction over all N input rows. Each block sums one (k, Ci tile,
// Co tile) over one slice of the rows into a partial buffer; a second pass
// adds the slices in a fixed order. No float atomics: the result is the same
// on every run.
//
// What bounds it on the card: the gathered rows. Each output tile reads K
// scattered input rows per output row (the TPU kernel staged sliding windows
// in VMEM for the same reason). Rows of x are read 32 bf16 channels at a time
// by 32 neighbouring threads, so each gathered row segment is one 64-byte
// transaction, and a gathered A tile is reused by all 64 output columns of
// the block from shared memory. Arithmetic is f32 FMA on bf16 inputs (exact
// products, f32 sums), 4x4 outputs per thread. It does not use the tensor
// cores yet (wgmma / mma.sync), and it does not skip absent (-1) entries:
// both are work for a later change. There is no window, so no entry of any
// book can fall outside it: nothing like the TPU's "far" COO finish exists.
//
// Every C entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not 0. Nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;  // rows of the output tile (output rows; dW: Ci)
constexpr int TN = 64;  // columns of the output tile (Co)
constexpr int TK = 32;  // reduction depth staged per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                   const int32_t* __restrict__ nbr,
                   const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ out, int n_out, int k, int ci, int co) {
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

  for (int r0 = 0; r0 < red; r0 += TK) {
#pragma unroll
    for (int i = 0; i < (TM * TK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx % TK;
      const int m = idx / TK;
      const int u = m0 + m;
      const int r = r0 + kk;
      float v = 0.f;
      if (u < n_out && r < red) {
        const int kq = r / ci;
        const int c = r - kq * ci;
        const int32_t j = nbr[(int64_t)u * k + kq];
        if (j >= 0) v = __bfloat162float(x[(int64_t)j * ci + c]);
      }
      As[kk][m] = v;
    }
#pragma unroll
    for (int i = 0; i < (TK * TN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int n = idx % TN;
      const int kk = idx / TN;
      const int r = r0 + kk;
      const int o = n0 + n;
      Bs[kk][n] = (r < red && o < co) ? __bfloat162float(w[(int64_t)r * co + o]) : 0.f;
    }
    __syncthreads();
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
    __syncthreads();
  }
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

// partial[s, kq, c, o] = sum over rows v of slice s of x[v, c] * g[adj[v, kq], o]
__global__ void __launch_bounds__(THREADS)
gather_dw_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ g,
                 const int32_t* __restrict__ adj, float* __restrict__ partial,
                 int n_in, int k, int ci, int co, int nslices) {
  __shared__ float Xs[TK][TM + 1];
  __shared__ float Gs[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int kq = blockIdx.z % k;
  const int s = blockIdx.z / k;
  const int rows = (n_in + nslices - 1) / nslices;
  const int vbeg = s * rows;
  const int vend = min(n_in, vbeg + rows);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int v0 = vbeg; v0 < vend; v0 += TK) {
#pragma unroll
    for (int i = 0; i < (TK * TM) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int m = idx % TM;
      const int kk = idx / TM;
      const int v = v0 + kk;
      const int c = c0 + m;
      Xs[kk][m] = (v < vend && c < ci) ? __bfloat162float(x[(int64_t)v * ci + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (TK * TN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int n = idx % TN;
      const int kk = idx / TN;
      const int v = v0 + kk;
      const int o = n0 + n;
      float val = 0.f;
      if (v < vend && o < co) {
        const int32_t j = adj[(int64_t)v * k + kq];
        if (j >= 0) val = __bfloat162float(g[(int64_t)j * co + o]);
      }
      Gs[kk][n] = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Gs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = partial + ((int64_t)s * k + kq) * ci * co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= ci) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx + 16 * j;
      if (o < co) dst[(int64_t)c * co + o] = acc[i][j];
    }
  }
}

// dw[i] = sum_s partial[s, i], slices added in order 0, 1, ...
__global__ void sum_slices_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dw, int64_t n, int nslices) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nslices; ++s) acc += partial[(int64_t)s * n + i];
    dw[i] = acc;
  }
}

}  // namespace

extern "C" int gcd_gather_gemm(const void* x, const void* nbr, const void* w,
                               void* out, int n_out, int k, int ci, int co,
                               void* stream) {
  if (n_out > 0 && co > 0) {
    dim3 grid((n_out + TM - 1) / TM, (co + TN - 1) / TN);
    gather_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const int32_t*)nbr, (const __nv_bfloat16*)w,
        (float*)out, n_out, k, ci, co);
  }
  return (int)cudaGetLastError();
}

extern "C" int gcd_gather_dw(const void* x, const void* g, const void* adj,
                             void* partial, void* dw, int n_in, int k, int ci,
                             int co, int nslices, void* stream) {
  if (ci > 0 && co > 0) {
    dim3 grid((ci + TM - 1) / TM, (co + TN - 1) / TN, k * nslices);
    gather_dw_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const int32_t*)adj,
        (float*)partial, n_in, k, ci, co, nslices);
    const int64_t n = (int64_t)k * ci * co;
    const int blocks = (int)((n + THREADS - 1) / THREADS < 4096 ? (n + THREADS - 1) / THREADS : 4096);
    sum_slices_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)partial, (float*)dw, n, nslices);
  }
  return (int)cudaGetLastError();
}
