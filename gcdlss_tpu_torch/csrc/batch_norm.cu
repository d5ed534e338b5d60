// Fused sparse batch norm for Hopper (sm_90a): masked statistics, the affine
// map, an optional residual add, an optional ReLU and the row mask, forward
// and backward, over [N, C] rows in bf16 or f32.
//
// Replaces no TPU kernel: the JAX package leaves the norm to XLA, which fuses
// it with its neighbours on the TPU. In eager PyTorch the same arithmetic is
// ~30 launches a call over the whole [N, C] tensor, in f32, and autograd
// keeps two f32 copies of (x - mean). These kernels are the norm of
// `ops/fused_norm.py` (`SparseBatchNorm` on the card).
//
// Forward, training (`bn_stats_kernel` twice, then `bn_apply_kernel`):
//     mean = sum_valid x / cnt, var = sum_valid (x - mean)^2 / cnt  (biased)
//     z = mask(act(round(round((x - mean) * rstd * w + b) + residual)))
// `round` is the activations' dtype; the residual and the act are optional.
// Eval applies the running statistics in one launch of `bn_apply_kernel`.
//
// Backward (`bn_grad_sums_kernel`, then `bn_grad_x_kernel`), with
// gy = gz where the output was kept (valid, and z > 0 under ReLU), else 0:
//     sums: S1 = sum gy, S2 = sum gy * (x - mean); dbias = S1, dweight = S2 * rstd
//     dx = w * rstd * (gy - valid * (S1 / cnt + (x - mean) * rstd^2 * S2 / cnt))
// and d_residual = gy, written in the same pass as the sums.
//
// What bounds them on the card: bytes. A norm reads its input twice for the
// statistics and once to apply them and writes one output, ~8 B an element in
// bf16, where the eager chain moves ~80. What the design does:
//
//  * 16-byte vectors. Where C times the element size is a multiple of 16 and
//    every pointer is 16-byte aligned, a thread owns 8 (bf16) or 4 (f32)
//    neighbouring channels and moves them in one request; a block covers
//    256 / (C / 8) rows a step, neighbouring threads on neighbouring bytes.
//    Ragged widths (the VFE's 9 channels) take the same layout one channel a
//    thread. Widths above 256 vectors take a second grid dimension.
//  * No float atomics. Each block sums its rows in a fixed order, writes one
//    partial per channel, and the last block to finish (an integer counter,
//    reset by that block) adds the partials in a fixed order. Every result
//    repeats bit for bit.
//  * The sums are raw (not divided) until the next launch reads them, so a
//    process group can all-reduce them in between (`parallel.mesh`).
//  * f32 throughout the arithmetic, with the eager chain's roundings: the
//    affine map's sub, mul and add are not fused into an FMA.
//
// Every C entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not 0. Nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows a thread loads before it adds them

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_float(p[0]);
  } else {
    static_assert(sizeof(T) * V == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_float<T>(f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// A thread's place: column group g (channels g*V .. g*V+V-1) of rows
// lane_r, lane_r + rp, ...; gw groups a block row, rp rows a block step.
struct Place {
  int gw, rp, lane_g, lane_r, g;
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(int c) {
  Place p;
  const int groups = c / V;
  p.gw = min(groups, kThreads);
  p.rp = kThreads / p.gw;
  p.lane_g = threadIdx.x % p.gw;
  p.lane_r = threadIdx.x / p.gw;
  p.g = blockIdx.y * p.gw + p.lane_g;
  p.active = p.lane_r < p.rp && p.g < groups;
  return p;
}

// Per-channel statistics of the normalisation: mean and rstd from the raw
// sums (train: [sum x (C), cnt, sum (x - mean)^2 (C)]) or the running buffers.
template <int V>
__device__ __forceinline__ void channel_stats(const float* stats, const float* rmean,
                                              const float* rvar, int c, int e0, int train,
                                              float eps, float (&mean)[V], float (&var)[V],
                                              float (&rstd)[V], float& cnt) {
  cnt = train ? fmaxf(stats[c], 1.f) : 1.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = train ? stats[e0 + i] / cnt : rmean[e0 + i];
    var[i] = train ? stats[c + 1 + e0 + i] / cnt : rvar[e0 + i];
    rstd[i] = 1.f / sqrtf(__fadd_rn(var[i], eps));
  }
}

// Sum, over the block's rows, of NS accumulators per channel (red: the
// block's [kThreads][NS * V] values), written to partial[s * c + e][blockIdx.x].
template <int V, int NS>
__device__ __forceinline__ void block_partials(float* red, const Place& p, int c,
                                               float* partial) {
  __syncthreads();
  const int e_base = blockIdx.y * p.gw * V;
  const int width = min(c - e_base, p.gw * V);
  for (int t = threadIdx.x; t < NS * width; t += kThreads) {
    const int s = t / width, e = t % width;
    float sum = 0.f;
    for (int r = 0; r < p.rp; ++r) sum += red[(r * p.gw * V + e) * NS + s];
    partial[((size_t)s * c + e_base + e) * gridDim.x + blockIdx.x] = sum;
  }
}

// True in the last block of the grid to finish; that block resets the counter.
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned done = atomicAdd(counter, 1u);
    last = done == gridDim.x * gridDim.y - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// out[j] = sum over blocks b of partial[j][b], j < rows: a warp a row, lanes
// over the blocks, added in a fixed order.
__device__ __forceinline__ float sum_row(const float* partial, int j, int nb, int lane) {
  float s = 0.f;
  for (int b = lane; b < nb; b += 32) s += __ldcg(partial + (size_t)j * nb + b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// PASS 0: stats[0:C] = sum of x over valid rows, stats[C] = their count.
// PASS 1: stats[C+1:2C+1] = sum of (x - stats[0:C] / count)^2 over them.
template <typename T, int V, int PASS>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid, int n, int c,
                    float* __restrict__ stats, float* __restrict__ partial,
                    int* __restrict__ counts, unsigned* __restrict__ counter) {
  __shared__ float red[kThreads * V];
  __shared__ int cred[kThreads];
  const Place p = place<V>(c);
  float acc[V], mean[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (PASS == 1 && p.active) {
    const float cnt = fmaxf(stats[c], 1.f);
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = stats[p.g * V + i] / cnt;
  }
  int cnt = 0;
  if (p.active) {
    const int64_t step = (int64_t)gridDim.x * p.rp;
    for (int64_t r0 = (int64_t)blockIdx.x * p.rp + p.lane_r; r0 < n; r0 += step * kUnroll) {
      float v[kUnroll][V];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * step;
        ok[u] = r < n;
        if (ok[u]) {
          ok[u] = valid[r] != 0;
          load_vec<T, V>(x + r * c + p.g * V, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        ++cnt;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (PASS == 0) {
            acc[i] += v[u][i];
          } else {
            const float d = __fsub_rn(v[u][i], mean[i]);
            acc[i] = __fadd_rn(acc[i], __fmul_rn(d, d));
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) red[threadIdx.x * V + i] = p.active ? acc[i] : 0.f;
  cred[threadIdx.x] = p.active && p.lane_g == 0 ? cnt : 0;
  block_partials<V, 1>(red, p, c, partial);
  if (PASS == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    int s = 0;
    for (int r = 0; r < p.rp; ++r) s += cred[r * p.gw];
    counts[blockIdx.x] = s;
  }
  if (!last_block(counter)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nb = gridDim.x;
  float* out = stats + (PASS == 0 ? 0 : c + 1);
  for (int e = warp; e < c; e += kThreads / 32) {
    const float s = sum_row(partial, e, nb, lane);
    if (lane == 0) out[e] = s;
  }
  if (PASS == 0 && warp == 0) {
    int s = 0;
    for (int b = lane; b < nb; b += 32) s += __ldcg(counts + b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) stats[c] = (float)s;
  }
}

// out = mask(act(round(round((x - mean) * rstd * w + b) + res))); in training
// with `update`, the first block row also moves the running statistics.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                    const T* __restrict__ res, const float* __restrict__ stats,
                    const float* __restrict__ weight, const float* __restrict__ bias,
                    float* __restrict__ rmean, float* __restrict__ rvar, T* __restrict__ out,
                    int n, int c, int train, int update, int relu, float keep, float momentum,
                    float eps) {
  const Place p = place<V>(c);
  if (!p.active) return;
  const int e0 = p.g * V;
  float mean[V], var[V], rstd[V], scale[V], shift[V], cnt;
  channel_stats<V>(stats, rmean, rvar, c, e0, train, eps, mean, var, rstd, cnt);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = __fmul_rn(rstd[i], weight[e0 + i]);
    shift[i] = bias[e0 + i];
  }
  if (train && update && blockIdx.x == 0 && p.lane_r == 0) {
    const float denom = fmaxf(cnt - 1.f, 1.f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float unbiased = __fdiv_rn(__fmul_rn(var[i], cnt), denom);
      rmean[e0 + i] = __fadd_rn(__fmul_rn(rmean[e0 + i], keep), __fmul_rn(momentum, mean[i]));
      rvar[e0 + i] = __fadd_rn(__fmul_rn(rvar[e0 + i], keep), __fmul_rn(momentum, unbiased));
    }
  }
  const int64_t step = (int64_t)gridDim.x * p.rp;
  for (int64_t r0 = (int64_t)blockIdx.x * p.rp + p.lane_r; r0 < n; r0 += step * kUnroll) {
    float v[kUnroll][V], rv[kUnroll][V];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r < n) {
        ok[u] = valid[r] != 0;
        load_vec<T, V>(x + r * c + e0, v[u]);
        if (res) load_vec<T, V>(res + r * c + e0, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r >= n) break;
      float z[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float y = __fadd_rn(__fmul_rn(__fsub_rn(v[u][i], mean[i]), scale[i]), shift[i]);
        y = round_to<T>(y);
        if (res) y = round_to<T>(__fadd_rn(y, rv[u][i]));
        if (relu && y < 0.f) y = 0.f;
        z[i] = ok[u] ? y : 0.f;
      }
      store_vec<T, V>(out + r * c + e0, z);
    }
  }
}

// The cotangent the norm's affine output receives: gz where the output was
// kept (a valid row, and z > 0 under ReLU), else 0.
template <typename T, int V>
__device__ __forceinline__ void kept_grad(const T* gz, const T* z, bool row_valid, int relu,
                                          int64_t at, float (&gy)[V]) {
  float g[V];
  load_vec<T, V>(gz + at, g);
  if (relu) {
    float zv[V];
    load_vec<T, V>(z + at, zv);
#pragma unroll
    for (int i = 0; i < V; ++i) gy[i] = zv[i] > 0.f ? g[i] : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) gy[i] = row_valid ? g[i] : 0.f;
  }
}

// sums[0:C] = sum gy, sums[C:2C] = sum gy * (x - mean); dbias = the first,
// dweight = the second times rstd (this rank's rows); dres = gy when given.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                        const T* __restrict__ gz, const T* __restrict__ z,
                        const float* __restrict__ stats, const float* __restrict__ rmean,
                        const float* __restrict__ rvar, T* __restrict__ dres,
                        float* __restrict__ partial, unsigned* __restrict__ counter,
                        float* __restrict__ sums, float* __restrict__ dweight,
                        float* __restrict__ dbias, int n, int c, int train, int relu,
                        float eps) {
  __shared__ float red[kThreads * V * 2];
  const Place p = place<V>(c);
  float acc[V][2];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i][0] = acc[i][1] = 0.f;
  if (p.active) {
    const int e0 = p.g * V;
    float mean[V], var[V], rstd[V], cnt;
    channel_stats<V>(stats, rmean, rvar, c, e0, train, eps, mean, var, rstd, cnt);
    const int64_t step = (int64_t)gridDim.x * p.rp;
    for (int64_t r0 = (int64_t)blockIdx.x * p.rp + p.lane_r; r0 < n; r0 += step * kUnroll) {
      float v[kUnroll][V], gy[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * step;
        if (r < n) {
          load_vec<T, V>(x + r * c + e0, v[u]);
          kept_grad<T, V>(gz, z, valid[r] != 0, relu, r * c + e0, gy[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * step;
        if (r >= n) break;
        if (dres) store_vec<T, V>(dres + r * c + e0, gy[u]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[i][0] += gy[u][i];
          acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(gy[u][i], __fsub_rn(v[u][i], mean[i])));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[(threadIdx.x * V + i) * 2] = p.active ? acc[i][0] : 0.f;
    red[(threadIdx.x * V + i) * 2 + 1] = p.active ? acc[i][1] : 0.f;
  }
  block_partials<V, 2>(red, p, c, partial);
  if (!last_block(counter)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nb = gridDim.x;
  for (int j = warp; j < 2 * c; j += kThreads / 32) {
    const float s = sum_row(partial, j, nb, lane);
    if (lane == 0) {
      sums[j] = s;
      if (j < c) {
        dbias[j] = s;
      } else {
        const int e = j - c;
        const float cnt = train ? fmaxf(stats[c], 1.f) : 1.f;
        const float v = train ? stats[c + 1 + e] / cnt : rvar[e];
        dweight[e] = __fmul_rn(s, 1.f / sqrtf(__fadd_rn(v, eps)));
      }
    }
  }
}

// dx = w * rstd * (gy - valid * (S1 / cnt + (x - mean) * rstd^2 * S2 / cnt))
// in training (the sums over every rank's rows); w * rstd * gy in eval.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_x_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                     const T* __restrict__ gz, const T* __restrict__ z,
                     const float* __restrict__ stats, const float* __restrict__ rmean,
                     const float* __restrict__ rvar, const float* __restrict__ weight,
                     const float* __restrict__ sums, T* __restrict__ dx, int n, int c, int train,
                     int relu, float eps) {
  const Place p = place<V>(c);
  if (!p.active) return;
  const int e0 = p.g * V;
  float mean[V], var[V], rstd[V], scale[V], k1[V], k2[V], cnt;
  channel_stats<V>(stats, rmean, rvar, c, e0, train, eps, mean, var, rstd, cnt);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = __fmul_rn(rstd[i], weight[e0 + i]);
    k1[i] = train ? sums[e0 + i] / cnt : 0.f;
    k2[i] = train ? __fmul_rn(__fmul_rn(rstd[i], rstd[i]), sums[c + e0 + i]) / cnt : 0.f;
  }
  const int64_t step = (int64_t)gridDim.x * p.rp;
  for (int64_t r0 = (int64_t)blockIdx.x * p.rp + p.lane_r; r0 < n; r0 += step * kUnroll) {
    float v[kUnroll][V], gy[kUnroll][V];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r < n) {
        ok[u] = valid[r] != 0;
        load_vec<T, V>(x + r * c + e0, v[u]);
        kept_grad<T, V>(gz, z, ok[u], relu, r * c + e0, gy[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r >= n) break;
      float d[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float centre =
            ok[u] ? __fadd_rn(k1[i], __fmul_rn(__fsub_rn(v[u][i], mean[i]), k2[i])) : 0.f;
        d[i] = __fmul_rn(scale[i], __fsub_rn(gy[u][i], centre));
      }
      store_vec<T, V>(dx + r * c + e0, d);
    }
  }
}

inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// 16-byte vectors where the width and every given pointer allow them
inline bool vector_path(int c, int elem, std::initializer_list<const void*> ptrs) {
  if ((c * elem) % 16 != 0) return false;
  for (const void* q : ptrs)
    if (q && !aligned16(q)) return false;
  return true;
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// (rows a block step, column chunks) of a width on the vector or scalar path
inline void block_shape(int c, int elem, bool vec, int& rp, int& chunks) {
  const int v = vec ? 16 / elem : 1;
  const int groups = c / v;
  const int gw = groups < kThreads ? groups : kThreads;
  rp = kThreads / gw;
  chunks = (groups + kThreads - 1) / kThreads;
}

// blocks along the rows: ceil(n / rp), at most `per_sm` blocks a SM in all
inline int row_blocks(int n, int rp, int chunks, int per_sm) {
  const int64_t want = ((int64_t)n + rp - 1) / rp;
  int64_t cap = (int64_t)per_sm * sm_count() / chunks;
  if (cap < 1) cap = 1;
  const int64_t nb = want < cap ? want : cap;
  return nb < 1 ? 1 : (int)nb;
}

template <typename T, int V>
void launch_stats(const void* x, const void* valid, void* stats, void* partial, void* counts,
                  void* counter, int n, int c, int pass, int nb, int chunks, cudaStream_t st) {
  const dim3 grid(nb, chunks);
  auto kernel = pass == 0 ? bn_stats_kernel<T, V, 0> : bn_stats_kernel<T, V, 1>;
  kernel<<<grid, kThreads, 0, st>>>((const T*)x, (const uint8_t*)valid, n, c, (float*)stats,
                                    (float*)partial, (int*)counts, (unsigned*)counter);
}

}  // namespace

// Blocks along the rows of the reduction kernels (`gcd_bn_stats`,
// `gcd_bn_grad_sums`) for these shapes: the rows of their partial buffers.
// Two blocks a SM; every launch at the same shapes takes the same number.
extern "C" int gcd_bn_blocks(int n, int c, int elem) {
  if (c <= 0 || (elem != 2 && elem != 4)) return 1;
  int rp, chunks;
  block_shape(c, elem, (c * elem) % 16 == 0, rp, chunks);
  return row_blocks(n, rp, chunks, 2);
}

// One pass of the training statistics into stats [2C + 1] f32 (PASS 0: the
// sums and the count; PASS 1: the centred squares about stats' mean).
// partial: [C, nb] f32; counts: [nb] int32; counter: one uint32, zero.
extern "C" int gcd_bn_stats(const void* x, const void* valid, void* stats, void* partial,
                            void* counts, void* counter, int n, int c, int pass, int nb, int bf16,
                            void* stream) {
  if (c > 0) {
    const int elem = bf16 ? 2 : 4;
    const bool vec = vector_path(c, elem, {x});
    int rp, chunks;
    block_shape(c, elem, vec, rp, chunks);
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
      (vec ? launch_stats<__nv_bfloat16, 8> : launch_stats<__nv_bfloat16, 1>)(
          x, valid, stats, partial, counts, counter, n, c, pass, nb, chunks, st);
    } else {
      (vec ? launch_stats<float, 4> : launch_stats<float, 1>)(
          x, valid, stats, partial, counts, counter, n, c, pass, nb, chunks, st);
    }
  }
  return (int)cudaGetLastError();
}

// out [N, C] = the normalised rows (train: from stats; eval: from the
// running buffers), + res when not null, ReLU when relu, zero rows where
// not valid; in training with `update`, the running buffers move by
// `momentum` (keep = 1 - momentum) toward the batch's mean and unbiased var.
extern "C" int gcd_bn_apply(const void* x, const void* valid, const void* res, const void* stats,
                            const void* weight, const void* bias, void* rmean, void* rvar,
                            void* out, int n, int c, int train, int update, int relu, float keep,
                            float momentum, float eps, int bf16, void* stream) {
  if (c > 0) {
    const int elem = bf16 ? 2 : 4;
    const bool vec = vector_path(c, elem, {x, res, out});
    int rp, chunks;
    block_shape(c, elem, vec, rp, chunks);
    const dim3 grid(row_blocks(n, rp * kUnroll, chunks, 8), chunks);
    cudaStream_t st = (cudaStream_t)stream;
#define GCD_BN_APPLY(T, V)                                                                   \
  bn_apply_kernel<T, V><<<grid, kThreads, 0, st>>>(                                          \
      (const T*)x, (const uint8_t*)valid, (const T*)res, (const float*)stats,                \
      (const float*)weight, (const float*)bias, (float*)rmean, (float*)rvar, (T*)out, n, c,  \
      train, update, relu, keep, momentum, eps)
    if (bf16) {
      if (vec) GCD_BN_APPLY(__nv_bfloat16, 8); else GCD_BN_APPLY(__nv_bfloat16, 1);
    } else {
      if (vec) GCD_BN_APPLY(float, 4); else GCD_BN_APPLY(float, 1);
    }
#undef GCD_BN_APPLY
  }
  return (int)cudaGetLastError();
}

// The backward's sums [2C] f32 (sum gy, sum gy * (x - mean)), dweight and
// dbias [C] f32 of this rank's rows, and dres [N, C] = gy when not null.
// z: the forward's output, read only under ReLU. partial: [2C, nb] f32.
extern "C" int gcd_bn_grad_sums(const void* x, const void* valid, const void* gz, const void* z,
                                const void* stats, const void* rmean, const void* rvar,
                                void* dres, void* partial, void* counter, void* sums,
                                void* dweight, void* dbias, int n, int c, int train, int relu,
                                float eps, int nb, int bf16, void* stream) {
  if (c > 0) {
    const int elem = bf16 ? 2 : 4;
    const bool vec = vector_path(c, elem, {x, gz, z, dres});
    int rp, chunks;
    block_shape(c, elem, vec, rp, chunks);
    const dim3 grid(nb, chunks);
    cudaStream_t st = (cudaStream_t)stream;
#define GCD_BN_SUMS(T, V)                                                                     \
  bn_grad_sums_kernel<T, V><<<grid, kThreads, 0, st>>>(                                       \
      (const T*)x, (const uint8_t*)valid, (const T*)gz, (const T*)z, (const float*)stats,     \
      (const float*)rmean, (const float*)rvar, (T*)dres, (float*)partial, (unsigned*)counter, \
      (float*)sums, (float*)dweight, (float*)dbias, n, c, train, relu, eps)
    if (bf16) {
      if (vec) GCD_BN_SUMS(__nv_bfloat16, 8); else GCD_BN_SUMS(__nv_bfloat16, 1);
    } else {
      if (vec) GCD_BN_SUMS(float, 4); else GCD_BN_SUMS(float, 1);
    }
#undef GCD_BN_SUMS
  }
  return (int)cudaGetLastError();
}

// dx [N, C] from the sums of `gcd_bn_grad_sums` (all-reduced over a group).
extern "C" int gcd_bn_grad_x(const void* x, const void* valid, const void* gz, const void* z,
                             const void* stats, const void* rmean, const void* rvar,
                             const void* weight, const void* sums, void* dx, int n, int c,
                             int train, int relu, float eps, int bf16, void* stream) {
  if (c > 0) {
    const int elem = bf16 ? 2 : 4;
    const bool vec = vector_path(c, elem, {x, gz, z, dx});
    int rp, chunks;
    block_shape(c, elem, vec, rp, chunks);
    const dim3 grid(row_blocks(n, rp * kUnroll, chunks, 8), chunks);
    cudaStream_t st = (cudaStream_t)stream;
#define GCD_BN_DX(T, V)                                                                       \
  bn_grad_x_kernel<T, V><<<grid, kThreads, 0, st>>>(                                          \
      (const T*)x, (const uint8_t*)valid, (const T*)gz, (const T*)z, (const float*)stats,     \
      (const float*)rmean, (const float*)rvar, (const float*)weight, (const float*)sums,      \
      (T*)dx, n, c, train, relu, eps)
    if (bf16) {
      if (vec) GCD_BN_DX(__nv_bfloat16, 8); else GCD_BN_DX(__nv_bfloat16, 1);
    } else {
      if (vec) GCD_BN_DX(float, 4); else GCD_BN_DX(float, 1);
    }
#undef GCD_BN_DX
  }
  return (int)cudaGetLastError();
}
