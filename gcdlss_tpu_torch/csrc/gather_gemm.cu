// Gather-GEMM sparse convolution kernels for Hopper (sm_90a): forward, dX and dW.
//
// Replaces the TPU kernels `_fwd_kernel` (K1) and `_bwd_kernel` (K2) of
// gcdlss_tpu/ops/fused_conv.py.
//
// K1, forward and dX (`gather_gemm_kernel`):
//     out[u, :] = sum_k x[nbr[u, k], :] @ W[k]          (nbr < 0 contributes 0)
// dX is the same function on the adjoint book with W transposed; for a
// submanifold book, whose adjoint is the book with its columns reversed, the
// kernel reads W[K-1-k] beside column k instead of a reversed copy of the book.
//
// K2, dW (`gather_dw_kernel`, `gather_dw_small_kernel`, `sum_slices_kernel`):
//     dW[k, c, o] = sum_v x[v, c] * g[adj[v, k], o]
//
// What bounds them on the card: their arithmetic, and the shared-memory reads
// that feed it. The gathered bytes of a whole conv move in ~0.1 ms; a dense
// f32 product over every offset on the CUDA cores takes a hundred times that,
// and 74-95% of the entries of the books are absent. The TPU kernel staged
// sliding windows of x in VMEM and skipped whole 128-row tiles; neither
// carries over: the card's L2 serves the scattered rows, and whole tiles are
// rarely empty (10-17% at k = 3). What the design does:
//
//  * Tensor cores. bf16 `mma.sync.m16n8k16` with f32 accumulators, fragments
//    read with `ldmatrix` from padded shared-memory tiles (row pitch an odd
//    multiple of 16 bytes: no bank conflicts). bf16 products are exact in
//    f32, so only the order of the sums differs from the plain version.
//  * 16-byte gathers. Where Ci (Co) is a multiple of 8 and the pointer is
//    16-byte aligned, a present row's slice goes global -> shared with
//    `cp.async` (8 bf16 a request) into the stage after the one multiplied; an absent row's
//    slice is a 16-byte store of zeros and asks memory for nothing. Otherwise
//    (Ci = 1, ragged widths, a misaligned view) the same tiles are filled
//    element by element, over the flattened (offset, channel) reduction so
//    that a one-channel input still fills a 64-deep tile.
//  * K1 skips per 16-row strip. A block of 8 warps owns 128 output rows and up
//    to 128 output columns; warp w gathers and multiplies rows 16w..16w+15.
//    The block first marks, per offset, which strips hold a present entry
//    (one pass over its book tile, integer `atomicOr` in shared memory). An
//    offset no strip needs is never staged, W[k] included; a warp whose strip
//    is empty at an offset neither gathers nor multiplies there.
//  * dW is fill-only along its reduction. A block owns one (offset, row slice,
//    Ci tile, Co tile); it compacts the present pairs (v, adj[v, k]) of 2048
//    rows at a time, in the order of the rows (ballot + prefix count), and
//    walks the compact list 64 pairs a step, gathering the x row and the g
//    row of each pair. The arithmetic is that of the present entries only.
//    Partial sums per slice are added in a fixed order by a second pass: no
//    float atomics anywhere, every result repeats bit for bit.
//  * Ci < 8 (the one-channel stem) takes dW on the CUDA cores: after the same
//    compaction one warp per pair lane and one thread per output column
//    accumulate x[v, c] * g[u, o]; the lanes are added in a fixed order. A
//    block takes 8 / Ci neighbouring offsets, so that the 125-column book of
//    the stem is read once and not once per column.
//
// There is no window, so no entry of any book can fall outside it: nothing
// like the TPU's "far" COO finish exists.
//
// Every C entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not 0. Nothing here allocates.

#include "gather_mma.cuh"

namespace {

using namespace gcd;
typedef __nv_bfloat16 bf16;

constexpr int STAGES = 2;  // shared-memory tiles: one multiplied, one in flight
constexpr int DEPTH = 64;  // reduction depth of one stage: four k16 steps

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------- K1

constexpr int BM = 128;           // output rows of a block: 8 strips of 16
constexpr int K1_THREADS = 256;   // one warp per strip
constexpr int ALD = DEPTH + 8;    // pitch of the A tile in bf16 (144 bytes)

template <int NT>
constexpr int k1_smem_bytes(int k) {
  return STAGES * (BM * ALD + DEPTH * (NT * 8 + 8)) * (int)sizeof(bf16) + k * (int)sizeof(uint32_t);
}

// NT: n8 tiles of a warp, the block's BN = 8 NT output columns. FLAT: the
// element-wise path over the flattened reduction r = k * Ci + c (any Ci, any
// alignment of x); otherwise Ci % 8 == 0, x 16-byte aligned, and a stage is
// 64 channels of one offset. `bvec`: W rows may be copied 16 bytes at a time.
template <int NT, bool FLAT>
__global__ void __launch_bounds__(K1_THREADS, 2)
gather_gemm_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                   const bf16* __restrict__ w, void* __restrict__ out, int n_out, int k, int ci,
                   int co, int n_tiles, int reverse, int out_bf16, int bvec) {
  constexpr int BN = NT * 8;
  constexpr int BLD = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);                    // [STAGES][BM][ALD]
  bf16* Bs = As + STAGES * BM * ALD;                               // [STAGES][DEPTH][BLD]
  uint32_t* kmask = reinterpret_cast<uint32_t*>(Bs + STAGES * DEPTH * BLD);  // [k]: strips present

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int red = FLAT ? k * ci : ci;  // extent that a stage's depth is cut from

  if (!FLAT) {
    for (int i = tid; i < k; i += K1_THREADS) kmask[i] = 0u;
    __syncthreads();
    const int entries = min(BM, n_out - m0) * k;
    const int32_t* tile = nbr + (size_t)m0 * k;
    for (int e = tid; e < entries; e += K1_THREADS) {
      if (tile[e] >= 0) {
        const int r = e / k;
        atomicOr(&kmask[e - r * k], 1u << (r >> 4));
      }
    }
    __syncthreads();
  }

  // a stage is (offset kq, channel start c0), or in FLAT (unused, start r0)
  auto next_offset = [&](int kq) {
    do {
      ++kq;
    } while (kq < k && kmask[kq] == 0u);
    return kq;
  };
  auto advance = [&](int& kq, int& c0) {
    c0 += DEPTH;
    if (!FLAT && c0 >= ci) {
      c0 = 0;
      kq = next_offset(kq);
    }
  };
  auto valid = [&](int kq, int c0) { return FLAT ? c0 < red : kq < k; };
  // the row of W (viewed as [k * Ci, Co]) that holds flat reduction index r
  auto w_row = [&](int r) {
    if (!reverse) return r;
    const int kq = r / ci;
    return (k - 1 - kq) * ci + (r - kq * ci);
  };

  auto fill = [&](int kq, int c0, int stage) {
    bf16* a = As + stage * BM * ALD;
    bf16* b = Bs + stage * DEPTH * BLD;
    const int depth = min(DEPTH, red - c0);
    const int depth16 = (depth + 15) & ~15;
    if (FLAT) {
      for (int e = tid; e < BM * DEPTH; e += K1_THREADS) {
        const int m = e / DEPTH;
        const int kk = e - m * DEPTH;
        const int u = m0 + m;
        const int r = c0 + kk;
        bf16 v = __float2bfloat16(0.f);
        if (u < n_out && r < red) {
          const int q = r / ci;
          const int32_t j = nbr[(size_t)u * k + q];
          if (j >= 0) v = x[(size_t)j * ci + (r - q * ci)];
        }
        a[m * ALD + kk] = v;
      }
    } else if ((kmask[kq] >> warp) & 1u) {
      constexpr int PIECES = DEPTH / 8;
      for (int i = lane; i < 16 * PIECES; i += 32) {
        const int row = warp * 16 + i / PIECES;
        const int cc = c0 + (i % PIECES) * 8;
        const int u = m0 + row;
        bf16* dst = a + row * ALD + (i % PIECES) * 8;
        const int32_t j = u < n_out ? nbr[(size_t)u * k + kq] : -1;
        if (j >= 0 && cc < ci) {
          cp_async16(dst, x + (size_t)j * ci + cc);
        } else {
          zero16(dst);
        }
      }
    }
    const int r0 = FLAT ? c0 : kq * ci + c0;
    if (bvec) {
      constexpr int PIECES = BN / 8;
      for (int i = tid; i < depth16 * PIECES; i += K1_THREADS) {
        const int rr = i / PIECES;
        const int col = n0 + (i % PIECES) * 8;
        bf16* dst = b + rr * BLD + (i % PIECES) * 8;
        if (rr < depth && col < co) {
          cp_async16(dst, w + (size_t)w_row(r0 + rr) * co + col);
        } else {
          zero16(dst);
        }
      }
    } else {
      for (int e = tid; e < depth16 * BN; e += K1_THREADS) {
        const int rr = e / BN;
        const int n = e - rr * BN;
        const bool in = rr < depth && n0 + n < co;
        b[rr * BLD + n] = in ? w[(size_t)w_row(r0 + rr) * co + n0 + n] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  auto compute = [&](int kq, int c0, int stage) {
    if (!FLAT && !((kmask[kq] >> warp) & 1u)) return;
    const bf16* a = As + stage * BM * ALD + (warp * 16 + lane % 16) * ALD + (lane / 16) * 8;
    const bf16* b = Bs + stage * DEPTH * BLD + (lane % 16) * BLD + (lane / 16) * 8;
    const int steps = (min(DEPTH, red - c0) + 15) / 16;
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, a + ks * 16);
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, b + ks * 16 * BLD + jn * 16);
        mma_bf16_16816(acc[2 * jn], af, bq[0], bq[1]);
        mma_bf16_16816(acc[2 * jn + 1], af, bq[2], bq[3]);
      }
    }
  };

  int pk = FLAT ? 0 : next_offset(-1), pc = 0;  // the stage filled next
  int ck = pk, cc = 0, stage = 0;               // the stage multiplied next
  for (int s = 0; s < STAGES - 1; ++s) {
    if (valid(pk, pc)) {
      fill(pk, pc, s);
      advance(pk, pc);
    }
    cp_async_commit();
  }
  while (valid(ck, cc)) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage has landed; the stage refilled below was read last round
    if (valid(pk, pc)) {
      fill(pk, pc, (stage + STAGES - 1) % STAGES);
      advance(pk, pc);
    }
    cp_async_commit();
    compute(ck, cc, stage);
    advance(ck, cc);
    stage = (stage + 1) % STAGES;
  }
  cp_async_wait<0>();

  const int row0 = m0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = row0 + (e / 2) * 8;
      const int o = n0 + j * 8 + 2 * (lane % 4) + (e % 2);
      if (u < n_out && o < co) {
        const size_t at = (size_t)u * co + o;
        if (out_bf16) {
          reinterpret_cast<bf16*>(out)[at] = __float2bfloat16(acc[j][e]);
        } else {
          reinterpret_cast<float*>(out)[at] = acc[j][e];
        }
      }
    }
  }
}

template <int NT>
void launch_gather_gemm(const bf16* x, const int32_t* nbr, const bf16* w, void* out, int n_out,
                        int k, int ci, int co, int n_tiles, int reverse, int out_bf16,
                        cudaStream_t stream) {
  const bool flat = ci % 8 != 0 || !aligned16(x);
  const int bvec = co % 8 == 0 && aligned16(w);
  const int smem = k1_smem_bytes<NT>(k);
  const int blocks = ((n_out + BM - 1) / BM) * n_tiles;
  auto kernel = flat ? gather_gemm_kernel<NT, true> : gather_gemm_kernel<NT, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<blocks, K1_THREADS, smem, stream>>>(x, nbr, w, out, n_out, k, ci, co, n_tiles,
                                               reverse, out_bf16, bvec);
}

// ---------------------------------------------------------------- K2: dW

constexpr int DW_SMALL_CI = 8;  // below it the CUDA-core branch

__host__ __device__ constexpr int dw_tile(int c) { return c <= 32 ? 32 : c <= 64 ? 64 : 128; }

template <int TM, int TN, int NW>
constexpr int dw_smem_bytes() {
  return STAGES * DEPTH * (TM + 8 + TN + 8) * (int)sizeof(bf16) +
         (2 * (NW * COMPACT_ROWS_PER_WARP + DEPTH) + NW) * (int)sizeof(int);
}

// partial[s, kq, c, o] = sum over the present pairs (v, u = adj[v, col]) of
// row slice s of x[v, c] * g[u, o], for one (TM x TN) tile of (Ci, Co); col is
// kq, or K-1-kq when the adjoint is the column-reversed book. WM x WN warps,
// each a (TM / WM) x (TN / WN) piece of the tile.
template <int TM, int TN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
gather_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const int32_t* __restrict__ adj, float* __restrict__ partial, int n_in, int k,
                 int ci, int co, int nslices, int n_tiles, int reverse, int xvec, int gvec) {
  constexpr int NW = WM * WN;
  constexpr int THREADS = NW * 32;
  constexpr int SEG = NW * COMPACT_ROWS_PER_WARP;
  constexpr int XLD = TM + 8, GLD = TN + 8;
  constexpr int MT = TM / WM / 16, NT = TN / WN / 8;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);       // [STAGES][DEPTH][XLD]
  bf16* Gs = Xs + STAGES * DEPTH * XLD;               // [STAGES][DEPTH][GLD]
  int* list_v = reinterpret_cast<int*>(Gs + STAGES * DEPTH * GLD);  // [SEG + DEPTH]
  int* list_u = list_v + SEG + DEPTH;
  int* wcount = list_u + SEG + DEPTH;                 // [NW]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int c0 = (blockIdx.x / n_tiles) * TM;
  const int n0 = (blockIdx.x % n_tiles) * TN;
  const int kq = blockIdx.y;
  const int col = reverse ? k - 1 - kq : kq;
  const int s = blockIdx.z;
  const int rows = (n_in + nslices - 1) / nslices;
  const int vbeg = min(n_in, s * rows);
  const int vend = min(n_in, vbeg + rows);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto fill = [&](int step, int stage) {
    const int* pv = list_v + step * DEPTH;
    const int* pu = list_u + step * DEPTH;
    bf16* xs = Xs + stage * DEPTH * XLD;
    bf16* gs = Gs + stage * DEPTH * GLD;
    if (xvec) {
      constexpr int PIECES = TM / 8;
      for (int i = tid; i < DEPTH * PIECES; i += THREADS) {
        const int p = i / PIECES;
        const int cc = c0 + (i % PIECES) * 8;
        const int v = pv[p];
        bf16* dst = xs + p * XLD + (i % PIECES) * 8;
        if (v >= 0 && cc < ci) {
          cp_async16(dst, x + (size_t)v * ci + cc);
        } else {
          zero16(dst);
        }
      }
    } else {
      for (int e = tid; e < DEPTH * TM; e += THREADS) {
        const int p = e / TM;
        const int m = e - p * TM;
        const int v = pv[p];
        const bool in = v >= 0 && c0 + m < ci;
        xs[p * XLD + m] = in ? x[(size_t)v * ci + c0 + m] : __float2bfloat16(0.f);
      }
    }
    if (gvec) {
      constexpr int PIECES = TN / 8;
      for (int i = tid; i < DEPTH * PIECES; i += THREADS) {
        const int p = i / PIECES;
        const int oo = n0 + (i % PIECES) * 8;
        const int u = pu[p];
        bf16* dst = gs + p * GLD + (i % PIECES) * 8;
        if (u >= 0 && oo < co) {
          cp_async16(dst, g + (size_t)u * co + oo);
        } else {
          zero16(dst);
        }
      }
    } else {
      for (int e = tid; e < DEPTH * TN; e += THREADS) {
        const int p = e / TN;
        const int n = e - p * TN;
        const int u = pu[p];
        const bool in = u >= 0 && n0 + n < co;
        gs[p * GLD + n] = in ? g[(size_t)u * co + n0 + n] : __float2bfloat16(0.f);
      }
    }
  };

  const int wm = warp / WN, wn = warp % WN;
  auto compute = [&](int stage) {
    // A = x^T: stored [pair][channel], read transposed
    const bf16* xa = Xs + stage * DEPTH * XLD + ((lane % 8) + (lane / 16) * 8) * XLD +
                     wm * (TM / WM) + ((lane / 8) % 2) * 8;
    const bf16* gb = Gs + stage * DEPTH * GLD + (lane % 16) * GLD + wn * (TN / WN) + (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < DEPTH / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4_trans(af[i], xa + ks * 16 * XLD + i * 16);
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, gb + ks * 16 * GLD + jn * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16_16816(acc[i][2 * jn], af[i], bq[0], bq[1]);
          mma_bf16_16816(acc[i][2 * jn + 1], af[i], bq[2], bq[3]);
        }
      }
    }
  };

  int cnt = 0;  // pairs carried over from the last segment: fewer than DEPTH
  for (int seg0 = vbeg; seg0 < vend; seg0 += SEG) {
    cnt = compact_segment<NW>(adj, k, col, seg0, vend, cnt, list_v, list_u, wcount);
    const bool last = seg0 + SEG >= vend;
    int steps = cnt / DEPTH;
    if (last) {  // the ragged end: pad the list with absent pairs
      steps = (cnt + DEPTH - 1) / DEPTH;
      for (int i = cnt + tid; i < steps * DEPTH; i += THREADS) {
        list_v[i] = -1;
        list_u[i] = -1;
      }
    }
    __syncthreads();
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < steps) fill(st, st);
      cp_async_commit();
    }
    for (int st = 0; st < steps; ++st) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (st + STAGES - 1 < steps) fill(st + STAGES - 1, (st + STAGES - 1) % STAGES);
      cp_async_commit();
      compute(st % STAGES);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the tiles and the lists
    if (!last) {      // move the remainder to the front, in order
      const int rem = cnt - steps * DEPTH;
      int tv = 0, tu = 0;
      if (tid < rem) {
        tv = list_v[steps * DEPTH + tid];
        tu = list_u[steps * DEPTH + tid];
      }
      __syncthreads();
      if (tid < rem) {
        list_v[tid] = tv;
        list_u[tid] = tu;
      }
      cnt = rem;
    }
  }

  float* dst = partial + ((size_t)s * k + kq) * ci * co;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + wm * (TM / WM) + i * 16 + lane / 4 + (e / 2) * 8;
        const int o = n0 + wn * (TN / WN) + j * 8 + 2 * (lane % 4) + (e % 2);
        if (c < ci && o < co) dst[(size_t)c * co + o] = acc[i][j][e];
      }
}

// The same sum for Ci < 8 on the CUDA cores: warp = pair lane (pairs p, p + 8,
// ...), thread = output column of a 32-column tile; lanes added in order. A
// block takes 8 / CI neighbouring offsets of its rows, one after the other
// per segment: a 32-byte sector of the book holds 8 columns of a row, and a
// block that read one column alone would move the whole book 8 times.
constexpr int SMALL_WARPS = 8;

template <int CI>
__global__ void __launch_bounds__(SMALL_WARPS * 32)
gather_dw_small_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       const int32_t* __restrict__ adj, float* __restrict__ partial, int n_in,
                       int k, int co, int nslices, int reverse) {
  constexpr int SEG = SMALL_WARPS * COMPACT_ROWS_PER_WARP;
  constexpr int KB = DW_SMALL_CI / CI;  // offsets of a block
  __shared__ int list_v[SEG];
  __shared__ int list_u[SEG];
  __shared__ int wcount[SMALL_WARPS];
  __shared__ float red[SMALL_WARPS][KB * CI][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + lane;
  const int k0 = blockIdx.y * KB;
  const int s = blockIdx.z;
  const int rows = (n_in + nslices - 1) / nslices;
  const int vbeg = min(n_in, s * rows);
  const int vend = min(n_in, vbeg + rows);
  float acc[KB][CI];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int c = 0; c < CI; ++c) acc[kk][c] = 0.f;

  for (int seg0 = vbeg; seg0 < vend; seg0 += SEG) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      if (k0 + kk >= k) break;  // the same for every thread of the block
      const int col = reverse ? k - 1 - (k0 + kk) : k0 + kk;
      const int cnt =
          compact_segment<SMALL_WARPS>(adj, k, col, seg0, vend, 0, list_v, list_u, wcount);
      __syncthreads();
      for (int p = warp; p < cnt; p += SMALL_WARPS) {
        const int v = list_v[p];
        const float gv = o < co ? __bfloat162float(g[(size_t)list_u[p] * co + o]) : 0.f;
#pragma unroll
        for (int c = 0; c < CI; ++c)
          acc[kk][c] = fmaf(__bfloat162float(x[(size_t)v * CI + c]), gv, acc[kk][c]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int c = 0; c < CI; ++c) red[warp][kk * CI + c][lane] = acc[kk][c];
  __syncthreads();
  for (int i = warp; i < KB * CI; i += SMALL_WARPS) {
    const int kq = k0 + i / CI;
    float sum = 0.f;
    for (int wl = 0; wl < SMALL_WARPS; ++wl) sum += red[wl][i][lane];
    if (kq < k && o < co)
      partial[(((size_t)s * k + kq) * CI + i % CI) * co + o] = sum;
  }
}

// dw[i] = sum_s partial[s, i], slices added in order 0, 1, ...
__global__ void sum_slices_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  int64_t n, int nslices) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nslices; ++s) acc += partial[(int64_t)s * n + i];
    dw[i] = acc;
  }
}

template <int TM, int TN, int WM, int WN>
void launch_gather_dw(const bf16* x, const bf16* g, const int32_t* adj, float* partial, int n_in,
                      int k, int ci, int co, int nslices, int reverse, cudaStream_t stream) {
  const int m_tiles = (ci + TM - 1) / TM, n_tiles = (co + TN - 1) / TN;
  const int xvec = ci % 8 == 0 && aligned16(x);
  const int gvec = co % 8 == 0 && aligned16(g);
  const int smem = dw_smem_bytes<TM, TN, WM * WN>();
  auto kernel = gather_dw_kernel<TM, TN, WM, WN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3(m_tiles * n_tiles, k, nslices), WM * WN * 32, smem, stream>>>(
      x, g, adj, partial, n_in, k, ci, co, nslices, n_tiles, reverse, xvec, gvec);
}

int dw_blocks_per_slice(int k, int ci, int co) {
  if (ci < DW_SMALL_CI) return (k + DW_SMALL_CI / ci - 1) / (DW_SMALL_CI / ci) * ((co + 31) / 32);
  const int tm = dw_tile(ci), tn = dw_tile(co);
  return k * ((ci + tm - 1) / tm) * ((co + tn - 1) / tn);
}

}  // namespace

// out [n_out, co] (f32, or bf16 when out_bf16) = sum_k x[nbr[:, k]] @ w[kw],
// kw = k, or K-1-k when `reverse`.
extern "C" int gcd_gather_gemm(const void* x, const void* nbr, const void* w, void* out,
                               int n_out, int k, int ci, int co, int reverse, int out_bf16,
                               void* stream) {
  if (n_out > 0 && co > 0) {
    // all of Co in one block up to 128 columns, else the fewest equal tiles
    const int n_tiles = (co + 127) / 128;
    const int bn = (((co + n_tiles - 1) / n_tiles) + 31) / 32 * 32;
    auto launch = bn == 32 ? launch_gather_gemm<4> : bn == 64 ? launch_gather_gemm<8>
                : bn == 96 ? launch_gather_gemm<12> : launch_gather_gemm<16>;
    launch((const bf16*)x, (const int32_t*)nbr, (const bf16*)w, out, n_out, k, ci, co, n_tiles,
           reverse, out_bf16, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// Row slices of dW's reduction for these shapes: enough blocks for four waves
// of the card's SMs, at least two segments of rows a slice, and a partial
// buffer [slices, k, ci, co] f32 of at most 64 MiB.
extern "C" int gcd_gather_dw_slices(int n_in, int k, int ci, int co) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (k <= 0 || ci <= 0 || co <= 0) return 1;
  const int per_slice = dw_blocks_per_slice(k, ci, co);
  const int64_t want = (4 * (int64_t)sms + per_slice - 1) / per_slice;
  const int64_t by_rows = n_in / (2 * 8 * COMPACT_ROWS_PER_WARP);
  const int64_t by_bytes = ((int64_t)64 << 20) / ((int64_t)k * ci * co * 4);
  int64_t n = want < by_rows ? want : by_rows;
  if (by_bytes < n) n = by_bytes;
  return n < 1 ? 1 : (int)n;
}

// dw [k, ci, co] f32; `partial` holds [nslices, k, ci, co] f32 (unused when
// nslices is 1: the kernel then writes dw itself).
extern "C" int gcd_gather_dw(const void* x, const void* g, const void* adj, void* partial,
                             void* dw, int n_in, int k, int ci, int co, int nslices, int reverse,
                             void* stream) {
  if (k > 0 && ci > 0 && co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const bf16* xp = (const bf16*)x;
    const bf16* gp = (const bf16*)g;
    const int32_t* ap = (const int32_t*)adj;
    float* dst = nslices == 1 ? (float*)dw : (float*)partial;
    if (ci < DW_SMALL_CI) {
      const int kb = DW_SMALL_CI / ci;
      const dim3 grid((co + 31) / 32, (k + kb - 1) / kb, nslices);
#define GCD_DW_SMALL(CI)                                                  \
  if (ci == CI)                                                           \
    gather_dw_small_kernel<CI><<<grid, SMALL_WARPS * 32, 0, st>>>(        \
        xp, gp, ap, dst, n_in, k, co, nslices, reverse);
      GCD_DW_SMALL(1)
      GCD_DW_SMALL(2)
      GCD_DW_SMALL(3)
      GCD_DW_SMALL(4)
      GCD_DW_SMALL(5)
      GCD_DW_SMALL(6)
      GCD_DW_SMALL(7)
#undef GCD_DW_SMALL
    } else {
      const int tm = dw_tile(ci), tn = dw_tile(co);
#define GCD_DW(TM, TN, WM, WN)                                                          \
  if (tm == TM && tn == TN)                                                             \
    launch_gather_dw<TM, TN, WM, WN>(xp, gp, ap, dst, n_in, k, ci, co, nslices, reverse, st);
      GCD_DW(32, 32, 2, 2)
      GCD_DW(32, 64, 2, 2)
      GCD_DW(32, 128, 2, 4)
      GCD_DW(64, 32, 2, 2)
      GCD_DW(64, 64, 2, 4)
      GCD_DW(64, 128, 2, 4)
      GCD_DW(128, 32, 4, 2)
      GCD_DW(128, 64, 4, 2)
      GCD_DW(128, 128, 2, 4)
#undef GCD_DW
    }
    if (nslices > 1) {
      const int64_t n = (int64_t)k * ci * co;
      const int64_t want = (n + 255) / 256;
      sum_slices_kernel<<<(int)(want < 4096 ? want : 4096), 256, 0, st>>>(
          (const float*)partial, (float*)dw, n, nslices);
    }
  }
  return (int)cudaGetLastError();
}
