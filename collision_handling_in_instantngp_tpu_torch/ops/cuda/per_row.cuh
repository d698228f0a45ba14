// Shared device code of the per-row HPD kernels: hpd_tail.cu (K8/K9) and
// hpd_full.cu (K10/K11).
//
// Rows are level-major, (L, N, .) in device memory. A row tile holds
// R = 16 * RPT rows of one level and never straddles two. The tiles of a
// level split into `spl` fixed segments, one block each (grid (spl, L));
// a block walks its segment's tiles in order. Sums across rows (marginal,
// dW, db) go to one partial per block and a second kernel adds the
// partials in block order: no atomics, bitwise stable run to run, and the
// split does not depend on the card.
//
// The products here are fp32 FMA on the CUDA cores: a 256-thread block
// computes an (R x 128) output tile, thread (ty, tx) holding rows
// ty*RPT + i and columns tx + 16*j, with the right operand staged through
// shared memory in 32-deep chunks. K8 and the hidden layers of K10 and K11
// run them, fp32 whatever matmul precision the model names (the TPU kernels
// pass no precision to their dots); the head's products of K9, K10 and K11
// run as 3xTF32 on the tensor cores instead (per_row_mma.cuh).
#pragma once

#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace per_row {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TT = 128;          // output columns per product pass
constexpr int BK = 32;           // contraction chunk staged in shared memory
constexpr int BS = TT + 1;       // padded row stride of the staged chunk
constexpr int WMAX = 128;        // columns of one product pass over a layer's width
constexpr int WLD = WMAX + 1;    // row stride of activation tiles up to WMAX wide
constexpr int WIDE_MAX = 512;    // widest hidden layer and head input (the JAX kernels')
constexpr int TMAX = 2048;       // widest head
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may use
constexpr int TARGET_BLOCKS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Rows {
  int L, N;   // levels, rows per level
  int spl;    // segments (blocks) per level
  int tps;    // tiles per segment
};

inline Rows make_rows(int L, int N, int R) {
  Rows g;
  g.L = L;
  g.N = N;
  g.spl = TARGET_BLOCKS / L > 0 ? TARGET_BLOCKS / L : 1;
  const int tpl = (N + R - 1) / R;
  g.tps = (tpl + g.spl - 1) / g.spl;
  return g;
}

// acc = A (R x kdim, shared, row stride lda) @ B[:, c0 : c0 + 128] where
// B is kdim x n in device memory: B[k * n + c], or with TRANS the
// transpose of an n x kdim matrix: B[c * kdim + k]. Columns >= n give 0.
// Starts with a barrier; b_s is BK x BS scratch.
template <int RPT, bool TRANS>
__device__ __forceinline__ void tile_mm(const float* __restrict__ A, int lda, int kdim,
                                        const float* __restrict__ B, int n, int c0,
                                        float* __restrict__ b_s, float (&acc)[RPT][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * TT; e += THREADS) {
      int kk, c;
      if (TRANS) {  // consecutive threads on consecutive k: contiguous reads
        c = e / BK;
        kk = e - c * BK;
      } else {
        kk = e / TT;
        c = e - kk * TT;
      }
      const int k = k0 + kk, col = c0 + c;
      float v = 0.f;
      if (k < kdim && col < n) v = TRANS ? B[(size_t)col * kdim + k] : B[(size_t)k * n + col];
      b_s[kk * BS + c] = v;
    }
    __syncthreads();
    const int kend = kdim - k0 < BK ? kdim - k0 : BK;
    for (int kk = 0; kk < kend; ++kk) {
      float a[RPT], bb[8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = A[(ty * RPT + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = b_s[kk * BS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

// part[a * n + c] += sum_r A[r, a] G[r, c] (a < m, c < n) and
// partb[c] += sum_r G[r, c], rows r < R in order. Each element of a block's
// partial is always updated by the same thread. m <= WMAX (outer_acc_wide
// below takes more); BIAS = false leaves partb out.
template <int R, bool BIAS = true>
__device__ __forceinline__ void outer_acc(const float* __restrict__ A, int lda, int m,
                                          const float* __restrict__ G, int ldg, int n,
                                          float* __restrict__ part, float* __restrict__ partb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c0 = 0; c0 < n; c0 += TT) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < R; ++r) {
      float a[8], g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ty * 8 + i < m ? A[r * lda + ty * 8 + i] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        g[j] = c < n ? G[r * ldg + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = ty * 8 + i;
      if (a >= m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < n) part[(size_t)a * n + c] += acc[i][j];
      }
    }
  }
  if (BIAS)
    for (int c = threadIdx.x; c < n; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += G[r * ldg + c];
      partb[c] += s;
    }
}

// outer_acc for any m: one pass per WMAX rows of part, partb with the first.
template <int R>
__device__ __forceinline__ void outer_acc_wide(const float* __restrict__ A, int lda, int m,
                                               const float* __restrict__ G, int ldg, int n,
                                               float* __restrict__ part, float* __restrict__ partb) {
  outer_acc<R>(A, lda, m < WMAX ? m : WMAX, G, ldg, n, part, partb);
  for (int a0 = WMAX; a0 < m; a0 += WMAX)
    outer_acc<R, false>(A + a0, lda, m - a0 < WMAX ? m - a0 : WMAX, G, ldg, n,
                        part + (size_t)a0 * n, partb);
}

// src rows [base, base + rows) of width `width` into dst (R x ld), zeros
// past `rows`
template <int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, size_t base, int rows,
                                          int width, float* __restrict__ dst, int ld) {
  for (int e = threadIdx.x; e < R * width; e += THREADS) {
    const int r = e / width, k = e - r * width;
    dst[r * ld + k] = r < rows ? src[(base + r) * width + k] : 0.f;
  }
}

// Logits A @ w + b of the tile into cache (R x (T + 1)); w is H x T.
template <int RPT>
__device__ __forceinline__ void tile_logits(const float* __restrict__ A, int lda, int H,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int T,
                                            float* __restrict__ b_s, float* __restrict__ cache) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ldc = T + 1;
  for (int c0 = 0; c0 < T; c0 += TT) {
    float acc[RPT][8];
    tile_mm<RPT, false>(A, lda, H, w, T, c0, b_s, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= T) continue;
      const float bc = b[c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) cache[(ty * RPT + i) * ldc + c] = acc[i][j] + bc;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Largest value, lowest index among equals; every lane ends with the pair.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.f;
  if (isinf(x)) return x > 0.f ? FLT_MAX : -FLT_MAX;
  return x;
}

// One warp: row[0:T) logits -> p = nan_to_num(e / sum e), e = exp(l - max l),
// in place (the TPU kernels' _softmax_tile).
__device__ __forceinline__ void softmax_row(float* __restrict__ row, int T) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int c = lane; c < T; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < T; c += 32) {
    const float e = expf(row[c] - m);
    row[c] = e;
    s += e;
  }
  s = warp_sum(s);
  for (int c = lane; c < T; c += 32) row[c] = nan_to_num(row[c] / s);
  __syncwarp();
}

// One warp: top-K of p by K argmax passes (lowest index first among equal
// values), each pass masking its column with -1 like the TPU kernels.
// Destroys the row.
__device__ __forceinline__ void topk_row(float* __restrict__ row, int T, int K,
                                         float* __restrict__ vals, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < K; ++q) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < T; c += 32) {
      const float v = row[c];
      if (v > bv) {  // columns rise, so the first of equal values stays
        bv = v;
        bi = c;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      vals[q] = bv;
      idx[q] = bi;
      row[bi] = -1.f;
    }
    __syncwarp();
  }
}

constexpr int KMAX_LANE = 4;  // top-K entries per lane in dlogits_row (K <= 128)

// One warp: p -> dlogits = p (g_p - <g_p, p>) in place, with
// g_p = gm (+ g_vals at the row's top-K columns); zeros on an invalid row.
// gm: the level's g_marg row with the primal's 1/N folded in. The top-K
// columns of a row are distinct (they come from the forward).
__device__ __forceinline__ void dlogits_row(float* __restrict__ row, int T, int K,
                                            const float* __restrict__ gm,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ gv, bool valid) {
  const int lane = threadIdx.x & 31;
  if (!valid) {
    for (int c = lane; c < T; c += 32) row[c] = 0.f;
    __syncwarp();
    return;
  }
  float dot = 0.f;
  for (int c = lane; c < T; c += 32) dot = fmaf(gm[c], row[c], dot);
  int ci[KMAX_LANE];
  float cg[KMAX_LANE], cp[KMAX_LANE];
#pragma unroll
  for (int u = 0; u < KMAX_LANE; ++u) {
    const int q = lane + 32 * u;
    ci[u] = -1;
    if (q < K) {
      ci[u] = idx[q];
      cg[u] = gv[q];
      cp[u] = row[ci[u]];
      dot = fmaf(cg[u], cp[u], dot);
    }
  }
  dot = warp_sum(dot);
  __syncwarp();
  for (int c = lane; c < T; c += 32) row[c] = row[c] * (gm[c] - dot);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < KMAX_LANE; ++u)
    if (ci[u] >= 0) row[ci[u]] = cp[u] * ((gm[ci[u]] + cg[u]) - dot);
  __syncwarp();
}

// Column sums of a tile's valid rows into colsum (each column owned by one
// thread across tiles).
__device__ __forceinline__ void column_sums(const float* __restrict__ cache, int ldc, int rows,
                                            int T, float* __restrict__ colsum) {
  for (int c = threadIdx.x; c < T; c += THREADS) {
    float a = 0.f;
    for (int r = 0; r < rows; ++r) a += cache[r * ldc + c];
    colsum[c] += a;
  }
}

// out[l * T + c] = (sum over segments in order of part[(l * spl + s) * T + c]) / N
__global__ void reduce_levels_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int L, int spl, int T, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * T) return;
  const int l = i / T, c = i - l * T;
  float s = 0.f;
  for (int sg = 0; sg < spl; ++sg) s += part[((size_t)l * spl + sg) * T + c];
  out[i] = s / (float)N;
}

// out[i] = sum over blocks in order of part[b * total + i]
__global__ void reduce_blocks_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int nblocks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * total + i];
  out[i] = s;
}

template <typename F>
inline void set_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace per_row
