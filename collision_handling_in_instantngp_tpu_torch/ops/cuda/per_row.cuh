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
// The hidden ReLU stack here (hidden_stack) is fp32 FMA on the CUDA cores:
// each thread a register block of R / 8 rows by 4 of the layer's own
// columns (8 x 4 at R = 64), its operands read as float4 from shared
// memory, the weights streamed through a two-chunk cp.async ring across
// the layers. K10's hidden layers and K11's
// replay of them run it, fp32 whatever matmul precision the model names
// (the TPU kernels pass no precision to their dots); the head's products of
// K9, K10 and K11 and K11's hidden dh and dW run as 3xTF32 on the tensor
// cores instead (per_row_mma.cuh), and K8's logits as fp32 FMA of its own
// (hpd_tail.cu: fma_logits), with the same chains.
#pragma once

#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace per_row {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WMAX = 128;        // columns of one product pass over a layer's width
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

// ------------------------------- cp.async ------------------------------------

// dst[0:4] <- src[0:4], asynchronously; both 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// the same, zeros where !ok (src is then not read, but stays 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

// *dst = *src (4 bytes), asynchronously; 0 where !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// --------------------------- the hidden ReLU stack ---------------------------
//
// hidden_stack: act_{i+1} = relu(act_i W_i + b_i) for the hidden layers of a
// row tile, in shared memory. Each output is one fp32 fma chain over k
// ascending from zero, then + b, then fmaxf(., 0): the TPU kernel's fp32
// dot and the plain version's order, so K10's outputs and K11's replayed
// ReLU masks agree bit for bit.
//
// A layer runs in passes of nc = 16, 32, 64 or 128 output columns (the
// least that holds it; 128-column passes past 128). A thread holds a
// register block of TM = R / 8 rows (rg + 8 i) by 4 columns (c0 + 4 cg),
// so a pass takes 2 nc threads, whole warps (all 256 at nc = 128; at R = 64,
// 32 outputs a thread), and reads its operands as float4: A's TM rows 4 k
// at a time (scalars where A's row stride is not a multiple of 4) and W's
// 4 columns once a k. A warp's A loads are broadcasts or hit distinct banks
// (its rows are consecutive, strides = 4 mod 8), its W loads are
// contiguous. One instance of the loop serves every layer and pass width:
// the kernels around it fill the instruction cache already (with an
// instance for each width, K11 slowed in every phase: PERF.md §6).
// W streams through the stage buffer in chunks of up to KS rows x nc
// columns (at RPT = 4 a chunk holds each whole layer of the per-row
// route), two halves as a ring across passes and layers: the next chunk
// (the next pass's, or the next layer's first) streams in by cp.async while
// one is computed. A pass deeper than a chunk continues its chains through
// the output tile (an fp32 value round-trips exactly).

// A tile of activations: its first row and its row stride, in floats.
struct Act {
  float* p;
  int ld;
};

// Pass width of a layer of n outputs.
__host__ __device__ constexpr int stack_nc(int n) {
  return n > 64 ? 128 : n > 32 ? 64 : n > 16 ? 32 : 16;
}

// Rows of W a chunk of nc columns holds in a buffer of buf floats.
__host__ __device__ constexpr int stack_ks(int nc, int buf) { return buf / nc / 4 * 4; }

// W[k0 : k0 + kn, c0 : c0 + nc] of a row-major (. x n) W into st (row
// stride nc), zeros past n: 16-byte pieces where al16 (W 16-byte aligned, n
// a multiple of 4), else 4-byte ones. Commits the group.
__device__ __forceinline__ void stack_stage(const float* __restrict__ W, int n, bool al16, int k0,
                                            int kn, int c0, int nc, float* __restrict__ st) {
  const int lg = 31 - __clz(nc);  // nc is a power of 2
  if (al16) {
    for (int e = threadIdx.x; e < kn * nc / 4; e += THREADS) {
      const int r = e >> (lg - 2), c = 4 * (e - (r << (lg - 2)));
      const bool ok = c0 + c < n;
      cp_async16(st + r * nc + c, ok ? W + (size_t)(k0 + r) * n + c0 + c : W, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kn * nc; e += THREADS) {
      const int r = e >> lg, c = e - (r << lg);
      const bool ok = c0 + c < n;
      cp_async4(st + r * nc + c, ok ? W + (size_t)(k0 + r) * n + c0 + c : W, ok);
    }
  }
  cp_commit();
}

// The pass [c0, c0 + nc) of out = relu(A W + b) over W's rows [k0, k0 + kn),
// staged in st (kn x nc): each thread's TM x 4 chains start from zero where
// first, else from out; + b and relu where last. Columns >= n are neither
// read nor written. vec: A's rows are 16-byte aligned (read as float4).
template <int TM>
__device__ __forceinline__ void stack_fma(const float* __restrict__ A, int lda, bool vec, int k0,
                                          int kn, const float* __restrict__ st, int nc, int c0,
                                          int n, const float* __restrict__ bias, bool first,
                                          bool last, float* __restrict__ out, int ldo) {
  const int cgs = nc / 4;
  if (threadIdx.x >= 8 * cgs) return;
  const int rg = threadIdx.x / cgs, cg = threadIdx.x - rg * cgs;
  const int c = c0 + 4 * cg;
  if (c >= n) return;
  const int ncol = n - c < 4 ? n - c : 4;
  const bool vout = ncol == 4 && (ldo & 3) == 0;
  float* o = out + rg * ldo + c;  // row i at + 8 i ldo
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (first) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    } else if (vout) {
      const float4 v = *reinterpret_cast<const float4*>(o + 8 * i * ldo);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = lane_of(v, u);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = u < ncol ? o[8 * i * ldo + u] : 0.f;
    }
  }
  const float* a = A + rg * lda + k0;  // row i at + 8 i lda
  const float* w = st + 4 * cg;
  int k = 0;
  if (vec) {
#pragma unroll 1
    for (; k + 4 <= kn; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + 8 * i * lda + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(w + (k + u) * nc);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = lane_of(av[i], u);
          acc[i][0] = fmaf(s, x.x, acc[i][0]);
          acc[i][1] = fmaf(s, x.y, acc[i][1]);
          acc[i][2] = fmaf(s, x.z, acc[i][2]);
          acc[i][3] = fmaf(s, x.w, acc[i][3]);
        }
      }
    }
  }
#pragma unroll 1
  for (; k < kn; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(w + k * nc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float s = a[8 * i * lda + k];
      acc[i][0] = fmaf(s, x.x, acc[i][0]);
      acc[i][1] = fmaf(s, x.y, acc[i][1]);
      acc[i][2] = fmaf(s, x.z, acc[i][2]);
      acc[i][3] = fmaf(s, x.w, acc[i][3]);
    }
  }
  float bb[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) bb[u] = last && u < ncol ? bias[c + u] : 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = last ? fmaxf(acc[i][u] + bb[u], 0.f) : acc[i][u];
    if (vout) {
      *reinterpret_cast<float4*>(o + 8 * i * ldo) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < ncol) o[8 * i * ldo + u] = v[u];
    }
  }
}

// The hidden layers of an R = 16 RPT row tile: for i < net.n - 1, act(i + 1)
// = relu(act(i) W_i + b_i), W_i (w[i] x w[i+1], row-major) and b_i at
// net.woff[i] and net.boff[i] in params (any alignment). act(i) -> Act;
// stage: STAGE floats. pre() runs once the first chunk is issued (act(0)'s
// loads, under the weights' latency). Starts with a barrier (stage free)
// and ends with one (every tile complete).
template <int RPT, int STAGE, typename NetT, typename FA, typename FP>
__device__ __forceinline__ void hidden_stack(const float* __restrict__ params, const NetT& net,
                                             FA act, float* __restrict__ stage, FP pre) {
  constexpr int BUF = STAGE / 2 / 4 * 4;
  const int layers = net.n - 1;
  // a chunk: layer i, its pass at column c0, W's rows from k0
  struct Pos {
    int i, c0, k0;
  };
  const auto kn_of = [&](const Pos& p) {
    const int ks = stack_ks(stack_nc(net.w[p.i + 1]), BUF);
    return net.w[p.i] - p.k0 < ks ? net.w[p.i] - p.k0 : ks;
  };
  const auto next = [&](Pos p) {
    p.k0 += kn_of(p);
    if (p.k0 >= net.w[p.i]) {
      p.k0 = 0;
      p.c0 += stack_nc(net.w[p.i + 1]);
      if (p.c0 >= net.w[p.i + 1]) {
        p.c0 = 0;
        ++p.i;
      }
    }
    return p;
  };
  const auto issue = [&](const Pos& p, float* st) {
    const float* W = params + net.woff[p.i];
    const int n = net.w[p.i + 1];
    const bool al16 = (reinterpret_cast<uintptr_t>(W) & 15) == 0 && (n & 3) == 0;
    stack_stage(W, n, al16, p.k0, kn_of(p), p.c0, stack_nc(n), st);
  };
  __syncthreads();
  Pos cur{0, 0, 0};
  if (layers > 0) issue(cur, stage);
  pre();
  for (int buf = 0; cur.i < layers; buf ^= 1) {
    const Pos nxt = next(cur);
    cp_wait<0>();
    __syncthreads();  // the chunk in place, the other half free, act(cur.i) complete
    if (nxt.i < layers) issue(nxt, stage + (buf ^ 1) * BUF);
    const int i = cur.i, n = net.w[i + 1], kn = kn_of(cur);
    const Act a = act(i), o = act(i + 1);
    stack_fma<2 * RPT>(a.p, a.ld, (a.ld & 3) == 0, cur.k0, kn, stage + buf * BUF, stack_nc(n),
                       cur.c0, n, params + net.boff[i], cur.k0 == 0, cur.k0 + kn >= net.w[i], o.p,
                       o.ld);
    cur = nxt;
  }
  __syncthreads();
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
