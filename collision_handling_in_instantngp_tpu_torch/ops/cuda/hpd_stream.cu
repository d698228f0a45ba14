// Unique-vertex HPD tail at scaled table widths: the fused pair (K1, K2)
// and the split kernels (K4, K5, K6) that the TPU runs past its fused gate,
// plus the measurement probe K7.
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/hpd_stream.py:
//   hpd_stream_select (K4): logits = h w + b tile by tile; m, s = row max and
//     sum exp; exact top-K on the raw logits, lowest index first among equal
//     values; vals = exp(l - m) / s.
//   hpd_stream_marginal (K5): p = exp(l - m) / s recomputed from m, s;
//     marg = counts @ p (unnormalized).
//   hpd_stream_fused_fwd (K1): K4 then K5 in one call.
//   hpd_stream_fused_bwd (K2), hpd_tail_unique_pallas_bwd (K6):
//     G = p g_marg^T; dot_r = sum_l counts G + sum_k g_vals vals (second term
//     dropped under noop_topk); dl = p (g_p - dot_r) with
//     g_p = counts^T g_marg (+ top-K scatter of g_vals); dh = dl w^T,
//     dW = h^T dl, db = sum_rows dl. K2 closes dot inside its row kernel;
//     K6 runs two launches, B1 (G) and B2 (dl, dh, dW, db), with dot closed
//     by the caller between them, as the TPU's split kernel does.
//   hpd_stream_fused_probe (K7): the rows pass with its later phases
//     removed, so that rung differences time each phase in place: "dots"
//     m = s = sum of the logits; "softmax" m, s = row max and sum exp.
//
// The TPU's two forms differ in what they keep in VMEM: the fused pair
// caches a (512, T) fp32 row block (32 MB) and the head, so its product runs
// once per direction. A Hopper block has 227 KB, so here both forms stream
// 128-column tiles of the logits and recompute them in each pass, and they
// share every pass:
//   rows pass     (hpd_fwd_rows_kernel): online max / sum-exp and the exact
//                 top-K on raw logits, lowest index first -> vals, idx, m, s.
//                 K1's first pass; all of K4.
//   columns pass  (hpd_fwd_cols_kernel): p = exp(l - m) / s, marginal
//                 counts @ p per row segment. K1's second pass; all of K5.
//   g_sweep       G[r, l] = <p[r], g_marg[l]>. K2's row pass, K6's B1.
//   dh_sweep      dl = p (g_p - dot), dh = dl w^T. K2's row pass, K6's B2.
//   bwd columns   (hpd_bwd_cols_kernel): dl, dW = h^T dl, db per row
//                 segment. K2's and K6-B2's column pass.
// Sums across row blocks (marg, dW, db) go to per-segment partials over a
// fixed number of row segments, summed in segment order by
// hpd_reduce_segments_kernel: no atomics, bitwise stable run to run. Every
// long sum is taken in two levels, a partial per tile (64 rows or 128
// columns) added to the running total, so no fp32 chain runs over a whole
// segment (20,224 rows at U_c = 161,792) or over T.
//
// Bound on this card: operations (fp32 FMA on the CUDA cores in
// shared-memory tiles; wgmma/TMA are later work). At H = 128, T = 2^16,
// U_c = 161,792 one logits product is 2.7 TFLOP against 32 MB of weight.
// K4, K5 and B1 each compute the logits once, as the TPU's split kernels do;
// B2 computes them twice (its row and its column part) where the TPU's runs
// once.

#include <float.h>
#include <limits.h>

#include "stream_tile.cuh"

namespace {

constexpr int BC = 32;      // column chunk of the dh product
constexpr int TP = TT + 1;  // padded tile row stride
constexpr int KMAX = 16;
constexpr int LMAX = 32;
// Row segments of the column-parallel kernels. Each holds a (L, T), (H, T)
// and (T,) partial: at H = 128, T = 2^16 the dW partials take 8 x 32 MB.
constexpr int SEGS = 8;
constexpr int NG = R * LMAX / THREADS;  // (row, level) pairs per thread in g_sweep

int rows_per_seg(int u) {
  const int tiles = (u + R - 1) / R;
  return ((tiles + SEGS - 1) / SEGS) * R;
}

// Row statistics of rows [r0, r0 + R): p = 0 on rows past `limit` (m = inf);
// s <= 0 reads as 1, as the TPU kernels pad s, so such a row's p stays finite
// and a zero count times it adds exactly 0.
__device__ __forceinline__ void load_ms(const float* __restrict__ m_in,
                                        const float* __restrict__ s_in, int limit, int r0,
                                        float* __restrict__ m_s, float* __restrict__ s_s) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const bool ok = r0 + r < limit;
    const float s = ok ? s_in[r0 + r] : 1.f;
    m_s[r] = ok ? m_in[r0 + r] : INFINITY;
    s_s[r] = s > 0.f ? s : 1.f;
  }
}

// ------------------------------- forward ---------------------------------- //

size_t fwd_rows_smem(int K) {
  return sizeof(float) * (R * HP + BK * TT + 2 * R * NSUB) + (size_t)R * NSUB * K * 8;
}

// One block per R rows sweeps every column tile: online max / sum-exp and,
// per (row, 16-column sub-stream), a sorted top-K list; the block then merges
// the NSUB lists of each row by (value desc, index asc).
template <int P>
__global__ void __launch_bounds__(THREADS)
hpd_fwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, int u, int H, int T, int K,
                    float* __restrict__ vals, int* __restrict__ idx,
                    float* __restrict__ m_out, float* __restrict__ s_out) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* pm = w_s + BK * TT;
  float* ps = pm + R * NSUB;
  float* lv = ps + R * NSUB;
  int* li = (int*)(lv + R * NSUB * K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, h_s);

  // per (row, tx) column sub-stream: online max / sum-exp and a sorted
  // top-K list (value descending, index ascending)
  float mrun[4], srun[4], thr[4];
  int cnt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrun[i] = -INFINITY;
    srun[i] = 0.f;
    thr[i] = -INFINITY;
    cnt[i] = 0;
  }
  for (int t0 = 0; t0 < T; t0 += TT) {
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, acc[i][j]);
      const float mnew = fmaxf(mrun[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(acc[i][j] - mnew);
      srun[i] = srun[i] * expf(mrun[i] - mnew) + sum;
      mrun[i] = mnew;
      // columns arrive in increasing index order, so inserting after every
      // entry of equal value keeps the lowest index first
      float* lvr = lv + ((ty * 4 + i) * NSUB + tx) * K;
      int* lir = li + ((ty * 4 + i) * NSUB + tx) * K;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[i][j];
        if (cnt[i] < K || v > thr[i]) {
          int pos = cnt[i] < K ? cnt[i] : K - 1;
          while (pos > 0 && lvr[pos - 1] < v) {
            lvr[pos] = lvr[pos - 1];
            lir[pos] = lir[pos - 1];
            --pos;
          }
          lvr[pos] = v;
          lir[pos] = t0 + tx + 16 * j;
          if (cnt[i] < K) ++cnt[i];
          thr[i] = cnt[i] == K ? lvr[K - 1] : -INFINITY;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sub = (ty * 4 + i) * NSUB + tx;
    pm[sub] = mrun[i];
    ps[sub] = srun[i];
    for (int q = cnt[i]; q < K; ++q) {
      lv[sub * K + q] = -INFINITY;
      li[sub * K + q] = INT_MAX;
    }
  }
  __syncthreads();
  if (threadIdx.x < R && r0 + threadIdx.x < u) {
    const int r = threadIdx.x;
    float m = -INFINITY;
    for (int sub = 0; sub < NSUB; ++sub) m = fmaxf(m, pm[r * NSUB + sub]);
    float s = 0.f;
    for (int sub = 0; sub < NSUB; ++sub) s += ps[r * NSUB + sub] * expf(pm[r * NSUB + sub] - m);
    int pos[NSUB];
    for (int sub = 0; sub < NSUB; ++sub) pos[sub] = 0;
    const size_t row = (size_t)(r0 + r);
    for (int q = 0; q < K; ++q) {
      int best = 0;
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int sub = 0; sub < NSUB; ++sub) {
        if (pos[sub] >= K) continue;
        const int e = (r * NSUB + sub) * K + pos[sub];
        const float v = lv[e];
        const int ii = li[e];
        if (v > bv || (v == bv && ii < bi)) {
          best = sub;
          bv = v;
          bi = ii;
        }
      }
      ++pos[best];
      vals[row * K + q] = expf(bv - m) / s;
      idx[row * K + q] = bi;
    }
    m_out[row] = m;
    s_out[row] = s;
  }
}

size_t probe_smem() { return sizeof(float) * (R * HP + BK * TT + 2 * R * NSUB); }

// K7: the rows pass with its later phases removed. Softmax keeps the online
// max / sum-exp per (row, sub-stream) and the NSUB merge; DOTS keeps only a
// sum of the logits, per tile first, then across the NSUB sub-streams in
// order (m = s = that sum).
template <int P, bool DOTS>
__global__ void __launch_bounds__(THREADS)
hpd_probe_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ b, int u, int H, int T,
                 float* __restrict__ m_out, float* __restrict__ s_out) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* pm = w_s + BK * TT;
  float* ps = pm + R * NSUB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, h_s);

  float mrun[4], srun[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrun[i] = -INFINITY;
    srun[i] = 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += TT) {
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (DOTS) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += acc[i][j];
        srun[i] += sum;
      } else {
        float tmax = acc[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, acc[i][j]);
        const float mnew = fmaxf(mrun[i], tmax);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += expf(acc[i][j] - mnew);
        srun[i] = srun[i] * expf(mrun[i] - mnew) + sum;
        mrun[i] = mnew;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sub = (ty * 4 + i) * NSUB + tx;
    pm[sub] = mrun[i];
    ps[sub] = srun[i];
  }
  __syncthreads();
  if (threadIdx.x < R && r0 + threadIdx.x < u) {
    const int r = threadIdx.x;
    float m = -INFINITY, s = 0.f;
    if (DOTS) {
      for (int sub = 0; sub < NSUB; ++sub) s += ps[r * NSUB + sub];
      m = s;
    } else {
      for (int sub = 0; sub < NSUB; ++sub) m = fmaxf(m, pm[r * NSUB + sub]);
      for (int sub = 0; sub < NSUB; ++sub) s += ps[r * NSUB + sub] * expf(pm[r * NSUB + sub] - m);
    }
    m_out[r0 + r] = m;
    s_out[r0 + r] = s;
  }
}

size_t fwd_cols_smem() {
  return sizeof(float) * (R * HP + BK * TT + R * TT + LMAX * R + 2 * R);
}

// Grid (T / TT, SEGS): one block per column tile and row segment sums
// counts @ p over the segment's rows into marg_part[seg].
template <int P>
__global__ void __launch_bounds__(THREADS)
hpd_fwd_cols_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const float* __restrict__ m_in, const float* __restrict__ s_in, int u,
                    int H, int T, int L, int seg_rows, float* __restrict__ marg_part) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* p_s = w_s + BK * TT;
  float* c_s = p_s + R * TT;
  float* m_s = c_s + LMAX * R;
  float* s_s = m_s + R;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * TT;
  const int seg = blockIdx.y;
  const int rbeg = seg * seg_rows;
  const int rend = min(u, rbeg + seg_rows);
  constexpr int NQ = LMAX * TT / THREADS;
  float macc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) macc[q] = 0.f;
  for (int r0 = rbeg; r0 < rend; r0 += R) {
    __syncthreads();
    load_rows(h, rend, H, r0, h_s);
    for (int i = threadIdx.x; i < LMAX * R; i += THREADS) {
      const int l = i / R, r = i - l * R;
      c_s[i] = (l < L && r0 + r < rend) ? counts[(size_t)l * u + r0 + r] : 0.f;
    }
    load_ms(m_in, s_in, rend, r0, m_s, s_s);
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float mr = m_s[row], sr = s_s[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) p_s[row * TT + tx + 16 * j] = expf(acc[i][j] - mr) / sr;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = threadIdx.x + THREADS * q;
      const int l = e / TT, c = e - l * TT;
      if (l < L) {
        float a = 0.f;
        for (int r = 0; r < R; ++r) a = pfma<P>(c_s[l * R + r], p_s[r * TT + c], a);
        macc[q] += a;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int e = threadIdx.x + THREADS * q;
    const int l = e / TT, c = e - l * TT;
    if (l < L) marg_part[((size_t)seg * L + l) * T + t0 + c] = macc[q];
  }
}

// out[i] = sum over segments in order of part[seg * n + i]
__global__ void hpd_reduce_segments_kernel(const float* __restrict__ part, float* __restrict__ out,
                                           size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int seg = 0; seg < SEGS; ++seg) s += part[(size_t)seg * n + i];
  out[i] = s;
}

int reduce_segments(const float* part, float* out, size_t n, cudaStream_t st) {
  hpd_reduce_segments_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out, n);
  return (int)cudaGetLastError();
}

// ------------------------------- backward --------------------------------- //

// dl of the tile into d_s (R x TP): p (g_p - dot) with
// g_p = counts^T g_marg (+ top-K scatter of g_vals unless noop).
template <int P>
__device__ __forceinline__ void tile_dl(const float (&acc)[4][8], int t0, int L, int K,
                                        int noop, const float* __restrict__ m_s,
                                        const float* __restrict__ s_s,
                                        const float* __restrict__ dot_s,
                                        const float* __restrict__ cT_s,
                                        const float* __restrict__ gm_s,
                                        const int* __restrict__ kidx_s,
                                        const float* __restrict__ kgv_s,
                                        float* __restrict__ d_s) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const float mr = m_s[row], sr = s_s[row], dr = dot_s[row];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      const float p = expf(acc[i][j] - mr) / sr;
      float gp = 0.f;
      for (int l = 0; l < L; ++l) gp = pfma<P>(cT_s[row * LMAX + l], gm_s[l * TP + col], gp);
      if (!noop)
        for (int q = 0; q < K; ++q)
          if (kidx_s[row * KMAX + q] == t0 + col) gp += kgv_s[row * KMAX + q];
      d_s[row * TP + col] = p * (gp - dr);
    }
  }
}

// Per-row residuals of the tile rows [r0, r0 + R) below `limit`.
__device__ __forceinline__ void load_row_state(
    const float* __restrict__ counts, const int* __restrict__ idx,
    const float* __restrict__ m_in, const float* __restrict__ s_in,
    const float* __restrict__ g_vals, int u, int limit, int L, int K, int r0,
    float* __restrict__ cT_s, float* __restrict__ m_s, float* __restrict__ s_s,
    int* __restrict__ kidx_s, float* __restrict__ kgv_s) {
  for (int i = threadIdx.x; i < R * LMAX; i += THREADS) {
    const int l = i / R, r = i - l * R;
    cT_s[r * LMAX + l] = (l < L && r0 + r < limit) ? counts[(size_t)l * u + r0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < R * KMAX; i += THREADS) {
    const int r = i / KMAX, q = i - r * KMAX;
    const bool ok = q < K && r0 + r < limit;
    kidx_s[i] = ok ? idx[(size_t)(r0 + r) * K + q] : -1;
    kgv_s[i] = ok ? g_vals[(size_t)(r0 + r) * K + q] : 0.f;
  }
  load_ms(m_in, s_in, limit, r0, m_s, s_s);
}

// g_marg columns [t0, t0 + TT) into gm_s (L x TP).
__device__ __forceinline__ void load_gm(const float* __restrict__ g_marg, int T, int L, int t0,
                                        float* __restrict__ gm_s) {
  for (int i = threadIdx.x; i < L * TT; i += THREADS) {
    const int l = i / TT, c = i - l * TT;
    gm_s[l * TP + c] = g_marg[(size_t)l * T + t0 + c];
  }
}

// G[r, l] = <p[r], g_marg[l]> of the block's rows over every column tile.
// Thread pairs e = threadIdx.x + THREADS * q -> (r = e / L, l = e % L).
template <int P>
__device__ __forceinline__ void g_sweep(const float* __restrict__ h_s,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        const float* __restrict__ g_marg, int H, int T, int L,
                                        const float* __restrict__ m_s,
                                        const float* __restrict__ s_s, float* __restrict__ w_s,
                                        float* __restrict__ d_s, float* __restrict__ gm_s,
                                        float (&gacc)[NG]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int q = 0; q < NG; ++q) gacc[q] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();
    load_gm(g_marg, T, L, t0, gm_s);
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d_s[row * TP + tx + 16 * j] = expf(acc[i][j] - m_s[row]) / s_s[row];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int e = threadIdx.x + THREADS * q;
      if (e < R * L) {
        const int r = e / L, l = e - r * L;
        float a = 0.f;
        for (int c = 0; c < TT; ++c) a = pfma<P>(d_s[r * TP + c], gm_s[l * TP + c], a);
        gacc[q] += a;
      }
    }
  }
}

// dh[r, :] = sum over column tiles of dl[r, tile] w[:, tile]^T, dl from
// tile_dl with the block's dot_s; written to dh for rows below u.
template <int P>
__device__ __forceinline__ void dh_sweep(
    const float* __restrict__ h_s, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ g_marg, int u, int r0, int H, int T, int L, int K, int noop,
    const float* __restrict__ m_s, const float* __restrict__ s_s,
    const float* __restrict__ dot_s, const float* __restrict__ cT_s,
    const int* __restrict__ kidx_s, const float* __restrict__ kgv_s, float* __restrict__ w_s,
    float* __restrict__ wc_s, float* __restrict__ d_s, float* __restrict__ gm_s,
    float* __restrict__ dh) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float dacc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();
    load_gm(g_marg, T, L, t0, gm_s);
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
    tile_dl<P>(acc, t0, L, K, noop, m_s, s_s, dot_s, cT_s, gm_s, kidx_s, kgv_s, d_s);
    float tacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) tacc[i][j] = 0.f;
    for (int c0 = 0; c0 < TT; c0 += BC) {
      __syncthreads();
      for (int i = threadIdx.x; i < HMAX * BC; i += THREADS) {
        const int hh = i / BC, cc = i - hh * BC;
        wc_s[cc * (HMAX + 1) + hh] = hh < H ? w[(size_t)hh * T + t0 + c0 + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < BC; ++cc) {
        float a[4], bw[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = d_s[(ty * 4 + i) * TP + c0 + cc];
#pragma unroll
        for (int j = 0; j < 8; ++j) bw[j] = wc_s[cc * (HMAX + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) tacc[i][j] = pfma<P>(a[i], bw[j], tacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dacc[i][j] += tacc[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= u) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hh = tx + 16 * j;
      if (hh < H) dh[(size_t)row * H + hh] = dacc[i][j];
    }
  }
}

// Shared memory of a row-parallel backward kernel (g_sweep and dh_sweep).
size_t bwd_rows_smem() {
  return sizeof(float) * (R * HP + BK * TT + BC * (HMAX + 1) + R * TP + LMAX * TP +
                          2 * R * LMAX + 3 * R + 2 * R * KMAX);
}

// The carve-up of bwd_rows_smem().
struct BwdRowsSmem {
  float *h_s, *w_s, *wc_s, *d_s, *gm_s, *cT_s, *gc_s, *m_s, *s_s, *dot_s, *kgv_s;
  int* kidx_s;
  __device__ explicit BwdRowsSmem(float* smem) {
    h_s = smem;
    w_s = h_s + R * HP;
    wc_s = w_s + BK * TT;
    d_s = wc_s + BC * (HMAX + 1);
    gm_s = d_s + R * TP;
    cT_s = gm_s + LMAX * TP;
    gc_s = cT_s + R * LMAX;
    m_s = gc_s + R * LMAX;
    s_s = m_s + R;
    dot_s = s_s + R;
    kgv_s = dot_s + R;
    kidx_s = (int*)(kgv_s + R * KMAX);
  }
};

size_t bwd_cols_smem() {
  return sizeof(float) * (R * HP + BK * TT + R * TP + LMAX * TP + R * LMAX + 3 * R +
                          2 * R * KMAX);
}

// Grid (T / TT, SEGS): one block per column tile and row segment sums
// dW = h^T dl and db over the segment's rows into dw_part / db_part[seg].
template <int P>
__global__ void __launch_bounds__(THREADS)
hpd_bwd_cols_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const int* __restrict__ idx, const float* __restrict__ m_in,
                    const float* __restrict__ s_in, const float* __restrict__ dot_in,
                    const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                    int H, int T, int L, int K, int noop, int seg_rows,
                    float* __restrict__ dw_part, float* __restrict__ db_part) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* d_s = w_s + BK * TT;
  float* gm_s = d_s + R * TP;
  float* cT_s = gm_s + LMAX * TP;
  float* m_s = cT_s + R * LMAX;
  float* s_s = m_s + R;
  float* dot_s = s_s + R;
  float* kgv_s = dot_s + R;
  int* kidx_s = (int*)(kgv_s + R * KMAX);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * TT;
  const int seg = blockIdx.y;
  const int rbeg = seg * seg_rows;
  const int rend = min(u, rbeg + seg_rows);
  load_gm(g_marg, T, L, t0, gm_s);
  // thread owns dW rows ty*8 + i and columns tx + 16*j; db column threadIdx.x
  float wacc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) wacc[i][j] = 0.f;
  float bacc = 0.f;
  for (int r0 = rbeg; r0 < rend; r0 += R) {
    __syncthreads();
    load_rows(h, rend, H, r0, h_s);
    load_row_state(counts, idx, m_in, s_in, g_vals, u, rend, L, K, r0, cT_s, m_s, s_s,
                   kidx_s, kgv_s);
    for (int r = threadIdx.x; r < R; r += THREADS) dot_s[r] = r0 + r < rend ? dot_in[r0 + r] : 0.f;
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
    tile_dl<P>(acc, t0, L, K, noop, m_s, s_s, dot_s, cT_s, gm_s, kidx_s, kgv_s, d_s);
    __syncthreads();
    float tacc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) tacc[i][j] = 0.f;
    for (int r = 0; r < R; ++r) {
      float a[8], dl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = h_s[r * HP + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) dl[j] = d_s[r * TP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) tacc[i][j] = pfma<P>(a[i], dl[j], tacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) wacc[i][j] += tacc[i][j];
    if (threadIdx.x < TT) {
      float tb = 0.f;
      for (int r = 0; r < R; ++r) tb += d_s[r * TP + threadIdx.x];
      bacc += tb;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int hh = ty * 8 + i;
    if (hh >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dw_part[((size_t)seg * H + hh) * T + t0 + tx + 16 * j] = wacc[i][j];
  }
  if (threadIdx.x < TT) db_part[(size_t)seg * T + t0 + threadIdx.x] = bacc;
}

int check_shape(int u, int H, int T, int L, int K) {
  if (u < 0 || H < 1 || H > HMAX || T < TT || T % TT != 0 || L < 1 || L > LMAX ||
      K < 1 || K > KMAX)
    return ERR_SHAPE;
  return 0;
}

// ------------------------- launches shared by K1-K6 ------------------------ //

// Rows pass: vals, idx (u, K), m, s (u).
int launch_select(const float* h, const float* w, const float* b, int u, int H, int T, int K,
                  int prec, float* vals, int* idx, float* m, float* s, cudaStream_t st) {
  if (u == 0) return 0;
  const int row_blocks = (u + R - 1) / R;
  DISPATCH_PREC(prec, {
    set_smem(hpd_fwd_rows_kernel<P>, fwd_rows_smem(K));
    hpd_fwd_rows_kernel<P><<<row_blocks, THREADS, fwd_rows_smem(K), st>>>(h, w, b, u, H, T, K,
                                                                      vals, idx, m, s);
  });
  return (int)cudaGetLastError();
}

// Columns pass and its ordered reduce: marg (L, T). marg_part: (SEGS, L, T).
int launch_marginal(const float* h, const float* w, const float* b, const float* counts,
                    const float* m, const float* s, int u, int H, int T, int L, int prec,
                    float* marg, float* marg_part, cudaStream_t st) {
  if (u == 0) return (int)cudaMemsetAsync(marg, 0, sizeof(float) * L * T, st);
  const dim3 cols_grid(T / TT, SEGS);
  DISPATCH_PREC(prec, {
    set_smem(hpd_fwd_cols_kernel<P>, fwd_cols_smem());
    hpd_fwd_cols_kernel<P><<<cols_grid, THREADS, fwd_cols_smem(), st>>>(
        h, w, b, counts, m, s, u, H, T, L, rows_per_seg(u), marg_part);
  });
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_segments(marg_part, marg, (size_t)L * T, st);
}

// Backward columns pass and its ordered reduces: dw (H, T), db (T) from the
// per-row dot. Scratch dw_part (SEGS, H, T), db_part (SEGS, T).
int launch_bwd_cols(const float* h, const float* w, const float* b, const float* counts,
                    const int* idx, const float* m, const float* s, const float* dot,
                    const float* g_marg, const float* g_vals, int u, int H, int T, int L,
                    int K, int noop, int prec, float* dw, float* db, float* dw_part,
                    float* db_part, cudaStream_t st) {
  if (u == 0) {
    const int err = (int)cudaMemsetAsync(dw, 0, sizeof(float) * H * T, st);
    if (err) return err;
    return (int)cudaMemsetAsync(db, 0, sizeof(float) * T, st);
  }
  const dim3 cols_grid(T / TT, SEGS);
  DISPATCH_PREC(prec, {
    set_smem(hpd_bwd_cols_kernel<P>, bwd_cols_smem());
    hpd_bwd_cols_kernel<P><<<cols_grid, THREADS, bwd_cols_smem(), st>>>(
        h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop, rows_per_seg(u),
        dw_part, db_part);
  });
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = reduce_segments(dw_part, dw, (size_t)H * T, st);
  if (err) return err;
  return reduce_segments(db_part, db, (size_t)T, st);
}

// Row-parallel backward: G by g_sweep, dot closed in the block, then dh.
template <int P>
__global__ void __launch_bounds__(THREADS)
hpd_bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const int* __restrict__ idx, const float* __restrict__ vals,
                    const float* __restrict__ m_in, const float* __restrict__ s_in,
                    const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                    int H, int T, int L, int K, int noop, float* __restrict__ dh,
                    float* __restrict__ dot_out) {
  extern __shared__ float smem[];
  const BwdRowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, sm.h_s);
  load_row_state(counts, idx, m_in, s_in, g_vals, u, u, L, K, r0, sm.cT_s, sm.m_s, sm.s_s,
                 sm.kidx_s, sm.kgv_s);

  float gacc[NG];
  g_sweep<P>(sm.h_s, w, b, g_marg, H, T, L, sm.m_s, sm.s_s, sm.w_s, sm.d_s, sm.gm_s, gacc);
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int e = threadIdx.x + THREADS * q;
    if (e < R * L) {
      const int r = e / L, l = e - r * L;
      sm.gc_s[r * LMAX + l] = sm.cT_s[r * LMAX + l] * gacc[q];
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float d = 0.f;
    for (int l = 0; l < L; ++l) d += sm.gc_s[r * LMAX + l];
    if (!noop && r0 + r < u) {
      float e = 0.f;
      for (int q = 0; q < K; ++q) e += sm.kgv_s[r * KMAX + q] * vals[(size_t)(r0 + r) * K + q];
      d += e;
    }
    sm.dot_s[r] = d;
    if (r0 + r < u) dot_out[r0 + r] = d;
  }

  dh_sweep<P>(sm.h_s, w, b, g_marg, u, r0, H, T, L, K, noop, sm.m_s, sm.s_s, sm.dot_s, sm.cT_s,
              sm.kidx_s, sm.kgv_s, sm.w_s, sm.wc_s, sm.d_s, sm.gm_s, dh);
}

size_t b1_smem() { return sizeof(float) * (R * HP + BK * TT + R * TP + LMAX * TP + 2 * R); }

// B1: G[r, l] = <p[r], g_marg[l]> for the block's R rows.
template <int P>
__global__ void __launch_bounds__(THREADS)
hpd_b1_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ m_in,
              const float* __restrict__ s_in, const float* __restrict__ g_marg, int u, int H,
              int T, int L, float* __restrict__ g_rows) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* d_s = w_s + BK * TT;
  float* gm_s = d_s + R * TP;
  float* m_s = gm_s + LMAX * TP;
  float* s_s = m_s + R;
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, h_s);
  load_ms(m_in, s_in, u, r0, m_s, s_s);
  float gacc[NG];
  g_sweep<P>(h_s, w, b, g_marg, H, T, L, m_s, s_s, w_s, d_s, gm_s, gacc);
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int e = threadIdx.x + THREADS * q;
    if (e < R * L) {
      const int r = e / L, l = e - r * L;
      if (r0 + r < u) g_rows[(size_t)(r0 + r) * L + l] = gacc[q];
    }
  }
}

// B2, row-parallel part: dh from the given per-row dot.
template <int P>
__global__ void __launch_bounds__(THREADS)
hpd_b2_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ counts,
                   const int* __restrict__ idx, const float* __restrict__ m_in,
                   const float* __restrict__ s_in, const float* __restrict__ dot_in,
                   const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                   int H, int T, int L, int K, int noop, float* __restrict__ dh) {
  extern __shared__ float smem[];
  const BwdRowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, sm.h_s);
  load_row_state(counts, idx, m_in, s_in, g_vals, u, u, L, K, r0, sm.cT_s, sm.m_s, sm.s_s,
                 sm.kidx_s, sm.kgv_s);
  for (int r = threadIdx.x; r < R; r += THREADS) sm.dot_s[r] = r0 + r < u ? dot_in[r0 + r] : 0.f;
  dh_sweep<P>(sm.h_s, w, b, g_marg, u, r0, H, T, L, K, noop, sm.m_s, sm.s_s, sm.dot_s, sm.cT_s,
              sm.kidx_s, sm.kgv_s, sm.w_s, sm.wc_s, sm.d_s, sm.gm_s, dh);
}

}  // namespace

extern "C" {

const char* hpd_stream_error_string(int code) { return port_error_string(code); }

int hpd_stream_segments() { return SEGS; }

// Rows pass (K4, K1's first): h (u, H), w (H, T), b (T) -> vals/idx (u, K),
// m/s (u).
int hpd_select(const float* h, const float* w, const float* b, int u, int H, int T, int K,
               int prec, float* vals, int* idx, float* m, float* s, void* stream) {
  const int err = check_shape(u, H, T, 1, K);
  if (err) return err;
  return launch_select(h, w, b, u, H, T, K, prec, vals, idx, m, s, (cudaStream_t)stream);
}

// K7: h (u, H), w (H, T), b (T) -> m, s (u). dots = 1: m = s = the row sum
// of the logits; dots = 0: row max and sum of exp(logit - m).
int hpd_probe(const float* h, const float* w, const float* b, int u, int H, int T, int prec,
              int dots, float* m, float* s, void* stream) {
  const int err = check_shape(u, H, T, 1, 1);
  if (err || u == 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_blocks = (u + R - 1) / R;
  DISPATCH_PREC(prec, {
    if (dots) {
      set_smem(hpd_probe_kernel<P, true>, probe_smem());
      hpd_probe_kernel<P, true><<<row_blocks, THREADS, probe_smem(), st>>>(h, w, b, u, H, T, m, s);
    } else {
      set_smem(hpd_probe_kernel<P, false>, probe_smem());
      hpd_probe_kernel<P, false><<<row_blocks, THREADS, probe_smem(), st>>>(h, w, b, u, H, T, m,
                                                                           s);
    }
  });
  return (int)cudaGetLastError();
}

// Columns pass (K5, K1's second): + counts (L, u), m/s (u) -> marg (L, T).
// marg_part: (SEGS, L, T) scratch.
int hpd_marginal(const float* h, const float* w, const float* b, const float* counts,
                 const float* m, const float* s, int u, int H, int T, int L, int prec,
                 float* marg, float* marg_part, void* stream) {
  const int err = check_shape(u, H, T, L, 1);
  if (err) return err;
  return launch_marginal(h, w, b, counts, m, s, u, H, T, L, prec, marg, marg_part,
                         (cudaStream_t)stream);
}

// K2: residuals of the forward plus g_marg (L, T), g_vals (u, K) -> dh (u, H),
// dw (H, T), db (T). Scratch: dot (u), dw_part (SEGS, H, T), db_part (SEGS, T).
int hpd_fused_bwd(const float* h, const float* w, const float* b, const float* counts,
                  const int* idx, const float* vals, const float* m, const float* s,
                  const float* g_marg, const float* g_vals, int u, int H, int T, int L, int K,
                  int noop, int prec, float* dh, float* dot, float* dw, float* db,
                  float* dw_part, float* db_part, void* stream) {
  int err = check_shape(u, H, T, L, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (u > 0) {
    const int row_blocks = (u + R - 1) / R;
    DISPATCH_PREC(prec, {
      set_smem(hpd_bwd_rows_kernel<P>, bwd_rows_smem());
      hpd_bwd_rows_kernel<P><<<row_blocks, THREADS, bwd_rows_smem(), st>>>(
          h, w, b, counts, idx, vals, m, s, g_marg, g_vals, u, H, T, L, K, noop, dh, dot);
    });
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_bwd_cols(h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop,
                         prec, dw, db, dw_part, db_part, st);
}

// K6-B1: h, w, b, m/s (u), g_marg (L, T) -> g_rows (u, L).
int hpd_unique_bwd_g(const float* h, const float* w, const float* b, const float* m,
                     const float* s, const float* g_marg, int u, int H, int T, int L, int prec,
                     float* g_rows, void* stream) {
  const int err = check_shape(u, H, T, L, 1);
  if (err || u == 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_PREC(prec, {
    set_smem(hpd_b1_kernel<P>, b1_smem());
    hpd_b1_kernel<P><<<(u + R - 1) / R, THREADS, b1_smem(), st>>>(h, w, b, m, s, g_marg, u, H, T,
                                                                  L, g_rows);
  });
  return (int)cudaGetLastError();
}

// K6-B2: residuals, dot (u), g_marg (L, T), g_vals (u, K) -> dh (u, H),
// dw (H, T), db (T). Scratch: dw_part (SEGS, H, T), db_part (SEGS, T).
int hpd_unique_bwd_main(const float* h, const float* w, const float* b, const float* counts,
                        const int* idx, const float* m, const float* s, const float* dot,
                        const float* g_marg, const float* g_vals, int u, int H, int T, int L,
                        int K, int noop, int prec, float* dh, float* dw, float* db,
                        float* dw_part, float* db_part, void* stream) {
  int err = check_shape(u, H, T, L, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (u > 0) {
    DISPATCH_PREC(prec, {
      set_smem(hpd_b2_rows_kernel<P>, bwd_rows_smem());
      hpd_b2_rows_kernel<P><<<(u + R - 1) / R, THREADS, bwd_rows_smem(), st>>>(
          h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop, dh);
    });
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_bwd_cols(h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop,
                         prec, dw, db, dw_part, db_part, st);
}

}  // extern "C"
