// Fused unique-vertex HPD tail at scaled table widths: forward and backward.
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/hpd_stream.py:
//   hpd_stream_fused_fwd (_fused_fwd_kernel):
//     logits = h w + b; m, s = row max and sum exp; exact top-K on the raw
//     logits, lowest index first among equal values; vals = exp(l - m) / s;
//     marg = counts @ p with p = exp(l - m) / s.
//   hpd_stream_fused_bwd (_fused_bwd_kernel):
//     G = p g_marg^T; dot_r = sum_l counts G + sum_k g_vals vals (second term
//     dropped under noop_topk); dl = p (g_p - dot_r) with
//     g_p = counts^T g_marg (+ top-K scatter of g_vals); dh = dl w^T,
//     dW = h^T dl, db = sum_rows dl.
//
// Bound on this card: operations. At the scaled shapes (U_c = 161,792,
// H = 128, T = 16,384) one logits product is 0.68 TFLOP, against 8 MB of
// weight and 83 MB of h. The TPU kernel caches a whole (512, T) fp32 row
// block (32 MB) in VMEM so the product runs once per direction; a Hopper
// block has 227 KB, so these kernels stream over 128-column tiles and
// recompute the logits in each pass instead:
//   forward  = fwd_rows (row-parallel: top-K, m, s) + fwd_cols
//              (column-parallel: marginal) + ordered reduce;
//   backward = bwd_rows (row-parallel: G, dot, then dl and dh) + bwd_cols
//              (column-parallel: dl, dW, db) + ordered reduce.
// Sums across row blocks (marg, dW, db) are written as per-segment partials
// over a fixed number of row segments and summed in segment order: no
// atomics, bitwise stable run to run. Products are fp32 FMA on the CUDA
// cores in shared-memory tiles (wgmma/TMA are later work).
#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int R = 64;       // rows per tile
constexpr int TT = 128;     // columns per tile
constexpr int BK = 32;      // contraction chunk of the logits product
constexpr int BC = 32;      // column chunk of the dh product
constexpr int HMAX = 128;   // widest head input
constexpr int HP = HMAX + 4;
constexpr int TP = TT + 1;  // padded tile row stride
constexpr int THREADS = 256;
constexpr int KMAX = 16;
constexpr int LMAX = 32;
constexpr int NSUB = 16;    // column sub-streams per row in fwd_rows
constexpr int SEGS = 8;     // row segments of the column-parallel kernels

int rows_per_seg(int u) {
  const int tiles = (u + R - 1) / R;
  return ((tiles + SEGS - 1) / SEGS) * R;
}

// h rows [r0, r0 + R) into h_s (R x HP), zero past `limit` and past H.
__device__ __forceinline__ void load_rows(const float* __restrict__ h, int limit, int H,
                                          int r0, float* __restrict__ h_s) {
  for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
    const int r = i / HMAX, k = i - r * HMAX;
    h_s[r * HP + k] = (r0 + r < limit && k < H) ? h[(size_t)(r0 + r) * H + k] : 0.f;
  }
}

// Logits of the tile rows x columns [t0, t0 + TT). Thread (ty, tx) holds
// rows ty*4 + i and columns tx + 16*j. Starts with a barrier.
template <int P>
__device__ __forceinline__ void tile_logits(const float* __restrict__ h_s,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int H, int T,
                                            int t0, float* __restrict__ w_s,
                                            float (&acc)[4][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * TT; i += THREADS) {
      const int kk = i / TT, c = i - kk * TT;
      w_s[i] = (k0 + kk < H) ? w[(size_t)(k0 + kk) * T + t0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = h_s[(ty * 4 + i) * HP + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = w_s[kk * TT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = pfma<P>(a[i], bb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bj = b[t0 + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] += bj;
  }
}

// ------------------------------- forward ---------------------------------- //

size_t fwd_rows_smem(int K) {
  return sizeof(float) * (R * HP + BK * TT + 2 * R * NSUB) + (size_t)R * NSUB * K * 8;
}

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

size_t fwd_cols_smem() {
  return sizeof(float) * (R * HP + BK * TT + R * TT + LMAX * R + 2 * R);
}

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
    for (int r = threadIdx.x; r < R; r += THREADS) {
      const bool ok = r0 + r < rend;
      m_s[r] = ok ? m_in[r0 + r] : INFINITY;  // p = 0 on rows past the segment
      s_s[r] = ok ? s_in[r0 + r] : 1.f;
    }
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
        float a = macc[q];
        for (int r = 0; r < R; ++r) a = pfma<P>(c_s[l * R + r], p_s[r * TT + c], a);
        macc[q] = a;
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
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const bool ok = r0 + r < limit;
    m_s[r] = ok ? m_in[r0 + r] : INFINITY;  // p = 0, so dl = 0, on rows past `limit`
    s_s[r] = ok ? s_in[r0 + r] : 1.f;
  }
}

size_t bwd_rows_smem() {
  return sizeof(float) * (R * HP + BK * TT + BC * (HMAX + 1) + R * TP + LMAX * TP +
                          2 * R * LMAX + 3 * R + 2 * R * KMAX);
}

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
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* wc_s = w_s + BK * TT;
  float* d_s = wc_s + BC * (HMAX + 1);
  float* gm_s = d_s + R * TP;
  float* cT_s = gm_s + LMAX * TP;
  float* gc_s = cT_s + R * LMAX;
  float* m_s = gc_s + R * LMAX;
  float* s_s = m_s + R;
  float* dot_s = s_s + R;
  float* kgv_s = dot_s + R;
  int* kidx_s = (int*)(kgv_s + R * KMAX);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, h_s);
  load_row_state(counts, idx, m_in, s_in, g_vals, u, u, L, K, r0, cT_s, m_s, s_s, kidx_s,
                 kgv_s);

  // sweep 1: G[r, l] = <p[r], g_marg[l]>, thread pairs e -> (r = e / L, l = e % L)
  constexpr int NG = R * LMAX / THREADS;
  float gacc[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q) gacc[q] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();
    for (int i = threadIdx.x; i < L * TT; i += THREADS) {
      const int l = i / TT, c = i - l * TT;
      gm_s[l * TP + c] = g_marg[(size_t)l * T + t0 + c];
    }
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
        float a = gacc[q];
        for (int c = 0; c < TT; ++c) a = pfma<P>(d_s[r * TP + c], gm_s[l * TP + c], a);
        gacc[q] = a;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int e = threadIdx.x + THREADS * q;
    if (e < R * L) {
      const int r = e / L, l = e - r * L;
      gc_s[r * LMAX + l] = cT_s[r * LMAX + l] * gacc[q];
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float d = 0.f;
    for (int l = 0; l < L; ++l) d += gc_s[r * LMAX + l];
    if (!noop && r0 + r < u) {
      float e = 0.f;
      for (int q = 0; q < K; ++q) e += kgv_s[r * KMAX + q] * vals[(size_t)(r0 + r) * K + q];
      d += e;
    }
    dot_s[r] = d;
    if (r0 + r < u) dot_out[r0 + r] = d;
  }

  // sweep 2: dl, then dh[r, :] += dl[r, tile] w[:, tile]^T
  float dacc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();
    for (int i = threadIdx.x; i < L * TT; i += THREADS) {
      const int l = i / TT, c = i - l * TT;
      gm_s[l * TP + c] = g_marg[(size_t)l * T + t0 + c];
    }
    float acc[4][8];
    tile_logits<P>(h_s, w, b, H, T, t0, w_s, acc);
    tile_dl<P>(acc, t0, L, K, noop, m_s, s_s, dot_s, cT_s, gm_s, kidx_s, kgv_s, d_s);
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
          for (int j = 0; j < 8; ++j) dacc[i][j] = pfma<P>(a[i], bw[j], dacc[i][j]);
      }
    }
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

size_t bwd_cols_smem() {
  return sizeof(float) * (R * HP + BK * TT + R * TP + LMAX * TP + R * LMAX + 3 * R +
                          2 * R * KMAX);
}

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
  for (int i = threadIdx.x; i < L * TT; i += THREADS) {
    const int l = i / TT, c = i - l * TT;
    gm_s[l * TP + c] = g_marg[(size_t)l * T + t0 + c];
  }
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
    for (int r = 0; r < R; ++r) {
      float a[8], dl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = h_s[r * HP + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) dl[j] = d_s[r * TP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) wacc[i][j] = pfma<P>(a[i], dl[j], wacc[i][j]);
    }
    if (threadIdx.x < TT)
      for (int r = 0; r < R; ++r) bacc += d_s[r * TP + threadIdx.x];
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

template <typename F>
void set_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

const char* hpd_stream_error_string(int code) { return port_error_string(code); }

int hpd_stream_segments() { return SEGS; }

// h (u, H), w (H, T), b (T), counts (L, u) -> marg (L, T), vals/idx (u, K),
// m/s (u). marg_part: (SEGS, L, T) scratch.
int hpd_fused_fwd(const float* h, const float* w, const float* b, const float* counts, int u,
                  int H, int T, int L, int K, int prec, float* marg, float* marg_part,
                  float* vals, int* idx, float* m, float* s, void* stream) {
  int err = check_shape(u, H, T, L, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (u == 0) return (int)cudaMemsetAsync(marg, 0, sizeof(float) * L * T, st);
  const int row_blocks = (u + R - 1) / R;
  const int seg_rows = rows_per_seg(u);
  const dim3 cols_grid(T / TT, SEGS);
  DISPATCH_PREC(prec, {
    set_smem(hpd_fwd_rows_kernel<P>, fwd_rows_smem(K));
    hpd_fwd_rows_kernel<P><<<row_blocks, THREADS, fwd_rows_smem(K), st>>>(h, w, b, u, H, T, K,
                                                                      vals, idx, m, s);
    err = (int)cudaGetLastError();
    if (err) return err;
    set_smem(hpd_fwd_cols_kernel<P>, fwd_cols_smem());
    hpd_fwd_cols_kernel<P><<<cols_grid, THREADS, fwd_cols_smem(), st>>>(
        h, w, b, counts, m, s, u, H, T, L, seg_rows, marg_part);
  });
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t n = (size_t)L * T;
  hpd_reduce_segments_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(marg_part, marg, n);
  return (int)cudaGetLastError();
}

// Residuals of hpd_fused_fwd plus g_marg (L, T), g_vals (u, K) -> dh (u, H),
// dw (H, T), db (T). Scratch: dot (u), dw_part (SEGS, H, T), db_part (SEGS, T).
int hpd_fused_bwd(const float* h, const float* w, const float* b, const float* counts,
                  const int* idx, const float* vals, const float* m, const float* s,
                  const float* g_marg, const float* g_vals, int u, int H, int T, int L, int K,
                  int noop, int prec, float* dh, float* dot, float* dw, float* db,
                  float* dw_part, float* db_part, void* stream) {
  int err = check_shape(u, H, T, L, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (u == 0) {
    err = (int)cudaMemsetAsync(dw, 0, sizeof(float) * H * T, st);
    if (err) return err;
    return (int)cudaMemsetAsync(db, 0, sizeof(float) * T, st);
  }
  const int row_blocks = (u + R - 1) / R;
  const int seg_rows = rows_per_seg(u);
  const dim3 cols_grid(T / TT, SEGS);
  DISPATCH_PREC(prec, {
    set_smem(hpd_bwd_rows_kernel<P>, bwd_rows_smem());
    hpd_bwd_rows_kernel<P><<<row_blocks, THREADS, bwd_rows_smem(), st>>>(
        h, w, b, counts, idx, vals, m, s, g_marg, g_vals, u, H, T, L, K, noop, dh, dot);
    err = (int)cudaGetLastError();
    if (err) return err;
    set_smem(hpd_bwd_cols_kernel<P>, bwd_cols_smem());
    hpd_bwd_cols_kernel<P><<<cols_grid, THREADS, bwd_cols_smem(), st>>>(
        h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop, seg_rows,
        dw_part, db_part);
  });
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t nw = (size_t)H * T;
  hpd_reduce_segments_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(dw_part, dw, nw);
  err = (int)cudaGetLastError();
  if (err) return err;
  hpd_reduce_segments_kernel<<<(unsigned)((T + 255) / 256), 256, 0, st>>>(db_part, db, (size_t)T);
  return (int)cudaGetLastError();
}

}  // extern "C"
