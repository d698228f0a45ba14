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
// The three backward passes run their products on the tensor cores (see
// "backward, on the tensor cores" below); the forward passes keep fp32 FMA
// on the CUDA cores (stream_tile.cuh), whose exact logits decide top-K.
// Sums across row blocks (marg, dW, db) go to per-segment partials over a
// fixed number of row segments, summed in segment order by
// hpd_reduce_segments_kernel: no atomics, bitwise stable run to run. Every
// long sum is taken in two levels, a partial per tile (64 rows or 128
// columns) added to the running total, so no fp32 chain runs over a whole
// segment (20,224 rows at U_c = 161,792) or over T.
//
// Bound on this card: operations. At H = 128, T = 2^16, U_c = 161,792 one
// logits product is 2.7 TFLOP against 32 MB of weight: 40 ms at the fp32
// CUDA-core peak (the forward), 16 ms as 3xTF32 at the TF32 tensor peak
// (the backward, five such products).
// K4, K5 and B1 each compute the logits once, as the TPU's split kernels do;
// B2 computes them twice (its row and its column part) where the TPU's runs
// once.

#include <float.h>
#include <limits.h>

#include "stream_tile.cuh"

namespace {

constexpr int KMAX = 16;
constexpr int LMAX = 32;
// Row segments of the column-parallel kernels. Each holds a (L, T), (H, T)
// and (T,) partial: at H = 128, T = 2^16 the dW partials take 8 x 32 MB.
constexpr int SEGS = 8;

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

// ------------------------ backward, on the tensor cores --------------------- //
//
// K2 and K6 compute one function; their launches share three passes:
//   G sweep   G[r, l] = <p[r], g_marg[l]> over every column tile
//             (K6's B1; K2's row kernel, which then closes dot in the block)
//   dh sweep  dl = p (g_p - dot) + top-K scatter, dh = dl w^T over every
//             column tile (K6's B2 row kernel; K2's row kernel)
//   columns   dl again per row tile of a segment, dW = h^T dl, db
//             (hpd_bwd_cols_kernel, both)
// Every product (the logits, G = p g_marg^T, g_p = counts^T g_marg, dh, dW)
// runs on the tensor cores as warpgroup MMAs: wgmma m64nNk8 tf32 with fp32
// accumulation. Each block is two warpgroups (8 warps). A tf32 wgmma takes
// its B operand from shared memory, K-major only (for each n, k runs
// contiguous), in the 128-byte swizzle; A comes from registers, which each
// thread loads by hand from shared memory in whichever orientation the
// product needs. So every product puts the operand that is fixed for the
// block, or stored by the block itself, on B, and the streamed one on A:
//   row kernels (a block owns R rows; column tiles of BT stream):
//     logits^T (cols x rows)   = w^T      (A, the streamed fp32 w tile)
//                                x h^T    (B: h hi/lo, made once)
//     g_p^T    (cols x rows)   = g_marg^T (A) x counts (B: counts^T hi/lo)
//     G        (rows x levels) = p (A, the p tile) x g_marg^T (B: the
//                                g_marg tile hi/lo, made per column tile)
//     dh^T     (H x rows)      = w (A) x dl^T (B: dl hi/lo, stored per tile)
//   columns kernel (a block owns BT columns; row tiles of a segment stream):
//     logits (rows x cols)     = h (A, the streamed h tile) x w (B: w^T hi/lo,
//                                made once)
//     g_p      (rows x cols)   = counts^T (A) x g_marg (B: g_marg^T hi/lo)
//     dW       (H x cols)      = h^T (A) x dl (B: dl^T hi/lo, stored per tile)
// 'highest' takes 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi),
// both rounded to nearest; a term is lo_a hi_b + hi_a lo_b + hi_a hi_b,
// within about 2^-22 of it (against GRAD_TOL = 1e-4 normwise). 'high' takes
// the same three products over a bf16 hi/lo split (its contract; bf16 values
// are exact in tf32), 'default' one product of bf16-rounded operands. The
// tensor cores round their fp32 sums toward zero once per k8 step, a bias that
// grows with the MMAs on one accumulator: every chain starts from a zeroed
// accumulator and holds at most 24 MMAs (the logits' chains KCH k8 steps,
// 12 MMAs), and its result is added to the running sum in fp32 (round to
// nearest); g_p
// starts from zero and dot is subtracted after. The tile sums are two-level,
// as in the forward, and the cross-block sums of dW and db go to the fixed
// segment partials: bitwise stable run to run.
// The logits of a 64 x 64 tile split their contraction (h) between the two
// warpgroups, each summing half with m64n64 MMAs; the halves meet through
// shared memory (split_k). So no A fragment is loaded twice, and each MMA
// does twice the work of an m64n32 one: with A in registers, the fragment
// loads and splits bound these kernels more than the MMAs do (PERF.md).
// The top-K scatter is an add per (row, tile), and only on column tiles that
// hold one of the rows' indices (a bit mask per row block, a block-wide vote
// per row tile in the columns kernel).
// Loads: the row kernels double-buffer the w tile with cp.async and stage the
// next g_marg tile in registers while the current one is used; the columns
// kernel double-buffers the row tiles with cp.async. One 8-warp block per SM
// (225 KB / 217 KB of shared memory).

constexpr int BT = 64;   // columns per backward tile
constexpr int LP = 32;   // level slots of the g_marg and counts tiles (= LMAX)
constexpr int KCH = 4;   // k8 steps of the logits per zeroed accumulator
constexpr int HITW = 512;  // words of the row kernels' top-K tile mask: T / BT <= 16384

constexpr int BWD_SMEM_ROWS = 2 * R * HMAX + 2 * R * BT + 2 * R * LP + 4 * LP * BT +
                              2 * HMAX * BT + 2 * BT + 2 * R * KMAX + 3 * R + HITW;
constexpr int COLS_STAGE = R * HMAX + R * LMAX + 2 * R * KMAX + 3 * R;
constexpr int BWD_SMEM_COLS =
    2 * BT * HMAX + 2 * BT * LP + 2 * BT * R + BT + 4 * BT + 2 * COLS_STAGE;

// + 1 KB: the swizzled tiles start on a 1024-byte boundary
size_t bwd_rows_smem() { return sizeof(float) * BWD_SMEM_ROWS + 1024; }
size_t bwd_cols_smem() { return sizeof(float) * BWD_SMEM_COLS + 1024; }

__device__ __forceinline__ float* align1024(float* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return smem + (((1024 - (a & 1023)) & 1023) >> 2);
}

// Column of (row, col) in an fp32 tile read by hand as an A operand with
// m = row (swz_a) or m = col (swz_b): the fragment loads hit 32 banks.
__device__ __forceinline__ int swz_a(int row, int col) { return col ^ ((row & 7) << 2); }
__device__ __forceinline__ int swz_b(int row, int col) { return col ^ ((row & 3) << 3); }

// Offset of element (n, k) of a K-major operand tile of `rows` rows in the
// 128-byte swizzle: each 32 k form a region of rows x 128 B, in which row n's
// 16-byte chunk c sits at chunk c ^ (n % 8). Regions start 1024-byte aligned.
__device__ __forceinline__ int sw128(int rows, int n, int k) {
  return (k >> 5) * rows * 32 + n * 32 + ((((k >> 2) & 7) ^ (n & 7)) << 2) + (k & 3);
}

// wgmma descriptor of k8 step s of such a tile, rows n0 + [0, N): start
// address, leading offset 1 (unused by the swizzle), stride 1024 B between
// 8-row groups, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_k8(const float* tile, int rows, int n0, int s) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile + (s >> 2) * rows * 32 + n0 * 32 +
                                                        (s & 3) * 8);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// tf32(x), rounded to nearest with ties away from zero: cvt.rna.tf32.f32's
// result for every finite x, in two integer operations (the cvt takes about
// eight here).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo) under the precision contract P (lo = 0 for P = 2)
template <int P>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (P == 0) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    const float h = bf16r(x);
    hi = __float_as_uint(h);
    lo = P == 1 ? __float_as_uint(bf16r(x - h)) : 0u;
  }
}

// x split into a K-major swizzled hi/lo pair at offset o (lo not kept for P = 2)
template <int P>
__device__ __forceinline__ void put(float* __restrict__ hi_t, float* __restrict__ lo_t, int o,
                                    float x) {
  uint32_t hi, lo;
  split<P>(x, hi, lo);
  hi_t[o] = __uint_as_float(hi);
  if (P != 2) lo_t[o] = __uint_as_float(lo);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes by the threads become visible to the MMAs' reads.
__device__ __forceinline__ void async_view() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk8 tf32 warpgroup MMA, A (4 registers a thread) from registers, B
// from the descriptor; d = a b + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7}, "
      "{%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  if constexpr (N == 16) wgmma_n16(d, a, desc, scale_d);
  if constexpr (N == 32) wgmma_n32(d, a, desc, scale_d);
  if constexpr (N == 64) wgmma_n64(d, a, desc, scale_d);
}

struct Frag {
  uint32_t hi[4], lo[4];
};

// The A fragment of k8 step k0 / 8 for the warp's 16 rows of the 64-row M
// tile at m0: lane (g, t) holds (m, k) = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4), offset by 16 (warp % 4) rows; element (m, k) = at(m, k).
template <int P, typename F>
__device__ __forceinline__ Frag frag_a(F at, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = m0 + 16 * ((threadIdx.x >> 5) & 3) + g;
  const float v[4] = {at(m, k0 + t), at(m + 8, k0 + t), at(m, k0 + t + 4), at(m + 8, k0 + t + 4)};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split<P>(v[i], f.hi[i], f.lo[i]);
  return f;
}

// The same from an operand already split into hi / lo tiles.
template <int P, typename FH, typename FL>
__device__ __forceinline__ Frag frag_a2(FH hi_at, FL lo_at, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = m0 + 16 * ((threadIdx.x >> 5) & 3) + g;
  const int mm[4] = {m, m + 8, m, m + 8}, kk[4] = {k0 + t, k0 + t, k0 + t + 4, k0 + t + 4};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(hi_at(mm[i], kk[i]));
    f.lo[i] = P == 2 ? 0u : __float_as_uint(lo_at(mm[i], kk[i]));
  }
  return f;
}

// d (+)= a b over one k8 step under P, the small products first:
// lo_a hi_b + hi_a lo_b + hi_a hi_b, or hi_a hi_b for P = 2. scale_d = 0
// starts d from zero.
template <int P, int N>
__device__ __forceinline__ void mma_step(float (&d)[N / 2], const Frag& a, uint64_t b_hi,
                                         uint64_t b_lo, int scale_d) {
  if (P != 2) {
    wgmma<N>(d, a.lo, b_hi, scale_d);
    wgmma<N>(d, a.hi, b_lo, 1);
    wgmma<N>(d, a.hi, b_hi, 1);
  } else {
    wgmma<N>(d, a.hi, b_hi, scale_d);
  }
}

// d = sum over k8 steps [s0, s1) (s1 - s0 <= S) of A(s) B(s), from zero
// (the first MMA ignores d), as one commit group, waited for. a_of(s): the
// A fragment; b_hi(s), b_lo(s): descriptors.
template <int P, int N, int S, typename FA, typename FH, typename FL>
__device__ __forceinline__ void chain(float (&d)[N / 2], int s0, int s1, FA a_of, FH b_hi,
                                      FL b_lo) {
  keep(d);
  wg_fence();
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (s0 + j < s1) mma_step<P, N>(d, a_of(s0 + j), b_hi(s0 + j), b_lo(s0 + j), j > 0);
  }
  wg_commit();
  wg_wait();
  keep(d);
}

// run = sum over k8 steps [s0, s1) of A(s) B(s) in chains of KCH steps, each
// from zero and added to run in fp32 in order (run = 0 for an empty range).
template <int P, int N, typename FA, typename FH, typename FL>
__device__ __forceinline__ void chains(float (&run)[N / 2], int s0, int s1, FA a_of, FH b_hi,
                                       FL b_lo) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) run[i] = 0.f;
  for (int c0 = s0; c0 < s1; c0 += KCH) {
    float d[N / 2];
    chain<P, N, KCH>(d, c0, min(s1, c0 + KCH), a_of, b_hi, b_lo);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) run[i] += d[i];
  }
}

// The logits of a 64 x 64 tile (M = 64 x N = 64, K = nk8 k8 steps <= 16)
// with K split between the warpgroups: warpgroup wg sums steps [8 wg,
// 8 wg + 8) with m64n64 MMAs, so each loads half of A and no A fragment twice;
// the two partial sums meet through xbuf (4096 floats, free on entry and on
// return): warpgroup wg keeps elements [16 wg, 16 wg + 16) of the m64n64
// accumulator, N = 32 wg + [0, 32), as l (the m64n32 layout at n0 = 32 wg).
template <int P, typename FA, typename FH, typename FL>
__device__ __forceinline__ void split_k(float (&l)[16], int nk8, FA a_of, FH b_hi, FL b_lo,
                                        float* __restrict__ xbuf) {
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  float part[32];
  chains<P, 64>(part, 8 * wg, min(nk8, 8 * wg + 8), a_of, b_hi, b_lo);
  // constant indices in each branch: the partial stays in registers
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) xbuf[e * 128 + tw] = part[16 + e];
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) xbuf[(16 + e) * 128 + tw] = part[e];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) l[e] = part[e] + xbuf[(16 + e) * 128 + tw];
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) l[e] = part[16 + e] + xbuf[e * 128 + tw];
  }
  __syncthreads();
}

// Accumulator element i of an m64nN tile: row m0 + 16 (warp % 4) + g +
// 8 ((i / 2) % 2), column n0 + 8 (i / 4) + 2 t + i % 2.
__device__ __forceinline__ int c_m(int m0, int i) {
  return m0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int c_n(int n0, int i) {
  return n0 + 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// p = exp(l - m) / s as exp(l - m) times 1 / s (within an ulp of the
// quotient); m = inf on rows past the limit, s <= 0 reads as 1.
__device__ __forceinline__ float recip_s(float s) { return 1.f / (s > 0.f ? s : 1.f); }
__device__ __forceinline__ float to_p(float l, float m, float inv) { return expf(l - m) * inv; }

// ------------------------------ row kernels -------------------------------- //

// The row kernels' shared memory; the swizzled tiles first, 1024-byte aligned.
struct RowsSmem {
  float *h_hi, *h_lo, *dl_hi, *dl_lo, *c_hi, *c_lo, *gm_hi, *gm_lo, *w_s, *b_s, *kgv_s, *m_s,
      *inv_s, *dot_s;
  float *p_s, *g_s;  // the G sweep's p tile and G partial (they alias dl_hi, dl_lo)
  int* kidx_s;
  unsigned* hit_s;   // bit i: a top-K index of the block's rows lies in column tile i
  __device__ explicit RowsSmem(float* smem) {
    h_hi = align1024(smem);
    h_lo = h_hi + R * HMAX;
    dl_hi = h_lo + R * HMAX;
    dl_lo = dl_hi + R * BT;
    c_hi = dl_lo + R * BT;
    c_lo = c_hi + R * LP;
    gm_hi = c_lo + R * LP;       // 2 stages of LP x BT
    gm_lo = gm_hi + 2 * LP * BT;
    w_s = gm_lo + 2 * LP * BT;   // 2 stages of HMAX x BT, fp32
    b_s = w_s + 2 * HMAX * BT;
    kgv_s = b_s + 2 * BT;
    kidx_s = (int*)(kgv_s + R * KMAX);
    m_s = (float*)(kidx_s + R * KMAX);
    inv_s = m_s + R;
    dot_s = inv_s + R;
    hit_s = (unsigned*)(dot_s + R);
    p_s = dl_hi;
    g_s = dl_lo;
  }
};

// w tile of columns [t0, t0 + BT) and its bias into w_s / b_s by cp.async
// (rows past H are zero from the kernel's start).
__device__ __forceinline__ void load_w_async(const float* __restrict__ w,
                                             const float* __restrict__ b, int H, int T, int t0,
                                             float* __restrict__ w_s, float* __restrict__ b_s) {
  for (int i = threadIdx.x; i < H * (BT / 4); i += THREADS) {
    const int k = i / (BT / 4), c = (i % (BT / 4)) * 4;
    cp_async16(w_s + k * BT + swz_b(k, c), w + (size_t)k * T + t0 + c);
  }
  if (threadIdx.x < BT / 4) cp_async16(b_s + 4 * threadIdx.x, b + t0 + 4 * threadIdx.x);
}

// The g_marg tile of columns [t0, t0 + BT) into registers (zero past L) ...
__device__ __forceinline__ void load_gm(const float* __restrict__ g_marg, int T, int L, int t0,
                                        float (&v)[LP * BT / THREADS]) {
#pragma unroll
  for (int j = 0; j < LP * BT / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS, l = i / BT, c = i % BT;
    v[j] = l < L ? g_marg[(size_t)l * T + t0 + c] : 0.f;
  }
}

// ... and from them into a stage of the hi / lo tile (n = level, k = column).
template <int P>
__device__ __forceinline__ void store_gm(const float (&v)[LP * BT / THREADS],
                                         float* __restrict__ hi_t, float* __restrict__ lo_t) {
#pragma unroll
  for (int j = 0; j < LP * BT / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS, l = i / BT, c = i % BT;
    put<P>(hi_t, lo_t, sw128(LP, l, c), v[j]);
  }
}

// Row kernels' start: h rows [r0, r0 + R) (zero past u and H) and counts^T
// as hi / lo tiles, per-row state (1 / s for s), the mask of column tiles
// that hold a top-K index, zero rows of the w buffers past H.
template <int P>
__device__ __forceinline__ void rows_prologue(const RowsSmem& sm, const float* __restrict__ h,
                                              const float* __restrict__ counts,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ m_in,
                                              const float* __restrict__ s_in,
                                              const float* __restrict__ g_vals, int u, int H,
                                              int L, int K, int r0) {
  for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
    const int r = i / HMAX, k = i % HMAX;
    put<P>(sm.h_hi, sm.h_lo, sw128(R, r, k),
           (r0 + r < u && k < H) ? h[(size_t)(r0 + r) * H + k] : 0.f);
  }
  for (int i = threadIdx.x; i < R * LP; i += THREADS) {
    const int l = i / R, r = i % R;
    put<P>(sm.c_hi, sm.c_lo, sw128(R, r, l),
           (l < L && r0 + r < u && counts) ? counts[(size_t)l * u + r0 + r] : 0.f);
  }
  for (int i = threadIdx.x; i < HITW; i += THREADS) sm.hit_s[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < R * KMAX; i += THREADS) {
    const int r = i / KMAX, q = i % KMAX;
    const bool ok = idx && q < K && r0 + r < u;
    const int c = ok ? idx[(size_t)(r0 + r) * K + q] : -1;
    sm.kidx_s[i] = c;
    sm.kgv_s[i] = ok ? g_vals[(size_t)(r0 + r) * K + q] : 0.f;
    if (c >= 0 && c / BT < 32 * HITW) atomicOr(&sm.hit_s[c / BT / 32], 1u << (c / BT % 32));
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const bool ok = r0 + r < u;
    sm.m_s[r] = ok ? m_in[r0 + r] : INFINITY;
    sm.inv_s[r] = recip_s(ok ? s_in[r0 + r] : 1.f);
  }
  for (int i = H * BT + threadIdx.x; i < HMAX * BT; i += THREADS) {
    sm.w_s[i] = 0.f;
    sm.w_s[HMAX * BT + i] = 0.f;
  }
}

// A sweep's start: g_marg tile 0 into stage 0; w tiles 0 and 1 by cp.async,
// one commit group each (at tile i's start W(i) is the second most recent).
template <int P>
__device__ __forceinline__ void sweep_start(const RowsSmem& sm, const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            const float* __restrict__ g_marg, int H, int T,
                                            int L) {
  float v[LP * BT / THREADS];
  load_gm(g_marg, T, L, 0, v);
  store_gm<P>(v, sm.gm_hi, sm.gm_lo);
  load_w_async(w, b, H, T, 0, sm.w_s, sm.b_s);
  cp_commit();
  if (BT < T) load_w_async(w, b, H, T, BT, sm.w_s + HMAX * BT, sm.b_s + BT);
  cp_commit();
}

// p^T of the tile: element i of the m64n32 layout is column t0 + c_m(0, i)
// and row c_n(32 wg, i) of the block (split_k; its exchange uses dl_hi).
template <int P>
__device__ __forceinline__ void rows_p(const RowsSmem& sm, const float* __restrict__ w_s,
                                       const float* __restrict__ b_s, int nk8, float (&l)[16]) {
  const int n0 = 32 * (threadIdx.x >> 7);
  auto wA = [&](int m, int k) { return w_s[k * BT + swz_b(k, m)]; };
  auto a_of = [&](int s) { return frag_a<P>(wA, 0, 8 * s); };
  auto bh = [&](int s) { return desc_k8(sm.h_hi, R, 0, s); };
  auto bl = [&](int s) { return desc_k8(sm.h_lo, R, 0, s); };
  split_k<P>(l, nk8, a_of, bh, bl, sm.dl_hi);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = c_n(n0, i);
    l[i] = to_p(l[i] + b_s[c_m(0, i)], sm.m_s[r], sm.inv_s[r]);
  }
}

// G[r, l] = <p[r], g_marg[l]>: warpgroup wg sums columns 32 wg + [0, 32) of
// every tile; element i of the m64n32 accumulator is row c_m(0, i), level
// c_n(0, i) (the first 8 elements for L <= 16, an m64n16 product).
template <int P>
__device__ __forceinline__ void g_sweep(const RowsSmem& sm, const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        const float* __restrict__ g_marg, int H, int T, int L,
                                        float (&gacc)[16]) {
  const int wg = threadIdx.x >> 7;
  const int nk8 = (H + 7) / 8;
  auto pA = [&](int m, int k) { return sm.p_s[m * BT + swz_a(m, k)]; };
  auto a_of = [&](int s) { return frag_a<P>(pA, 0, 8 * s); };
#pragma unroll
  for (int i = 0; i < 16; ++i) gacc[i] = 0.f;
  sweep_start<P>(sm, w, b, g_marg, H, T, L);
  for (int t0 = 0, it = 0; t0 < T; t0 += BT, ++it) {
    const int st = it & 1;
    const float* gm_hi = sm.gm_hi + st * LP * BT;
    const float* gm_lo = sm.gm_lo + st * LP * BT;
    float v[LP * BT / THREADS];
    if (t0 + BT < T) load_gm(g_marg, T, L, t0 + BT, v);
    cp_wait<1>();
    async_view();
    __syncthreads();
    float p[16];
    rows_p<P>(sm, sm.w_s + st * HMAX * BT, sm.b_s + st * BT, nk8, p);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = c_n(32 * wg, i), c = c_m(0, i);
      sm.p_s[r * BT + swz_a(r, c)] = p[i];
    }
    __syncthreads();
    auto bh = [&](int s) { return desc_k8(gm_hi, LP, 0, s); };
    auto bl = [&](int s) { return desc_k8(gm_lo, LP, 0, s); };
    float gt[16];
    if (L <= 16) {
      float g8[8];
      chain<P, 16, 4>(g8, 4 * wg, 4 * wg + 4, a_of, bh, bl);
#pragma unroll
      for (int i = 0; i < 8; ++i) gt[i] = g8[i];
#pragma unroll
      for (int i = 8; i < 16; ++i) gt[i] = 0.f;
    } else {
      chain<P, 32, 4>(gt, 4 * wg, 4 * wg + 4, a_of, bh, bl);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) gacc[i] += gt[i];
    __syncthreads();
    if (t0 + BT < T) store_gm<P>(v, sm.gm_hi + (st ^ 1) * LP * BT, sm.gm_lo + (st ^ 1) * LP * BT);
    if (t0 + 2 * BT < T)
      load_w_async(w, b, H, T, t0 + 2 * BT, sm.w_s + st * HMAX * BT, sm.b_s + st * BT);
    cp_commit();
  }
  cp_wait<0>();
  // G = warpgroup 0's sum + warpgroup 1's, in that order, in warpgroup 0.
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sm.g_s[c_m(0, i) * LP + c_n(0, i)] = gacc[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) gacc[i] += sm.g_s[c_m(0, i) * LP + c_n(0, i)];
  }
  __syncthreads();
}

// dh[r, :] = sum over column tiles of dl[r, tile] w[:, tile]^T with the
// block's dot_s, written for rows below u. Warpgroup wg holds dh^T rows
// (= dh columns) 64 wg + [0, 64) for the block's 64 rows.
template <int P>
__device__ __forceinline__ void dh_sweep(const RowsSmem& sm, const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         const float* __restrict__ g_marg, int u, int r0, int H,
                                         int T, int L, int K, int noop,
                                         float* __restrict__ dh) {
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const int nk8 = (H + 7) / 8, nl8 = (L + 7) / 8;
  float dacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dacc[i] = 0.f;
  sweep_start<P>(sm, w, b, g_marg, H, T, L);
  for (int t0 = 0, it = 0; t0 < T; t0 += BT, ++it) {
    const int st = it & 1;
    const float* w_s = sm.w_s + st * HMAX * BT;
    const float* gm_hi = sm.gm_hi + st * LP * BT;
    const float* gm_lo = sm.gm_lo + st * LP * BT;
    float v[LP * BT / THREADS];
    if (t0 + BT < T) load_gm(g_marg, T, L, t0 + BT, v);
    cp_wait<1>();
    async_view();
    __syncthreads();
    float q[16];
    rows_p<P>(sm, w_s, sm.b_s + st * BT, nk8, q);
    // g_p^T = g_marg^T counts: A (m = column, k = level) from the g_marg tile
    float gp[16];
    {
      auto hiA = [&](int m, int k) { return gm_hi[sw128(LP, k, m)]; };
      auto loA = [&](int m, int k) { return gm_lo[sw128(LP, k, m)]; };
      auto a_of = [&](int s) { return frag_a2<P>(hiA, loA, 0, 8 * s); };
      auto bh = [&](int s) { return desc_k8(sm.c_hi, R, 32 * wg, s); };
      auto bl = [&](int s) { return desc_k8(sm.c_lo, R, 32 * wg, s); };
      chain<P, 32, 4>(gp, 0, nl8, a_of, bh, bl);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) gp[i] -= sm.dot_s[c_n(32 * wg, i)];
    if (!noop && (it >= 32 * HITW || (sm.hit_s[it / 32] >> (it % 32)) & 1u)) {
      // the thread's columns t0 + 16 wq + g (+ 8); rows c_n(32 wg, 4 j + e)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = c_n(32 * wg, 4 * j + e);
          for (int k = 0; k < K; ++k) {
            const int c = sm.kidx_s[r * KMAX + k] - t0 - 16 * wq - g;
            const float gv = sm.kgv_s[r * KMAX + k];
            gp[4 * j + e] += c == 0 ? gv : 0.f;
            gp[4 * j + 2 + e] += c == 8 ? gv : 0.f;
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float dl = q[i] * gp[i];
      put<P>(sm.dl_hi, sm.dl_lo, sw128(R, c_n(32 * wg, i), c_m(0, i)), dl);
    }
    async_view();
    __syncthreads();
    // dh^T += w dl^T: A (m = h, k = column) from the w tile
    {
      auto wA = [&](int m, int k) { return w_s[m * BT + swz_b(m, k)]; };
      auto a_of = [&](int s) { return frag_a<P>(wA, 64 * wg, 8 * s); };
      auto bh = [&](int s) { return desc_k8(sm.dl_hi, R, 0, s); };
      auto bl = [&](int s) { return desc_k8(sm.dl_lo, R, 0, s); };
      float dt[32];
      chain<P, 64, BT / 8>(dt, 0, BT / 8, a_of, bh, bl);
#pragma unroll
      for (int i = 0; i < 32; ++i) dacc[i] += dt[i];
    }
    __syncthreads();
    if (t0 + BT < T) store_gm<P>(v, sm.gm_hi + (st ^ 1) * LP * BT, sm.gm_lo + (st ^ 1) * LP * BT);
    if (t0 + 2 * BT < T)
      load_w_async(w, b, H, T, t0 + 2 * BT, sm.w_s + st * HMAX * BT, sm.b_s + st * BT);
    cp_commit();
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = c_m(64 * wg, i), r = r0 + c_n(0, i);
    if (r < u && c < H) dh[(size_t)r * H + c] = dacc[i];
  }
}

// K2's row kernel: G by g_sweep, dot closed in the block, then dh.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
hpd_bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const int* __restrict__ idx, const float* __restrict__ vals,
                    const float* __restrict__ m_in, const float* __restrict__ s_in,
                    const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                    int H, int T, int L, int K, int noop, float* __restrict__ dh,
                    float* __restrict__ dot_out) {
  extern __shared__ float smem[];
  const RowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  rows_prologue<P>(sm, h, counts, idx, m_in, s_in, g_vals, u, H, L, K, r0);
  float gacc[16];
  g_sweep<P>(sm, w, b, g_marg, H, T, L, gacc);
  // counts G into g_s, then dot per row in level order
  if (threadIdx.x < 128) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = c_m(0, i), l = c_n(0, i);
      if (l < L)
        sm.g_s[r * LP + l] = r0 + r < u ? counts[(size_t)l * u + r0 + r] * gacc[i] : 0.f;
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float d = 0.f;
    for (int l = 0; l < L; ++l) d += sm.g_s[r * LP + l];
    if (!noop && r0 + r < u) {
      float e = 0.f;
      for (int q = 0; q < K; ++q) e += sm.kgv_s[r * KMAX + q] * vals[(size_t)(r0 + r) * K + q];
      d += e;
    }
    sm.dot_s[r] = d;
    if (r0 + r < u) dot_out[r0 + r] = d;
  }
  __syncthreads();
  dh_sweep<P>(sm, w, b, g_marg, u, r0, H, T, L, K, noop, dh);
}

// K6's B1: G[r, l] = <p[r], g_marg[l]> for the block's R rows.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
hpd_b1_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ m_in,
              const float* __restrict__ s_in, const float* __restrict__ g_marg, int u, int H,
              int T, int L, float* __restrict__ g_rows) {
  extern __shared__ float smem[];
  const RowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  rows_prologue<P>(sm, h, nullptr, nullptr, m_in, s_in, nullptr, u, H, L, 1, r0);
  float gacc[16];
  g_sweep<P>(sm, w, b, g_marg, H, T, L, gacc);
  if (threadIdx.x < 128) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = c_m(0, i), l = c_n(0, i);
      if (l < L && r0 + r < u) g_rows[(size_t)(r0 + r) * L + l] = gacc[i];
    }
  }
}

// K6's B2, row-parallel part: dh from the given per-row dot.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
hpd_b2_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ counts,
                   const int* __restrict__ idx, const float* __restrict__ m_in,
                   const float* __restrict__ s_in, const float* __restrict__ dot_in,
                   const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                   int H, int T, int L, int K, int noop, float* __restrict__ dh) {
  extern __shared__ float smem[];
  const RowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  rows_prologue<P>(sm, h, counts, idx, m_in, s_in, g_vals, u, H, L, K, r0);
  for (int r = threadIdx.x; r < R; r += THREADS) sm.dot_s[r] = r0 + r < u ? dot_in[r0 + r] : 0.f;
  __syncthreads();
  dh_sweep<P>(sm, w, b, g_marg, u, r0, H, T, L, K, noop, dh);
}

// ---------------------------- columns kernel ------------------------------- //

// The columns kernel's per-row-tile stage (fp32, read by hand): h tile,
// counts^T, top-K indices and g_vals, m, s, dot.
struct ColsStage {
  float *h_s, *cT_s, *kgv_s, *m_s, *s_s, *dot_s;
  int* kidx_s;
  __device__ ColsStage(float* base) {
    h_s = base;
    cT_s = h_s + R * HMAX;
    kgv_s = cT_s + R * LMAX;
    kidx_s = (int*)(kgv_s + R * KMAX);
    m_s = (float*)(kidx_s + R * KMAX);
    s_s = m_s + R;
    dot_s = s_s + R;
  }
};

// Row tile [r0, r0 + R) of the segment (ending at rend) into a stage:
// cp.async for rows below rend, neutral values (h = 0, m = inf, counts 0,
// no top-K) past it.
__device__ __forceinline__ void load_stage_async(ColsStage st, const float* __restrict__ h,
                                                 const float* __restrict__ counts,
                                                 const int* __restrict__ idx,
                                                 const float* __restrict__ m_in,
                                                 const float* __restrict__ s_in,
                                                 const float* __restrict__ dot_in,
                                                 const float* __restrict__ g_vals, int u,
                                                 int rend, int H, int L, int K, int r0) {
  if ((H & 3) == 0 && ((uintptr_t)h & 15) == 0) {
    // 16 bytes a copy: swz_a moves whole 4-float chunks
    for (int i = threadIdx.x; i < R * (HMAX / 4); i += THREADS) {
      const int r = i / (HMAX / 4), k = (i % (HMAX / 4)) * 4;
      float* dst = st.h_s + r * HMAX + swz_a(r, k);
      if (r0 + r < rend && k < H) {
        cp_async16(dst, h + (size_t)(r0 + r) * H + k);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i % HMAX;
      float* dst = st.h_s + r * HMAX + swz_a(r, k);
      if (r0 + r < rend && k < H)
        cp_async4(dst, h + (size_t)(r0 + r) * H + k);
      else
        *dst = 0.f;
    }
  }
  for (int i = threadIdx.x; i < R * LMAX; i += THREADS) {
    const int l = i / R, r = i % R;
    float* dst = st.cT_s + r * LMAX + swz_a(r, l);
    if (l < L && r0 + r < rend)
      cp_async4(dst, counts + (size_t)l * u + r0 + r);
    else
      *dst = 0.f;
  }
  for (int i = threadIdx.x; i < R * KMAX; i += THREADS) {
    const int r = i / KMAX, q = i % KMAX;
    if (q < K && r0 + r < rend) {
      cp_async4(st.kidx_s + i, idx + (size_t)(r0 + r) * K + q);
      cp_async4(st.kgv_s + i, g_vals + (size_t)(r0 + r) * K + q);
    } else {
      st.kidx_s[i] = -1;
      st.kgv_s[i] = 0.f;
    }
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    if (r0 + r < rend) {
      cp_async4(st.m_s + r, m_in + r0 + r);
      cp_async4(st.s_s + r, s_in + r0 + r);
      cp_async4(st.dot_s + r, dot_in + r0 + r);
    } else {
      st.m_s[r] = INFINITY;
      st.s_s[r] = 1.f;
      st.dot_s[r] = 0.f;
    }
  }
}

// Grid (T / BT, SEGS): one block per column tile and row segment sums
// dW = h^T dl and db over the segment's rows into dw_part / db_part[seg].
// Logits, p and dl: warpgroup wg holds the tile's 64 rows x columns
// 32 wg + [0, 32); dW: warpgroup wg holds dW rows 64 wg + [0, 64).
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
hpd_bwd_cols_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const int* __restrict__ idx, const float* __restrict__ m_in,
                    const float* __restrict__ s_in, const float* __restrict__ dot_in,
                    const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                    int H, int T, int L, int K, int noop, int seg_rows,
                    float* __restrict__ dw_part, float* __restrict__ db_part) {
  extern __shared__ float smem[];
  float* wt_hi = align1024(smem);  // w^T (n = column, k = h)
  float* wt_lo = wt_hi + BT * HMAX;
  float* gt_hi = wt_lo + BT * HMAX;  // g_marg^T (n = column, k = level)
  float* gt_lo = gt_hi + BT * LP;
  float* dlt_hi = gt_lo + BT * LP;  // dl^T (n = column, k = row)
  float* dlt_lo = dlt_hi + BT * R;
  float* b_s = dlt_lo + BT * R;
  float* dbp = b_s + BT;  // per warp of a warpgroup: column sums of its 16 rows
  float* stage0 = dbp + 4 * BT;
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int rbeg = seg * seg_rows;
  const int rend = min(u, rbeg + seg_rows);
  const int nk8 = (H + 7) / 8, nl8 = (L + 7) / 8;
  for (int s = 0; s < 2; ++s) {
    if (rbeg + s * R < rend)
      load_stage_async(ColsStage(stage0 + s * COLS_STAGE), h, counts, idx, m_in, s_in, dot_in,
                       g_vals, u, rend, H, L, K, rbeg + s * R);
    cp_commit();
  }
  for (int i = threadIdx.x; i < HMAX * BT; i += THREADS) {
    const int k = i / BT, c = i % BT;
    put<P>(wt_hi, wt_lo, sw128(BT, c, k), k < H ? w[(size_t)k * T + t0 + c] : 0.f);
  }
  for (int i = threadIdx.x; i < LP * BT; i += THREADS) {
    const int l = i / BT, c = i % BT;
    put<P>(gt_hi, gt_lo, sw128(BT, c, l), l < L ? g_marg[(size_t)l * T + t0 + c] : 0.f);
  }
  if (threadIdx.x < BT) b_s[threadIdx.x] = b[t0 + threadIdx.x];
  float wacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) wacc[i] = 0.f;
  float bacc = 0.f;
  for (int r0 = rbeg, it = 0; r0 < rend; r0 += R, ++it) {
    const ColsStage st(stage0 + (it & 1) * COLS_STAGE);
    cp_wait<1>();
    async_view();
    __syncthreads();
    // does a top-K index of the row tile fall in this column tile?
    bool mine = false;
#pragma unroll
    for (int j = 0; j < R * KMAX / THREADS; ++j) {
      const int c = st.kidx_s[threadIdx.x + j * THREADS] - t0;
      mine |= c >= 0 && c < BT;
    }
    const bool hits = __syncthreads_or(mine) && !noop;
    // logits: element i is row c_m(0, i), column c_n(32 wg, i)
    float q[16];
    {
      auto hA = [&](int m, int k) { return st.h_s[m * HMAX + swz_a(m, k)]; };
      auto a_of = [&](int s) { return frag_a<P>(hA, 0, 8 * s); };
      auto bh = [&](int s) { return desc_k8(wt_hi, BT, 0, s); };
      auto bl = [&](int s) { return desc_k8(wt_lo, BT, 0, s); };
      split_k<P>(q, nk8, a_of, bh, bl, dlt_hi);
      const float inv0 = recip_s(st.s_s[c_m(0, 0)]), inv1 = recip_s(st.s_s[c_m(0, 2)]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = c_m(0, i);
        q[i] = to_p(q[i] + b_s[c_n(32 * wg, i)], st.m_s[r], (i >> 1) & 1 ? inv1 : inv0);
      }
    }
    // g_p = counts^T g_marg: A (m = row, k = level) from the stage
    float gp[16];
    {
      auto cA = [&](int m, int k) { return st.cT_s[m * LMAX + swz_a(m, k)]; };
      auto a_of = [&](int s) { return frag_a<P>(cA, 0, 8 * s); };
      auto bh = [&](int s) { return desc_k8(gt_hi, BT, 32 * wg, s); };
      auto bl = [&](int s) { return desc_k8(gt_lo, BT, 32 * wg, s); };
      chain<P, 32, 4>(gp, 0, nl8, a_of, bh, bl);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) gp[i] -= st.dot_s[c_m(0, i)];
    if (hits) {
      // the thread's rows c_m(0, 2 hs); columns t0 + 32 wg + 8 j + 2 t + e
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        const int r = c_m(0, 2 * hs);
        for (int k = 0; k < K; ++k) {
          const int c = st.kidx_s[r * KMAX + k] - t0 - 32 * wg;
          const float gv = st.kgv_s[r * KMAX + k];
          const bool mine = c >= 0 && c < 32 && ((c >> 1) & 3) == (lane & 3);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool hit = mine && (c >> 3) == j;
            gp[4 * j + 2 * hs] += hit && !(c & 1) ? gv : 0.f;
            gp[4 * j + 2 * hs + 1] += hit && (c & 1) ? gv : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      q[i] *= gp[i];
      put<P>(dlt_hi, dlt_lo, sw128(BT, c_n(32 * wg, i), c_m(0, i)), q[i]);
    }
    // db: column sums of the warp's 16 rows (rows g, g + 8, then over g)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = q[4 * j + e] + q[4 * j + 2 + e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) dbp[wq * BT + c_n(32 * wg, 4 * j + e)] = v;
      }
    async_view();
    __syncthreads();
    if (threadIdx.x < BT) {
      const int c = threadIdx.x;
      bacc += ((dbp[c] + dbp[BT + c]) + dbp[2 * BT + c]) + dbp[3 * BT + c];
    }
    // dW += h^T dl: A (m = h, k = row) from the stage's h tile
    {
      auto hT = [&](int m, int k) { return st.h_s[k * HMAX + swz_a(k, m)]; };
      auto a_of = [&](int s) { return frag_a<P>(hT, 64 * wg, 8 * s); };
      auto bh = [&](int s) { return desc_k8(dlt_hi, BT, 0, s); };
      auto bl = [&](int s) { return desc_k8(dlt_lo, BT, 0, s); };
      float dt[32];
      chain<P, 64, R / 8>(dt, 0, R / 8, a_of, bh, bl);
#pragma unroll
      for (int i = 0; i < 32; ++i) wacc[i] += dt[i];
    }
    __syncthreads();
    if (r0 + 2 * R < rend)
      load_stage_async(ColsStage(stage0 + (it & 1) * COLS_STAGE), h, counts, idx, m_in, s_in,
                       dot_in, g_vals, u, rend, H, L, K, r0 + 2 * R);
    cp_commit();
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = c_m(64 * wg, i), c = c_n(0, i);
    if (hh < H) dw_part[((size_t)seg * H + hh) * T + t0 + c] = wacc[i];
  }
  if (threadIdx.x < BT) db_part[(size_t)seg * T + t0 + threadIdx.x] = bacc;
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
  const dim3 cols_grid(T / BT, SEGS);
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
    set_smem(hpd_b1_kernel<P>, bwd_rows_smem());
    hpd_b1_kernel<P><<<(u + R - 1) / R, THREADS, bwd_rows_smem(), st>>>(h, w, b, m, s, g_marg, u, H, T,
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
