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
// 64-column tiles of the logits and recompute them in each pass, and they
// share every pass:
//   rows pass     (hpd_fwd_rows_kernel): online max / sum-exp and the exact
//                 top-K on raw logits, lowest index first -> vals, idx, m, s;
//                 the rows its guard cannot settle go to the fp32 fix-up
//                 (hpd_fix_rows_kernel). K1's first pass; all of K4.
//   columns pass  (hpd_fwd_cols_kernel): p = exp(l - m) / s, marginal
//                 counts @ p per row segment. K1's second pass; all of K5.
//   g_sweep       G[r, l] = <p[r], g_marg[l]>. K2's row pass, K6's B1.
//   dh_sweep      dl = p (g_p - dot), dh = dl w^T. K2's row pass, K6's B2.
//   bwd columns   (hpd_bwd_cols_kernel): dl, dW = h^T dl, db per row
//                 segment. K2's and K6-B2's column pass.
// Every pass runs its products on the tensor cores as warpgroup MMAs (see
// "backward, on the tensor cores" and "forward, on the tensor cores"
// below); the top-K stays that of the fp32 logits by candidate refinement.
// Every pass takes any head width there, its contraction over H in 128-deep
// chunks past H = 128; only the fix-up of the rows the guard lists runs on
// the CUDA cores (exact fp32).
// Sums across row blocks (marg, dW, db) go to per-segment partials over a
// fixed number of row segments, summed in segment order by
// hpd_reduce_segments_kernel: no atomics, bitwise stable run to run. Every
// long sum is taken in two levels, a partial per tile (64 rows or 64
// columns) added to the running total, so no fp32 chain runs over a whole
// segment (20,224 rows at U_c = 161,792) or over T.
//
// Bound on this card: operations. At H = 128, T = 2^16, U_c = 161,792 one
// logits product is 2.7 TFLOP against 32 MB of weight: 16 ms as 3xTF32 at
// the TF32 tensor peak (40 ms at the fp32 CUDA-core peak). K4, K5 and B1
// each compute the logits once, as the TPU's split kernels do; B2 computes
// them twice (its row and its column part) where the TPU's runs once; at a
// head of nc 128-deep chunks each block of dh's or dW's nc recomputes them.
// (The forward passes sum a head's chunks in one block.)

#include <float.h>
#include <limits.h>

#include "stream_tile.cuh"

namespace {

constexpr int KMAX = 16;
constexpr int LMAX = 32;
// Row segments of the column-parallel kernels. Each holds a (L, T), (H, T)
// and (T,) partial: at H = 128, T = 2^16 the dW partials take 8 x 32 MB.
constexpr int SEGS = 8;
// blocks of the fix-up launch (one per SM of an H100)
constexpr int FIX_BLOCKS = 132;

int rows_per_seg(int u) {
  const int tiles = (u + R - 1) / R;
  return ((tiles + SEGS - 1) / SEGS) * R;
}

// The widest head: every pass takes the contraction over H in ceil(H / HMAX)
// HMAX-deep chunks through the tiles of one chunk, so no shared-memory plan
// grows with H ("Any head width" below); the backward puts its chunks of dh
// and dW on grid.y (row kernels) and grid.z (columns kernel), at most 65,535
// blocks each.
constexpr int HWIDE = 65535 * HMAX;

// The logits h w + b of the rows row(r) (r < R; -1: a zero row) x columns
// [t0, t0 + TT), h streamed through h_s (R x HP) in HMAX-deep chunks, each
// element one fma chain over k ascending across the chunks (tile_dot's
// arithmetic); laid out as in tile_dot. Starts with a barrier. The fix-up's
// sweep at a head wider than HMAX.
template <int P, typename Row>
__device__ __forceinline__ void wide_tile_logits(const float* __restrict__ h, Row row, int H,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ b, int T, int t0,
                                                 float* __restrict__ h_s, float* __restrict__ w_s,
                                                 float (&acc)[4][8]) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < H; c0 += HMAX) {
    const int hc = H - c0 < HMAX ? H - c0 : HMAX;
    __syncthreads();  // h_s is free
    for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i - r * HMAX;
      const int gr = row(r);
      h_s[r * HP + k] = (gr >= 0 && k < hc) ? h[(size_t)gr * H + c0 + k] : 0.f;
    }
    tile_dot_acc<P>(h_s, w + (size_t)c0 * T, hc, T, t0, w_s, acc);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bj = b[t0 + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] += bj;
  }
}

// -------------------- exact fp32 rows sweep (the fix-up) -------------------- //

size_t fix_rows_smem(int K) {
  return sizeof(float) * (R * HP + BK * TT + 2 * R * NSUB) + (size_t)R * NSUB * K * 8;
}

// The rows pass in fp32 FMA on the CUDA cores (stream_tile.cuh), exact to
// the plain version's contract: the tensor-core rows pass below hands it the
// rows whose top-K its guard cannot settle (fix_rows[0, *n_fix)). Blocks
// stride over the list R rows at a time; each sweeps every column tile with
// online max / sum-exp and, per (row, 16-column sub-stream), a sorted top-K
// list, then merges the NSUB lists of each row by (value desc, index asc)
// and writes the row's vals, idx, m and s.
// WIDE (a head wider than HMAX): the listed rows' h streamed through the
// tile in HMAX-deep chunks for every column tile (wide_tile_logits).
template <int P, bool WIDE>
__global__ void __launch_bounds__(THREADS)
hpd_fix_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, int H, int T, int K,
                    const int* __restrict__ fix_rows, const int* __restrict__ n_fix,
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
  const int n = *n_fix;
  for (int base = blockIdx.x * R; base < n; base += gridDim.x * R) {
    __syncthreads();  // the previous rows' merge has read lv / li
    for (int i = threadIdx.x; !WIDE && i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i - r * HMAX;
      h_s[r * HP + k] =
          (base + r < n && k < H) ? h[(size_t)fix_rows[base + r] * H + k] : 0.f;
    }
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
      if (WIDE)
        wide_tile_logits<P>(h, [&](int r) { return base + r < n ? fix_rows[base + r] : -1; }, H,
                            w, b, T, t0, h_s, w_s, acc);
      else
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
    if (threadIdx.x < R && base + threadIdx.x < n) {
      const int r = threadIdx.x;
      float m = -INFINITY;
      for (int sub = 0; sub < NSUB; ++sub) m = fmaxf(m, pm[r * NSUB + sub]);
      float s = 0.f;
      for (int sub = 0; sub < NSUB; ++sub) s += ps[r * NSUB + sub] * expf(pm[r * NSUB + sub] - m);
      int pos[NSUB];
      for (int sub = 0; sub < NSUB; ++sub) pos[sub] = 0;
      const size_t row = (size_t)fix_rows[base + r];
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
}

// absmax[k] = max_t |w[k, t]| (k < H), absmax[H] = max_t |b[t]|: the
// rows pass's guard bound. One block per row of w, one for b.
__global__ void hpd_absmax_kernel(const float* __restrict__ w, const float* __restrict__ b, int H,
                                  int T, float* __restrict__ absmax) {
  __shared__ float part[THREADS];
  const float* x = blockIdx.x < H ? w + (size_t)blockIdx.x * T : b;
  float a = 0.f;
  for (int t = threadIdx.x; t < T; t += THREADS) a = fmaxf(a, fabsf(x[t]));
  part[threadIdx.x] = a;
  __syncthreads();
  for (int n = THREADS / 2; n > 0; n >>= 1) {
    if (threadIdx.x < n) part[threadIdx.x] = fmaxf(part[threadIdx.x], part[threadIdx.x + n]);
    __syncthreads();
  }
  if (threadIdx.x == 0) absmax[blockIdx.x] = part[0];
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
// (The forward passes use the same machinery: see "forward, on the tensor
// cores" below.) K2 and K6 compute one function; their launches share three
// passes:
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
// nearest). The logits take the lo products apart, as the forward's do
// (LO_APART): p = exp(l - m) / s with m and s from the forward, so a logit
// biased otherwise than the forward's biases p by the difference in one
// direction per column, which dW and db sum over every row (the whole row
// tile's products on one accumulator: dW 1.5e-4 normwise at T = 2^16 on the
// init's weights; apart, 2e-5; apart in the columns kernel alone, still
// 1.5e-4: the row kernels' dot carries the bias too); g_p
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
// Any head width: the contraction over H runs in nc = ceil(H / HMAX) chunks
// of HMAX (the last zero-filled past H), each split_k's halves of one chunk
// from zeroed chains, the chunks' partials summed in fp32 in load order. At
// nc = 1 (H <= HMAX) the passes are the ones above, in instances of their
// own (CH = false: one chunk, a constant, so the main path's kernels carry
// no chunk loop and hold no more registers). Past it the tiles of one
// chunk take the place of the whole-h tiles, so no shared-memory plan grows
// with H, and nothing that a block accumulates does either:
//   row kernels    the w ring carries (column tile, chunk) loads; the h hi /
//                  lo B tile is restaged for every chunk, split from the
//                  fp32 chunk that cp.async brought into dl's tiles while the
//                  chunk before was used; dh's chunks go on grid.y (block y
//                  owns dh columns HMAX y + [0, HMAX)),
//                  its own chunk loaded last in every tile so that its w
//                  chunk is still resident for dh^T = w dl^T; K2's row kernel
//                  runs in two launches, G and dot once per row tile, then
//                  dh's chunks from that dot (K6's B1 / B2 split, in K2's
//                  own kernel).
//   columns kernel the ring carries (row tile, chunk) loads of h, the row
//                  tile's counts, top-K, m, s and dot with its last; the
//                  w^T hi / lo B tile is restaged for every chunk in the same
//                  way (its fp32 chunk staged in dl^T's tiles); dW's
//                  chunks go on grid.z, the block's own chunk last (its h
//                  chunk resident for dW = h^T dl); db in block z = 0.
// So a head of nc chunks computes the logits nc times in each pass that
// holds dh or dW, and restages a B tile per chunk: the cost of keeping one
// HMAX-deep chunk of dh or dW per block.

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

// HMAX-deep chunks of the contraction over H: the backward's grid.y (row
// kernels) or grid.z (columns kernel).
__host__ __device__ __forceinline__ int h_chunks(int H) { return (H + HMAX - 1) / HMAX; }

// The instances of every pass (and of the fix-up): CH = true past HMAX (the
// chunk loops), CH = false else (one chunk, a constant: the code of a
// single h tile).
#define DISPATCH_CHUNKED(H, ...)   \
  if ((H) > HMAX) {                \
    constexpr bool CH = true;      \
    __VA_ARGS__;                   \
  } else {                         \
    constexpr bool CH = false;     \
    __VA_ARGS__;                   \
  }

// Built with -DHPD_STREAM_PHASES (tools/k2_phases.py), thread 0 of each
// block of the backward kernels and of the forward's rows (K1 / K4; not K7)
// and columns passes sums the clock64() ticks of its phases into bwd_phase
// (kernel PK_*, phase PH_*; PH_SELECT: the rows pass's selection, the
// columns pass's p and marginal); every mark is a block barrier, so the
// ticks are the block's. Otherwise the marks compile to nothing.
enum { PH_WAIT, PH_RESTAGE, PH_LOGITS, PH_G, PH_DL, PH_PRODUCT, PH_REST, PH_SELECT, NPH };
enum { PK_ROWS, PK_B1, PK_B2, PK_COLS, PK_FWD_ROWS, PK_FWD_COLS, NPK };
#ifdef HPD_STREAM_PHASES
__device__ unsigned long long bwd_phase[NPK * NPH];
struct Clock {
  unsigned long long ph[NPH], t0;
  __device__ Clock() {
    for (int i = 0; i < NPH; ++i) ph[i] = 0ull;
    t0 = clock64();
  }
  __device__ void mark(int i) {
    __syncthreads();
    const unsigned long long t = clock64();
    ph[i] += t - t0;
    t0 = t;
  }
  __device__ void end(int k) {
    if (threadIdx.x == 0)
      for (int i = 0; i < NPH; ++i) atomicAdd(&bwd_phase[k * NPH + i], ph[i]);
  }
};
#else
struct Clock {
  __device__ void mark(int) {}
  __device__ void end(int) {}
};
#endif

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
// A fragment; b_hi(s), b_lo(s): descriptors. LO_APART (every pass's logits)
// takes the products with a lo operand into an accumulator of their own,
// added to the hi_a hi_b one in fp32 at the end: the large accumulator then
// takes a third of the MMAs, and so a third of the truncations toward zero
// that bias the result.
// b_lo_zero (uniform in the block; LO_APART only): B's lo part is zero, so
// hi_a lo_b is skipped.
template <int P, int N, int S, bool LO_APART = false, typename FA, typename FH, typename FL>
__device__ __forceinline__ void chain(float (&d)[N / 2], int s0, int s1, FA a_of, FH b_hi,
                                      FL b_lo, bool b_lo_zero = false) {
  if constexpr (LO_APART && P != 2) {
    float dl[N / 2];
    keep(d);
    keep(dl);
    wg_fence();
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (s0 + j < s1) {
        const Frag a = a_of(s0 + j);
        wgmma<N>(dl, a.lo, b_hi(s0 + j), j > 0);
        if (!b_lo_zero) wgmma<N>(dl, a.hi, b_lo(s0 + j), 1);
        wgmma<N>(d, a.hi, b_hi(s0 + j), j > 0);
      }
    }
    wg_commit();
    wg_wait();
    keep(d);
    keep(dl);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] += dl[i];
  } else {
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
}

// run += sum over k8 steps [s0, s1) of A(s) B(s) in chains of KCH steps,
// each from zero and added to run in fp32 in order.
template <int P, int N, bool LO_APART = false, typename FA, typename FH, typename FL>
__device__ __forceinline__ void chains_add(float (&run)[N / 2], int s0, int s1, FA a_of,
                                           FH b_hi, FL b_lo) {
  for (int c0 = s0; c0 < s1; c0 += KCH) {
    float d[N / 2];
    chain<P, N, KCH, LO_APART>(d, c0, min(s1, c0 + KCH), a_of, b_hi, b_lo);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) run[i] += d[i];
  }
}

// The same from run = 0 (run = 0 for an empty range).
template <int P, int N, bool LO_APART = false, typename FA, typename FH, typename FL>
__device__ __forceinline__ void chains(float (&run)[N / 2], int s0, int s1, FA a_of, FH b_hi,
                                       FL b_lo) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) run[i] = 0.f;
  chains_add<P, N, LO_APART>(run, s0, s1, a_of, b_hi, b_lo);
}

// split_k's exchange: warpgroup wg's m64n64 partial `part` of a 64 x 64 tile
// whose contraction the two warpgroups split meets the other's through xbuf
// (4096 floats, free on entry and on return): warpgroup wg keeps elements
// [16 wg, 16 wg + 16) of the sum, N = 32 wg + [0, 32), as l (the m64n32
// layout at n0 = 32 wg).
__device__ __forceinline__ void meet(const float (&part)[32], float (&l)[16],
                                     float* __restrict__ xbuf) {
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
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

// The logits of a 64 x 64 tile (M = 64 x N = 64, K = nk8 k8 steps <= 16)
// with K split between the warpgroups: warpgroup wg sums steps [8 wg,
// 8 wg + 8) with m64n64 MMAs, so each loads half of A and no A fragment
// twice; the two partial sums meet through xbuf (meet).
template <int P, bool LO_APART = false, typename FA, typename FH, typename FL>
__device__ __forceinline__ void split_k(float (&l)[16], int nk8, FA a_of, FH b_hi, FL b_lo,
                                        float* __restrict__ xbuf) {
  const int wg = threadIdx.x >> 7;
  float part[32];
  chains<P, 64, LO_APART>(part, 8 * wg, min(nk8, 8 * wg + 8), a_of, b_hi, b_lo);
  meet(part, l, xbuf);
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

// The same for rows [c0, c0 + HMAX) of a head wider than HMAX, zero past H
// (an earlier chunk's rows would remain in the stage).
__device__ __forceinline__ void load_w_chunk_async(const float* __restrict__ w,
                                                   const float* __restrict__ b, int H, int T,
                                                   int t0, int c0, float* __restrict__ w_s,
                                                   float* __restrict__ b_s) {
  const int hc = min(H - c0, HMAX);
  for (int i = threadIdx.x; i < hc * (BT / 4); i += THREADS) {
    const int k = i / (BT / 4), c = (i % (BT / 4)) * 4;
    cp_async16(w_s + k * BT + swz_b(k, c), w + (size_t)(c0 + k) * T + t0 + c);
  }
  for (int i = hc * BT + threadIdx.x; i < HMAX * BT; i += THREADS) w_s[i] = 0.f;
  if (threadIdx.x < BT / 4) cp_async16(b_s + 4 * threadIdx.x, b + t0 + 4 * threadIdx.x);
}

// Past HMAX, the chunks of the B tiles: fp32 by cp.async, then split in
// shared memory.

// h rows [r0, r0 + R), columns [c0, c0 + HMAX) (zero past u and H), fp32,
// into hf (R x HMAX; the backward's row kernels: dl's two tiles) by cp.async.
static_assert(R * HMAX == 2 * R * BT, "h's fp32 chunk fills dl_hi and dl_lo");
__device__ __forceinline__ void load_h_async(const float* __restrict__ h, int u, int H, int r0,
                                             int c0, float* __restrict__ hf) {
  if ((H & 3) == 0 && ((uintptr_t)h & 15) == 0) {
    for (int i = threadIdx.x; i < R * (HMAX / 4); i += THREADS) {
      const int r = i / (HMAX / 4), k = (i % (HMAX / 4)) * 4;
      float* dst = hf + r * HMAX + k;
      if (r0 + r < u && c0 + k < H) {
        cp_async16(dst, h + (size_t)(r0 + r) * H + c0 + k);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i % HMAX;
      if (r0 + r < u && c0 + k < H)
        cp_async4(hf + i, h + (size_t)(r0 + r) * H + c0 + k);
      else
        hf[i] = 0.f;
    }
  }
}

// Four consecutive k of an fp32 operand, split into its hi / lo tiles at o
// (one 16-byte chunk of the 128-byte swizzle; lo not kept for P = 2).
template <int P>
__device__ __forceinline__ void put4(float* __restrict__ hi_t, float* __restrict__ lo_t, int o,
                                     float4 x) {
  uint4 hi, lo;
  split<P>(x.x, hi.x, lo.x);
  split<P>(x.y, hi.y, lo.y);
  split<P>(x.z, hi.z, lo.z);
  split<P>(x.w, hi.w, lo.w);
  *(uint4*)(hi_t + o) = hi;
  if (P != 2) *(uint4*)(lo_t + o) = lo;
}

// hf (R x HMAX, fp32) as hi / lo B tiles of h^T (n = row, k = h), the row
// passes' (forward and backward): a thread takes 4 consecutive k of rows
// threadIdx.x / 32 + 8 j, 16 bytes a load and a store, each warp's stores on
// 32 distinct banks.
template <int P>
__device__ __forceinline__ void split_h(float* __restrict__ h_hi, float* __restrict__ h_lo,
                                        const float* __restrict__ hf) {
  const int k = (threadIdx.x & 31) * 4;
#pragma unroll
  for (int j = 0; j < R * HMAX / (4 * THREADS); ++j) {
    const int r = (threadIdx.x >> 5) + 8 * j;
    put4<P>(h_hi, h_lo, sw128(R, r, k), *(const float4*)(hf + r * HMAX + k));
  }
}

// Rows [c0, c0 + HMAX) of w (zero past H) at columns [t0, t0 + BT), fp32,
// into wf (HMAX x BT; the backward's columns kernel: dl^T's two tiles) by
// cp.async.
static_assert(HMAX * BT == 2 * BT * R, "w's fp32 chunk fills dlt_hi and dlt_lo");
__device__ __forceinline__ void load_wf_async(const float* __restrict__ w, int H, int T, int t0,
                                              int c0, float* __restrict__ wf) {
  for (int i = threadIdx.x; i < HMAX * (BT / 4); i += THREADS) {
    const int k = i / (BT / 4), c = (i % (BT / 4)) * 4;
    float* dst = wf + k * BT + c;
    if (c0 + k < H) {
      cp_async16(dst, w + (size_t)(c0 + k) * T + t0 + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = 0.f;
    }
  }
}

// The same from a chunk that load_wf_async staged in wf (HMAX x BT): a
// thread takes column threadIdx.x % BT at 4 consecutive k, 4 (threadIdx.x /
// BT) + 16 j, storing 16 bytes at once, each warp's stores on 32 banks.
template <int P>
__device__ __forceinline__ void split_wt(float* __restrict__ wt_hi, float* __restrict__ wt_lo,
                                         const float* __restrict__ wf) {
  const int c = threadIdx.x % BT;
#pragma unroll
  for (int j = 0; j < HMAX * BT / (4 * THREADS); ++j) {
    const int k = 4 * (threadIdx.x / BT) + 16 * j;
    const float* x = wf + k * BT + c;
    put4<P>(wt_hi, wt_lo, sw128(BT, c, k), make_float4(x[0], x[BT], x[2 * BT], x[3 * BT]));
  }
}

// ------------------------ forward, on the tensor cores ---------------------- //
//
// Both forward passes take the logits as the backward does (wgmma tf32,
// 3xTF32 at 'highest', the bf16 splits at 'high' / 'default', chains of at
// most 4 k8 steps from zeroed accumulators added in fp32, split_k between
// the warpgroups, the lo products apart from hi_a hi_b (chain's LO_APART)):
// the forward's outputs are held to 1e-5, and that takes two thirds of the
// truncations toward zero off the large accumulator.
//   rows pass    (hpd_fwd_rows_kernel; a block owns R rows, 64-column tiles
//                stream): logits^T (cols x rows) = w^T (A, the streamed fp32
//                w tile by cp.async, split in registers) x h^T (B: h hi/lo,
//                made once per block). Thread (warp q, lane (g, t)) of
//                warpgroup wg holds 8 rows x 2 columns of every tile: 32
//                sub-streams per row, each with an online max / sum-exp,
//                merged in sub-stream order at the end.
//   columns pass (hpd_fwd_cols_kernel; a block owns 64 columns and a row
//                segment, 64-row tiles stream through a cp.async ring):
//                logits (rows x cols) = h (A) x w (B: w^T hi/lo, made once);
//                p = exp(l - m) / s into a p tile; marg^T (cols x levels)
//                += p^T (A, read by hand from the p tile) x counts^T (B:
//                counts hi/lo, n = level, k = row: counts' own layout),
//                m64n16k8 at L <= 16, warpgroup wg summing rows 32 wg + [0,
//                32) of each tile. Per-tile chains, the warpgroups' sums in
//                order, then the fixed segment partials: bitwise stable.
// The columns pass selects nothing. The rows pass selects the exact top-K of
// the fp32 logits (the plain version's, lowest index first) from tensor-core
// logits by candidate refinement:
//   1. each row keeps its top kc = K + GSLACK candidates by tensor-core
//      logit (value desc, index asc): a per-row threshold (the kc-th value)
//      filters each tile; survivors go to a per-row buffer, merged into the
//      sorted list by one thread per row after the tile. The kept set is the
//      exact tensor-core top kc whatever the buffer order.
//   2. at the end each candidate's logit is recomputed in fp32, one fma
//      chain over k ascending, then + b: the arithmetic of tile_dot, so the
//      value the fp32 rows pass (hpd_fix_rows_kernel) gives.
//   3. the top K of the recomputed values (desc, index asc) give idx;
//      vals = exp(l - top) / s from the recomputed values, with s the
//      sweep's sum-exp whose candidate terms are replaced by the
//      recomputed ones; m is the sweep's row max.
//   4. the guard: with eps_r >= |tensor-core logit - fp32 logit| for every
//      column of row r (guard_coef below), every column outside the
//      candidates has an fp32 logit <= (kc-th tensor-core value) + eps_r. So
//      when the K-th recomputed value exceeds the kc-th tensor-core value by
//      more than 2 eps_r, the fp32 top K lies among the candidates, ties
//      included, and step 3 is exact.
//   5. rows that fail the guard go to a list (fix_rows, an atomic count;
//      the order of the list changes nothing) that hpd_fix_rows_kernel, the
//      exact fp32 sweep, settles after the rows pass. The count is returned.
// K7 (hpd_probe_kernel) is the same sweep with its later phases removed.
// Any head width, as in the backward: the contraction over H in nc =
// ceil(H / HMAX) chunks (zero past H in the last), each split_k half of a
// chunk from zeroed chains, the chunks' partials summed in fp32 in chunk
// order, then the halves met and the bias added. H <= HMAX has instances of
// its own (CH = false: one chunk, a constant; the whole-h tiles above). Past
// it the tiles of one chunk take the place of the whole-h tiles, so neither
// plan grows with H, and the restaged B tile's fp32 chunk has a tile of its
// own (32 KB), so that every load, across column or row tiles too, overlaps
// the MMAs of the chunk before:
//   rows pass    load n = chunk n % nc of column tile n / nc: w's chunk into
//                stage n & 1 and h's fp32 chunk into hf; per chunk h^T's hi /
//                lo tile is split from hf (split_h), then hf takes the next
//                load's chunk. 225,792 of the block's 232,448 bytes.
//   columns pass load n = chunk n % nc of row tile n / nc: h's chunk (with
//                the row tile's last, its counts, m and s) into stage n & 1,
//                and w's fp32 chunk of the block's columns into wf; per chunk
//                w^T's hi / lo tile is split from wf (split_wt), then wf
//                takes the next load's chunk. 231,680 bytes.
// The fp32 recompute of the candidates and the guard read h over all of H
// from device memory.

constexpr int GSLACK = 4;                // candidates beyond K
constexpr int KCMAX = KMAX + GSLACK;     // candidate list depth, K <= KMAX
constexpr int NSUBT = 32;                // sub-streams per row in the rows pass
constexpr int XBUF = 4096;               // split_k's exchange (floats)
enum { MODE_DOTS = 0, MODE_SOFTMAX = 1, MODE_SELECT = 2 };

// eps_r = guard_coef(P, H) * (sum_k |h_rk| max_t |w_kt| + max_t |b_t|) =
// c 2^-20 S_r bounds |tensor-core logit - fp32 logit| for every column t,
// since S_r >= sum_k |h_rk w_kt| + |b_t|. With n_f fmas in the fp32 chain
// (H; 3H at 'high', pfma's three) and nc = ceil(H / HMAX) chunks:
//   fp32 chain: n_f fmas and the bias add, each one rounding of a running
//     sum <= 1.01 S_r (the 1.01 covers the bf16 terms' growth at 'high' /
//     'default'): <= 1.01 (n_f + 1) 2^-24 S_r, which is <= (n_f / 16 + 1)
//     2^-20 S_r at nc = 1 and, as n_f <= 384 nc, <= (n_f / 16 + 0.07 +
//     0.24 nc) 2^-20 S_r at any nc.
//   tensor cores: at 'highest' x = hi + lo + r with |r| <= 2^-22 |x|, and
//     lo_a lo_b is dropped: <= 3 2^-22 = 0.75 2^-20 of each |term|; at
//     'high' / 'default' the products are the contract's, exact. An MMA
//     adds its 8 products to the accumulator with each addend truncated
//     against the largest (<= 9 2^-23 S_c, S_c the part of S_r over the
//     chain's k); a chain holds <= 12 MMAs (4 on the hi_a hi_b accumulator;
//     this bound counts all 12): <= 13.5 2^-20 S_c. The chains of every
//     chunk and warpgroup cover disjoint k, so their S_c sum to <= S_r:
//     <= 13.5 2^-20 S_r at any nc.
//   fp32 sums: at nc = 1 those of chains, of the two warpgroups and the
//     bias, 4 roundings: <= 0.25 2^-20 S_r. At nc chunks each warpgroup adds
//     its 2 nc chains (2 nc - 1 roundings), then the halves and the bias:
//     4 nc roundings of sums <= 1.01 S_r, and each chain's lo accumulator
//     added to its hi one (one rounding of the chain, <= 2^-24 S_c):
//     <= (0.2525 nc + 0.0625) 2^-20 S_r.
//   nc = 1: total <= (n_f / 16 + 15.5) 2^-20 S_r; c = n_f / 16 + 16 leaves
//     0.5 for S_r's own fp32 rounding (< 2^-16 of it).
//   nc > 1: total <= (n_f / 16 + 14.38 + 0.4925 nc) 2^-20 S_r; c = n_f / 16
//     + 16 + (nc - 1) / 2 (the value at nc = 1) leaves > 1.1. S_r is summed
//     in double there (its rounding < 2^-40 of it), so what is left covers
//     the float roundings of c, S_r and eps_r (4 of 2^-24 c) for every c <
//     4.6e6: every H <= HWIDE.
template <bool CH>
__device__ __forceinline__ float guard_coef(int P, int H) {
  const float c = (P == 1 ? 3 : 1) * H / 16.f + 16.f;
  return (CH ? c + 0.5f * (h_chunks(H) - 1) : c) * 0x1p-20f;
}

// (v, i) before (v2, i2) in the candidate order: value desc, index asc.
__device__ __forceinline__ bool before(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// logits^T of a 64-column tile for the block's R rows: element i is column
// c_m(0, i) of the tile and row c_n(32 wg, i) (split_k over h; its exchange
// in xbuf), bias added.
template <int P, bool LO_APART>
__device__ __forceinline__ void tile_logits_t(const float* __restrict__ h_hi,
                                              const float* __restrict__ h_lo,
                                              const float* __restrict__ w_s,
                                              const float* __restrict__ b_s, int nk8,
                                              float* __restrict__ xbuf, float (&l)[16]) {
  auto wA = [&](int m, int k) { return w_s[k * BT + swz_b(k, m)]; };
  auto a_of = [&](int s) { return frag_a<P>(wA, 0, 8 * s); };
  auto bh = [&](int s) { return desc_k8(h_hi, R, 0, s); };
  auto bl = [&](int s) { return desc_k8(h_lo, R, 0, s); };
  split_k<P, LO_APART>(l, nk8, a_of, bh, bl, xbuf);
#pragma unroll
  for (int i = 0; i < 16; ++i) l[i] += b_s[c_m(0, i)];
}

// The rows pass's shared memory; the swizzled tiles first, 1024-byte aligned.
// hf, past HMAX only: h's fp32 chunk (R x HMAX).
struct FwdRowsSmem {
  float *h_hi, *h_lo, *xbuf, *w_s, *b_s, *cv, *lv, *thr, *m_s, *s_s, *ex, *hf;
  int *ci, *li, *ccnt;
  __device__ explicit FwdRowsSmem(float* smem) {
    h_hi = align1024(smem);
    h_lo = h_hi + R * HMAX;
    xbuf = h_lo + R * HMAX;
    w_s = xbuf + XBUF;          // 2 stages of HMAX x BT, fp32
    b_s = w_s + 2 * HMAX * BT;
    cv = b_s + 2 * BT;          // per-row candidate buffer of a tile
    ci = (int*)(cv + R * BT);
    lv = (float*)(ci + R * BT);  // per-row candidate list, sorted
    li = (int*)(lv + R * KCMAX);
    thr = (float*)(li + R * KCMAX);
    ccnt = (int*)(thr + R);
    m_s = (float*)(ccnt + R);
    s_s = m_s + R;
    hf = s_s + R;
    ex = cv;                    // the candidates' fp32 logits, after the sweep
  }
};
constexpr int FWD_ROWS_SMEM =
    2 * R * HMAX + XBUF + 2 * HMAX * BT + 2 * BT + 2 * R * BT + 2 * R * KCMAX + 4 * R;
size_t fwd_rows_smem(bool chunked) {
  return sizeof(float) * (FWD_ROWS_SMEM + (chunked ? R * HMAX : 0)) + 1024;
}

// Load n of the rows pass past HMAX: w's chunk n % nc of column tile n / nc
// and the tile's bias into stage n & 1 (nothing past the last), not
// committed.
__device__ __forceinline__ void fwd_rows_issue_w(const FwdRowsSmem& sm,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ b, int H, int T,
                                                 int nc, int n) {
  if (n < T / BT * nc)
    load_w_chunk_async(w, b, H, T, n / nc * BT, n % nc * HMAX, sm.w_s + (n & 1) * HMAX * BT,
                       sm.b_s + (n & 1) * BT);
}

// logits^T of column tile it past HMAX, laid out as tile_logits_t's. Per
// chunk: wait for its loads, split h^T's hi / lo tile from hf, give hf the
// next load's h chunk, add each warpgroup's split_k half of the chunk to its
// partial; after the tile's last chunk meet the halves (xbuf) and add the
// bias; then, every warp done with the stage, issue w load n + 2 into it.
// The commit groups end, at each chunk's start, with w load n, h's chunk n
// (wait<1> takes both) and w load n + 1.
template <int P>
__device__ __forceinline__ void fwd_rows_chunks(const FwdRowsSmem& sm,
                                                const float* __restrict__ h,
                                                const float* __restrict__ w,
                                                const float* __restrict__ b, int u, int H,
                                                int T, int r0, int it, Clock& clk,
                                                float (&l)[16]) {
  const int wg = threadIdx.x >> 7;
  const int nc = h_chunks(H), n_loads = T / BT * nc;
  float part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
  for (int ci = 0; ci < nc; ++ci) {
    const int n = it * nc + ci;
    const float* w_s = sm.w_s + (n & 1) * HMAX * BT;
    cp_wait<1>();
    async_view();
    __syncthreads();
    clk.mark(PH_WAIT);
    split_h<P>(sm.h_hi, sm.h_lo, sm.hf);
    async_view();
    __syncthreads();
    if (n + 1 < n_loads) load_h_async(h, u, H, r0, (n + 1) % nc * HMAX, sm.hf);
    cp_commit();
    clk.mark(PH_RESTAGE);
    auto wA = [&](int m, int k) { return w_s[k * BT + swz_b(k, m)]; };
    auto a_of = [&](int s) { return frag_a<P>(wA, 0, 8 * s); };
    auto bh = [&](int s) { return desc_k8(sm.h_hi, R, 0, s); };
    auto bl = [&](int s) { return desc_k8(sm.h_lo, R, 0, s); };
    const int nk8 = (min(H - ci * HMAX, HMAX) + 7) / 8;
    chains_add<P, 64, true>(part, 8 * wg, min(nk8, 8 * wg + 8), a_of, bh, bl);
    clk.mark(PH_LOGITS);
    if (ci + 1 == nc) {
      meet(part, l, sm.xbuf);
      const float* b_s = sm.b_s + (n & 1) * BT;
#pragma unroll
      for (int i = 0; i < 16; ++i) l[i] += b_s[c_m(0, i)];
      clk.mark(PH_LOGITS);
    }
    __syncthreads();  // every warp is done with the stage and its bias
    fwd_rows_issue_w(sm, w, b, H, T, nc, n + 2);
    cp_commit();
  }
}

// The rows pass of the block's R rows. MODE_SELECT writes vals, idx (u, K),
// m, s and lists the rows its guard leaves to the fix-up; MODE_SOFTMAX (K7)
// writes the row max and sum-exp; MODE_DOTS (K7) m = s = the row sum of the
// logits, per tile first, then over the sub-streams in order. CH: a head
// past HMAX (fwd_rows_chunks).
template <int P, int MODE, bool CH>
__device__ __forceinline__ void fwd_rows_sweep(
    float* smem, const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ b, int u, int H, int T, int K, const float* __restrict__ absmax,
    float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ m_out,
    float* __restrict__ s_out, int* __restrict__ fix_rows, int* __restrict__ n_fix) {
  const FwdRowsSmem sm(smem);
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const int r0 = blockIdx.x * R;
  const int nk8 = (H + 7) / 8;
  const int kc = K + GSLACK;
  Clock clk;
  if (!CH) {
    // h^T (n = row, k = h) as hi / lo B tiles, zero past u and H; w rows past
    // H zero in both stages
    for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i % HMAX;
      put<P>(sm.h_hi, sm.h_lo, sw128(R, r, k),
             (r0 + r < u && k < H) ? h[(size_t)(r0 + r) * H + k] : 0.f);
    }
    for (int i = H * BT + threadIdx.x; i < HMAX * BT; i += THREADS) {
      sm.w_s[i] = 0.f;
      sm.w_s[HMAX * BT + i] = 0.f;
    }
  }
  if (MODE == MODE_SELECT) {
    for (int r = threadIdx.x; r < R; r += THREADS) {
      sm.thr[r] = -INFINITY;
      sm.ccnt[r] = 0;
    }
  }
  if (CH) {
    // w load 0, h's chunk of it, w load 1, one commit group each
    fwd_rows_issue_w(sm, w, b, H, T, h_chunks(H), 0);
    cp_commit();
    load_h_async(h, u, H, r0, 0, sm.hf);
    cp_commit();
    fwd_rows_issue_w(sm, w, b, H, T, h_chunks(H), 1);
    cp_commit();
  } else {
    // w tiles 0 and 1 by cp.async, one commit group each
    load_w_async(w, b, H, T, 0, sm.w_s, sm.b_s);
    cp_commit();
    if (BT < T) load_w_async(w, b, H, T, BT, sm.w_s + HMAX * BT, sm.b_s + BT);
    cp_commit();
  }
  float mrun[8], srun[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    mrun[q] = -INFINITY;
    srun[q] = 0.f;
  }
  int len = 0;  // thread r < R: length of row r's candidate list
  clk.mark(PH_REST);
  for (int t0 = 0, it = 0; t0 < T; t0 += BT, ++it) {
    const int st = it & 1;
    float l[16];
    if (CH) {
      fwd_rows_chunks<P>(sm, h, w, b, u, H, T, r0, it, clk, l);
    } else {
      cp_wait<1>();
      async_view();
      __syncthreads();
      clk.mark(PH_WAIT);
      tile_logits_t<P, true>(sm.h_hi, sm.h_lo, sm.w_s + st * HMAX * BT, sm.b_s + st * BT, nk8,
                             sm.xbuf, l);
      clk.mark(PH_LOGITS);
    }
    // row q = 2 j + e of the thread: elements 4 j + e (column c) and
    // 4 j + 2 + e (column c + 8)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * j + e;
        const float v0 = l[4 * j + e], v1 = l[4 * j + 2 + e];
        if (MODE == MODE_DOTS) {
          srun[q] += v0 + v1;
        } else {
          const float mnew = fmaxf(mrun[q], fmaxf(v0, v1));
          srun[q] = srun[q] * expf(mrun[q] - mnew) + (expf(v0 - mnew) + expf(v1 - mnew));
          mrun[q] = mnew;
        }
        if (MODE == MODE_SELECT) {
          const int r = c_n(32 * wg, 4 * j + e), c = t0 + c_m(0, 4 * j + e);
          const float th = sm.thr[r];
          if (v0 > th) {
            const int p = atomicAdd(&sm.ccnt[r], 1);
            sm.cv[r * BT + p] = v0;
            sm.ci[r * BT + p] = c;
          }
          if (v1 > th) {
            const int p = atomicAdd(&sm.ccnt[r], 1);
            sm.cv[r * BT + p] = v1;
            sm.ci[r * BT + p] = c + 8;
          }
        }
      }
    __syncthreads();
    if (MODE == MODE_SELECT && threadIdx.x < R) {
      // merge the tile's survivors into row r's list (insertion, desc / asc)
      const int r = threadIdx.x, n = sm.ccnt[r];
      float* lvr = sm.lv + r * KCMAX;
      int* lir = sm.li + r * KCMAX;
      for (int e = 0; e < n; ++e) {
        const float v = sm.cv[r * BT + e];
        const int c = sm.ci[r * BT + e];
        if (len == kc && !before(v, c, lvr[kc - 1], lir[kc - 1])) continue;
        int pos = len < kc ? len : kc - 1;
        while (pos > 0 && before(v, c, lvr[pos - 1], lir[pos - 1])) {
          lvr[pos] = lvr[pos - 1];
          lir[pos] = lir[pos - 1];
          --pos;
        }
        lvr[pos] = v;
        lir[pos] = c;
        if (len < kc) ++len;
      }
      sm.ccnt[r] = 0;
      if (len == kc) sm.thr[r] = lvr[kc - 1];
    }
    if (!CH) {
      if (t0 + 2 * BT < T)
        load_w_async(w, b, H, T, t0 + 2 * BT, sm.w_s + st * HMAX * BT, sm.b_s + st * BT);
      cp_commit();
    }
    clk.mark(PH_SELECT);
  }
  cp_wait<0>();
  // the row statistics: sub-stream 8 wq + g of row r, merged in order
  float* pm = sm.xbuf;
  float* ps = sm.xbuf + R * NSUBT;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = c_n(32 * wg, 4 * j + e), sub = 8 * wq + g;
      pm[r * NSUBT + sub] = mrun[2 * j + e];
      ps[r * NSUBT + sub] = srun[2 * j + e];
    }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float m = -INFINITY, s = 0.f;
    if (MODE == MODE_DOTS) {
      for (int sub = 0; sub < NSUBT; ++sub) s += ps[r * NSUBT + sub];
      m = s;
    } else {
      for (int sub = 0; sub < NSUBT; ++sub) m = fmaxf(m, pm[r * NSUBT + sub]);
      for (int sub = 0; sub < NSUBT; ++sub) s += ps[r * NSUBT + sub] * expf(pm[r * NSUBT + sub] - m);
    }
    if (r0 + r < u) {
      m_out[r0 + r] = m;
      s_out[r0 + r] = s;
    }
    sm.m_s[r] = m;
    sm.s_s[r] = s;
  }
  if (MODE != MODE_SELECT) return;
  __syncthreads();
  // each candidate's fp32 logit: tile_dot's chain over k ascending, then + b
  for (int pi = threadIdx.x; pi < R * kc; pi += THREADS) {
    const int r = pi / kc, c = pi % kc;
    if (r0 + r >= u) continue;
    const int t = sm.li[r * KCMAX + c];
    const float* hr = h + (size_t)(r0 + r) * H;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc = pfma<P>(hr[k], w[(size_t)k * T + t], acc);
    sm.ex[r * KCMAX + c] = acc + b[t];
  }
  __syncthreads();
  if (threadIdx.x < R && r0 + threadIdx.x < u) {
    const int r = threadIdx.x;
    const size_t row = (size_t)(r0 + r);
    const float* exr = sm.ex + r * KCMAX;
    const float* lvr = sm.lv + r * KCMAX;
    const int* lir = sm.li + r * KCMAX;
    const float m = sm.m_s[r];
    int sel[KMAX];
    unsigned taken = 0u;
    for (int q = 0; q < K; ++q) {
      int best = 0;
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int c = 0; c < kc; ++c) {
        if ((taken >> c) & 1u) continue;
        if (before(exr[c], lir[c], bv, bi)) {
          best = c;
          bv = exr[c];
          bi = lir[c];
        }
      }
      taken |= 1u << best;
      sel[q] = best;
      idx[row * K + q] = bi;
    }
    // s with the candidates' terms from the fp32 recompute, as differences
    // from the top one (they carry most of a peaked row's sum, and a
    // tensor-core logit near 70 is off by about 5e-5, which moves its term
    // by as much), the rest from the sweep; m stays the sweep's, so that
    // p = exp(l - m) / s of the later passes, on tensor-core logits, is
    // 1 / s at the top. vals = exp(fp32 difference from the top) / s.
    const float top = exr[sel[0]];
    float rest = sm.s_s[r];
    for (int c = 0; c < kc; ++c) rest -= expf(lvr[c] - m);
    float s = fmaxf(rest, 0.f);
    for (int c = 0; c < kc; ++c) s += expf(exr[c] - top);
    for (int q = 0; q < K; ++q) vals[row * K + q] = expf(exr[sel[q]] - top) / s;
    s_out[row] = s;
    const float ek = exr[sel[K - 1]];
    const float* hr = h + row * H;
    float sr;
    if (CH) {  // S_r in double past HMAX (guard_coef)
      double sd = absmax[H];
      for (int k = 0; k < H; ++k) sd = fma((double)fabsf(hr[k]), (double)absmax[k], sd);
      sr = (float)sd;
    } else {
      sr = absmax[H];
      for (int k = 0; k < H; ++k) sr = fmaf(fabsf(hr[k]), absmax[k], sr);
    }
    // NaN anywhere fails the guard and goes to the fix-up as well
    if (!(ek - sm.lv[r * KCMAX + kc - 1] > 2.f * guard_coef<CH>(P, H) * sr))
      fix_rows[atomicAdd(n_fix, 1)] = (int)row;
  }
  clk.mark(PH_REST);
  clk.end(PK_FWD_ROWS);
}

// K4 and K1's first pass: vals, idx, m, s; rows the guard leaves go to
// fix_rows / n_fix for hpd_fix_rows_kernel.
template <int P, bool CH>
__global__ void __launch_bounds__(THREADS, 1)
hpd_fwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, int u, int H, int T, int K,
                    const float* __restrict__ absmax, float* __restrict__ vals,
                    int* __restrict__ idx, float* __restrict__ m_out, float* __restrict__ s_out,
                    int* __restrict__ fix_rows, int* __restrict__ n_fix) {
  extern __shared__ float smem[];
  fwd_rows_sweep<P, MODE_SELECT, CH>(smem, h, w, b, u, H, T, K, absmax, vals, idx, m_out, s_out,
                                     fix_rows, n_fix);
}

// K7: the rows pass with its later phases removed (DOTS: m = s = row sum of
// the logits; else the row max and sum-exp).
template <int P, bool DOTS, bool CH>
__global__ void __launch_bounds__(THREADS, 1)
hpd_probe_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ b, int u, int H, int T, float* __restrict__ m_out,
                 float* __restrict__ s_out) {
  extern __shared__ float smem[];
  fwd_rows_sweep<P, DOTS ? MODE_DOTS : MODE_SOFTMAX, CH>(smem, h, w, b, u, H, T, 1, nullptr,
                                                         nullptr, nullptr, m_out, s_out, nullptr,
                                                         nullptr);
}

// The columns pass's per-row-tile stage (fp32): the h tile (read by hand as
// A, swz_a), counts (level-major, as in device memory), m, s.
struct FwdColsStage {
  float *h_s, *c_s, *m_s, *s_s;
  __device__ explicit FwdColsStage(float* base) {
    h_s = base;
    c_s = h_s + R * HMAX;
    m_s = c_s + LP * R;
    s_s = m_s + R;
  }
};
constexpr int FWD_COLS_STAGE = R * HMAX + LP * R + 2 * R;

// Row tile [r0, r0 + R) of the segment (ending at rend) into a stage:
// cp.async below rend, neutral values past it (h = 0, counts 0, m = inf,
// s = 1: p = 0). CH (a head past HMAX): h's columns [c0, c0 + HMAX), zero
// past H, and the counts, m and s only with `extras` (the row tile's last
// chunk); else c0 = 0 and extras, constants.
template <bool CH>
__device__ __forceinline__ void load_fwd_stage_async(FwdColsStage st, const float* __restrict__ h,
                                                     const float* __restrict__ counts,
                                                     const float* __restrict__ m_in,
                                                     const float* __restrict__ s_in, int u,
                                                     int rend, int H, int L, int r0,
                                                     int chunk_c0 = 0, bool chunk_extras = true) {
  const int c0 = CH ? chunk_c0 : 0;
  const bool extras = CH ? chunk_extras : true;
  if ((H & 3) == 0 && ((uintptr_t)h & 15) == 0) {
    for (int i = threadIdx.x; i < R * (HMAX / 4); i += THREADS) {
      const int r = i / (HMAX / 4), k = (i % (HMAX / 4)) * 4;
      float* dst = st.h_s + r * HMAX + swz_a(r, k);
      if (r0 + r < rend && c0 + k < H) {
        cp_async16(dst, h + (size_t)(r0 + r) * H + c0 + k);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i % HMAX;
      float* dst = st.h_s + r * HMAX + swz_a(r, k);
      if (r0 + r < rend && c0 + k < H)
        cp_async4(dst, h + (size_t)(r0 + r) * H + c0 + k);
      else
        *dst = 0.f;
    }
  }
  if (!extras) return;
  for (int i = threadIdx.x; i < LP * R; i += THREADS) {
    const int l = i / R, r = i % R;
    if (l < L && r0 + r < rend)
      cp_async4(st.c_s + i, counts + (size_t)l * u + r0 + r);
    else
      st.c_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    if (r0 + r < rend) {
      cp_async4(st.m_s + r, m_in + r0 + r);
      cp_async4(st.s_s + r, s_in + r0 + r);
    } else {
      st.m_s[r] = INFINITY;
      st.s_s[r] = 1.f;
    }
  }
}

// + HMAX x BT past HMAX: wf, w's fp32 chunk
constexpr int FWD_COLS_SMEM =
    2 * BT * HMAX + 2 * LP * R + R * BT + XBUF + BT + 2 * FWD_COLS_STAGE;
size_t fwd_cols_smem(bool chunked) {
  return sizeof(float) * (FWD_COLS_SMEM + (chunked ? HMAX * BT : 0)) + 1024;
}

// K5 and K1's second pass. Grid (T / BT, SEGS): one block per 64-column
// tile and row segment sums marg over the segment's rows into
// marg_part[seg]. Logits and p: warpgroup wg holds the tile's 64 rows x
// columns 32 wg + [0, 32) (past HMAX summed over h's chunks, the w^T tile
// restaged for each); marg^T: warpgroup wg sums rows 32 wg + [0, 32) of
// every tile, and the two sums meet in order at the end.
template <int P, bool CH>
__global__ void __launch_bounds__(THREADS, 1)
hpd_fwd_cols_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const float* __restrict__ m_in, const float* __restrict__ s_in, int u,
                    int H, int T, int L, int seg_rows, float* __restrict__ marg_part) {
  extern __shared__ float smem[];
  float* wt_hi = align1024(smem);  // w^T (n = column, k = h)
  float* wt_lo = wt_hi + BT * HMAX;
  float* c_hi = wt_lo + BT * HMAX;  // counts (n = level, k = row)
  float* c_lo = c_hi + LP * R;
  float* p_s = c_lo + LP * R;  // p (row, column), swz_b
  float* xbuf = p_s + R * BT;
  float* b_s = xbuf + XBUF;
  float* stage0 = b_s + BT;
  float* wf = stage0 + 2 * FWD_COLS_STAGE;  // CH: w's fp32 chunk (HMAX x BT)
  const int wg = threadIdx.x >> 7;
  const int t0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int rbeg = seg * seg_rows;
  const int rend = min(u, rbeg + seg_rows);
  const int nk8 = (H + 7) / 8;
  Clock clk;
  // CH: load n is chunk n % nc of row tile n / nc, into stage n & 1, with
  // the row tile's counts, m and s on its last chunk; w's chunk of load n
  // goes to wf. The commit groups end, at each chunk's start, with load n,
  // w's chunk n (wait<1> takes both) and load n + 1.
  const int nc = CH ? h_chunks(H) : 1;
  const int n_loads = (rend > rbeg ? (rend - rbeg + R - 1) / R : 0) * nc;
  auto issue = [&](int n) {  // not committed; nothing past the last
    if (n < n_loads)
      load_fwd_stage_async<true>(FwdColsStage(stage0 + (n & 1) * FWD_COLS_STAGE), h, counts,
                                 m_in, s_in, u, rend, H, L, rbeg + n / nc * R, n % nc * HMAX,
                                 n % nc == nc - 1);
  };
  if (CH) {
    issue(0);
    cp_commit();
    if (n_loads > 0) load_wf_async(w, H, T, t0, 0, wf);
    cp_commit();
    issue(1);
    cp_commit();
  } else {
    for (int s = 0; s < 2; ++s) {
      if (rbeg + s * R < rend)
        load_fwd_stage_async<false>(FwdColsStage(stage0 + s * FWD_COLS_STAGE), h, counts, m_in,
                                    s_in, u, rend, H, L, rbeg + s * R);
      cp_commit();
    }
    for (int i = threadIdx.x; i < HMAX * BT; i += THREADS) {
      const int k = i / BT, c = i % BT;
      put<P>(wt_hi, wt_lo, sw128(BT, c, k), k < H ? w[(size_t)k * T + t0 + c] : 0.f);
    }
  }
  if (threadIdx.x < BT) b_s[threadIdx.x] = b[t0 + threadIdx.x];
  // marg^T partial: element i is column c_m(0, i), level c_n(0, i) (the
  // first 8 elements, an m64n16 product, for L <= 16)
  float macc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) macc[i] = 0.f;
  clk.mark(PH_REST);
  for (int r0 = rbeg, it = 0; r0 < rend; r0 += R, ++it) {
    const int last = CH ? it * nc + nc - 1 : it;  // the row tile's last load
    const FwdColsStage st(stage0 + (last & 1) * FWD_COLS_STAGE);
    // logits: element i is row c_m(0, i), column c_n(32 wg, i)
    float q[16];
    if (CH) {
      // the warpgroup's partial over h's chunks, in chunk order
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      for (int ci = 0; ci < nc; ++ci) {
        const int n = it * nc + ci;
        const float* h_s = stage0 + (n & 1) * FWD_COLS_STAGE;
        cp_wait<1>();
        async_view();
        __syncthreads();
        clk.mark(PH_WAIT);
        // w^T's chunk from wf, then the next load's chunk into wf
        split_wt<P>(wt_hi, wt_lo, wf);
        async_view();
        __syncthreads();
        if (n + 1 < n_loads) load_wf_async(w, H, T, t0, (n + 1) % nc * HMAX, wf);
        cp_commit();
        clk.mark(PH_RESTAGE);
        auto hA = [&](int m, int k) { return h_s[m * HMAX + swz_a(m, k)]; };
        auto a_of = [&](int s) { return frag_a<P>(hA, 0, 8 * s); };
        auto bh = [&](int s) { return desc_k8(wt_hi, BT, 0, s); };
        auto bl = [&](int s) { return desc_k8(wt_lo, BT, 0, s); };
        const int nk8c = (min(H - ci * HMAX, HMAX) + 7) / 8;
        chains_add<P, 64, true>(part, 8 * wg, min(nk8c, 8 * wg + 8), a_of, bh, bl);
        clk.mark(PH_LOGITS);
        if (ci + 1 < nc) {
          __syncthreads();  // every warp is done with the stage
          issue(n + 2);
          cp_commit();
        }
      }
      meet(part, q, xbuf);
      clk.mark(PH_LOGITS);
    } else {
      cp_wait<1>();
      async_view();
      __syncthreads();
      clk.mark(PH_WAIT);
    }
    // counts^T as the B tile (the m64n16 product reads levels 0-15 only);
    // occurrence counts up to 2^11 are exact in tf32, so their lo part is
    // zero and the tile's hi_a lo_b product is skipped (decided per tile,
    // by the block's vote after the split, so any count stays exact)
    bool c_lo_nonzero = false;
    for (int i = threadIdx.x; i < (L <= 16 ? 16 : LP) * R; i += THREADS) {
      const int l = i / R, r = i % R;
      uint32_t hi, lo;
      split<P>(st.c_s[i], hi, lo);
      c_hi[sw128(LP, l, r)] = __uint_as_float(hi);
      if (P != 2) c_lo[sw128(LP, l, r)] = __uint_as_float(lo);
      c_lo_nonzero |= lo != 0u;
    }
    if (!CH) {
      auto hA = [&](int m, int k) { return st.h_s[m * HMAX + swz_a(m, k)]; };
      auto a_of = [&](int s) { return frag_a<P>(hA, 0, 8 * s); };
      auto bh = [&](int s) { return desc_k8(wt_hi, BT, 0, s); };
      auto bl = [&](int s) { return desc_k8(wt_lo, BT, 0, s); };
      split_k<P, true>(q, nk8, a_of, bh, bl, xbuf);
      clk.mark(PH_LOGITS);
    }
    const float inv0 = recip_s(st.s_s[c_m(0, 0)]), inv1 = recip_s(st.s_s[c_m(0, 2)]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = c_m(0, i), c = c_n(32 * wg, i);
      p_s[r * BT + swz_b(r, c)] =
          to_p(q[i] + b_s[c], st.m_s[r], (i >> 1) & 1 ? inv1 : inv0);
    }
    async_view();
    const bool c_lo_zero = !__syncthreads_or(c_lo_nonzero);
    // marg^T += p^T counts^T: A (m = column, k = row) from the p tile
    {
      auto pA = [&](int m, int k) { return p_s[k * BT + swz_b(k, m)]; };
      auto a_of = [&](int s) { return frag_a<P>(pA, 0, 8 * s); };
      auto bh = [&](int s) { return desc_k8(c_hi, LP, 0, s); };
      auto bl = [&](int s) { return desc_k8(c_lo, LP, 0, s); };
      if (L <= 16) {
        float d[8];
        chain<P, 16, 4, true>(d, 4 * wg, 4 * wg + 4, a_of, bh, bl, c_lo_zero);
#pragma unroll
        for (int i = 0; i < 8; ++i) macc[i] += d[i];
      } else {
        float d[16];
        chain<P, 32, 4, true>(d, 4 * wg, 4 * wg + 4, a_of, bh, bl, c_lo_zero);
#pragma unroll
        for (int i = 0; i < 16; ++i) macc[i] += d[i];
      }
    }
    __syncthreads();
    if (CH) {
      issue(last + 2);
    } else if (r0 + 2 * R < rend) {
      load_fwd_stage_async<false>(FwdColsStage(stage0 + (it & 1) * FWD_COLS_STAGE), h, counts,
                                  m_in, s_in, u, rend, H, L, r0 + 2 * R);
    }
    cp_commit();
    clk.mark(PH_SELECT);
  }
  cp_wait<0>();
  // marg^T = warpgroup 0's sum + warpgroup 1's, in that order
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) xbuf[c_m(0, i) * LP + c_n(0, i)] = macc[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = c_m(0, i), l = c_n(0, i);
      if (l < L) marg_part[((size_t)seg * L + l) * T + t0 + c] = macc[i] + xbuf[c * LP + l];
    }
  }
  clk.mark(PH_REST);
  clk.end(PK_FWD_COLS);
}

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

// h rows [r0, r0 + R), columns [c0, c0 + HMAX) (zero past u and H) as the
// row kernels' hi / lo B tiles (n = row, k = h).
template <int P>
__device__ __forceinline__ void stage_h(const RowsSmem& sm, const float* __restrict__ h, int u,
                                        int H, int r0, int c0) {
  for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
    const int r = i / HMAX, k = i % HMAX;
    put<P>(sm.h_hi, sm.h_lo, sw128(R, r, k),
           (r0 + r < u && c0 + k < H) ? h[(size_t)(r0 + r) * H + c0 + k] : 0.f);
  }
}

// Row kernels' start: h rows [r0, r0 + R) as hi / lo tiles where one chunk
// holds them (past HMAX the sweeps restage every chunk), counts^T as hi / lo
// tiles, per-row state (1 / s for s), the mask of column tiles that hold a
// top-K index, zero rows of the w buffers past H.
template <int P, bool CH>
__device__ __forceinline__ void rows_prologue(const RowsSmem& sm, const float* __restrict__ h,
                                              const float* __restrict__ counts,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ m_in,
                                              const float* __restrict__ s_in,
                                              const float* __restrict__ g_vals, int u, int H,
                                              int L, int K, int r0) {
  if (!CH) stage_h<P>(sm, h, u, H, r0, 0);
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

// The w loads of a row kernel's sweep: load n is chunk chunk(n) of column
// tile n / nc into stage n & 1; `last` is the chunk each tile loads last,
// which stays resident after the tile's logits. Past HMAX the h chunk of
// load n comes by cp.async too, into dl's tiles (free while the logits
// run), in a commit group of its own after w load n: at every chunk's start
// the groups end with those two (wait<1> takes them) and w load n + 1.
struct WRing {
  int nc, last, n_loads;
  // chunked: H > HMAX (else nc = 1, a constant of the instance)
  __device__ WRing(int H, int T, int last_, bool chunked)
      : nc(chunked ? h_chunks(H) : 1), last(last_), n_loads(T / BT * nc) {}
  __device__ int chunk(int n) const { return (last + 1 + n % nc) % nc; }
  // load n into its stage (nothing past the last), not committed
  __device__ void issue(const RowsSmem& sm, const float* __restrict__ w,
                        const float* __restrict__ b, int H, int T, int n) const {
    if (n >= n_loads) return;
    if (nc == 1)
      load_w_async(w, b, H, T, n * BT, sm.w_s + (n & 1) * HMAX * BT, sm.b_s + (n & 1) * BT);
    else
      load_w_chunk_async(w, b, H, T, n / nc * BT, chunk(n) * HMAX,
                         sm.w_s + (n & 1) * HMAX * BT, sm.b_s + (n & 1) * BT);
  }
  // the h chunk of load n into the fp32 staging tile (nothing past the last),
  // not committed
  __device__ void issue_h(const RowsSmem& sm, const float* __restrict__ h, int u, int H, int r0,
                          int n) const {
    if (n < n_loads) load_h_async(h, u, H, r0, chunk(n) * HMAX, sm.dl_hi);
  }
  // the stage of column tile it's last load (w chunk `last`, the tile's bias)
  __device__ int last_stage(int it) const { return (it * nc + nc - 1) & 1; }
};

// A sweep's start: g_marg tile 0 into stage 0; w loads 0 and 1 (and, CH,
// h's chunk of load 0 between them) by cp.async, one commit group each.
template <int P, bool CH>
__device__ __forceinline__ void sweep_start(const RowsSmem& sm, const WRing& ring,
                                            const float* __restrict__ h,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            const float* __restrict__ g_marg, int u, int r0,
                                            int H, int T, int L) {
  float v[LP * BT / THREADS];
  load_gm(g_marg, T, L, 0, v);
  store_gm<P>(v, sm.gm_hi, sm.gm_lo);
  ring.issue(sm, w, b, H, T, 0);
  cp_commit();
  if (CH) {
    ring.issue_h(sm, h, u, H, r0, 0);
    cp_commit();
  }
  ring.issue(sm, w, b, H, T, 1);
  cp_commit();
}

// The commit groups that end column tile it: h's chunk (CH) and w of the
// next tile's first load, then w load + 1.
template <bool CH>
__device__ __forceinline__ void sweep_next(const RowsSmem& sm, const WRing& ring,
                                           const float* __restrict__ h,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int u, int r0, int H,
                                           int T, int it) {
  const int n = (it + 1) * ring.nc;  // the next tile's first load, already in flight
  if (CH) {
    ring.issue_h(sm, h, u, H, r0, n);
    cp_commit();
  }
  ring.issue(sm, w, b, H, T, n + 1);
  cp_commit();
}

// p^T of column tile it: element i of the m64n32 layout is column
// BT it + c_m(0, i) and row c_n(32 wg, i) of the block. Takes the tile's nc
// loads from the ring, waiting for each: per chunk (h restaged first where
// nc > 1) each warpgroup's split_k half, summed over the chunks in load
// order, then the halves met (xbuf: dl_hi); load n + 2 issued after each
// load but the tile's last, whose stage the caller still reads. CH: the
// instance for heads past HMAX (nc = 1 a constant otherwise).
template <int P, bool CH>
__device__ __forceinline__ void rows_p(const RowsSmem& sm, const WRing& ring,
                                       const float* __restrict__ h, const float* __restrict__ w,
                                       const float* __restrict__ b, int u, int H, int T, int r0,
                                       int it, Clock& clk, float (&l)[16]) {
  const int wg = threadIdx.x >> 7;
  if (!CH) {  // one chunk: the whole h tile stays; split_k as in the forward
    const int st = it & 1;
    cp_wait<1>();
    async_view();
    __syncthreads();
    clk.mark(PH_WAIT);
    tile_logits_t<P, true>(sm.h_hi, sm.h_lo, sm.w_s + st * HMAX * BT, sm.b_s + st * BT,
                           (H + 7) / 8, sm.dl_hi, l);
    clk.mark(PH_LOGITS);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = c_n(32 * wg, i);
      l[i] = to_p(l[i], sm.m_s[r], sm.inv_s[r]);
    }
    return;
  }
  float part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
  const int nc = ring.nc;
  for (int ci = 0; ci < nc; ++ci) {
    const int n = it * nc + ci, c0 = ring.chunk(n) * HMAX;
    const float* w_s = sm.w_s + (n & 1) * HMAX * BT;
    cp_wait<1>();
    async_view();
    __syncthreads();
    clk.mark(PH_WAIT);
    // h's chunk from the staging tile, then the next chunk into it
    split_h<P>(sm.h_hi, sm.h_lo, sm.dl_hi);
    async_view();
    __syncthreads();
    if (ci + 1 < nc) {
      ring.issue_h(sm, h, u, H, r0, n + 1);
      cp_commit();
    }
    clk.mark(PH_RESTAGE);
    auto wA = [&](int m, int k) { return w_s[k * BT + swz_b(k, m)]; };
    auto a_of = [&](int s) { return frag_a<P>(wA, 0, 8 * s); };
    auto bh = [&](int s) { return desc_k8(sm.h_hi, R, 0, s); };
    auto bl = [&](int s) { return desc_k8(sm.h_lo, R, 0, s); };
    const int nk8 = (min(H - c0, HMAX) + 7) / 8;
    chains_add<P, 64, true>(part, 8 * wg, min(nk8, 8 * wg + 8), a_of, bh, bl);
    clk.mark(PH_LOGITS);
    if (ci + 1 < nc) {
      __syncthreads();  // every warp is done with the stage and with h's tiles
      ring.issue(sm, w, b, H, T, n + 2);
      cp_commit();
    }
  }
  meet(part, l, sm.dl_hi);
  clk.mark(PH_LOGITS);
  const float* b_s = sm.b_s + ring.last_stage(it) * BT;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = c_n(32 * wg, i);
    l[i] = to_p(l[i] + b_s[c_m(0, i)], sm.m_s[r], sm.inv_s[r]);
  }
}

// G[r, l] = <p[r], g_marg[l]>: warpgroup wg sums columns 32 wg + [0, 32) of
// every tile; element i of the m64n32 accumulator is row c_m(0, i), level
// c_n(0, i) (the first 8 elements for L <= 16, an m64n16 product). The
// chunks of h in order, so every block of a row tile computes the same G.
template <int P, bool CH>
__device__ __forceinline__ void g_sweep(const RowsSmem& sm, const float* __restrict__ h,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        const float* __restrict__ g_marg, int u, int r0, int H,
                                        int T, int L, Clock& clk, float (&gacc)[16]) {
  const int wg = threadIdx.x >> 7;
  const WRing ring(H, T, h_chunks(H) - 1, CH);
  auto pA = [&](int m, int k) { return sm.p_s[m * BT + swz_a(m, k)]; };
  auto a_of = [&](int s) { return frag_a<P>(pA, 0, 8 * s); };
#pragma unroll
  for (int i = 0; i < 16; ++i) gacc[i] = 0.f;
  sweep_start<P, CH>(sm, ring, h, w, b, g_marg, u, r0, H, T, L);
  for (int t0 = 0, it = 0; t0 < T; t0 += BT, ++it) {
    const int st = it & 1;  // the g_marg stage
    const float* gm_hi = sm.gm_hi + st * LP * BT;
    const float* gm_lo = sm.gm_lo + st * LP * BT;
    float v[LP * BT / THREADS];
    if (t0 + BT < T) load_gm(g_marg, T, L, t0 + BT, v);
    float p[16];
    rows_p<P, CH>(sm, ring, h, w, b, u, H, T, r0, it, clk, p);
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
    clk.mark(PH_G);
    if (t0 + BT < T) store_gm<P>(v, sm.gm_hi + (st ^ 1) * LP * BT, sm.gm_lo + (st ^ 1) * LP * BT);
    sweep_next<CH>(sm, ring, h, w, b, u, r0, H, T, it);
    clk.mark(PH_REST);
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

// dh[r, HMAX own + [0, HMAX)] = sum over column tiles of dl[r, tile]
// w[HMAX own + [0, HMAX), tile]^T with the block's dot_s, written for rows
// below u and columns below H. Warpgroup wg holds dh^T rows (= dh columns)
// HMAX own + 64 wg + [0, 64) for the block's 64 rows; chunk own of w is
// every tile's last load, still in its stage for the product.
template <int P, bool CH>
__device__ __forceinline__ void dh_sweep(const RowsSmem& sm, const float* __restrict__ h,
                                         const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         const float* __restrict__ g_marg, int u, int r0, int H,
                                         int T, int L, int K, int noop, int own, Clock& clk,
                                         float* __restrict__ dh) {
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const int nl8 = (L + 7) / 8;
  const WRing ring(H, T, own, CH);
  float dacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dacc[i] = 0.f;
  sweep_start<P, CH>(sm, ring, h, w, b, g_marg, u, r0, H, T, L);
  for (int t0 = 0, it = 0; t0 < T; t0 += BT, ++it) {
    const int st = it & 1;  // the g_marg stage
    const float* w_s = sm.w_s + ring.last_stage(it) * HMAX * BT;
    const float* gm_hi = sm.gm_hi + st * LP * BT;
    const float* gm_lo = sm.gm_lo + st * LP * BT;
    float v[LP * BT / THREADS];
    if (t0 + BT < T) load_gm(g_marg, T, L, t0 + BT, v);
    float q[16];
    rows_p<P, CH>(sm, ring, h, w, b, u, H, T, r0, it, clk, q);
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
    clk.mark(PH_DL);
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
    clk.mark(PH_PRODUCT);
    if (t0 + BT < T) store_gm<P>(v, sm.gm_hi + (st ^ 1) * LP * BT, sm.gm_lo + (st ^ 1) * LP * BT);
    sweep_next<CH>(sm, ring, h, w, b, u, r0, H, T, it);
    clk.mark(PH_REST);
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = own * HMAX + c_m(64 * wg, i), r = r0 + c_n(0, i);
    if (r < u && c < H) dh[(size_t)r * H + c] = dacc[i];
  }
}

// K2's row kernel, block (row tile x, dh chunk y): G by g_sweep, dot closed
// in the block and written to dot_out, then dh's chunk y. Past HMAX (CH) in
// two launches, so that G is swept once per row tile and not in each of
// dh's nc blocks: `part` 1 (grid.y = 1) G and dot, `part` 2 dh's chunks from
// dot_out.
template <int P, bool CH>
__global__ void __launch_bounds__(THREADS, 1)
hpd_bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ counts,
                    const int* __restrict__ idx, const float* __restrict__ vals,
                    const float* __restrict__ m_in, const float* __restrict__ s_in,
                    const float* __restrict__ g_marg, const float* __restrict__ g_vals, int u,
                    int H, int T, int L, int K, int noop, int part, float* __restrict__ dh,
                    float* __restrict__ dot_out) {
  extern __shared__ float smem[];
  const RowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  Clock clk;
  rows_prologue<P, CH>(sm, h, counts, idx, m_in, s_in, g_vals, u, H, L, K, r0);
  clk.mark(PH_REST);
  if (CH && part == 2) {
    for (int r = threadIdx.x; r < R; r += THREADS) sm.dot_s[r] = r0 + r < u ? dot_out[r0 + r] : 0.f;
    __syncthreads();
    dh_sweep<P, CH>(sm, h, w, b, g_marg, u, r0, H, T, L, K, noop, blockIdx.y, clk, dh);
    clk.end(PK_ROWS);
    return;
  }
  float gacc[16];
  g_sweep<P, CH>(sm, h, w, b, g_marg, u, r0, H, T, L, clk, gacc);
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
  clk.mark(PH_G);
  if (!CH) dh_sweep<P, CH>(sm, h, w, b, g_marg, u, r0, H, T, L, K, noop, 0, clk, dh);
  clk.end(PK_ROWS);
}

// K6's B1: G[r, l] = <p[r], g_marg[l]> for the block's R rows.
template <int P, bool CH>
__global__ void __launch_bounds__(THREADS, 1)
hpd_b1_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ m_in,
              const float* __restrict__ s_in, const float* __restrict__ g_marg, int u, int H,
              int T, int L, float* __restrict__ g_rows) {
  extern __shared__ float smem[];
  const RowsSmem sm(smem);
  const int r0 = blockIdx.x * R;
  Clock clk;
  rows_prologue<P, CH>(sm, h, nullptr, nullptr, m_in, s_in, nullptr, u, H, L, 1, r0);
  clk.mark(PH_REST);
  float gacc[16];
  g_sweep<P, CH>(sm, h, w, b, g_marg, u, r0, H, T, L, clk, gacc);
  if (threadIdx.x < 128) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = c_m(0, i), l = c_n(0, i);
      if (l < L && r0 + r < u) g_rows[(size_t)(r0 + r) * L + l] = gacc[i];
    }
  }
  clk.mark(PH_REST);
  clk.end(PK_B1);
}

// K6's B2, row-parallel part, block (row tile x, dh chunk y): dh's chunk y
// from the given per-row dot.
template <int P, bool CH>
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
  Clock clk;
  rows_prologue<P, CH>(sm, h, counts, idx, m_in, s_in, g_vals, u, H, L, K, r0);
  for (int r = threadIdx.x; r < R; r += THREADS) sm.dot_s[r] = r0 + r < u ? dot_in[r0 + r] : 0.f;
  __syncthreads();
  clk.mark(PH_REST);
  dh_sweep<P, CH>(sm, h, w, b, g_marg, u, r0, H, T, L, K, noop, CH ? blockIdx.y : 0, clk, dh);
  clk.end(PK_B2);
}

// ---------------------------- columns kernel ------------------------------- //

// The columns kernel's per-row-tile stage (fp32, read by hand): a chunk of
// the h tile, counts^T, top-K indices and g_vals, m, s, dot.
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

// Row tile [r0, r0 + R) of the segment (ending at rend) into a stage: h's
// columns [c0, c0 + HMAX) and, with `extras` (a row tile's last load),
// counts^T, the top-K, m, s and dot; cp.async for rows below rend, neutral
// values (h = 0, m = inf, counts 0, no top-K) past it and past H.
__device__ __forceinline__ void load_stage_async(ColsStage st, const float* __restrict__ h,
                                                 const float* __restrict__ counts,
                                                 const int* __restrict__ idx,
                                                 const float* __restrict__ m_in,
                                                 const float* __restrict__ s_in,
                                                 const float* __restrict__ dot_in,
                                                 const float* __restrict__ g_vals, int u,
                                                 int rend, int H, int L, int K, int r0, int c0,
                                                 bool extras) {
  if ((H & 3) == 0 && ((uintptr_t)h & 15) == 0) {
    // 16 bytes a copy: swz_a moves whole 4-float chunks
    for (int i = threadIdx.x; i < R * (HMAX / 4); i += THREADS) {
      const int r = i / (HMAX / 4), k = (i % (HMAX / 4)) * 4;
      float* dst = st.h_s + r * HMAX + swz_a(r, k);
      if (r0 + r < rend && c0 + k < H) {
        cp_async16(dst, h + (size_t)(r0 + r) * H + c0 + k);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
      const int r = i / HMAX, k = i % HMAX;
      float* dst = st.h_s + r * HMAX + swz_a(r, k);
      if (r0 + r < rend && c0 + k < H)
        cp_async4(dst, h + (size_t)(r0 + r) * H + c0 + k);
      else
        *dst = 0.f;
    }
  }
  if (!extras) return;
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

// The columns kernel's loads: load n is chunk chunk(n) of the segment's row
// tile n / nc into stage n & 1, the row tile's own data with its last load;
// the block's own dW chunk is every row tile's last, so its h chunk stays in
// the stage for dW = h^T dl.
struct CRing {
  int nc, own, n_loads, rbeg, rend;
  const float *h, *counts, *m_in, *s_in, *dot_in, *g_vals, *w;
  const int* idx;
  int u, H, L, K, T, t0;
  float *stage0, *wf;
  __device__ int chunk(int n) const { return (own + 1 + n % nc) % nc; }
  __device__ float* stage(int n) const { return stage0 + (n & 1) * COLS_STAGE; }
  // load n into its stage (nothing past the last), not committed
  __device__ void issue(int n) const {
    if (n < n_loads)
      load_stage_async(ColsStage(stage(n)), h, counts, idx, m_in, s_in, dot_in, g_vals, u, rend,
                       H, L, K, rbeg + n / nc * R, chunk(n) * HMAX, n % nc == nc - 1);
  }
  // past HMAX: w's chunk of load n, fp32, into wf (dl^T's tiles, free while
  // the logits run) for stage_wt, in a commit group of its own after load n
  __device__ void issue_w(int n) const {
    if (n < n_loads) load_wf_async(w, H, T, t0, chunk(n) * HMAX, wf);
  }
};

// w^T at columns [t0, t0 + BT), rows [c0, c0 + HMAX) of w (zero past H), as
// the columns kernel's hi / lo B tiles (n = column, k = h).
template <int P>
__device__ __forceinline__ void stage_wt(float* __restrict__ wt_hi, float* __restrict__ wt_lo,
                                         const float* __restrict__ w, int H, int T, int t0,
                                         int c0) {
  for (int i = threadIdx.x; i < HMAX * BT; i += THREADS) {
    const int k = i / BT, c = i % BT;
    put<P>(wt_hi, wt_lo, sw128(BT, c, k), c0 + k < H ? w[(size_t)(c0 + k) * T + t0 + c] : 0.f);
  }
}

// Grid (T / BT, SEGS, nc): one block per column tile, row segment and dW
// chunk sums dW[HMAX z + [0, HMAX), tile] = h^T dl and (z = 0) db over the
// segment's rows into dw_part / db_part[seg]. Logits, p and dl: warpgroup
// wg holds the tile's 64 rows x columns 32 wg + [0, 32) (the logits summed
// over h's chunks, each split_k's halves from the w^T tile of its chunk,
// restaged where nc > 1); dW: warpgroup wg holds its chunk's rows
// 64 wg + [0, 64).
template <int P, bool CH>
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
  const int seg = blockIdx.y, own = blockIdx.z;
  const int rbeg = seg * seg_rows;
  const int rend = min(u, rbeg + seg_rows);
  const int nc = CH ? h_chunks(H) : 1, nl8 = (L + 7) / 8;
  const int tiles = rend > rbeg ? (rend - rbeg + R - 1) / R : 0;
  const CRing ring{nc, own, tiles * nc, rbeg, rend, h, counts, m_in, s_in, dot_in, g_vals, w,
                   idx, u, H, L, K, T, t0, stage0, dlt_hi};
  Clock clk;
  ring.issue(0);
  cp_commit();
  if (CH) {
    ring.issue_w(0);
    cp_commit();
  }
  ring.issue(1);
  cp_commit();
  if (!CH) stage_wt<P>(wt_hi, wt_lo, w, H, T, t0, 0);
  for (int i = threadIdx.x; i < LP * BT; i += THREADS) {
    const int l = i / BT, c = i % BT;
    put<P>(gt_hi, gt_lo, sw128(BT, c, l), l < L ? g_marg[(size_t)l * T + t0 + c] : 0.f);
  }
  if (threadIdx.x < BT) b_s[threadIdx.x] = b[t0 + threadIdx.x];
  clk.mark(PH_REST);
  float wacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) wacc[i] = 0.f;
  float bacc = 0.f;
  // does a top-K index of the row tile (its stage sv) fall in this column tile?
  auto hits_of = [&](const ColsStage& sv) {
    bool mine = false;
#pragma unroll
    for (int j = 0; j < R * KMAX / THREADS; ++j) {
      const int c = sv.kidx_s[threadIdx.x + j * THREADS] - t0;
      mine |= c >= 0 && c < BT;
    }
    return __syncthreads_or(mine) && !noop;
  };
  for (int it = 0; it < tiles; ++it) {
    const ColsStage st(ring.stage(it * nc + nc - 1));  // the row tile's last load
    bool hits;
    // logits: element i is row c_m(0, i), column c_n(32 wg, i)
    float q[16];
    if (!CH) {  // one chunk: w^T's tiles stay
      cp_wait<1>();
      async_view();
      __syncthreads();
      clk.mark(PH_WAIT);
      hits = hits_of(st);
      auto hA = [&](int m, int k) { return st.h_s[m * HMAX + swz_a(m, k)]; };
      auto a_of = [&](int s) { return frag_a<P>(hA, 0, 8 * s); };
      auto bh = [&](int s) { return desc_k8(wt_hi, BT, 0, s); };
      auto bl = [&](int s) { return desc_k8(wt_lo, BT, 0, s); };
      split_k<P, true>(q, (H + 7) / 8, a_of, bh, bl, dlt_hi);
    } else {
      // the logits' warpgroup partial over h's chunks, in load order
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      for (int ci = 0; ci < nc; ++ci) {
        const int n = it * nc + ci, c0 = ring.chunk(n) * HMAX;
        const float* h_s = ring.stage(n);
        cp_wait<1>();
        async_view();
        __syncthreads();
        clk.mark(PH_WAIT);
        // w^T's chunk from the staging tile, then the next chunk into it
        split_wt<P>(wt_hi, wt_lo, dlt_hi);
        async_view();
        __syncthreads();
        if (ci + 1 < nc) {
          ring.issue_w(n + 1);
          cp_commit();
        }
        clk.mark(PH_RESTAGE);
        auto hA = [&](int m, int k) { return h_s[m * HMAX + swz_a(m, k)]; };
        auto a_of = [&](int s) { return frag_a<P>(hA, 0, 8 * s); };
        auto bh = [&](int s) { return desc_k8(wt_hi, BT, 0, s); };
        auto bl = [&](int s) { return desc_k8(wt_lo, BT, 0, s); };
        const int nk8 = (min(H - c0, HMAX) + 7) / 8;
        chains_add<P, 64, true>(part, 8 * wg, min(nk8, 8 * wg + 8), a_of, bh, bl);
        clk.mark(PH_LOGITS);
        if (ci + 1 < nc) {
          __syncthreads();  // every warp is done with the stage and with w^T's tiles
          ring.issue(n + 2);
          cp_commit();
        }
      }
      hits = hits_of(st);
      meet(part, q, dlt_hi);
    }
    clk.mark(PH_LOGITS);
    {
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
    clk.mark(PH_DL);
    // dW += h^T dl: A (m = h, k = row) from the stage's chunk own of h
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
    clk.mark(PH_PRODUCT);
    if (CH) {  // w's chunk of the next row tile's first load (dl^T's tiles are free)
      ring.issue_w((it + 1) * nc);
      cp_commit();
    }
    ring.issue((it + 1) * nc + 1);  // the row tile's last load + 2
    cp_commit();
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = own * HMAX + c_m(64 * wg, i), c = c_n(0, i);
    if (hh < H) dw_part[((size_t)seg * H + hh) * T + t0 + c] = wacc[i];
  }
  if (own == 0 && threadIdx.x < BT) db_part[(size_t)seg * T + t0 + threadIdx.x] = bacc;
  clk.mark(PH_REST);
  clk.end(PK_COLS);
}

int check_shape(int u, int H, int T, int L, int K) {
  if (u < 0 || H < 1 || H > HWIDE || T < TT || T % TT != 0 || L < 1 || L > LMAX ||
      K < 1 || K > KMAX)
    return ERR_SHAPE;
  return 0;
}

// ------------------------- launches shared by K1-K6 ------------------------ //

// Rows pass: vals, idx (u, K), m, s (u), then the fix-up of the rows its
// guard lists (n_fix of them, in fix_rows). Scratch absmax (H + 1),
// fix_rows (u); n_fix (1) is zeroed here.
int launch_select(const float* h, const float* w, const float* b, int u, int H, int T, int K,
                  int prec, float* vals, int* idx, float* m, float* s, float* absmax,
                  int* fix_rows, int* n_fix, cudaStream_t st) {
  int err = (int)cudaMemsetAsync(n_fix, 0, sizeof(int), st);
  if (err || u == 0) return err;
  const int row_blocks = (u + R - 1) / R;
  hpd_absmax_kernel<<<H + 1, THREADS, 0, st>>>(w, b, H, T, absmax);
  err = (int)cudaGetLastError();
  if (err) return err;
  DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
    set_smem(hpd_fwd_rows_kernel<P, CH>, fwd_rows_smem(CH));
    hpd_fwd_rows_kernel<P, CH><<<row_blocks, THREADS, fwd_rows_smem(CH), st>>>(
        h, w, b, u, H, T, K, absmax, vals, idx, m, s, fix_rows, n_fix);
  }));
  err = (int)cudaGetLastError();
  if (err) return err;
  // one block per SM at most, striding over the list (none when it is empty)
  const int fix_blocks = row_blocks < FIX_BLOCKS ? row_blocks : FIX_BLOCKS;
  DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
    set_smem(hpd_fix_rows_kernel<P, CH>, fix_rows_smem(K));
    hpd_fix_rows_kernel<P, CH><<<fix_blocks, THREADS, fix_rows_smem(K), st>>>(
        h, w, b, H, T, K, fix_rows, n_fix, vals, idx, m, s);
  }));
  return (int)cudaGetLastError();
}

// Columns pass and its ordered reduce: marg (L, T). marg_part: (SEGS, L, T).
int launch_marginal(const float* h, const float* w, const float* b, const float* counts,
                    const float* m, const float* s, int u, int H, int T, int L, int prec,
                    float* marg, float* marg_part, cudaStream_t st) {
  if (u == 0) return (int)cudaMemsetAsync(marg, 0, sizeof(float) * L * T, st);
  const dim3 cols_grid(T / BT, SEGS);
  DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
    set_smem(hpd_fwd_cols_kernel<P, CH>, fwd_cols_smem(CH));
    hpd_fwd_cols_kernel<P, CH><<<cols_grid, THREADS, fwd_cols_smem(CH), st>>>(
        h, w, b, counts, m, s, u, H, T, L, rows_per_seg(u), marg_part);
  }));
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
  const dim3 cols_grid(T / BT, SEGS, h_chunks(H));
  DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
    set_smem(hpd_bwd_cols_kernel<P, CH>, bwd_cols_smem());
    hpd_bwd_cols_kernel<P, CH><<<cols_grid, THREADS, bwd_cols_smem(), st>>>(
        h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop,
        rows_per_seg(u), dw_part, db_part);
  }));
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = reduce_segments(dw_part, dw, (size_t)H * T, st);
  if (err) return err;
  return reduce_segments(db_part, db, (size_t)T, st);
}

}  // namespace

extern "C" {

const char* hpd_stream_error_string(int code) { return port_error_string(code); }

#ifdef HPD_STREAM_PHASES
// The marked kernels' clock64() ticks by kernel (PK_*) and phase (PH_*),
// summed over the blocks of the launches since the last reset, into
// out[NPK * NPH]; then zeroes them if reset.
int hpd_stream_bwd_phases(unsigned long long* out, int reset) {
  return read_phases(bwd_phase, out, reset);
}
#endif

int hpd_stream_segments() { return SEGS; }

// Rows pass (K4, K1's first): h (u, H), w (H, T), b (T) -> vals/idx (u, K),
// m/s (u); n_fix (1): the rows the fix-up settled. Scratch absmax (H + 1),
// fix_rows (u).
int hpd_select(const float* h, const float* w, const float* b, int u, int H, int T, int K,
               int prec, float* vals, int* idx, float* m, float* s, float* absmax,
               int* fix_rows, int* n_fix, void* stream) {
  const int err = check_shape(u, H, T, 1, K);
  if (err) return err;
  return launch_select(h, w, b, u, H, T, K, prec, vals, idx, m, s, absmax, fix_rows, n_fix,
                       (cudaStream_t)stream);
}

// K7: h (u, H), w (H, T), b (T) -> m, s (u). dots = 1: m = s = the row sum
// of the logits; dots = 0: row max and sum of exp(logit - m).
int hpd_probe(const float* h, const float* w, const float* b, int u, int H, int T, int prec,
              int dots, float* m, float* s, void* stream) {
  const int err = check_shape(u, H, T, 1, 1);
  if (err || u == 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_blocks = (u + R - 1) / R;
  DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
    if (dots) {
      set_smem(hpd_probe_kernel<P, true, CH>, fwd_rows_smem(CH));
      hpd_probe_kernel<P, true, CH><<<row_blocks, THREADS, fwd_rows_smem(CH), st>>>(
          h, w, b, u, H, T, m, s);
    } else {
      set_smem(hpd_probe_kernel<P, false, CH>, fwd_rows_smem(CH));
      hpd_probe_kernel<P, false, CH><<<row_blocks, THREADS, fwd_rows_smem(CH), st>>>(
          h, w, b, u, H, T, m, s);
    }
  }));
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
    // past HMAX two launches: G and dot (one block per row tile), then dh's
    // chunks on grid.y
    const int row_blocks = (u + R - 1) / R;
    for (int part = H > HMAX ? 1 : 0; part <= (H > HMAX ? 2 : 0); ++part) {
      const dim3 rows_grid(row_blocks, part == 1 ? 1 : h_chunks(H));
      DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
        set_smem(hpd_bwd_rows_kernel<P, CH>, bwd_rows_smem());
        hpd_bwd_rows_kernel<P, CH><<<rows_grid, THREADS, bwd_rows_smem(), st>>>(
            h, w, b, counts, idx, vals, m, s, g_marg, g_vals, u, H, T, L, K, noop, part, dh,
            dot);
      }));
      err = (int)cudaGetLastError();
      if (err) return err;
    }
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
  DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
    set_smem(hpd_b1_kernel<P, CH>, bwd_rows_smem());
    hpd_b1_kernel<P, CH><<<(u + R - 1) / R, THREADS, bwd_rows_smem(), st>>>(
        h, w, b, m, s, g_marg, u, H, T, L, g_rows);
  }));
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
    const dim3 rows_grid((u + R - 1) / R, h_chunks(H));
    DISPATCH_PREC(prec, DISPATCH_CHUNKED(H, {
      set_smem(hpd_b2_rows_kernel<P, CH>, bwd_rows_smem());
      hpd_b2_rows_kernel<P, CH><<<rows_grid, THREADS, bwd_rows_smem(), st>>>(
          h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop, dh);
    }));
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_bwd_cols(h, w, b, counts, idx, m, s, dot, g_marg, g_vals, u, H, T, L, K, noop,
                         prec, dw, db, dw_part, db_part, st);
}

}  // extern "C"
