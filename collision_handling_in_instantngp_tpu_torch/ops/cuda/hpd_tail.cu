// Per-row fused HPD tail (kernels K8 and K9): the head layer, softmax,
// top-K on p and the loss marginal over every (pixel, level, corner) row.
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/hpd_tail.py:
//   hpd_tail_pallas_fwd (_fwd_kernel): h (L, N, H), w (H, T), b (T) ->
//     p = nan_to_num(e / sum e) of logits = h w + b; vals/idx (L, N, K):
//     K argmax passes on p (lowest index among equal p), each masking its
//     column with -1; marg (L, T) = sum over rows of p / N.
//   hpd_tail_pallas_bwd (_bwd_kernel): + idx, g_marg (L, T), g_vals
//     (L, N, K) -> g_p = g_marg[l] / N + g_vals scattered at idx;
//     dl = p (g_p - <g_p, p>); dh = dl w^T, dw = h^T dl, db = sum_rows dl.
//
// Bound on this card: operations. At the per-row route's shapes (L = 4,
// N = 229,616, H = 128, T = 256) each of the three products is 60 GFLOP
// against 470 MB of h; the TPU kernel keeps a (512, T) row block in VMEM.
// Here a block keeps an (R, T) logits tile in shared memory (R = 64 at
// T = 256, 16 at T = 2048), so each product runs once per direction.
//
// The forward (K8), for any K <= 128 and any H: the logits in fp32 FMA on
// the CUDA cores, each one fma chain over k ascending from zero then + b
// (fp32_logit's arithmetic), a thread owning an 8 x 8 output block and
// reading its operands as float4 from shared memory (the head staged
// through a cp.async ring from the padded head); h goes through the tile
// whole where it fits (the next tile's h then loads behind the row
// passes), else in WMAX-deep chunks, the chains continued through the
// logits tile. Then P = THREADS / R threads a row: max, e = exp(l - max)
// and s, then p = nan_to_num(e / s) in place, which the column sums read
// and the top-K ranks: each thread keeps the top KL of its columns (at
// K <= P only those at or above the least of the group's thread maxima),
// and K rounds take the group's best, the owner refilling its list when it
// empties. (K10's route, 3xTF32 logits with the fp32 top-K by candidate
// refinement, took 5.68 ms here against this route's first version's 3.62
// at the per-row shapes: PERF.md §6.)
// The backward (K9) recomputes the logits once, turns the tile into dl in
// place, then runs dW/db and dh from it. Its three products are 3xTF32
// on the tensor cores (per_row_mma.cuh's head_logits, head_dw, head_dh, as
// in K11), from h at stride mma_ld(H) with zeros past H and a copy of the
// head padded with zeros to head_rows(H) x head_ld(T); its bound is the three
// products' work at the TF32 peak (3xTF32: three passes each), softmax and
// dl not counted. Its tile holds all of h: a head input wider than the
// 16-row tile allows (H <= 1,152 at T = 2048, 3,040 at T = 256) is refused.
// dW/db accumulate in
// one partial per block (read-modify-write by the owning thread), summed in
// block order by a second kernel. No atomics. dh is written into the h tile
// (free once dW has read it), then stored to device memory row by row.
#include "per_row.cuh"
#include "per_row_mma.cuh"

using namespace per_row;

namespace {

// Built with -DHPD_TAIL_PHASES (tools/k11_phases.py --kernel k8), thread 0
// of K8 sums the clock64() ticks of each phase of its tiles into k8_phase
// (the phases end at a barrier, so its ticks are the block's); otherwise
// the marks (common.cuh) compile to nothing.
#ifdef HPD_TAIL_PHASES
constexpr int K8_PHASES = 5;  // loads, logits, softmax, column sums, top-K
__device__ unsigned long long k8_phase[K8_PHASES];
#endif

constexpr int KMAX = 128;

// ------------------------------- K8, the forward ---------------------------- //

// Thread grid of fma_logits at R rows: RG groups of 8 rows, CG groups of 8
// columns (4 cg + [0, 4) and CP / 2 + 4 cg + [0, 4) of a pass of CP
// columns: a warp's float4 loads and stores are contiguous), the head
// staged KS rows x CP columns a chunk into one of two buffers. The row
// passes: P threads a row.
template <int R>
struct Fma {
  static constexpr int RG = R / 8;
  static constexpr int CG = THREADS / RG;
  static constexpr int CP = 8 * CG;
  static constexpr int KS = 4096 / CP;
  static constexpr int P = THREADS / R;
};
constexpr int FMA_STAGE = 2 * 4096;  // the two buffers, at every R

// Row stride of K8's logits tile: >= round32(T) and = P
// (mod 32), so that the row passes' P threads a row, on consecutive
// columns, and the warp's 32 / P rows hit distinct banks (mma_ld(T) at
// R = 64, P = 4).
__host__ __device__ constexpr int logits_ld(int R, int T) { return round32(T) + THREADS / R; }

// the h tile (chunk width hc, stride mma_ld(hc)), the staged head, the
// logits tile and the column sums
size_t exact_smem(int R, int hc, int T) {
  return sizeof(float) *
         ((size_t)R * mma_ld(hc) + FMA_STAGE + (size_t)R * logits_ld(R, T) + T);
}

// Chunk (ROWS x COLS) of the padded head at (r0, c0) into st (row stride
// COLS) in 16-byte cp.async pieces; a piece at or past the head's row
// stride ldw is zero-filled (a pass may reach past T).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_fill(const float* __restrict__ w, int ldw, int r0, int c0,
                                           float* __restrict__ st) {
  constexpr int V = COLS / 4;
  static_assert(ROWS * V % THREADS == 0, "whole pieces a thread");
#pragma unroll
  for (int u = 0; u < ROWS * V / THREADS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int r = e / V, c = 4 * (e - r * V);
    const bool in = c0 + c < ldw;
    cp_async16(st + r * COLS + c, in ? w + (size_t)(r0 + r) * ldw + c0 + c : w, in);
  }
}

// cache[r, c] (c < T) over the h chunk A (R x lda: columns k0 + [0, kw) of
// h, zeros past kw to a multiple of 4): each element one fp32 fma chain
// over k ascending, from zero on the first chunk, else continued from
// cache (an fp32 value round-trips exactly), + b[c] after the last chunk:
// hidden_stack's and fp32_logit's arithmetic, bit for bit (the zero products
// past kw leave a chain unchanged). The head streams through stage
// (FMA_STAGE floats) from the padded head w (row stride ldw). Starts with a
// barrier (stage free, A complete) and ends with one (cache complete).
template <int RPT>
__device__ __forceinline__ void fma_logits(const float* __restrict__ A, int lda, int k0, int kw,
                                           bool first, bool last, const float* __restrict__ w,
                                           int ldw, const float* __restrict__ b, int T,
                                           float* __restrict__ stage, float* __restrict__ cache,
                                           int ldc) {
  using F = Fma<16 * RPT>;
  constexpr int BUF = F::KS * F::CP;
  const int rg = threadIdx.x / F::CG, cg = threadIdx.x % F::CG;
  const int nk = (kw + 3) & ~3;
  const float* a_row = A + rg * 8 * lda;
  for (int c0 = 0; c0 < T; c0 += F::CP) {
    const int cc[2] = {c0 + 4 * cg, c0 + F::CP / 2 + 4 * cg};
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!first && cc[h2] < T)
          v = *reinterpret_cast<const float4*>(cache + (rg * 8 + i) * ldc + cc[h2]);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][4 * h2 + u] = lane_of(v, u);
      }
    staged<2>(
        (nk + F::KS - 1) / F::KS,
        [&](int ci, int buf) {
          stage_fill<F::KS, F::CP>(w, ldw, k0 + ci * F::KS, c0, stage + buf * BUF);
        },
        [&](int ci, int buf) {
          const float* st = stage + buf * BUF + 4 * cg;
          const int kb = ci * F::KS, ke = min(F::KS, nk - kb);
          for (int kk = 0; kk < ke; kk += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a[i] = *reinterpret_cast<const float4*>(a_row + i * lda + kb + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 x = *reinterpret_cast<const float4*>(st + (kk + u) * F::CP);
              const float4 y = *reinterpret_cast<const float4*>(st + (kk + u) * F::CP + F::CP / 2);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float av = lane_of(a[i], u);
                acc[i][0] = fmaf(av, x.x, acc[i][0]);
                acc[i][1] = fmaf(av, x.y, acc[i][1]);
                acc[i][2] = fmaf(av, x.z, acc[i][2]);
                acc[i][3] = fmaf(av, x.w, acc[i][3]);
                acc[i][4] = fmaf(av, y.x, acc[i][4]);
                acc[i][5] = fmaf(av, y.y, acc[i][5]);
                acc[i][6] = fmaf(av, y.z, acc[i][6]);
                acc[i][7] = fmaf(av, y.w, acc[i][7]);
              }
            }
          }
        });
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = cc[h2];
      if (c >= T) continue;
      float bb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) bb[u] = last && c + u < T ? b[c + u] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float4 v;
        v.x = last ? acc[i][4 * h2] + bb[0] : acc[i][4 * h2];
        v.y = last ? acc[i][4 * h2 + 1] + bb[1] : acc[i][4 * h2 + 1];
        v.z = last ? acc[i][4 * h2 + 2] + bb[2] : acc[i][4 * h2 + 2];
        v.w = last ? acc[i][4 * h2 + 3] + bb[3] : acc[i][4 * h2 + 3];
        *reinterpret_cast<float4*>(cache + (rg * 8 + i) * ldc + c) = v;
      }
    }
  }
  __syncthreads();
}

// The row passes of K8: a group of P = THREADS / R
// consecutive threads a row (row threadIdx.x / P), a thread on the
// columns part + P j (part = threadIdx.x % P).

// The row's max, then e = exp(l - max) in place; s = sum e, and e_tau the
// e of the least of the group's P thread maxima (a bound for the top K,
// K <= P: those P columns all rank at or above it), on every thread of the
// group. s is softmax_row's sum bit for bit (32 lane sums over the columns
// lane + 32 j, j ascending, then warp_sum's butterfly), so p = e / s and
// with it the top-K are those of the parent's K8, whose one warp a row
// took the same max and e: thread part holds the sums of the lanes part +
// P u (its columns with j = u (mod 32 / P)), runs the butterfly's steps
// past P in registers and the rest through the group's shuffles.
template <int R>
__device__ __forceinline__ void row_softmax(float* __restrict__ row, int T, float& s,
                                            float& e_tau) {
  constexpr int P = THREADS / R, NU = 32 / P;
  const int part = threadIdx.x % P;
  float m = -INFINITY;
#pragma unroll 4
  for (int c = part; c < T; c += P) m = fmaxf(m, row[c]);
  float tau = m;
#pragma unroll
  for (int off = P / 2; off; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    tau = fminf(tau, __shfl_xor_sync(FULL, tau, off));
  }
  float ls[NU];  // the sums of lanes part + P u
#pragma unroll
  for (int u = 0; u < NU; ++u) ls[u] = 0.f;
  const int whole = T / 32 * 32;  // the columns of whole 32-column blocks, then the rest
  for (int c0 = part; c0 < whole; c0 += 32)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const float e = expf(row[c0 + P * u] - m);
      row[c0 + P * u] = e;
      ls[u] += e;
    }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int c = whole + part + P * u;
    if (c < T) {
      const float e = expf(row[c] - m);
      row[c] = e;
      ls[u] += e;
    }
  }
#pragma unroll
  for (int half = NU / 2; half; half >>= 1)  // lanes L and L ^ (P half)
#pragma unroll
    for (int u = 0; u < half; ++u) ls[u] += ls[u + half];
  s = ls[0];
#pragma unroll
  for (int off = P / 2; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  e_tau = expf(tau - m);
}

constexpr int KL = 4;  // entries of a thread's list in row_topk

// (v, c) into the sorted list (value desc, index asc) where it ranks
// before the list's last entry
__device__ __forceinline__ void list_insert(float (&tv)[KL], int (&ti)[KL], float v, int c) {
  if (!ranks_before(v, c, tv[KL - 1], ti[KL - 1])) return;
  tv[KL - 1] = v;
  ti[KL - 1] = c;
#pragma unroll
  for (int q = KL - 1; q > 0; --q)
    if (ranks_before(tv[q], ti[q], tv[q - 1], ti[q - 1])) {
      const float x = tv[q];
      const int i = ti[q];
      tv[q] = tv[q - 1];
      ti[q] = ti[q - 1];
      tv[q - 1] = x;
      ti[q - 1] = i;
    }
}

// e -> p = nan_to_num(e / s) in place (the column sums read it), and the
// top K of p (value desc, index asc: the plain version's order) into
// vals/idx where write. At K <= P no column ranks below p_tau, the p of
// e_tau (row_softmax), so only the columns at or above it are ranked. Each
// thread keeps the top KL of those of its columns; each of K rounds takes
// the group's best head, and its owner pops it, refilling its list from
// its columns ranking after it when it empties.
template <int R>
__device__ __forceinline__ void row_topk(float* __restrict__ row, int T, int K, float s,
                                         float e_tau, bool write, float* __restrict__ vals,
                                         int* __restrict__ idx) {
  constexpr int P = THREADS / R;
  const int part = threadIdx.x % P;
  float tv[KL];
  int ti[KL];
#pragma unroll
  for (int q = 0; q < KL; ++q) {
    tv[q] = -INFINITY;
    ti[q] = INT_MAX;
  }
  const float p_tau = K <= P ? nan_to_num(e_tau / s) : -INFINITY;
  int mine = 0;  // this thread's columns at or above p_tau
#pragma unroll 4
  for (int c = part; c < T; c += P) {
    const float p = nan_to_num(row[c] / s);
    row[c] = p;
    if (p >= p_tau) {
      ++mine;
      list_insert(tv, ti, p, c);
    }
  }
  int taken = 0;
  for (int q = 0; q < K; ++q) {
    float bv = tv[0];
    int bi = ti[0];
#pragma unroll
    for (int off = P / 2; off; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ranks_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (write && part == 0) {
      vals[q] = bv;
      idx[q] = bi;
    }
    if (bi % P == part) {  // the owner pops its head (K <= T: bi is a column)
      ++taken;
#pragma unroll
      for (int u = 0; u < KL - 1; ++u) {
        tv[u] = tv[u + 1];
        ti[u] = ti[u + 1];
      }
      tv[KL - 1] = -INFINITY;
      ti[KL - 1] = INT_MAX;
      if (ti[0] == INT_MAX && taken < mine)
        for (int c = part; c < T; c += P) {
          const float v = row[c];
          if (v >= p_tau && ranks_before(bv, bi, v, c)) list_insert(tv, ti, v, c);
        }
    }
  }
}

// h chunk width and rows per thread of K8's widest tile that fits: all of
// H where some tile holds it, else WMAX-deep chunks
int pick_exact(int H, int T, int* hc) {
  for (int pass = 0; pass < 2; ++pass) {
    const int w = pass == 0 || H < WMAX ? H : WMAX;
    for (int rpt = 4; rpt >= 1; rpt >>= 1)
      if (exact_smem(16 * rpt, w, T) <= (size_t)SMEM_MAX) {
        *hc = w;
        return rpt;
      }
  }
  return 0;
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
tail_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w_pad,
                const float* __restrict__ b, int H, int T, int K, int hc, Rows g,
                float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ marg_part) {
  constexpr int R = 16 * RPT;
  extern __shared__ __align__(16) float smem[];
  const int lda = mma_ld(hc), ldc = logits_ld(R, T), ldw = head_ld(T);
  float* h_s = smem;
  float* stage = h_s + R * lda;
  float* cache = stage + FMA_STAGE;
  float* colsum = cache + R * ldc;
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my = threadIdx.x / Fma<R>::P;  // the row of this thread's group
  for (int c = threadIdx.x; c < T; c += THREADS) colsum[c] = 0.f;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  PHASE_START(K8_PHASES);
  bool ahead = false;  // this tile's h is in flight (whole tiles)
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    for (int k0 = 0; k0 < H; k0 += hc) {
      const int kw = min(hc, H - k0), kp = (kw + 3) & ~3;
      if (ahead) {
        cp_wait<0>();
        __syncthreads();
      } else {
        __syncthreads();  // h_s and cache are free
        for (int r = warp; r < R; r += WARPS)
          for (int k = lane; k < kp; k += 32)
            h_s[r * lda + k] = r < rows && k < kw ? h[(base + r) * H + k0 + k] : 0.f;
      }
      PHASE_SYNC_MARK(0);
      fma_logits<RPT>(h_s, lda, k0, kw, k0 == 0, k0 + hc >= H, w_pad, ldw, b, T, stage, cache,
                      ldc);
      PHASE_MARK(1);
    }
    // the next tile's h into the free h tile, behind the row passes
    ahead = hc == H && t + 1 < t_end;
    if (ahead) {
      const int rows1 = min(R, g.N - r0 - R);
      const int kp = (H + 3) & ~3;
      if (H % 4 == 0) {  // 16-byte copies
        for (int e = threadIdx.x; e < R * kp / 4; e += THREADS) {
          const int r = e / (kp / 4), k = 4 * (e - r * (kp / 4));
          const bool in = r < rows1;
          const uint32_t d = (uint32_t)__cvta_generic_to_shared(h_s + r * lda + k);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                       "l"(in ? h + (base + R + r) * H + k : h), "r"(in ? 16 : 0));
        }
      } else {
        for (int r = warp; r < R; r += WARPS)
          for (int k = lane; k < kp; k += 32) {
            const bool in = r < rows1 && k < H;
            const uint32_t d = (uint32_t)__cvta_generic_to_shared(h_s + r * lda + k);
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                         "l"(in ? h + (base + R + r) * H + k : h), "r"(in ? 4 : 0));
          }
      }
      cp_commit();
    }
    float* row = cache + my * ldc;
    float s, e_tau;
    row_softmax<R>(row, T, s, e_tau);
    PHASE_SYNC_MARK(2);
    row_topk<R>(row, T, K, s, e_tau, my < rows, vals + (base + my) * K, idx + (base + my) * K);
    __syncthreads();
    PHASE_MARK(4);
    column_sums(cache, ldc, rows, T, colsum);
    PHASE_SYNC_MARK(3);
  }
  PHASE_END(k8_phase, K8_PHASES);
  __syncthreads();
  for (int c = threadIdx.x; c < T; c += THREADS)
    marg_part[((size_t)l * g.spl + seg) * T + c] = colsum[c];
}

// ------------------------------ K9, the backward ---------------------------- //

// the h tile (stride mma_ld(H), dh's tile after dW), the staged head
// chunks, the logits / dl tile (stride mma_ld(T)) and g_marg's row
size_t tail_bwd_smem(int R, int H, int T) {
  return sizeof(float) * ((size_t)R * mma_ld(H) + head_stage_floats(R / 16) +
                          (size_t)R * mma_ld(T) + T);
}

int pick_bwd_rpt(int H, int T) {
  for (int rpt = 4; rpt >= 1; rpt >>= 1)
    if (tail_bwd_smem(16 * rpt, H, T) <= (size_t)SMEM_MAX) return rpt;
  return 0;
}

// the forward's limits (any H); the backward's also that its tile fits
int check_shape(int L, int N, int H, int T, int K, bool bwd) {
  if (L < 1 || N < 1 || H < 1 || T < 1 || T > TMAX || K < 1 || K > KMAX || K > T)
    return ERR_SHAPE;
  return bwd && !pick_bwd_rpt(H, T) ? ERR_SHAPE : 0;
}

template <int RPT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
tail_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w_pad,
                const float* __restrict__ b, const int* __restrict__ idx,
                const float* __restrict__ g_marg, const float* __restrict__ g_vals, int H, int T,
                int K, Rows g, float* __restrict__ dh, float* __restrict__ part) {
  constexpr int R = 16 * RPT;
  extern __shared__ float smem[];
  const int ldh = mma_ld(H), ldc = mma_ld(T), ldw = head_ld(T);
  float* h_s = smem;
  float* stage = h_s + R * ldh;
  float* cache = stage + head_stage_floats(RPT);
  float* gm_s = cache + R * ldc;
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  float* pw = part + ((size_t)l * g.spl + seg) * ((size_t)H * T + T);
  float* pb = pw + (size_t)H * T;
  for (int c = threadIdx.x; c < T; c += THREADS) gm_s[c] = g_marg[(size_t)l * T + c] / (float)g.N;
  // the h tile's padding columns stay zero: load_rows and dh write [0, H)
  for (int e = threadIdx.x; e < R * (ldh - H); e += THREADS)
    h_s[e / (ldh - H) * ldh + H + e % (ldh - H)] = 0.f;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    __syncthreads();
    load_rows<R>(h, base, rows, H, h_s, ldh);
    head_logits<RPT>(h_s, ldh, H, w_pad, ldw, b, T, stage, cache, ldc);
    for (int r = warp; r < R; r += WARPS) {
      float* row = cache + r * ldc;
      softmax_row(row, T);
      const size_t gr = (base + (r < rows ? r : 0)) * K;
      dlogits_row(row, T, K, gm_s, idx + gr, g_vals + gr, r < rows);
    }
    __syncthreads();
    head_dw<RPT>(h_s, ldh, H, cache, ldc, T, pw, pb);
    // dh = dl w^T into the h tile (begins with a barrier: dW has read it)
    if (WIDE)
      head_dh_wide<RPT, false>(cache, ldc, T, w_pad, ldw, H, nullptr, 0, stage, h_s, ldh);
    else
      head_dh<RPT, false>(cache, ldc, T, w_pad, ldw, H, nullptr, 0, stage, h_s, ldh);
    for (int e = threadIdx.x; e < rows * H; e += THREADS) {
      const int r = e / H, k = e - r * H;
      dh[(base + r) * H + k] = h_s[r * ldh + k];
    }
  }
}

template <int RPT>
int launch_exact(const float* h, const float* w_pad, const float* b, int L, int N, int H, int T,
                 int K, int hc, float* marg_part, float* vals, int* idx, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const size_t smem = exact_smem(16 * RPT, hc, T);
  set_smem(tail_fwd_kernel<RPT>, smem);
  tail_fwd_kernel<RPT><<<dim3(g.spl, L), THREADS, smem, st>>>(h, w_pad, b, H, T, K, hc, g, vals,
                                                             idx, marg_part);
  return (int)cudaGetLastError();
}

template <int RPT, bool WIDE>
int launch_bwd(const float* h, const float* w_pad, const float* b, const int* idx,
               const float* g_marg, const float* g_vals, int L, int N, int H, int T, int K,
               float* dh, float* part, float* dwb, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const int total = H * T + T;
  const int nblocks = g.spl * L;
  int err = (int)cudaMemsetAsync(part, 0, sizeof(float) * (size_t)nblocks * total, st);
  if (err) return err;
  const size_t smem = tail_bwd_smem(16 * RPT, H, T);
  set_smem(tail_bwd_kernel<RPT, WIDE>, smem);
  tail_bwd_kernel<RPT, WIDE><<<dim3(g.spl, L), THREADS, smem, st>>>(h, w_pad, b, idx, g_marg, g_vals,
                                                              H, T, K, g, dh, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_blocks_kernel<<<(total + 255) / 256, 256, 0, st>>>(part, dwb, nblocks, total);
  return (int)cudaGetLastError();
}

// launch_bwd at the tile size the shared memory allows
template <bool WIDE>
int bwd_rpt(const float* h, const float* w_pad, const float* b, const int* idx,
            const float* g_marg, const float* g_vals, int L, int N, int H, int T, int K,
            float* dh, float* part, float* dwb, cudaStream_t st) {
  switch (pick_bwd_rpt(H, T)) {
    case 4:
      return launch_bwd<4, WIDE>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
    case 2:
      return launch_bwd<2, WIDE>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
    default:
      return launch_bwd<1, WIDE>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
  }
}

}  // namespace

extern "C" {

const char* hpd_tail_error_string(int code) { return port_error_string(code); }

#ifdef HPD_TAIL_PHASES
// K8's clock64() ticks by phase, summed over the blocks of the launches
// since the last reset, into out[K8_PHASES]; then zeroes them if reset.
int hpd_tail_fwd_phases(unsigned long long* out, int reset) {
  return read_phases(k8_phase, out, reset);
}
#endif

// Row stride of the padded head at T columns, the one the per-row kernels
// read: K9 here, K10 and K11 (hpd_full.cu, through hpd_tail.padded_head).
int hpd_tail_head_ld(int T) { return head_ld(T); }

// Rows of the padded head at a head input of H: whole WMAX-row chunks.
int hpd_tail_head_rows(int H) { return head_rows(H); }

// Blocks of the forward's (bwd = 0) or the backward's (bwd = 1) launch for
// these shapes (the partial buffers have one row each), 0 if the kernels
// do not take them.
int hpd_tail_blocks(int L, int N, int H, int T, int K, int bwd) {
  if (check_shape(L, N, H, T, K, bwd)) return 0;
  int hc;
  return make_rows(L, N, 16 * (bwd ? pick_bwd_rpt(H, T) : pick_exact(H, T, &hc))).spl * L;
}

// h (L, N, H), b (T) and w_pad, the head padded as for hpd_tail_bwd ->
// marg (L, T), vals (L, N, K), idx (L, N, K). marg_part: (hpd_tail_blocks(..,
// 0), T) scratch.
int hpd_tail_fwd(const float* h, const float* w_pad, const float* b, int L, int N, int H, int T,
                 int K, float* marg, float* marg_part, float* vals, int* idx, void* stream) {
  int err = check_shape(L, N, H, T, K, false);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  int hc = H;
  const int rpt = pick_exact(H, T, &hc);
  switch (rpt) {
    case 4: err = launch_exact<4>(h, w_pad, b, L, N, H, T, K, hc, marg_part, vals, idx, st); break;
    case 2: err = launch_exact<2>(h, w_pad, b, L, N, H, T, K, hc, marg_part, vals, idx, st); break;
    default: err = launch_exact<1>(h, w_pad, b, L, N, H, T, K, hc, marg_part, vals, idx, st);
  }
  if (err) return err;
  const Rows g = make_rows(L, N, 16 * rpt);
  reduce_levels_kernel<<<(L * T + 255) / 256, 256, 0, st>>>(marg_part, marg, L, g.spl, T, N);
  return (int)cudaGetLastError();
}

// + idx (L, N, K), g_marg (L, T), g_vals (L, N, K) -> dh (L, N, H) and
// dwb = [dw (H, T), db (T)]. w_pad: the head padded with zeros to
// (hpd_tail_head_rows(H), hpd_tail_head_ld(T)), 16-byte aligned. part: (hpd_tail_blocks(..,
// 1), H * T + T) scratch.
int hpd_tail_bwd(const float* h, const float* w_pad, const float* b, const int* idx,
                 const float* g_marg, const float* g_vals, int L, int N, int H, int T, int K,
                 float* dh, float* part, float* dwb, void* stream) {
  const int err = check_shape(L, N, H, T, K, true);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return H > WMAX
             ? bwd_rpt<true>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st)
             : bwd_rpt<false>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
}

}  // extern "C"
