// The per-row head's three products on the tensor cores: the logits replay
// (R x H) (H x T), dW_head = a_head^T dl and dh = dl W_head^T, for a row
// tile of R = 16 * RPT rows. hpd_full.cu's backward (K11) and the per-row
// tail's backward (hpd_tail.cu, K9) take all three, hpd_full.cu's forward
// (K10) the logits; each helper takes an (R x H) activation tile, the
// (H x T) head (a zero-padded copy in device memory) and the (R x T)
// logits / dlogits tile. K11's hidden layers' backward takes the same
// steps (below: hid_bwd, and head_dw with its reads bounded).
//
// Arithmetic: warp-level mma.sync m16n8k8 tf32 as 3xTF32. x = hi + lo,
// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away from
// zero, cvt.rna.tf32.f32's result); a term is lo_a hi_b + hi_a lo_b +
// hi_a hi_b. The tensor cores round their fp32 sums toward zero, a bias that
// grows with the MMAs on one accumulator: the lo products go to an
// accumulator of their own, every chain starts from zero and holds at most
// CHAIN k8 steps, and chains are added in fp32 (round to nearest).
//
// Layout: the operands are read from shared memory into registers by hand.
// A tile the helpers read has a row stride of mma_ld(width) floats, which is
// = 4 (mod 32), with zeros in the columns [width, round32(width)). Fragment
// loads that put the fragment's group index (lane / 4) on the row then hit
// 32 banks (4 g + t). dW contracts over the rows: there the k index of a k8
// step runs over the rows 2 t and 2 t + 1 (the same order in A and B), so
// those loads hit 32 banks too (8 t + g). The head streams through a staged
// chunk, [k][n] with a stride = 8 (mod 32) for the logits, [n][k] with a
// stride = 4 (mod 32) for dh, copied in 16-byte pieces from a copy of the
// head padded with zeros to head_rows(H) x head_ld(T), so no copy needs a
// bound.
#pragma once

#include "per_row.cuh"

namespace per_row {

constexpr int CHAIN = 16;  // k8 steps per zeroed accumulator (<= 24)

__host__ __device__ constexpr int round32(int w) { return (w + 31) / 32 * 32; }

// Row stride of a tile the helpers read: >= round32(w) and = 4 (mod 32).
__host__ __device__ constexpr int mma_ld(int w) { return round32(w) + 4; }

// Row stride of the padded head (head_rows(H) x head_ld(T), zeros past H
// and T): every staged chunk lies inside it.
__host__ __device__ constexpr int head_ld(int T) { return (T + 255) / 256 * 256; }

// Rows of the padded head: H rounded up to a whole WMAX-row chunk of dh.
__host__ __device__ constexpr int head_rows(int H) { return (H + WMAX - 1) / WMAX * WMAX; }

// Warp grid over an (R x .) output: MT m16 tiles a warp, WR warps down the
// rows, WC across. The staged chunks of the head are double-buffered at
// RPT = 4 (the per-row route's tile) and single at the narrower tiles: so
// the backward still has a tile for every shape the FMA kernel took.
template <int RPT>
struct Grid {
  static constexpr int MT = RPT >= 2 ? 2 : 1;
  static constexpr int WR = RPT / MT;
  static constexpr int WC = WARPS / WR;
  static constexpr int CB = WC * 32;              // logits columns a block pass
  static constexpr int KL = RPT >= 4 ? 64 : 16;   // staged k rows of the logits' chunk
  static constexpr int LDL = CB + 8;              // its stride, = 8 (mod 32)
  static constexpr int NTD = WMAX / (8 * WC);     // dh's n8 tiles a warp: WMAX columns in all
  static constexpr int KD = RPT >= 4 ? 64 : 32;   // staged t columns of dh's chunk
  static constexpr int LDD = KD + 4;              // its stride, = 4 (mod 32)
  static constexpr int NBUF = RPT >= 4 ? 2 : 1;
  static constexpr int BUF = KL * LDL > WMAX * LDD ? KL * LDL : WMAX * LDD;
  static constexpr int STAGE = NBUF * BUF;
};

// Floats of the staged head chunks at RPT rows a thread.
__host__ __device__ constexpr int head_stage_floats(int rpt) {
  return rpt >= 4 ? Grid<4>::STAGE : rpt == 2 ? Grid<2>::STAGE : Grid<1>::STAGE;
}

// Chunk (rows x cols, cols a multiple of 4) of a padded head at (r0, c0)
// into a stage buffer of row stride lds (a multiple of 4).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ w, int ldw, int r0, int c0,
                                            float* __restrict__ st, int lds) {
  constexpr int V = COLS / 4;
  static_assert(ROWS * V % THREADS == 0, "whole vectors a thread");
#pragma unroll
  for (int u = 0; u < ROWS * V / THREADS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int r = e / V, c = 4 * (e - r * V);
    cp_async16(st + r * lds + c, w + (size_t)(r0 + r) * ldw + c0 + c);
  }
}

struct Nop {
  __device__ void operator()() const {}
};

// For chunks 0 .. n - 1 (n >= 1): issue(c, buf) stages chunk c into buffer
// buf with stage_chunk, compute(c, buf) reads it. With NBUF = 2 chunk c + 1
// streams in while chunk c is computed. pre() runs once chunk 0 is issued,
// before any wait (work that needs no stage buffer, under chunk 0's
// latency). Starts with a barrier (the buffers are free) and ends with one.
template <int NBUF, typename FI, typename FC, typename FP = Nop>
__device__ __forceinline__ void staged(int n, FI issue, FC compute, FP pre = FP()) {
  __syncthreads();
  if (NBUF == 2) {
    issue(0, 0);
    cp_commit();
    pre();
  }
  for (int c = 0; c < n; ++c) {
    if (NBUF == 2) {
      if (c + 1 < n) issue(c + 1, (c + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      issue(c, 0);
      cp_commit();
      if (c == 0) pre();
      cp_wait<0>();
    }
    __syncthreads();
    compute(c, NBUF == 2 ? c & 1 : 0);
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b: A 16 x 8 row-major, B 8 x 8 column-major, tf32, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&d)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[i][j][q] = 0.f;
}

// hi += lo, element by element (the end of a chain)
template <int MT, int NT>
__device__ __forceinline__ void merge(float (&hi)[MT][NT][4], const float (&lo)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[i][j][q] += lo[i][j][q];
}

// k8 steps [s0, s1) of a warp's (16 MT x 8 NT) product, 3xTF32: hi_a hi_b
// into d, lo_a hi_b + hi_a lo_b into dl; the next step's fragments load
// while a step's MMAs issue. a_of(s, i, q): element q of m
// tile i's A fragment at step s (rows g, g + 8, g, g + 8; k t, t, t + 4,
// t + 4); b_of(s, j, q): element q of n tile j's B fragment (k t, t + 4;
// column g).
template <int MT, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma3_steps(float (&d)[MT][NT][4], float (&dl)[MT][NT][4], int s0,
                                           int s1, FA a_of, FB b_of) {
  if (s0 >= s1) return;
  float ra[MT][4], rb[NT][2];
  const auto load = [&](int s) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) ra[i][q] = a_of(s, i, q);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) rb[j][q] = b_of(s, j, q);
  };
  load(s0);
  for (int s = s0; s < s1; ++s) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) split(ra[i][q], ah[i][q], al[i][q]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) split(rb[j][q], bh[j][q], bl[j][q]);
    if (s + 1 < s1) load(s + 1);  // in flight while this step's MMAs issue
    // the two MMAs on each dl apart, so the second need not wait for the first
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(dl[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(d[i][j], ah[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(dl[i][j], ah[i], bl[j]);
  }
}

// cache[r, c] = (A @ w)[r, c] + b[c] for c < T, 0 for T <= c < round32(T).
// A: R x H, stride lda (mma_ld(H), zeros past H); w: the head padded with
// zeros to head_rows(H) x ldw in device memory, ldw = head_ld(T), 16-byte aligned;
// cache: stride ldc >= round32(T). Starts with a barrier (stage is
// free, A complete) and ends with one; stage: head_stage_floats(RPT) floats.
template <int RPT>
__device__ __forceinline__ void head_logits(const float* __restrict__ A, int lda, int H,
                                            const float* __restrict__ w, int ldw,
                                            const float* __restrict__ b, int T,
                                            float* __restrict__ stage, float* __restrict__ cache,
                                            int ldc) {
  using G = Grid<RPT>;
  constexpr int MT = G::MT, NT = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp / G::WC) * 16 * MT, n0 = (warp % G::WC) * 32;
  const int nk = (H + 7) / 8, tc = round32(T);
  const int nkc = (H + G::KL - 1) / G::KL;  // k chunks per column pass
  float d[MT][NT][4], dl[MT][NT][4];
  staged<G::NBUF>(
      (tc + G::CB - 1) / G::CB * nkc,
      [&](int ci, int buf) {
        stage_chunk<G::KL, G::CB>(w, ldw, ci % nkc * G::KL, ci / nkc * G::CB,
                                  stage + buf * G::BUF, G::LDL);
      },
      [&](int ci, int buf) {
        const int c0 = ci / nkc * G::CB, kc = ci % nkc;
        const float* st = stage + buf * G::BUF;
        if (kc == 0) {
          zero(d);
          zero(dl);
        }
        const int sb = kc * (G::KL / 8);
        mma3_steps<MT, NT>(
            d, dl, sb, min(nk, sb + G::KL / 8),
            [&](int s, int i, int q) {
              return A[(m0 + 16 * i + g + 8 * (q & 1)) * lda + 8 * s + t4 + 4 * (q >> 1)];
            },
            [&](int s, int j, int q) {
              return st[(8 * (s - sb) + t4 + 4 * q) * G::LDL + n0 + 8 * j + g];
            });
        if (kc < nkc - 1) return;
        merge(d, dl);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = c0 + n0 + 8 * j + 2 * t4 + (q & 1);
            if (c >= tc) continue;
            const float bc = c < T ? b[c] : 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i)
              cache[(m0 + 16 * i + g + 8 * (q >> 1)) * ldc + c] = c < T ? d[i][j][q] + bc : 0.f;
          }
      });
}

// part[h * T + c] += sum_r A[r, h] G[r, c] (h < H, c < T), a 3xTF32 product
// over the tile's R rows, and partb[c] += sum_r G[r, c] in row order. A:
// R x H, stride lda; G: R x T, stride ldg (both mma_ld of their width, zeros
// in the padding; with BOUND, any strides and no padding: the reads past H
// and T give zeros, as K11's hidden layers take dW_i = act_i^T g_i). Each
// element of the partial is updated by the same thread, tile after tile:
// the sums are bitwise stable. No barrier.
// The product is taken transposed (M = T, N = H), so that the 8 lanes of a
// fragment row hold 8 consecutive columns c of the partial: each access of
// its read-modify-write fills whole 32-byte sectors. The partial's values
// load before the MMAs, which hide their latency.
template <int RPT, bool BOUND = false>
__device__ __forceinline__ void head_dw(const float* __restrict__ A, int lda, int H,
                                        const float* __restrict__ G, int ldg, int T,
                                        float* __restrict__ part, float* __restrict__ partb) {
  constexpr int R = 16 * RPT, MT = 2, NT = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_n = round32(H) / 32, tiles = round32(T) / 32 * tiles_n;
  for (int tile = warp; tile < tiles; tile += WARPS) {
    const int m0 = tile / tiles_n * 32, n0 = tile % tiles_n * 32;
    float d[MT][NT][4], dl[MT][NT][4], old[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = m0 + 16 * i + g + 8 * (q >> 1), h = n0 + 8 * j + 2 * t4 + (q & 1);
          old[i][j][q] = c < T && h < H ? part[(size_t)h * T + c] : 0.f;
        }
    zero(d);
    zero(dl);
    // k slot t of a k8 step reads row 2 t, slot t + 4 row 2 t + 1
    mma3_steps<MT, NT>(
        d, dl, 0, R / 8,
        [&](int s, int i, int q) {
          const int c = m0 + 16 * i + g + 8 * (q & 1);
          return BOUND && c >= T ? 0.f : G[(8 * s + 2 * t4 + (q >> 1)) * ldg + c];
        },
        [&](int s, int j, int q) {
          const int h = n0 + 8 * j + g;
          return BOUND && h >= H ? 0.f : A[(8 * s + 2 * t4 + q) * lda + h];
        });
    merge(d, dl);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = m0 + 16 * i + g + 8 * (q >> 1), h = n0 + 8 * j + 2 * t4 + (q & 1);
          if (c < T && h < H) part[(size_t)h * T + c] = old[i][j][q] + d[i][j][q];
        }
  }
  for (int c = threadIdx.x; c < T; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += G[r * ldg + c];
    partb[c] += s;
  }
}

// out[r, h] = (G @ w^T)[r, h] * (act[r, h] > 0) for h < H: G R x T, stride
// ldg (mma_ld(T), zeros past T); w the padded head as in head_logits; act
// the head's input, stride lda; out stride ldo. Chains of CHAIN k8 steps
// over T, added in order into out (each element by the thread that owns it).
// Starts with a barrier (stage is free, G complete); stage as head_logits'.
// MASK = false (the per-row tail's dh: the gradient of the head's input
// itself) drops the mask; act is then not read. H <= WMAX (head_dh_wide
// below takes wider heads).
template <int RPT, bool MASK = true>
__device__ __forceinline__ void head_dh(const float* __restrict__ G, int ldg, int T,
                                        const float* __restrict__ w, int ldw, int H,
                                        const float* __restrict__ act, int lda,
                                        float* __restrict__ stage, float* __restrict__ out,
                                        int ldo) {
  using Gr = Grid<RPT>;
  constexpr int MT = Gr::MT, NT = Gr::NTD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp / Gr::WC) * 16 * MT, n0 = (warp % Gr::WC) * 8 * NT;
  const int nk = (T + 7) / 8;
  float d[MT][NT][4], dl[MT][NT][4];
  staged<Gr::NBUF>(
      (T + Gr::KD - 1) / Gr::KD,
      [&](int ci, int buf) {
        stage_chunk<WMAX, Gr::KD>(w, ldw, 0, ci * Gr::KD, stage + buf * Gr::BUF, Gr::LDD);
      },
      [&](int ci, int buf) {
        const float* st = stage + buf * Gr::BUF;
        const int sb = ci * (Gr::KD / 8), se = min(nk, sb + Gr::KD / 8);
        if (sb % CHAIN == 0) {
          zero(d);
          zero(dl);
        }
        mma3_steps<MT, NT>(
            d, dl, sb, se,
            [&](int s, int i, int q) {
              return G[(m0 + 16 * i + g + 8 * (q & 1)) * ldg + 8 * s + t4 + 4 * (q >> 1)];
            },
            [&](int s, int j, int q) {
              return st[(n0 + 8 * j + g) * Gr::LDD + 8 * (s - sb) + t4 + 4 * q];
            });
        if (se % CHAIN != 0 && se != nk) return;
        merge(d, dl);
        const bool first = sb < CHAIN, last = se == nk;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = m0 + 16 * i + g + 8 * (q >> 1);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int h = n0 + 8 * j + 2 * t4 + (q & 1);
              if (h >= H) continue;
              float v = first ? d[i][j][q] : out[r * ldo + h] + d[i][j][q];
              if (MASK && last) v *= act[r * lda + h] > 0.f ? 1.f : 0.f;
              out[r * ldo + h] = v;
            }
          }
      });
}

// head_dh for any H <= head_rows(H): one head_dh per WMAX columns of dh,
// each reading its WMAX rows of the padded head.
template <int RPT, bool MASK = true>
__device__ __forceinline__ void head_dh_wide(const float* __restrict__ G, int ldg, int T,
                                             const float* __restrict__ w, int ldw, int H,
                                             const float* __restrict__ act, int lda,
                                             float* __restrict__ stage, float* __restrict__ out,
                                             int ldo) {
  for (int h0 = 0; h0 < H; h0 += WMAX)
    head_dh<RPT, MASK>(G, ldg, T, w + (size_t)h0 * ldw, ldw, H - h0 < WMAX ? H - h0 : WMAX,
                       MASK ? act + h0 : act, lda, stage, out + h0, ldo);
}

// ------------------ K11's hidden layers on the tensor cores ------------------
//
// The hidden layers' backward as the head's 3xTF32 k8 steps: dh_i = (g
// W_i^T) * (act_i > 0) (hid_bwd) and dW_i = act_i^T g (head_dw with BOUND).
// W_i (w_i x w_{i+1}, row-major in the packed parameters, at any offset)
// streams through the head's stage buffers by 4-byte cp.async, zeros past
// its edges, [n][k] at Grid::LDD = 4 (mod 32), WMAX output columns a slab.
// The activation and gradient tiles lie in shared memory at the strides
// K11's plan gives them (hid_ld: = 4 (mod 8), so the fragment loads hit 32
// banks, where the tile fits at it); reads past a width are bounded, so no
// tile needs zero padding. A warp takes items of 16 rows x 32 output
// columns. Each staged chunk of the contraction (Grid::KD deep, at most 8
// k8 steps) is one chain from zeroed accumulators; the chains are added in
// order in fp32 into the output tile, each element by the thread that owns
// it.

// Row stride of a hidden activation or gradient tile: >= round8(w) (a k8
// step's reach) and = 4 (mod 8).
__host__ __device__ constexpr int hid_ld(int w) { return (w + 7) / 8 * 8 + 4; }

// st[r * lds + c] = src[(r0 + r) * ld + c0 + c] for r < rows, c < COLS, 0
// where r0 + r >= rmax or c0 + c >= cmax
template <int COLS>
__device__ __forceinline__ void stage_bounded(const float* __restrict__ src, int ld, int r0,
                                              int rmax, int c0, int cmax, int rows,
                                              float* __restrict__ st, int lds) {
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * COLS; e += THREADS) {
    const int r = e / COLS, c = e - r * COLS;
    const bool ok = r0 + r < rmax && c0 + c < cmax;
    cp_async4(st + r * lds + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// out[r, a] = (G @ W^T)[r, a] * (act[r, a] > 0) for a < N: G R x K (stride
// ldg), W N x K in device memory (the layer's weight: N its input width, K
// its output width), act R x N (stride lda, the layer's input), out stride
// ldo (only a < N written). pre() runs under the first chunk's staging (as
// staged's). Starts with a barrier and ends with one.
template <int RPT, typename FP>
__device__ __forceinline__ void hid_bwd(const float* __restrict__ G, int ldg, int K,
                                        const float* __restrict__ W, int N,
                                        const float* __restrict__ act, int lda,
                                        float* __restrict__ stage, float* __restrict__ out,
                                        int ldo, FP pre) {
  using Gr = Grid<RPT>;
  constexpr int MI = RPT, KC = Gr::KD;  // m16 tiles of the row tile; a chunk's depth
  static_assert(KC <= 8 * CHAIN, "a chunk is one chain");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nkc = (K + KC - 1) / KC;
  staged<Gr::NBUF>(
      (N + WMAX - 1) / WMAX * nkc,
      [&](int ci, int buf) {
        const int n0 = ci / nkc * WMAX;
        stage_bounded<KC>(W, K, n0, N, ci % nkc * KC, K, (min(WMAX, N - n0) + 31) / 32 * 32,
                          stage + buf * Gr::BUF, Gr::LDD);
      },
      [&](int ci, int buf) {
        const int n0 = ci / nkc * WMAX, kc = ci % nkc, k0 = kc * KC;
        const float* st = stage + buf * Gr::BUF;
        const int items = MI * ((min(WMAX, N - n0) + 31) / 32);
        const int steps = (min(KC, K - k0) + 7) / 8;
        for (int it = warp; it < items; it += WARPS) {
          const int m0 = it % MI * 16, nl = it / MI * 32;
          float d[1][4][4], dl[1][4][4];
          zero(d);
          zero(dl);
          mma3_steps<1, 4>(
              d, dl, 0, steps,
              [&](int s, int, int q) {
                const int k = k0 + 8 * s + t4 + 4 * (q >> 1);
                return k < K ? G[(m0 + g + 8 * (q & 1)) * ldg + k] : 0.f;
              },
              [&](int s, int j, int q) { return st[(nl + 8 * j + g) * Gr::LDD + 8 * s + t4 + 4 * q]; });
          merge(d, dl);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = m0 + g + 8 * (q >> 1), a = n0 + nl + 8 * j + 2 * t4 + (q & 1);
              if (a >= N) continue;
              float v = kc == 0 ? d[0][j][q] : out[r * ldo + a] + d[0][j][q];
              if (kc == nkc - 1) v *= act[r * lda + a] > 0.f ? 1.f : 0.f;
              out[r * ldo + a] = v;
            }
        }
      },
      pre);
}

// ------------ the exact fp32 top-K of p from tensor-core logits ------------
//
// K10 takes its head's logits with head_logits and selects the top-K of p =
// nan_to_num(e / s), e = exp(l - max l), with the fp32 logits (one fma chain
// over k ascending from zero, then + b: hidden_stack's arithmetic, which the
// CUDA-core forward runs) by candidate refinement:
//   1. top_candidates: each row keeps its top kc = K + GSLACK columns by
//      tensor-core logit (value desc, index asc).
//   2. recompute_streamed: each candidate's logit in fp32, hidden_stack's chain.
//   3. settle_row: one s for the row, the tensor-core softmax's sum with the
//      candidates' terms replaced by their recomputed ones (as differences
//      from the top recomputed logit); p = nan_to_num(exp(l - top) / s) of
//      each candidate; the top K of those p, lowest index among equal p, as
//      topk_row ranks them. p is monotone in l under one s, so the order is
//      that of the fp32 logits but for values that round to one p.
//   4. the guard: with eps_r >= |tensor-core logit - fp32 logit| for every
//      column (guard_coef), a column outside the candidates has an fp32 logit
//      <= (kc-th tensor-core value) + eps_r. So when the K-th selected
//      logit exceeds the kc-th tensor-core value by more than 2 eps_r +
//      GUARD_ABS, its e exceeds theirs by a factor > exp(GUARD_ABS) (64
//      ulps), and while its p is a normal float (>= P_MIN) no such column
//      can reach it in p: the top K lies among the candidates. A row that
//      fails (a near-tie cluster deeper than GSLACK at the K-th place, p
//      underflowing there, a NaN) is redone whole in fp32 by one warp
//      (exact_row): the CUDA-core forward's own arithmetic, bit for bit.
// What can still differ from the plain version: two candidates whose e lie
// within an ulp or two of each other may divide to one p under the plain
// version's s and to two under the kernel's (or the reverse), since the
// kernel's s comes from tensor-core terms; the two then swap places. This
// needs two logits within about 2^-23 of each other (relative) at a place
// of the top K; tests/test_torch_tf32_per_row.py plants it.

// The guard's constants. hpd_full.py restates them (GUARD_SLACK, GUARD_ABS,
// P_MIN, guard_eps) for the CPU emulation of the refinement, and
// tests/test_torch_tf32_per_row.py holds them to this file.
constexpr int GSLACK = 4;             // candidates beyond K
constexpr float GUARD_ABS = 0x1p-18f;  // the guard's margin beyond 2 eps_r
constexpr float P_MIN = 0x1p-100f;     // the least p of a settled K-th place

// eps_r = guard_coef(H) * S_r, S_r = max_t |b_t| + sum_k |a_rk| max_t |w_kt|
// (>= sum_k |a_rk w_kt| + |b_t| for every t), bounds |head_logits' logit -
// fp32 logit| of row r. With nk = ceil(H / 8) k8 steps, all in one chain
// (head_logits restarts no chain; nothing below depends on nk's size, so
// the bound holds at every H <= WIDE_MAX):
//   split: x = hi + lo + r, |r| <= 2^-22 |x|, lo_a lo_b dropped: <= 3 2^-22
//     = 0.75 2^-20 of each |term|.
//   hi_a hi_b accumulator: nk MMAs; each aligns its 8 products and the
//     accumulator to the largest and truncates (<= 9 2^-23 of a running sum
//     <= S_r) and truncates its result (<= 2^-23): 1.25 nk 2^-20 S_r.
//   lo accumulator: 2 nk MMAs on sums <= 2^-10 S_r: <= 2.5 nk 2^-30 S_r,
//     < 0.16 2^-20 S_r at nk = 64 (H = 512).
//   the two accumulators' fp32 add and + b: 2 roundings, 0.125 2^-20 S_r.
//   fp32 chain: H fmas and + b, each one rounding of a sum <= S_r:
//     (H + 1) 2^-24 S_r = (H + 1) / 16 2^-20 S_r.
// Total <= (1.25 nk + H / 16 + 0.35) 2^-20 S_r; c = 1.25 nk + H / 16 + 2
// leaves 1.6 2^-20 for S_r's own fp32 rounding ((H + 1) 2^-24 of it, under
// 0.004 2^-20 S_r at H = 512). At H = 128: 30 2^-20; at H = 512: 114 2^-20.
__host__ __device__ __forceinline__ float guard_coef(int H) {
  const int nk = (H + 7) / 8;
  return (1.25f * nk + H / 16.f + 2.f) * 0x1p-20f;
}

// (v, i) before (v2, i2) in the candidate order: value desc, index asc.
__device__ __forceinline__ bool ranks_before(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Floats of the refinement's lists at R rows and kc candidates: lv, li, ex
// (R x kc each), m, s, S_r and the fix-up flag (R each).
__host__ __device__ constexpr int refine_floats(int R, int kc) { return R * (3 * kc + 4); }

// Block: am[k] = max_t |w[k * T + t]| for k < H, am[H] = max_t |b[t]|.
__device__ __forceinline__ void head_absmax(const float* __restrict__ w,
                                            const float* __restrict__ b, int H, int T,
                                            float* __restrict__ am) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k <= H; k += WARPS) {
    const float* src = k < H ? w + (size_t)k * T : b;
    float m = 0.f;
    for (int c = lane; c < T; c += 32) m = fmaxf(m, fabsf(src[c]));
    m = warp_max(m);
    if (lane == 0) am[k] = m;
  }
}

// One thread: the top KC of the columns c = part + P j of row[0:T) (value
// desc, index asc), kept sorted in registers by insertion; the first n_out
// into v[q ld], ix[q ld], sentinels (-inf, INT_MAX) where fewer. With P threads a row on consecutive lanes and rows at a stride
// = 4 (mod 32), 8 rows x 4 parts of a warp read 32 banks.
template <int KC>
__device__ __forceinline__ void top_part(const float* __restrict__ row, int T, int P, int part,
                                         float* __restrict__ v, int* __restrict__ ix, int ld,
                                         int n_out) {
  float tv[KC];
  int ti[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    tv[q] = -INFINITY;
    ti[q] = INT_MAX;
  }
#pragma unroll 4
  for (int c = part; c < T; c += P) {
    const float x = row[c];
    if (ranks_before(x, c, tv[KC - 1], ti[KC - 1])) {
      tv[KC - 1] = x;
      ti[KC - 1] = c;
      // every step, taken or not: an early exit would split the warp
#pragma unroll
      for (int q = KC - 1; q > 0; --q)
        if (ranks_before(tv[q], ti[q], tv[q - 1], ti[q - 1])) {
          const float x2 = tv[q];
          const int i2 = ti[q];
          tv[q] = tv[q - 1];
          ti[q] = ti[q - 1];
          tv[q - 1] = x2;
          ti[q - 1] = i2;
        }
    }
  }
#pragma unroll
  for (int q = 0; q < KC; ++q)
    if (q < n_out) {
      v[q * ld] = tv[q];
      ix[q * ld] = ti[q];
    }
}

// Block: each row r < rows of the (R x T) tile (stride ldc) gets its top kc
// (<= KC) columns (value desc, index asc) in lv[r kc ..], li[r kc ..]: P =
// THREADS / R threads a row each keep the top KC of their share of the
// columns (top_part, into scr: 2 THREADS KC words), then one thread a row
// merges the P sorted lists; with KC = 0 (no scratch) one thread a row
// keeps the top GMAX of the whole row. A missing candidate (fewer than kc
// ordered values: NaNs) gets lv = NaN, li = 0, which fails the guard. The
// rows are only read. Ends with a barrier.
template <int R, int KC, int GMAX>
__device__ __forceinline__ void top_candidates(const float* __restrict__ cache, int ldc, int T,
                                               int rows, int kc, float* __restrict__ scr,
                                               float* __restrict__ lv, int* __restrict__ li) {
  constexpr int P = KC > 0 ? THREADS / R : 1, KL = KC > 0 ? KC : GMAX;
  float* sv = scr;
  int* si = reinterpret_cast<int*>(scr + THREADS * KL);
  if (KC > 0) {
    // list (r, part) at column r P + part of a KC x THREADS array
    top_part<KL>(cache + threadIdx.x / P * ldc, T, P, threadIdx.x % P, sv + threadIdx.x,
                 si + threadIdx.x, THREADS, KL);
    __syncthreads();
  } else if (threadIdx.x < rows) {
    top_part<KL>(cache + threadIdx.x * ldc, T, 1, 0, lv + threadIdx.x * kc,
                 li + threadIdx.x * kc, 1, kc);
  }
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    int head[P];
#pragma unroll
    for (int p = 0; p < P; ++p) head[p] = 0;
    for (int q = 0; q < kc; ++q) {
      float bv;
      int bi;
      if (KC == 0) {
        bv = lv[r * kc + q];
        bi = li[r * kc + q];
      } else {
        int best = 0;
        bv = -INFINITY;
        bi = INT_MAX;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (head[p] >= KL) continue;
          const int o = head[p] * THREADS + r * P + p;
          if (ranks_before(sv[o], si[o], bv, bi)) {
            best = p;
            bv = sv[o];
            bi = si[o];
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) head[p] += p == best ? 1 : 0;
      }
      lv[r * kc + q] = bi == INT_MAX ? NAN : bv;
      li[r * kc + q] = bi == INT_MAX ? 0 : bi;
    }
  }
  __syncthreads();
}

// fp32 logit of column t for the head input a (H floats): one fma chain
// over k ascending from zero, then + b[t] (hidden_stack's arithmetic). w: the
// padded head, row stride ldw.
__device__ __forceinline__ float fp32_logit(const float* __restrict__ a, int H,
                                            const float* __restrict__ w, int ldw,
                                            const float* __restrict__ b, int t) {
  float acc = 0.f;
  for (int k = 0; k < H; ++k) acc = fmaf(a[k], __ldg(w + (size_t)k * ldw + t), acc);
  return acc + __ldg(b + t);
}

// Block: ex[e] = fp32_logit of candidate li[e], e < rows kc (row e / kc),
// the same chains, with the head streamed as head_logits streams it (the
// padded head's [k][n] chunks, double-buffered cp.async copies into stage):
// a chain advances over a chunk when the chunk holds its column, in k
// order, the thread's chains side by side. A: the head input tile, stride
// lda. MAXE >= ceil(rows kc / THREADS) chains a thread. Starts with a
// barrier (stage is free) and ends with one.
template <int RPT, int MAXE>
__device__ __forceinline__ void recompute_streamed(const float* __restrict__ A, int lda, int H,
                                                   const float* __restrict__ w, int ldw,
                                                   const float* __restrict__ b, int rows,
                                                   int kc, int T, const int* __restrict__ li,
                                                   float* __restrict__ stage,
                                                   float* __restrict__ ex) {
  using G = Grid<RPT>;
  const int n = rows * kc;
  const int nkc = (H + G::KL - 1) / G::KL;  // k chunks per column block
  float acc[MAXE];
  int col[MAXE], arow[MAXE];  // the chain's column (INT_MAX: none) and head input row
#pragma unroll
  for (int j = 0; j < MAXE; ++j) {
    const int e = threadIdx.x + j * THREADS;
    col[j] = e < n ? li[e] : INT_MAX;
    arow[j] = e < n ? e / kc * lda : 0;
    acc[j] = 0.f;
  }
  staged<G::NBUF>(
      (T + G::CB - 1) / G::CB * nkc,
      [&](int ci, int buf) {
        stage_chunk<G::KL, G::CB>(w, ldw, ci % nkc * G::KL, ci / nkc * G::CB,
                                  stage + buf * G::BUF, G::LDL);
      },
      [&](int ci, int buf) {
        const float* st = stage + buf * G::BUF;
        const int c0 = ci / nkc * G::CB, k0 = ci % nkc * G::KL, kn = min(G::KL, H - k0);
        int wo[MAXE];  // the chain's column in the chunk, -1 if not there
        bool any = false;
#pragma unroll
        for (int j = 0; j < MAXE; ++j) {
          wo[j] = col[j] >= c0 && col[j] < c0 + G::CB ? col[j] - c0 : -1;
          any |= wo[j] >= 0;
        }
        if (!any) return;
        const float* a = A + k0;
        for (int k = 0; k < kn; ++k) {
#pragma unroll
          for (int j = 0; j < MAXE; ++j)
            if (wo[j] >= 0) acc[j] = fmaf(a[arow[j] + k], st[k * G::LDL + wo[j]], acc[j]);
        }
      });
#pragma unroll
  for (int j = 0; j < MAXE; ++j)
    if (col[j] != INT_MAX) ex[threadIdx.x + j * THREADS] = acc[j] + __ldg(b + col[j]);
  __syncthreads();
}

// Block, rows r < rows: sr[r] = S_r = am[H] + sum_k |a_rk| am[k], one thread
// a row. A: the head input tile, stride lda.
__device__ __forceinline__ void guard_sums(const float* __restrict__ A, int lda, int H,
                                           const float* __restrict__ am, int rows,
                                           float* __restrict__ sr) {
  if (threadIdx.x >= rows) return;
  const float* a = A + threadIdx.x * lda;
  float s = am[H];
  for (int k = 0; k < H; ++k) s = fmaf(fabsf(a[k]), am[k], s);
  sr[threadIdx.x] = s;
}

// One thread, one row: ranks its kc candidates (tensor-core values lv,
// columns li, fp32 logits ex) on p under one s (from the tensor-core
// softmax's max m and sum s_tc) and writes the top K to vals/idx; returns
// whether the guard (eps = eps_r) settles the row. An unsettled row's
// vals/idx are written again by exact_row. lv is overwritten with the p.
__device__ __forceinline__ bool settle_row(float* __restrict__ lv, const int* __restrict__ li,
                                           const float* __restrict__ ex, int kc, int K, int T,
                                           float m, float s_tc, float eps,
                                           float* __restrict__ vals, int* __restrict__ idx) {
  float top = -INFINITY;
  for (int c = 0; c < kc; ++c) top = fmaxf(top, ex[c]);
  float rest = s_tc;
  for (int c = 0; c < kc; ++c) rest -= expf(lv[c] - m);
  float s = fmaxf(rest, 0.f);
  for (int c = 0; c < kc; ++c) s += expf(ex[c] - top);
  const float lv_last = lv[kc - 1];
  for (int c = 0; c < kc; ++c) lv[c] = nan_to_num(expf(ex[c] - top) / s);
  unsigned long long taken = 0ull;
  int last = 0;
  float p_last = 0.f;
  for (int q = 0; q < K; ++q) {
    float bp = -INFINITY;
    int bi = INT_MAX;
    for (int c = 0; c < kc; ++c) {
      // p is never NaN, so some candidate is always picked
      if (!((taken >> c) & 1ull) && ranks_before(lv[c], li[c], bp, bi)) {
        last = c;
        bp = lv[c];
        bi = li[c];
      }
    }
    taken |= 1ull << last;
    vals[q] = bp;
    idx[q] = bi;
    p_last = bp;
  }
  const bool all = kc >= T;  // no column outside the candidates
  return p_last >= P_MIN && (all || ex[last] - lv_last > 2.f * eps + GUARD_ABS);
}

// One warp, two rows (K10's p, which only the column sums read): each row's
// logits -> p = nan_to_num(e * (1 / s)), e = exp(l - max l), s = sum e,
// in place; the rows' max and sum in ma, sa, mb, sb on every lane. The two
// rows' passes side by side, for the latency of the warp's reductions.
__device__ __forceinline__ void softmax_pair(float* __restrict__ ra, float* __restrict__ rb,
                                             int T, float& ma, float& sa, float& mb,
                                             float& sb) {
  const int lane = threadIdx.x & 31;
  float xa = -INFINITY, xb = -INFINITY;
  for (int c = lane; c < T; c += 32) {
    xa = fmaxf(xa, ra[c]);
    xb = fmaxf(xb, rb[c]);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    xa = fmaxf(xa, __shfl_xor_sync(FULL, xa, off));
    xb = fmaxf(xb, __shfl_xor_sync(FULL, xb, off));
  }
  float ua = 0.f, ub = 0.f;
  for (int c = lane; c < T; c += 32) {
    const float ea = expf(ra[c] - xa), eb = expf(rb[c] - xb);
    ra[c] = ea;
    rb[c] = eb;
    ua += ea;
    ub += eb;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    ua += __shfl_xor_sync(FULL, ua, off);
    ub += __shfl_xor_sync(FULL, ub, off);
  }
  const float ia = 1.f / ua, ib = 1.f / ub;
  for (int c = lane; c < T; c += 32) {
    ra[c] = nan_to_num(ra[c] * ia);
    rb[c] = nan_to_num(rb[c] * ib);
  }
  __syncwarp();
  ma = xa;
  sa = ua;
  mb = xb;
  sb = ub;
}

// One warp, two rows of K11's logits: dl = p (g_p - <g_p, p>) in place,
// with p = nan_to_num(e * (1 / s)), e = exp(l - max l), s = sum e, and
// g_p = gm (+ g_vals at the row's top-K columns), the two rows' passes side
// by side. Three passes over a row: its max; e, with s and sum gm e; dl.
// <g_p, p> is taken as (sum gm e + sum of the top-K's g_vals e) / s
// (nan_to_num'd, so that a row whose p are all zeros has none): it rounds
// otherwise than dlogits_row's sum of gm p, which p only feeds (sums held
// to 1e-4). A row that is not valid (va / vb false) ends as zeros; ia, gva
// (ib, gvb): its top-K columns and g_vals (K <= KMAX = 32, one a lane),
// read only if valid.
__device__ __forceinline__ void softmax_dl_pair(float* __restrict__ ra, float* __restrict__ rb,
                                                int T, int K, const float* __restrict__ gm,
                                                const int* __restrict__ ia,
                                                const float* __restrict__ gva, bool va,
                                                const int* __restrict__ ib,
                                                const float* __restrict__ gvb, bool vb) {
  const int lane = threadIdx.x & 31;
  // the top-K loads first: in flight through the first two passes
  const bool ta = va && lane < K, tb = vb && lane < K;
  const int ca = ta ? ia[lane] : 0, cb = tb ? ib[lane] : 0;
  const float ga = ta ? gva[lane] : 0.f, gb = tb ? gvb[lane] : 0.f;
  float xa = -INFINITY, xb = -INFINITY;
  for (int c = lane; c < T; c += 32) {
    xa = fmaxf(xa, ra[c]);
    xb = fmaxf(xb, rb[c]);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    xa = fmaxf(xa, __shfl_xor_sync(FULL, xa, off));
    xb = fmaxf(xb, __shfl_xor_sync(FULL, xb, off));
  }
  float ua = 0.f, ub = 0.f, da = 0.f, db = 0.f;
  for (int c = lane; c < T; c += 32) {
    const float ea = expf(ra[c] - xa), eb = expf(rb[c] - xb);
    ra[c] = ea;
    rb[c] = eb;
    ua += ea;
    ub += eb;
    da = fmaf(gm[c], ea, da);
    db = fmaf(gm[c], eb, db);
  }
  __syncwarp();
  const float pa = ta ? ra[ca] : 0.f, pb = tb ? rb[cb] : 0.f;  // e, then p
  da = fmaf(ga, pa, da);
  db = fmaf(gb, pb, db);
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    ua += __shfl_xor_sync(FULL, ua, off);
    ub += __shfl_xor_sync(FULL, ub, off);
    da += __shfl_xor_sync(FULL, da, off);
    db += __shfl_xor_sync(FULL, db, off);
  }
  const float sa = 1.f / ua, sb = 1.f / ub;
  da = nan_to_num(da * sa);
  db = nan_to_num(db * sb);
  for (int c = lane; c < T; c += 32) {
    ra[c] = va ? nan_to_num(ra[c] * sa) * (gm[c] - da) : 0.f;
    rb[c] = vb ? nan_to_num(rb[c] * sb) * (gm[c] - db) : 0.f;
  }
  __syncwarp();
  if (ta) ra[ca] = nan_to_num(pa * sa) * ((gm[ca] + ga) - da);
  if (tb) rb[cb] = nan_to_num(pb * sb) * ((gm[cb] + gb) - db);
  __syncwarp();
}

// One warp: the row's fp32 logits (fp32_logit for every column; the lanes
// read consecutive columns of the padded head w) into row[0:T), then
// softmax_row and topk_row: the CUDA-core forward's arithmetic, bit for
// bit. a: the row's head input.
__device__ __noinline__ void exact_row(const float* __restrict__ a, int H,
                                       const float* __restrict__ w, int ldw,
                                       const float* __restrict__ b, int T, int K,
                                       float* __restrict__ row, float* __restrict__ vals,
                                       int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < T; c += 32) row[c] = fp32_logit(a, H, w, ldw, b, c);
  __syncwarp();
  softmax_row(row, T);
  topk_row(row, T, K, vals, idx);
}

}  // namespace per_row
