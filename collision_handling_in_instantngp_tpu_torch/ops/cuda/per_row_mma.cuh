// The per-row head's three products on the tensor cores: the logits replay
// (R x H) (H x T), dW_head = a_head^T dl and dh = dl W_head^T, for a row
// tile of R = 16 * RPT rows. hpd_full.cu's backward (K11) takes them; each
// helper takes an (R x H) activation tile, the (H x T) head (a zero-padded
// copy in device memory) and the (R x T) logits / dlogits tile, so the
// per-row tail's backward (hpd_tail.cu) can take them as they are.
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
// head padded with zeros to WMAX x head_ld(T), so no copy needs a bound.
#pragma once

#include "per_row.cuh"

namespace per_row {

constexpr int CHAIN = 16;  // k8 steps per zeroed accumulator (<= 24)

__host__ __device__ constexpr int round32(int w) { return (w + 31) / 32 * 32; }

// Row stride of a tile the helpers read: >= round32(w) and = 4 (mod 32).
__host__ __device__ constexpr int mma_ld(int w) { return round32(w) + 4; }

// Row stride of the padded head (WMAX x head_ld(T), zeros past H and T):
// every staged chunk lies inside it.
__host__ __device__ constexpr int head_ld(int T) { return (T + 255) / 256 * 256; }

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

// dst[0:4] <- src[0:4], asynchronously; both 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// For chunks 0 .. n - 1: issue(c, buf) stages chunk c into buffer buf with
// stage_chunk, compute(c, buf) reads it. With NBUF = 2 chunk c + 1 streams in
// while chunk c is computed. Starts with a barrier (the buffers are free)
// and ends with one.
template <int NBUF, typename FI, typename FC>
__device__ __forceinline__ void staged(int n, FI issue, FC compute) {
  __syncthreads();
  if (NBUF == 2) {
    issue(0, 0);
    cp_commit();
  }
  for (int c = 0; c < n; ++c) {
    if (NBUF == 2) {
      if (c + 1 < n) issue(c + 1, (c + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      issue(c, 0);
      cp_commit();
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
// zeros to WMAX x ldw in device memory, ldw = head_ld(T), 16-byte aligned;
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
// in the padding). Each element of the partial is updated by the same
// thread, tile after tile: the sums are bitwise stable. No barrier.
// The product is taken transposed (M = T, N = H), so that the 8 lanes of a
// fragment row hold 8 consecutive columns c of the partial: each access of
// its read-modify-write fills whole 32-byte sectors. The partial's values
// load before the MMAs, which hide their latency.
template <int RPT>
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
          return G[(8 * s + 2 * t4 + (q >> 1)) * ldg + m0 + 16 * i + g + 8 * (q & 1)];
        },
        [&](int s, int j, int q) { return A[(8 * s + 2 * t4 + q) * lda + n0 + 8 * j + g]; });
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
template <int RPT>
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
              if (last) v *= act[r * lda + h] > 0.f ? 1.f : 0.f;
              out[r * ldo + h] = v;
            }
          }
      });
}

}  // namespace per_row
