// The whole HPD index network per row (kernels K10 and K11): the hidden
// ReLU stack, the head, softmax, top-K on p and the loss marginal, from
// the grid vertices alone.
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/hpd_full.py:
//   hpd_full forward (_full_fwd_impl, _fwd_kernel): verts (L, N, d) and
//     every layer -> marg (L, T), vals/idx (L, N, K), as the per-row tail.
//   hpd_full backward (_hpd_full_bwd, _bwd_kernel): replays the stack from
//     the vertices; dl as the per-row tail; then dW_i = act_i^T d and
//     db_i = sum_rows d down the stack, with d <- (d W_i^T) * (act_i > 0),
//     the mask taken on the layer's post-activation input. No dverts.
//
// At the per-row route's shapes (L = 4, N = 229,616, [2 -> 32 -> 64 -> 128
// -> 256]) the forward is 79 GFLOP and the backward 237, against 7 MB of
// vertices and 29 MB of top-K outputs. Only those touch device memory: a
// row tile's activations and its (R, T) logits stay in shared memory, and
// the weights stream from L2 (the head is 128 KB at T = 256 and 1 MB at
// T = 2048: it cannot stay resident). The hidden layers run as fp32 FMA on
// the CUDA cores (per_row.cuh), the weights staged in 32-deep chunks; the
// head's products run as 3xTF32 on the tensor cores (per_row_mma.cuh): the
// forward's logits, the backward's logits replay, dW_head and dh (60 of the
// forward's 79 GFLOP, 181 of the backward's 237), so the bounds are the
// head at the TF32 peak plus the rest at the fp32 peak.
// The forward's top-K stays the exact top-K of p from the fp32 logits (the
// CUDA-core forward's): per tile, the candidates by tensor-core logit, p
// and the column sums from the tensor-core logits, the candidates' fp32
// recompute (the head streamed once more), their ranking on p and the
// guard, and the fp32 redo of the rows it leaves (per_row_mma.cuh: the
// derivation and what can still differ). The rows redone are counted in
// n_fix.
// dW/db of every layer accumulate in one partial per block (read-modify-
// write by the owning thread; for dW_head about 3.7 GB of L2 traffic a
// launch at those shapes), summed in block order by a second kernel. No
// atomics but the redo count.
#include "per_row.cuh"
#include "per_row_mma.cuh"

using namespace per_row;

namespace {

// Built with -DHPD_FULL_PHASES (tools/k11_phases.py), thread 0 of K11 and
// of K10 sums the clock64() ticks of each phase of its tiles into
// k11_phase / k10_phase (the phases end at a barrier, so its ticks are the
// block's); otherwise the marks (common.cuh) compile to nothing.
#ifdef HPD_FULL_PHASES
constexpr int K11_PHASES = 6;  // replay, logits, softmax + dl, dW_head, dh, hidden layers
// hidden layers, logits, softmax, column sums, and the top-K's candidates,
// fp32 recompute, ranking and redo
constexpr int K10_PHASES = 7;
__device__ unsigned long long k11_phase[K11_PHASES];
__device__ unsigned long long k10_phase[K10_PHASES];
#endif

constexpr int MAXL = 16;  // layers, head included
constexpr int KMAX = 32;

struct Net {
  int n;               // layers; the last is the head
  int w[MAXL + 1];     // widths: w[0] = d, w[n] = T
  int woff[MAXL];      // offset of W_i (w[i] x w[i+1], row-major) in params
  int boff[MAXL];      // offset of b_i (w[i+1])
  int aoff[MAXL];      // offset, in floats per tile row, of act_i in the backward
  int acols;           // sum over i < n - 1 of (w[i] + 1), + mma_ld(w[n - 1])
  int total;           // packed parameter count
};

// The strides of a stack past WMAX (the WIDE instances' last argument):
// the forward's activation tiles and the backward's gradient tiles.
struct Wide {
  int lda;
  int gld;
};

int make_net(int n, const int* widths, Net* net) {
  if (n < 1 || n > MAXL) return ERR_SHAPE;
  net->n = n;
  int off = 0, acols = 0;
  for (int i = 0; i <= n; ++i) net->w[i] = widths[i];
  for (int i = 0; i < n; ++i) {
    const int wmax = i == n - 1 ? TMAX : WIDE_MAX;
    if (widths[i] < 1 || widths[i] > WIDE_MAX || widths[i + 1] < 1 || widths[i + 1] > wmax)
      return ERR_SHAPE;
    net->woff[i] = off;
    off += widths[i] * widths[i + 1];
    net->boff[i] = off;
    off += widths[i + 1];
    net->aoff[i] = acols;
    acols += i == n - 1 ? mma_ld(widths[i]) : widths[i] + 1;
  }
  net->acols = acols;
  net->total = off;
  return 0;
}

// mma_ld(WMAX) and WLD up to WMAX-wide stacks
Wide wide_strides(const Net& net) {
  int maxw = WMAX, maxg = WMAX;
  for (int i = 0; i < net.n; ++i) {
    maxw = net.w[i] > maxw ? net.w[i] : maxw;
    if (i > 0) maxg = net.w[i] > maxg ? net.w[i] : maxg;
  }
  return Wide{mma_ld(maxw), maxg + 1};
}

constexpr int GMAX = KMAX + GSLACK;  // candidates a row at most
static_assert(refine_floats(1, GMAX) <= mma_ld(WMAX),
              "the refinement's lists fit a spare activation tile");

// Floats of the forward's staged buffer at R rows: the hidden products'
// chunk, then the head's chunks (the logits', then the recompute's), with
// the candidates' per-thread lists between them.
__host__ __device__ constexpr int fwd_stage(int R) {
  return BK * BS > head_stage_floats(R / 16) ? BK * BS : head_stage_floats(R / 16);
}

// chains a thread of the candidates' recompute at R rows, kc candidates
__host__ __device__ constexpr int chains(int R, int kc) { return (R * kc + THREADS - 1) / THREADS; }

// two activation tiles (stride Wide::lda), the staged buffer, the logits
// tile (stride mma_ld(T)), the column sums and the head's row maxima
size_t fwd_smem(const Net& net, int R) {
  const int T = net.w[net.n];
  return sizeof(float) * (2 * (size_t)R * wide_strides(net).lda + fwd_stage(R) +
                          (size_t)R * mma_ld(T) + T + net.w[net.n - 1] + 1);
}

// acts (the head's input at stride mma_ld(H)), gA, the staged chunk (the
// hidden products' or the head's), the cache (stride mma_ld(T)), which the
// hidden layers' backward reuses as gB once dh has read it, and g_marg.
size_t bwd_smem(const Net& net, int R) {
  const int T = net.w[net.n];
  const int stage = BK * BS > head_stage_floats(R / 16) ? BK * BS : head_stage_floats(R / 16);
  const int gld = wide_strides(net).gld;
  const int ldc = mma_ld(T) > gld ? mma_ld(T) : gld;
  return sizeof(float) * ((size_t)R * net.acols + (size_t)R * gld + stage + (size_t)R * ldc + T);
}

// rows per thread of the widest tile whose forward AND backward fit, 0 if none
int pick_rpt(const Net& net) {
  for (int rpt = 4; rpt >= 1; rpt >>= 1)
    if (fwd_smem(net, 16 * rpt) <= (size_t)SMEM_MAX && bwd_smem(net, 16 * rpt) <= (size_t)SMEM_MAX)
      return rpt;
  return 0;
}

int check(int n, const int* widths, int L, int N, int K, Net* net) {
  int err = make_net(n, widths, net);
  if (err) return err;
  const int T = net->w[n];
  if (L < 1 || N < 1 || K < 1 || K > KMAX || K > T || !pick_rpt(*net)) return ERR_SHAPE;
  return 0;
}

// out = relu(A @ W + b) for an (R x kdim) tile, n <= 128 output columns
template <int RPT>
__device__ __forceinline__ void hidden_layer(const float* __restrict__ A, int lda, int kdim,
                                             const float* __restrict__ W,
                                             const float* __restrict__ bias, int n,
                                             float* __restrict__ b_s, float* __restrict__ out,
                                             int ldo) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RPT][8];
  tile_mm<RPT, false>(A, lda, kdim, W, n, 0, b_s, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tx + 16 * j;
    if (c >= n) continue;
    const float bc = bias[c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) out[(ty * RPT + i) * ldo + c] = fmaxf(acc[i][j] + bc, 0.f);
  }
}

// out = (G @ W^T) * (act > 0): W is n x kdim, act the layer's input (R x n)
template <int RPT>
__device__ __forceinline__ void back_layer(const float* __restrict__ G, int ldg, int kdim,
                                           const float* __restrict__ W, int n,
                                           const float* __restrict__ act, int lda,
                                           float* __restrict__ b_s, float* __restrict__ out) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RPT][8];
  tile_mm<RPT, true>(G, ldg, kdim, W, n, 0, b_s, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tx + 16 * j;
    if (c >= n) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      out[r * WLD + c] = acc[i][j] * (act[r * lda + c] > 0.f ? 1.f : 0.f);
    }
  }
}

// hidden_layer for any n: TT output columns a pass
template <int RPT>
__device__ __forceinline__ void hidden_layer_wide(const float* __restrict__ A, int lda, int kdim,
                                                  const float* __restrict__ W,
                                                  const float* __restrict__ bias, int n,
                                                  float* __restrict__ b_s, float* __restrict__ out,
                                                  int ldo) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c0 = 0; c0 < n; c0 += TT) {
    float acc[RPT][8];
    tile_mm<RPT, false>(A, lda, kdim, W, n, c0, b_s, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= n) continue;
      const float bc = bias[c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) out[(ty * RPT + i) * ldo + c] = fmaxf(acc[i][j] + bc, 0.f);
    }
  }
}

// back_layer for any n, out at stride ldo: TT columns a pass
template <int RPT>
__device__ __forceinline__ void back_layer_wide(const float* __restrict__ G, int ldg, int kdim,
                                                const float* __restrict__ W, int n,
                                                const float* __restrict__ act, int lda,
                                                float* __restrict__ b_s, float* __restrict__ out,
                                                int ldo) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c0 = 0; c0 < n; c0 += TT) {
    float acc[RPT][8];
    tile_mm<RPT, true>(G, ldg, kdim, W, n, c0, b_s, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= n) continue;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
        out[r * ldo + c] = acc[i][j] * (act[r * lda + c] > 0.f ? 1.f : 0.f);
      }
    }
  }
}

// WIDE: a width of the stack past WMAX (its tiles' strides at run time)
template <int RPT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
full_fwd_kernel(const float* __restrict__ verts, const float* __restrict__ params, Net net,
                const float* __restrict__ w_pad, int K, Rows g, float* __restrict__ vals,
                int* __restrict__ idx, float* __restrict__ marg_part, int* __restrict__ n_fix,
                Wide wide) {
  constexpr int R = 16 * RPT;
  extern __shared__ __align__(16) float smem[];
  const int n = net.n, d = net.w[0], T = net.w[n], H = net.w[n - 1];
  const int ldc = mma_ld(T), ldw = head_ld(T);
  const int kc = min(K + GSLACK, T);
  const int LDA = WIDE ? wide.lda : mma_ld(WMAX);
  float* buf0 = smem;
  float* buf1 = buf0 + R * LDA;
  float* stage = buf1 + R * LDA;
  float* cache = stage + fwd_stage(R);
  float* colsum = cache + R * ldc;
  float* amax = colsum + T;
  // the refinement's lists, in the activation tile the stack does not end
  // in (the stack's n - 1 layers swap the two tiles)
  float* lv = n % 2 ? buf1 : buf0;
  int* li = reinterpret_cast<int*>(lv + R * kc);
  float* ex = lv + 2 * R * kc;
  float* m_s = ex + R * kc;
  float* s_s = m_s + R;
  float* sr = s_s + R;
  int* fix = reinterpret_cast<int*>(sr + R);
  const float* w_head = params + net.woff[n - 1];
  const float* b_head = params + net.boff[n - 1];
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < T; c += THREADS) colsum[c] = 0.f;
  head_absmax(w_head, b_head, H, T, amax);
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  const int pad = (H + 7) / 8 * 8 - H;  // head_logits reads the head input to a multiple of 8
  PHASE_START(K10_PHASES);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    __syncthreads();
    load_rows<R>(verts, base, rows, d, buf0, LDA);
    float* in = buf0;
    float* out = buf1;
    for (int i = 0; i < n - 1; ++i) {
      if (WIDE)
        hidden_layer_wide<RPT>(in, LDA, net.w[i], params + net.woff[i], params + net.boff[i],
                               net.w[i + 1], stage, out, LDA);
      else
        hidden_layer<RPT>(in, LDA, net.w[i], params + net.woff[i], params + net.boff[i],
                          net.w[i + 1], stage, out, LDA);
      float* tmp = in;
      in = out;
      out = tmp;
    }
    for (int e = threadIdx.x; e < R * pad; e += THREADS) in[e / pad * LDA + H + e % pad] = 0.f;
    PHASE_SYNC_MARK(0);
    // the logits on the tensor cores (begins and ends with a barrier)
    head_logits<RPT>(in, LDA, H, w_pad, ldw, b_head, T, stage, cache, ldc);
    PHASE_MARK(1);
    // each row's candidates, before softmax overwrites the row (the threads'
    // lists in the staged buffer, free after head_logits): at K <= 4 (the
    // per-row route's) several threads a row, past it one thread a row
    if (kc <= 8)
      top_candidates<R, 8, GMAX>(cache, ldc, T, rows, kc, stage, lv, li);
    else
      top_candidates<R, 0, GMAX>(cache, ldc, T, rows, kc, stage, lv, li);
    PHASE_MARK(4);
    // p from the tensor-core logits, two rows a warp at a time (R / WARPS
    // is even)
    for (int r = warp; r < R; r += 2 * WARPS) {
      float ma, sa, mb, sb;
      softmax_pair(cache + r * ldc, cache + (r + WARPS) * ldc, T, ma, sa, mb, sb);
      if (lane == 0) {
        m_s[r] = ma;
        s_s[r] = sa;
        m_s[r + WARPS] = mb;
        s_s[r + WARPS] = sb;
      }
    }
    __syncthreads();
    PHASE_MARK(2);
    column_sums(cache, ldc, rows, T, colsum);
    PHASE_SYNC_MARK(3);
    // the candidates' fp32 logits
    guard_sums(in, LDA, H, amax, rows, sr);
    if (kc <= 8)
      recompute_streamed<RPT, chains(R, 8)>(in, LDA, H, w_pad, ldw, b_head, rows, kc, T, li,
                                            stage, ex);
    else
      recompute_streamed<RPT, chains(R, GMAX)>(in, LDA, H, w_pad, ldw, b_head, rows, kc, T, li,
                                               stage, ex);
    PHASE_MARK(5);
    if (threadIdx.x < rows) {
      const int r = threadIdx.x;
      const size_t o = (base + r) * K;
      fix[r] = !settle_row(lv + r * kc, li + r * kc, ex + r * kc, kc, K, T, m_s[r], s_s[r],
                           guard_coef(H) * sr[r], vals + o, idx + o);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += WARPS) {
      if (!fix[r]) continue;
      const size_t o = (base + r) * K;
      exact_row(in + r * LDA, H, w_pad, ldw, b_head, T, K, cache + r * ldc, vals + o, idx + o);
      if (lane == 0) atomicAdd(n_fix, 1);
    }
    PHASE_SYNC_MARK(6);
  }
  PHASE_END(k10_phase, K10_PHASES);
  __syncthreads();
  for (int c = threadIdx.x; c < T; c += THREADS)
    marg_part[((size_t)l * g.spl + seg) * T + c] = colsum[c];
}

template <int RPT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
full_bwd_kernel(const float* __restrict__ verts, const float* __restrict__ params, Net net,
                const float* __restrict__ w_pad, int K, const int* __restrict__ idx,
                const float* __restrict__ g_marg, const float* __restrict__ g_vals, Rows g,
                float* __restrict__ part, Wide wide) {
  constexpr int R = 16 * RPT;
  constexpr int STAGE = BK * BS > head_stage_floats(RPT) ? BK * BS : head_stage_floats(RPT);
  extern __shared__ float smem[];
  const int n = net.n, d = net.w[0], T = net.w[n], H = net.w[n - 1];
  const int ldh = mma_ld(H), ldc = mma_ld(T), ldw = head_ld(T);
  const int gld = WIDE ? wide.gld : WLD;
  float* acts = smem;
  float* gA = acts + R * net.acols;
  float* b_s = gA + R * gld;
  float* cache = b_s + STAGE;
  float* gB = cache;
  float* gm_s = cache + R * (ldc > gld ? ldc : gld);
  float* a_head = acts + R * net.aoff[n - 1];
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  float* pp = part + ((size_t)l * g.spl + seg) * net.total;
  for (int c = threadIdx.x; c < T; c += THREADS) gm_s[c] = g_marg[(size_t)l * T + c] / (float)g.N;
  for (int e = threadIdx.x; e < R * (ldh - H); e += THREADS)
    a_head[e / (ldh - H) * ldh + H + e % (ldh - H)] = 0.f;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  PHASE_START(K11_PHASES);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    __syncthreads();
    load_rows<R>(verts, base, rows, d, acts, n == 1 ? ldh : d + 1);
    // replay the stack, keeping every layer's input
    for (int i = 0; i < n - 1; ++i) {
      if (WIDE)
        hidden_layer_wide<RPT>(acts + R * net.aoff[i], net.w[i] + 1, net.w[i],
                               params + net.woff[i], params + net.boff[i], net.w[i + 1], b_s,
                               acts + R * net.aoff[i + 1], i + 1 == n - 1 ? ldh : net.w[i + 1] + 1);
      else
        hidden_layer<RPT>(acts + R * net.aoff[i], net.w[i] + 1, net.w[i], params + net.woff[i],
                          params + net.boff[i], net.w[i + 1], b_s, acts + R * net.aoff[i + 1],
                          i + 1 == n - 1 ? ldh : net.w[i + 1] + 1);
    }
    PHASE_SYNC_MARK(0);
    head_logits<RPT>(a_head, ldh, H, w_pad, ldw, params + net.boff[n - 1], T, b_s, cache, ldc);
    PHASE_MARK(1);
    __syncthreads();
    for (int r = warp; r < R; r += WARPS) {
      float* row = cache + r * ldc;
      softmax_row(row, T);
      const size_t gr = (base + (r < rows ? r : 0)) * K;
      dlogits_row(row, T, K, gm_s, idx + gr, g_vals + gr, r < rows);
    }
    __syncthreads();
    PHASE_MARK(2);
    head_dw<RPT>(a_head, ldh, H, cache, ldc, T, pp + net.woff[n - 1], pp + net.boff[n - 1]);
    if (n > 1) {
      float* gc = gA;
      float* gn = gB;
      PHASE_SYNC_MARK(3);
      if (WIDE)
        head_dh_wide<RPT>(cache, ldc, T, w_pad, ldw, H, a_head, ldh, b_s, gc, gld);
      else
        head_dh<RPT>(cache, ldc, T, w_pad, ldw, H, a_head, ldh, b_s, gc, WLD);
      PHASE_MARK(4);
      for (int i = n - 2; i >= 0; --i) {
        const float* a_i = acts + R * net.aoff[i];
        __syncthreads();
        if (WIDE)
          outer_acc_wide<R>(a_i, net.w[i] + 1, net.w[i], gc, gld, net.w[i + 1], pp + net.woff[i],
                            pp + net.boff[i]);
        else
          outer_acc<R>(a_i, net.w[i] + 1, net.w[i], gc, WLD, net.w[i + 1], pp + net.woff[i],
                       pp + net.boff[i]);
        if (i > 0) {
          if (WIDE)
            back_layer_wide<RPT>(gc, gld, net.w[i + 1], params + net.woff[i], net.w[i], a_i,
                                 net.w[i] + 1, b_s, gn, gld);
          else
            back_layer<RPT>(gc, WLD, net.w[i + 1], params + net.woff[i], net.w[i], a_i,
                            net.w[i] + 1, b_s, gn);
          float* tmp = gc;
          gc = gn;
          gn = tmp;
        }
      }
      PHASE_SYNC_MARK(5);
    }
  }
  PHASE_END(k11_phase, K11_PHASES);
}

template <int RPT, bool WIDE>
int launch_fwd(const float* verts, const float* params, const float* w_pad, const Net& net,
               int L, int N, int K, float* marg, float* marg_part, float* vals, int* idx,
               int* n_fix, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const int T = net.w[net.n];
  int err = (int)cudaMemsetAsync(n_fix, 0, sizeof(int), st);
  if (err) return err;
  const size_t smem = fwd_smem(net, 16 * RPT);
  set_smem(full_fwd_kernel<RPT, WIDE>, smem);
  full_fwd_kernel<RPT, WIDE><<<dim3(g.spl, L), THREADS, smem, st>>>(
      verts, params, net, w_pad, K, g, vals, idx, marg_part, n_fix, wide_strides(net));
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_levels_kernel<<<(L * T + 255) / 256, 256, 0, st>>>(marg_part, marg, L, g.spl, T, N);
  return (int)cudaGetLastError();
}

template <int RPT, bool WIDE>
int launch_bwd(const float* verts, const float* params, const float* w_pad, const Net& net,
               int L, int N, int K, const int* idx, const float* g_marg, const float* g_vals,
               float* part, float* dparams, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const int nblocks = g.spl * L;
  int err = (int)cudaMemsetAsync(part, 0, sizeof(float) * (size_t)nblocks * net.total, st);
  if (err) return err;
  const size_t smem = bwd_smem(net, 16 * RPT);
  set_smem(full_bwd_kernel<RPT, WIDE>, smem);
  full_bwd_kernel<RPT, WIDE><<<dim3(g.spl, L), THREADS, smem, st>>>(
      verts, params, net, w_pad, K, idx, g_marg, g_vals, g, part, wide_strides(net));
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_blocks_kernel<<<(net.total + 255) / 256, 256, 0, st>>>(part, dparams, nblocks,
                                                                net.total);
  return (int)cudaGetLastError();
}

// a width of the stack past WMAX: the WIDE instances
bool wide(const Net& net) { return wide_strides(net).lda > mma_ld(WMAX); }

// launch_fwd / launch_bwd at the tile size the shared memory allows
template <bool WIDE>
int fwd_rpt(const float* verts, const float* params, const float* w_pad, const Net& net, int L,
            int N, int K, float* marg, float* marg_part, float* vals, int* idx, int* n_fix,
            cudaStream_t st) {
  switch (pick_rpt(net)) {
    case 4:
      return launch_fwd<4, WIDE>(verts, params, w_pad, net, L, N, K, marg, marg_part, vals, idx,
                                 n_fix, st);
    case 2:
      return launch_fwd<2, WIDE>(verts, params, w_pad, net, L, N, K, marg, marg_part, vals, idx,
                                 n_fix, st);
    default:
      return launch_fwd<1, WIDE>(verts, params, w_pad, net, L, N, K, marg, marg_part, vals, idx,
                                 n_fix, st);
  }
}

template <bool WIDE>
int bwd_rpt(const float* verts, const float* params, const float* w_pad, const Net& net, int L,
            int N, int K, const int* idx, const float* g_marg, const float* g_vals, float* part,
            float* dparams, cudaStream_t st) {
  switch (pick_rpt(net)) {
    case 4:
      return launch_bwd<4, WIDE>(verts, params, w_pad, net, L, N, K, idx, g_marg, g_vals, part,
                                 dparams, st);
    case 2:
      return launch_bwd<2, WIDE>(verts, params, w_pad, net, L, N, K, idx, g_marg, g_vals, part,
                                 dparams, st);
    default:
      return launch_bwd<1, WIDE>(verts, params, w_pad, net, L, N, K, idx, g_marg, g_vals, part,
                                 dparams, st);
  }
}

}  // namespace

extern "C" {

const char* hpd_full_error_string(int code) { return port_error_string(code); }

#ifdef HPD_FULL_PHASES
// K11's (hpd_full_phases) and K10's (hpd_full_fwd_phases) clock64() ticks
// by phase, summed over the blocks of the launches since the last reset,
// into out[K11_PHASES] / out[K10_PHASES]; then zeroes them if reset.
int hpd_full_phases(unsigned long long* out, int reset) { return read_phases(k11_phase, out, reset); }

int hpd_full_fwd_phases(unsigned long long* out, int reset) {
  return read_phases(k10_phase, out, reset);
}
#endif

// Blocks of the launch (rows of the partial buffers), 0 if the kernels do
// not take these shapes. widths: n_layers + 1 ints, d first, T last.
int hpd_full_blocks(int n_layers, const int* widths, int L, int N, int K) {
  Net net;
  if (check(n_layers, widths, L, N, K, &net)) return 0;
  return make_rows(L, N, 16 * pick_rpt(net)).spl * L;
}

// verts (L, N, d), params packed [W0 (w0 x w1), b0, W1, b1, ...] ->
// marg (L, T), vals (L, N, K), idx (L, N, K). w_pad: the head padded as for
// hpd_full_bwd. marg_part: (blocks, T) scratch. n_fix (1): the rows the
// guard left to the exact fp32 redo.
int hpd_full_fwd(const float* verts, const float* params, const float* w_pad, int n_layers,
                 const int* widths, int L, int N, int K, float* marg, float* marg_part,
                 float* vals, int* idx, int* n_fix, void* stream) {
  Net net;
  const int err = check(n_layers, widths, L, N, K, &net);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return wide(net) ? fwd_rpt<true>(verts, params, w_pad, net, L, N, K, marg, marg_part, vals, idx,
                                   n_fix, st)
                   : fwd_rpt<false>(verts, params, w_pad, net, L, N, K, marg, marg_part, vals,
                                    idx, n_fix, st);
}

// + idx (L, N, K), g_marg (L, T), g_vals (L, N, K) -> dparams (packed like
// params). w_pad: the head padded with zeros to (hpd_tail_head_rows(H),
// hpd_tail_head_ld(T)),
// 16-byte aligned. part: (blocks, packed count) scratch.
int hpd_full_bwd(const float* verts, const float* params, const float* w_pad, int n_layers,
                 const int* widths, int L, int N, int K, const int* idx, const float* g_marg,
                 const float* g_vals, float* part, float* dparams, void* stream) {
  Net net;
  const int err = check(n_layers, widths, L, N, K, &net);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return wide(net) ? bwd_rpt<true>(verts, params, w_pad, net, L, N, K, idx, g_marg, g_vals, part,
                                   dparams, st)
                   : bwd_rpt<false>(verts, params, w_pad, net, L, N, K, idx, g_marg, g_vals, part,
                                    dparams, st);
}

}  // extern "C"
