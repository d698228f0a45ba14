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
// T = 2048: it cannot stay resident). The hidden stack runs as fp32 FMA on
// the CUDA cores (per_row.cuh: hidden_stack, register blocks of up to 8 x 4
// outputs a thread from float4 operands, the weights in a cp.async ring
// across layers): the forward's, and the backward's replay of it, one
// routine, which so takes the forward's ReLU masks bit for bit. Every
// other product runs as 3xTF32 on the tensor cores (per_row_mma.cuh),
// whatever the model's precision: the forward's
// logits (60 of its 79 GFLOP), and the backward's logits replay, dW_head,
// dh and the hidden layers' dh and dW (hid_bwd, head_dw; 218 of its 237).
// So the bounds are those products at the TF32 peak plus the stack at the
// fp32 peak.
// The forward's top-K stays the exact top-K of p from the fp32 logits (the
// CUDA-core forward's): per tile, the candidates by tensor-core logit, p
// and the column sums from the tensor-core logits, the candidates' fp32
// recompute (the head streamed once more), their ranking on p and the
// guard, and the fp32 redo of the rows it leaves (per_row_mma.cuh: the
// derivation and what can still differ). The rows redone are counted in
// n_fix.
// dW/db of every layer accumulate in one partial per block (read-modify-
// write by the owning thread once a row tile; for dW_head about 3.7 GB of
// L2 traffic a launch at those shapes), summed in block order by a second
// kernel. No atomics but the redo count. The backward's softmax and dl run
// two rows a warp in three passes over a row (per_row_mma.cuh:
// softmax_dl_pair; its p only feeds sums).
#include "per_row.cuh"
#include "per_row_mma.cuh"

using namespace per_row;

namespace {

// Built with -DHPD_FULL_PHASES (tools/k11_phases.py), thread 0 of K11 and
// of K10 sums the clock64() ticks of each phase of its tiles into
// k11_phase / k10_phase (the phases end at a barrier, so its ticks are the
// block's); otherwise the marks (common.cuh) compile to nothing.
#ifdef HPD_FULL_PHASES
// replay, logits, softmax + dl, dW_head, dh, the hidden layers' dW, their dh
constexpr int K11_PHASES = 7;
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
  // the backward's tile (bwd_layout): act_i's row stride and its offset, in
  // floats per tile row; their sum; the gradient tiles' row stride
  int ald[MAXL];
  int aoff[MAXL];
  int acols;
  int gld;
  int total;           // packed parameter count
};

// The forward's activation stride for a stack past WMAX (the WIDE
// instance's last argument).
struct Wide {
  int lda;
};

// The backward's tile strides. Compact (the first tile, which decides the
// route): act_i at w[i] + 1, the head's input at mma_ld(H), the gradient
// tiles at max(WMAX, widest hidden) + 1. Padded: the hidden activations
// after the vertices and the gradient tiles at hid_ld (their fragment loads
// on 32 banks); the vertices, which only layer 0's products read, stay at
// d + 1.
void bwd_layout(Net* net, bool padded) {
  const int n = net->n;
  int acols = 0, maxg = 1;
  for (int i = 0; i < n; ++i) {
    const int w = net->w[i];
    net->ald[i] = i == n - 1 ? mma_ld(w) : padded && i > 0 ? hid_ld(w) : w + 1;
    net->aoff[i] = acols;
    acols += net->ald[i];
    if (i > 0) maxg = w > maxg ? w : maxg;
  }
  net->acols = acols;
  net->gld = padded ? hid_ld(maxg) : (maxg > WMAX ? maxg : WMAX) + 1;
}

int make_net(int n, const int* widths, Net* net) {
  if (n < 1 || n > MAXL) return ERR_SHAPE;
  net->n = n;
  int off = 0;
  for (int i = 0; i <= n; ++i) net->w[i] = widths[i];
  for (int i = 0; i < n; ++i) {
    const int wmax = i == n - 1 ? TMAX : WIDE_MAX;
    if (widths[i] < 1 || widths[i] > WIDE_MAX || widths[i + 1] < 1 || widths[i + 1] > wmax)
      return ERR_SHAPE;
    net->woff[i] = off;
    off += widths[i] * widths[i + 1];
    net->boff[i] = off;
    off += widths[i + 1];
  }
  net->total = off;
  bwd_layout(net, false);
  return 0;
}

// mma_ld(WMAX) up to WMAX-wide stacks
Wide wide_strides(const Net& net) {
  int maxw = WMAX;
  for (int i = 0; i < net.n; ++i) maxw = net.w[i] > maxw ? net.w[i] : maxw;
  return Wide{mma_ld(maxw)};
}

constexpr int GMAX = KMAX + GSLACK;  // candidates a row at most
static_assert(refine_floats(1, GMAX) <= mma_ld(WMAX),
              "the refinement's lists fit a spare activation tile");

// Floats of the staged buffer at R rows: the head's chunks (the logits',
// then in the forward the recompute's, with the candidates' per-thread
// lists between them), and the hidden stack's weights in its two halves.
__host__ __device__ constexpr int stage_floats(int R) { return head_stage_floats(R / 16); }

// chains a thread of the candidates' recompute at R rows, kc candidates
__host__ __device__ constexpr int chains(int R, int kc) { return (R * kc + THREADS - 1) / THREADS; }

// two activation tiles (stride Wide::lda), the staged buffer, the logits
// tile (stride mma_ld(T)), the column sums and the head's row maxima
size_t fwd_smem(const Net& net, int R) {
  const int T = net.w[net.n];
  return sizeof(float) * (2 * (size_t)R * wide_strides(net).lda + stage_floats(R) +
                          (size_t)R * mma_ld(T) + T + net.w[net.n - 1] + 1);
}

// acts (the head's input at stride mma_ld(H)), gA, the staged buffer, the
// cache (stride mma_ld(T)), which the hidden layers' backward reuses as gB
// once dh has read it, and g_marg; at the net's layout.
size_t bwd_smem(const Net& net, int R) {
  const int T = net.w[net.n];
  const int stage = stage_floats(R);
  const int ldc = mma_ld(T) > net.gld ? mma_ld(T) : net.gld;
  return sizeof(float) *
         ((size_t)R * net.acols + (size_t)R * net.gld + stage + (size_t)R * ldc + T);
}

// rows per thread of the widest tile whose forward AND compact backward
// fit, 0 if none (make_net's net: the compact layout)
int pick_rpt(const Net& net) {
  for (int rpt = 4; rpt >= 1; rpt >>= 1)
    if (fwd_smem(net, 16 * rpt) <= (size_t)SMEM_MAX && bwd_smem(net, 16 * rpt) <= (size_t)SMEM_MAX)
      return rpt;
  return 0;
}

// The backward's layout at R rows: padded where it fits, else compact.
Net bwd_net(Net net, int R) {
  bwd_layout(&net, true);
  if (bwd_smem(net, R) > (size_t)SMEM_MAX) bwd_layout(&net, false);
  return net;
}

int check(int n, const int* widths, int L, int N, int K, Net* net) {
  int err = make_net(n, widths, net);
  if (err) return err;
  const int T = net->w[n];
  if (L < 1 || N < 1 || K < 1 || K > KMAX || K > T || !pick_rpt(*net)) return ERR_SHAPE;
  return 0;
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
  float* cache = stage + stage_floats(R);
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
    // the stack alternates the two tiles, from the vertices in buf0
    hidden_stack<RPT, stage_floats(R)>(
        params, net, [&](int i) { return Act{i % 2 ? buf1 : buf0, LDA}; }, stage,
        [&] { load_rows<R>(verts, base, rows, d, buf0, LDA); });
    float* in = (n - 1) % 2 ? buf1 : buf0;
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

// WIDE: a width of the stack past WMAX (the head's dh in WMAX-column
// passes; the hidden layers' products take any width)
template <int RPT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
full_bwd_kernel(const float* __restrict__ verts, const float* __restrict__ params, Net net,
                const float* __restrict__ w_pad, int K, const int* __restrict__ idx,
                const float* __restrict__ g_marg, const float* __restrict__ g_vals, Rows g,
                float* __restrict__ part) {
  constexpr int R = 16 * RPT;
  constexpr int STAGE = stage_floats(R);
  extern __shared__ float smem[];
  const int n = net.n, d = net.w[0], T = net.w[n], H = net.w[n - 1];
  const int ldh = mma_ld(H), ldc = mma_ld(T), ldw = head_ld(T), gld = net.gld;
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
  // the head's input's padding stays zero: the replay writes [0, H)
  for (int e = threadIdx.x; e < R * (ldh - H); e += THREADS)
    a_head[e / (ldh - H) * ldh + H + e % (ldh - H)] = 0.f;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  PHASE_START(K11_PHASES);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    // replay the stack, keeping every layer's input: K10's routine, so the
    // ReLU masks are the forward's, bit for bit
    hidden_stack<RPT, STAGE>(
        params, net, [&](int i) { return Act{acts + R * net.aoff[i], net.ald[i]}; }, b_s,
        [&] { load_rows<R>(verts, base, rows, d, acts, net.ald[0]); });
    PHASE_SYNC_MARK(0);
    head_logits<RPT>(a_head, ldh, H, w_pad, ldw, params + net.boff[n - 1], T, b_s, cache, ldc);
    PHASE_MARK(1);
    // dl, two rows a warp at a time (R / WARPS is even)
    for (int r = warp; r < R; r += 2 * WARPS) {
      const int r2 = r + WARPS;
      const size_t ga = (base + (r < rows ? r : 0)) * K, gb = (base + (r2 < rows ? r2 : 0)) * K;
      softmax_dl_pair(cache + r * ldc, cache + r2 * ldc, T, K, gm_s, idx + ga, g_vals + ga,
                      r < rows, idx + gb, g_vals + gb, r2 < rows);
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
        head_dh<RPT>(cache, ldc, T, w_pad, ldw, H, a_head, ldh, b_s, gc, gld);
      PHASE_MARK(4);
      // down the stack: dW_i = act_i^T g and db_i, under the staging of
      // g <- (g W_i^T) * (act_i > 0) (g is complete: the product before
      // ended with a barrier)
      for (int i = n - 2; i >= 0; --i) {
        const float* a_i = acts + R * net.aoff[i];
        const auto dw = [&] {
          head_dw<RPT, true>(a_i, net.ald[i], net.w[i], gc, gld, net.w[i + 1],
                             pp + net.woff[i], pp + net.boff[i]);
          PHASE_MARK(5);
        };
        if (i > 0) {
          hid_bwd<RPT>(gc, gld, net.w[i + 1], params + net.woff[i], net.w[i], a_i, net.ald[i],
                       b_s, gn, gld, dw);
          float* tmp = gc;
          gc = gn;
          gn = tmp;
        } else {
          dw();
        }
        PHASE_SYNC_MARK(6);
      }
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
  const Net bnet = bwd_net(net, 16 * RPT);
  const size_t smem = bwd_smem(bnet, 16 * RPT);
  set_smem(full_bwd_kernel<RPT, WIDE>, smem);
  full_bwd_kernel<RPT, WIDE><<<dim3(g.spl, L), THREADS, smem, st>>>(
      verts, params, bnet, w_pad, K, idx, g_marg, g_vals, g, part);
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
