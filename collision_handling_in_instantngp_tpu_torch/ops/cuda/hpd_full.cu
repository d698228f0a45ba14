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
// Bound on this card: operations. At the per-row route's shapes (L = 4,
// N = 229,616, [2 -> 32 -> 64 -> 128 -> 256]) the forward is 79 GFLOP and
// the backward about 3x that, against 7 MB of vertices and 29 MB of top-K
// outputs. Only those touch device memory: a row tile's activations and
// its (R, T) logits stay in shared memory, and the weights stream from L2
// in 32-deep chunks (the head is 128 KB at T = 256 and 1 MB at T = 2048:
// it cannot stay resident). dW/db of every layer accumulate in one partial
// per block (read-modify-write by the owning thread), summed in block
// order by a second kernel. No atomics.
#include "per_row.cuh"

using namespace per_row;

namespace {

constexpr int MAXL = 16;  // layers, head included
constexpr int KMAX = 32;

struct Net {
  int n;               // layers; the last is the head
  int w[MAXL + 1];     // widths: w[0] = d, w[n] = T
  int woff[MAXL];      // offset of W_i (w[i] x w[i+1], row-major) in params
  int boff[MAXL];      // offset of b_i (w[i+1])
  int aoff[MAXL];      // offset, in floats per tile row, of act_i in the backward
  int acols;           // sum over i < n of (w[i] + 1)
  int total;           // packed parameter count
};

int make_net(int n, const int* widths, Net* net) {
  if (n < 1 || n > MAXL) return ERR_SHAPE;
  net->n = n;
  int off = 0, acols = 0;
  for (int i = 0; i <= n; ++i) net->w[i] = widths[i];
  for (int i = 0; i < n; ++i) {
    const int wmax = i == n - 1 ? TMAX : WMAX;
    if (widths[i] < 1 || widths[i] > WMAX || widths[i + 1] < 1 || widths[i + 1] > wmax)
      return ERR_SHAPE;
    net->woff[i] = off;
    off += widths[i] * widths[i + 1];
    net->boff[i] = off;
    off += widths[i + 1];
    net->aoff[i] = acols;
    acols += widths[i] + 1;
  }
  net->acols = acols;
  net->total = off;
  return 0;
}

size_t fwd_smem(const Net& net, int R) {
  const int T = net.w[net.n];
  return sizeof(float) * (2 * (size_t)R * WLD + BK * BS + (size_t)R * (T + 1) + T);
}

size_t bwd_smem(const Net& net, int R) {
  const int T = net.w[net.n];
  return sizeof(float) *
         ((size_t)R * net.acols + 2 * (size_t)R * WLD + BK * BS + (size_t)R * (T + 1) + T);
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

template <int RPT>
__global__ void __launch_bounds__(THREADS)
full_fwd_kernel(const float* __restrict__ verts, const float* __restrict__ params, Net net,
                int K, Rows g, float* __restrict__ vals, int* __restrict__ idx,
                float* __restrict__ marg_part) {
  constexpr int R = 16 * RPT;
  extern __shared__ float smem[];
  const int n = net.n, d = net.w[0], T = net.w[n];
  float* buf0 = smem;
  float* buf1 = buf0 + R * WLD;
  float* b_s = buf1 + R * WLD;
  float* cache = b_s + BK * BS;
  float* colsum = cache + R * (T + 1);
  const int ldc = T + 1;
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < T; c += THREADS) colsum[c] = 0.f;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    __syncthreads();
    load_rows<R>(verts, base, rows, d, buf0, WLD);
    float* in = buf0;
    float* out = buf1;
    for (int i = 0; i < n - 1; ++i) {
      hidden_layer<RPT>(in, WLD, net.w[i], params + net.woff[i], params + net.boff[i],
                        net.w[i + 1], b_s, out, WLD);
      float* tmp = in;
      in = out;
      out = tmp;
    }
    tile_logits<RPT>(in, WLD, net.w[n - 1], params + net.woff[n - 1], params + net.boff[n - 1], T,
                     b_s, cache);
    __syncthreads();
    for (int r = warp; r < R; r += WARPS) softmax_row(cache + r * ldc, T);
    __syncthreads();
    column_sums(cache, ldc, rows, T, colsum);
    __syncthreads();
    for (int r = warp; r < rows; r += WARPS)
      topk_row(cache + r * ldc, T, K, vals + (base + r) * K, idx + (base + r) * K);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < T; c += THREADS)
    marg_part[((size_t)l * g.spl + seg) * T + c] = colsum[c];
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
full_bwd_kernel(const float* __restrict__ verts, const float* __restrict__ params, Net net,
                int K, const int* __restrict__ idx, const float* __restrict__ g_marg,
                const float* __restrict__ g_vals, Rows g, float* __restrict__ part) {
  constexpr int R = 16 * RPT;
  extern __shared__ float smem[];
  const int n = net.n, d = net.w[0], T = net.w[n];
  float* acts = smem;
  float* gA = acts + R * net.acols;
  float* gB = gA + R * WLD;
  float* b_s = gB + R * WLD;
  float* cache = b_s + BK * BS;
  float* gm_s = cache + R * (T + 1);
  const int ldc = T + 1;
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  float* pp = part + ((size_t)l * g.spl + seg) * net.total;
  for (int c = threadIdx.x; c < T; c += THREADS) gm_s[c] = g_marg[(size_t)l * T + c] / (float)g.N;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    __syncthreads();
    load_rows<R>(verts, base, rows, d, acts, d + 1);
    // replay the stack, keeping every layer's input
    for (int i = 0; i < n - 1; ++i)
      hidden_layer<RPT>(acts + R * net.aoff[i], net.w[i] + 1, net.w[i], params + net.woff[i],
                        params + net.boff[i], net.w[i + 1], b_s, acts + R * net.aoff[i + 1],
                        net.w[i + 1] + 1);
    const float* a_head = acts + R * net.aoff[n - 1];
    const int ld_head = net.w[n - 1] + 1;
    tile_logits<RPT>(a_head, ld_head, net.w[n - 1], params + net.woff[n - 1],
                     params + net.boff[n - 1], T, b_s, cache);
    __syncthreads();
    for (int r = warp; r < R; r += WARPS) {
      float* row = cache + r * ldc;
      softmax_row(row, T);
      const size_t gr = (base + (r < rows ? r : 0)) * K;
      dlogits_row(row, T, K, gm_s, idx + gr, g_vals + gr, r < rows);
    }
    __syncthreads();
    outer_acc<R>(a_head, ld_head, net.w[n - 1], cache, ldc, T, pp + net.woff[n - 1],
                 pp + net.boff[n - 1]);
    if (n > 1) {
      float* gc = gA;
      float* gn = gB;
      back_layer<RPT>(cache, ldc, T, params + net.woff[n - 1], net.w[n - 1], a_head, ld_head, b_s,
                      gc);
      for (int i = n - 2; i >= 0; --i) {
        const float* a_i = acts + R * net.aoff[i];
        __syncthreads();
        outer_acc<R>(a_i, net.w[i] + 1, net.w[i], gc, WLD, net.w[i + 1], pp + net.woff[i],
                     pp + net.boff[i]);
        if (i > 0) {
          back_layer<RPT>(gc, WLD, net.w[i + 1], params + net.woff[i], net.w[i], a_i,
                          net.w[i] + 1, b_s, gn);
          float* tmp = gc;
          gc = gn;
          gn = tmp;
        }
      }
    }
  }
}

template <int RPT>
int launch_fwd(const float* verts, const float* params, const Net& net, int L, int N, int K,
               float* marg, float* marg_part, float* vals, int* idx, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const int T = net.w[net.n];
  const size_t smem = fwd_smem(net, 16 * RPT);
  set_smem(full_fwd_kernel<RPT>, smem);
  full_fwd_kernel<RPT><<<dim3(g.spl, L), THREADS, smem, st>>>(verts, params, net, K, g, vals,
                                                              idx, marg_part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_levels_kernel<<<(L * T + 255) / 256, 256, 0, st>>>(marg_part, marg, L, g.spl, T, N);
  return (int)cudaGetLastError();
}

template <int RPT>
int launch_bwd(const float* verts, const float* params, const Net& net, int L, int N, int K,
               const int* idx, const float* g_marg, const float* g_vals, float* part,
               float* dparams, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const int nblocks = g.spl * L;
  int err = (int)cudaMemsetAsync(part, 0, sizeof(float) * (size_t)nblocks * net.total, st);
  if (err) return err;
  const size_t smem = bwd_smem(net, 16 * RPT);
  set_smem(full_bwd_kernel<RPT>, smem);
  full_bwd_kernel<RPT><<<dim3(g.spl, L), THREADS, smem, st>>>(verts, params, net, K, idx,
                                                              g_marg, g_vals, g, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_blocks_kernel<<<(net.total + 255) / 256, 256, 0, st>>>(part, dparams, nblocks,
                                                                net.total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hpd_full_error_string(int code) { return port_error_string(code); }

// Blocks of the launch (rows of the partial buffers), 0 if the kernels do
// not take these shapes. widths: n_layers + 1 ints, d first, T last.
int hpd_full_blocks(int n_layers, const int* widths, int L, int N, int K) {
  Net net;
  if (check(n_layers, widths, L, N, K, &net)) return 0;
  return make_rows(L, N, 16 * pick_rpt(net)).spl * L;
}

// verts (L, N, d), params packed [W0 (w0 x w1), b0, W1, b1, ...] ->
// marg (L, T), vals (L, N, K), idx (L, N, K). marg_part: (blocks, T).
int hpd_full_fwd(const float* verts, const float* params, int n_layers, const int* widths,
                 int L, int N, int K, float* marg, float* marg_part, float* vals, int* idx,
                 void* stream) {
  Net net;
  const int err = check(n_layers, widths, L, N, K, &net);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_rpt(net)) {
    case 4: return launch_fwd<4>(verts, params, net, L, N, K, marg, marg_part, vals, idx, st);
    case 2: return launch_fwd<2>(verts, params, net, L, N, K, marg, marg_part, vals, idx, st);
    default: return launch_fwd<1>(verts, params, net, L, N, K, marg, marg_part, vals, idx, st);
  }
}

// + idx (L, N, K), g_marg (L, T), g_vals (L, N, K) -> dparams (packed like
// params). part: (blocks, packed count) scratch.
int hpd_full_bwd(const float* verts, const float* params, int n_layers, const int* widths,
                 int L, int N, int K, const int* idx, const float* g_marg, const float* g_vals,
                 float* part, float* dparams, void* stream) {
  Net net;
  const int err = check(n_layers, widths, L, N, K, &net);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_rpt(net)) {
    case 4:
      return launch_bwd<4>(verts, params, net, L, N, K, idx, g_marg, g_vals, part, dparams, st);
    case 2:
      return launch_bwd<2>(verts, params, net, L, N, K, idx, g_marg, g_vals, part, dparams, st);
    default:
      return launch_bwd<1>(verts, params, net, L, N, K, idx, g_marg, g_vals, part, dparams, st);
  }
}

}  // extern "C"
