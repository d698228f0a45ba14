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
// T <= 512, 16 at T = 2048), so each product runs once per direction: the
// forward computes the logits, the softmax, the column sums and the
// top-K from that one tile; the backward recomputes the logits once, turns
// the tile into dl in place, then runs dh and dW/db from it. dW/db
// accumulate in one partial per block (read-modify-write by the owning
// thread), summed in block order by a second kernel. No atomics.
#include "per_row.cuh"

using namespace per_row;

namespace {

constexpr int HMAX = 128;
constexpr int KMAX = 128;

size_t tail_smem(int R, int T) {
  return sizeof(float) * ((size_t)R * WLD + BK * BS + (size_t)R * (T + 1) + T);
}

// rows per thread of the widest tile that fits, 0 if none
int pick_rpt(int T) {
  for (int rpt = 4; rpt >= 1; rpt >>= 1)
    if (tail_smem(16 * rpt, T) <= (size_t)SMEM_MAX) return rpt;
  return 0;
}

int check_shape(int L, int N, int H, int T, int K) {
  if (L < 1 || N < 1 || H < 1 || H > HMAX || T < 1 || T > TMAX || K < 1 || K > KMAX || K > T)
    return ERR_SHAPE;
  return pick_rpt(T) ? 0 : ERR_SHAPE;
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
tail_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, int H, int T, int K, Rows g,
                float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ marg_part) {
  constexpr int R = 16 * RPT;
  extern __shared__ float smem[];
  float* h_s = smem;
  float* b_s = h_s + R * WLD;
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
    load_rows<R>(h, base, rows, H, h_s, WLD);
    tile_logits<RPT>(h_s, WLD, H, w, b, T, b_s, cache);
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
tail_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, const int* __restrict__ idx,
                const float* __restrict__ g_marg, const float* __restrict__ g_vals, int H, int T,
                int K, Rows g, float* __restrict__ dh, float* __restrict__ part) {
  constexpr int R = 16 * RPT;
  extern __shared__ float smem[];
  float* h_s = smem;
  float* b_s = h_s + R * WLD;
  float* cache = b_s + BK * BS;
  float* gm_s = cache + R * (T + 1);
  const int ldc = T + 1;
  const int l = blockIdx.y, seg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* pw = part + ((size_t)l * g.spl + seg) * ((size_t)H * T + T);
  float* pb = pw + (size_t)H * T;
  for (int c = threadIdx.x; c < T; c += THREADS) gm_s[c] = g_marg[(size_t)l * T + c] / (float)g.N;
  const int tpl = (g.N + R - 1) / R;
  const int t_end = min(tpl, (seg + 1) * g.tps);
  for (int t = seg * g.tps; t < t_end; ++t) {
    const int r0 = t * R;
    const int rows = min(R, g.N - r0);
    const size_t base = (size_t)l * g.N + r0;
    __syncthreads();
    load_rows<R>(h, base, rows, H, h_s, WLD);
    tile_logits<RPT>(h_s, WLD, H, w, b, T, b_s, cache);
    __syncthreads();
    for (int r = warp; r < R; r += WARPS) {
      float* row = cache + r * ldc;
      softmax_row(row, T);
      const size_t gr = (base + (r < rows ? r : 0)) * K;
      dlogits_row(row, T, K, gm_s, idx + gr, g_vals + gr, r < rows);
    }
    // dh = dl w^T (begins with a barrier)
    float acc[RPT][8];
    tile_mm<RPT, true>(cache, ldc, T, w, H, 0, b_s, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = tx + 16 * j;
        if (k < H) dh[(base + r) * H + k] = acc[i][j];
      }
    }
    outer_acc<R>(h_s, WLD, H, cache, ldc, T, pw, pb);
  }
}

template <int RPT>
int launch_fwd(const float* h, const float* w, const float* b, int L, int N, int H, int T,
               int K, float* marg, float* marg_part, float* vals, int* idx, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const size_t smem = tail_smem(16 * RPT, T);
  set_smem(tail_fwd_kernel<RPT>, smem);
  tail_fwd_kernel<RPT><<<dim3(g.spl, L), THREADS, smem, st>>>(h, w, b, H, T, K, g, vals, idx,
                                                              marg_part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_levels_kernel<<<(L * T + 255) / 256, 256, 0, st>>>(marg_part, marg, L, g.spl, T, N);
  return (int)cudaGetLastError();
}

template <int RPT>
int launch_bwd(const float* h, const float* w, const float* b, const int* idx,
               const float* g_marg, const float* g_vals, int L, int N, int H, int T, int K,
               float* dh, float* part, float* dwb, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const int total = H * T + T;
  const int nblocks = g.spl * L;
  int err = (int)cudaMemsetAsync(part, 0, sizeof(float) * (size_t)nblocks * total, st);
  if (err) return err;
  const size_t smem = tail_smem(16 * RPT, T);
  set_smem(tail_bwd_kernel<RPT>, smem);
  tail_bwd_kernel<RPT><<<dim3(g.spl, L), THREADS, smem, st>>>(h, w, b, idx, g_marg, g_vals, H,
                                                              T, K, g, dh, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_blocks_kernel<<<(total + 255) / 256, 256, 0, st>>>(part, dwb, nblocks, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hpd_tail_error_string(int code) { return port_error_string(code); }

// Blocks of the launch for these shapes (the partial buffers have one row
// each), 0 if the kernels do not take them.
int hpd_tail_blocks(int L, int N, int H, int T, int K) {
  if (check_shape(L, N, H, T, K)) return 0;
  return make_rows(L, N, 16 * pick_rpt(T)).spl * L;
}

// h (L, N, H), w (H, T), b (T) -> marg (L, T), vals (L, N, K), idx (L, N, K).
// marg_part: (hpd_tail_blocks, T) scratch.
int hpd_tail_fwd(const float* h, const float* w, const float* b, int L, int N, int H, int T,
                 int K, float* marg, float* marg_part, float* vals, int* idx, void* stream) {
  const int err = check_shape(L, N, H, T, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_rpt(T)) {
    case 4: return launch_fwd<4>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
    case 2: return launch_fwd<2>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
    default: return launch_fwd<1>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
  }
}

// + idx (L, N, K), g_marg (L, T), g_vals (L, N, K) -> dh (L, N, H) and
// dwb = [dw (H, T), db (T)]. part: (hpd_tail_blocks, H * T + T) scratch.
int hpd_tail_bwd(const float* h, const float* w, const float* b, const int* idx,
                 const float* g_marg, const float* g_vals, int L, int N, int H, int T, int K,
                 float* dh, float* part, float* dwb, void* stream) {
  const int err = check_shape(L, N, H, T, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_rpt(T)) {
    case 4:
      return launch_bwd<4>(h, w, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
    case 2:
      return launch_bwd<2>(h, w, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
    default:
      return launch_bwd<1>(h, w, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
  }
}

}  // extern "C"
