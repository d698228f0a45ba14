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
// T = 256, 16 at T = 2048), so each product runs once per direction: the
// forward computes the logits, the softmax, the column sums and the
// top-K from that one tile (fp32 FMA on the CUDA cores, per_row.cuh); the
// backward recomputes the logits once, turns the tile into dl in place,
// then runs dW/db and dh from it. The backward's three products are 3xTF32
// on the tensor cores (per_row_mma.cuh's head_logits, head_dw, head_dh, as
// in K11), from h at stride mma_ld(H) with zeros past H and a copy of the
// head padded with zeros to head_rows(H) x head_ld(T); its bound is the three
// products' work at the TF32 peak (3xTF32: three passes each), softmax and
// dl not counted. dW/db accumulate in
// one partial per block (read-modify-write by the owning thread), summed in
// block order by a second kernel. No atomics. dh is written into the h tile
// (free once dW has read it), then stored to device memory row by row.
#include "per_row.cuh"
#include "per_row_mma.cuh"

using namespace per_row;

namespace {

constexpr int HMAX = WIDE_MAX;
constexpr int KMAX = 128;

// Row stride of the forward's h tile: WLD up to WMAX (the narrow instances'
// constant), H + 1 past it (the WIDE instances).
__host__ __device__ constexpr int fwd_ld(int H) { return H > WMAX ? H + 1 : WLD; }

// the forward's h tile (stride fwd_ld(H)), the staged chunk, the logits tile
// and the column sums
size_t tail_smem(int R, int H, int T) {
  return sizeof(float) * ((size_t)R * fwd_ld(H) + BK * BS + (size_t)R * (T + 1) + T);
}

// the h tile (stride mma_ld(H), dh's tile after dW), the staged head
// chunks, the logits / dl tile (stride mma_ld(T)) and g_marg's row
size_t tail_bwd_smem(int R, int H, int T) {
  return sizeof(float) * ((size_t)R * mma_ld(H) + head_stage_floats(R / 16) +
                          (size_t)R * mma_ld(T) + T);
}

// rows per thread of the widest tile that fits, 0 if none
int pick_rpt(int H, int T) {
  for (int rpt = 4; rpt >= 1; rpt >>= 1)
    if (tail_smem(16 * rpt, H, T) <= (size_t)SMEM_MAX) return rpt;
  return 0;
}

int pick_bwd_rpt(int H, int T) {
  for (int rpt = 4; rpt >= 1; rpt >>= 1)
    if (tail_bwd_smem(16 * rpt, H, T) <= (size_t)SMEM_MAX) return rpt;
  return 0;
}

int check_shape(int L, int N, int H, int T, int K) {
  if (L < 1 || N < 1 || H < 1 || H > HMAX || T < 1 || T > TMAX || K < 1 || K > KMAX || K > T)
    return ERR_SHAPE;
  return pick_rpt(H, T) && pick_bwd_rpt(H, T) ? 0 : ERR_SHAPE;
}

// WIDE: H > WMAX (the h tile's stride at run time)
template <int RPT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
tail_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, int H, int T, int K, Rows g,
                float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ marg_part) {
  constexpr int R = 16 * RPT;
  extern __shared__ float smem[];
  const int ldh = WIDE ? H + 1 : WLD;
  float* h_s = smem;
  float* b_s = h_s + R * ldh;
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
    load_rows<R>(h, base, rows, H, h_s, ldh);
    tile_logits<RPT>(h_s, ldh, H, w, b, T, b_s, cache);
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

template <int RPT, bool WIDE>
int launch_fwd(const float* h, const float* w, const float* b, int L, int N, int H, int T,
               int K, float* marg, float* marg_part, float* vals, int* idx, cudaStream_t st) {
  const Rows g = make_rows(L, N, 16 * RPT);
  const size_t smem = tail_smem(16 * RPT, H, T);
  set_smem(tail_fwd_kernel<RPT, WIDE>, smem);
  tail_fwd_kernel<RPT, WIDE><<<dim3(g.spl, L), THREADS, smem, st>>>(h, w, b, H, T, K, g, vals, idx,
                                                              marg_part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_levels_kernel<<<(L * T + 255) / 256, 256, 0, st>>>(marg_part, marg, L, g.spl, T, N);
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

// launch_fwd / launch_bwd at the tile size the shared memory allows
template <bool WIDE>
int fwd_rpt(const float* h, const float* w, const float* b, int L, int N, int H, int T, int K,
            float* marg, float* marg_part, float* vals, int* idx, cudaStream_t st) {
  switch (pick_rpt(H, T)) {
    case 4: return launch_fwd<4, WIDE>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
    case 2: return launch_fwd<2, WIDE>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
    default: return launch_fwd<1, WIDE>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
  }
}

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

// Row stride of the padded head at T columns, the one the per-row kernels
// read: K9 here, K10 and K11 (hpd_full.cu, through hpd_tail.padded_head).
int hpd_tail_head_ld(int T) { return head_ld(T); }

// Rows of the padded head at a head input of H: whole WMAX-row chunks.
int hpd_tail_head_rows(int H) { return head_rows(H); }

// Blocks of the forward's (bwd = 0) or the backward's (bwd = 1) launch for
// these shapes (the partial buffers have one row each), 0 if the kernels
// do not take them.
int hpd_tail_blocks(int L, int N, int H, int T, int K, int bwd) {
  if (check_shape(L, N, H, T, K)) return 0;
  return make_rows(L, N, 16 * (bwd ? pick_bwd_rpt(H, T) : pick_rpt(H, T))).spl * L;
}

// h (L, N, H), w (H, T), b (T) -> marg (L, T), vals (L, N, K), idx (L, N, K).
// marg_part: (hpd_tail_blocks(.., 0), T) scratch.
int hpd_tail_fwd(const float* h, const float* w, const float* b, int L, int N, int H, int T,
                 int K, float* marg, float* marg_part, float* vals, int* idx, void* stream) {
  const int err = check_shape(L, N, H, T, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return H > WMAX ? fwd_rpt<true>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st)
                  : fwd_rpt<false>(h, w, b, L, N, H, T, K, marg, marg_part, vals, idx, st);
}

// + idx (L, N, K), g_marg (L, T), g_vals (L, N, K) -> dh (L, N, H) and
// dwb = [dw (H, T), db (T)]. w_pad: the head padded with zeros to
// (hpd_tail_head_rows(H), hpd_tail_head_ld(T)), 16-byte aligned. part: (hpd_tail_blocks(..,
// 1), H * T + T) scratch.
int hpd_tail_bwd(const float* h, const float* w_pad, const float* b, const int* idx,
                 const float* g_marg, const float* g_vals, int L, int N, int H, int T, int K,
                 float* dh, float* part, float* dwb, void* stream) {
  const int err = check_shape(L, N, H, T, K);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return H > WMAX
             ? bwd_rpt<true>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st)
             : bwd_rpt<false>(h, w_pad, b, idx, g_marg, g_vals, L, N, H, T, K, dh, part, dwb, st);
}

}  // extern "C"
