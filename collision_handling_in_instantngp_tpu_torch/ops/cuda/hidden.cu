// Fused ReLU hidden stack of the HPD index network, forward (K3a) and
// backward (K3b), on the tensor cores.
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/hidden.py:
// hidden_stack_pallas (_fwd_kernel, _bwd_kernel): h = relu(...relu(x W0 + b0)
// ... W_{n-1} + b_{n-1}) over the U_c unique-vertex rows, [2 -> 32 -> 64 ->
// 128] on the main path. The contract is the JAX kernel's (hidden.supports):
// every width <= 512, every hidden width a multiple of 8, any depth.
//
// Bound on this card: at the main path's shapes, bytes. U_c = 161,792 rows
// of h (128 floats) are 83 MB, against 3.4 GFLOP of products (x3 as
// 3xTF32): the forward's least time is h's store, the backward's gh's load.
// The TPU kernel keeps every weight in VMEM; a 512-wide layer is 1 MB, past
// any block's shared memory, so here the forward's weights stream from L2
// (L1 keeps the main path's 42 KB stack) straight into the MMA fragments,
// the backward stages them in shared memory only when they fit, and the
// activations of a row tile stay on chip, in shared memory.
//
// Products: warp-level mma.sync under the precision contract of
// ops/precision.py: 'highest' m16n8k8 tf32 as 3xTF32 (x = hi + lo, both
// rounded to nearest; lo_a hi_b + hi_a lo_b into an accumulator of their
// own, hi_a hi_b into another, as per_row_mma.cuh does); 'high' m16n8k16
// bf16 with the same three products over the bf16 hi/lo split; 'default' one
// m16n8k16 bf16 product of bf16-rounded operands (bf16 products are exact in
// fp32; the sums are the tensor cores' fp32). Every chain starts from zeroed
// accumulators and runs CHAIN_K deep; chains add in fp32 in order.
// item_mm below is the one product routine: a warp's 16 x 32 output tile,
// its fragments loaded from whatever the caller's accessors read (an
// activation tile in shared memory at a row stride of mma_ld(width) = 4
// (mod 32): the A loads hit 32 banks; a weight in device or shared memory).
// block_mm spreads an output over the warps and hands each finished element
// to the caller; the dW kernel keeps one tile a warp across its rows.
//
// Forward: a block walks row tiles of RT rows; the tile's activations
// ping-pong between two shared buffers, layer by layer; the last layer's
// results go from the registers to h.
// Backward (K3b), two kernels over chunks of rows, then the reduce:
//  hidden_bwd_kernel walks row tiles: recomputes the tile's forward,
//   keeping every pre-activation in shared memory and writing each hidden
//   layer's activation act_l = relu(pre_{l-1}) to a device scratch; then per
//   layer, last first, g masked with the kernel's ReLU rule pre >= 0 and
//   g <- (g W_l^T), each g written over the pre-activations it no longer
//   needs and to the scratch. The weights are staged in shared memory once
//   per block when they fit beside the tile (45 KB on the main path).
//  hidden_dw_kernel takes dW_l = act_l^T g_l and db_l = the rows' sum of g_l
//   from the scratch: a block owns a 64 x 64 tile of one layer's dW and a
//   range of rows (the contraction), staged 32 rows at a time; each warp
//   keeps its 16 x 32 piece of dW in mma fragments across the whole range
//   (a chain of 32 rows from zeroed accumulators per stage, added in fp32
//   in order) and writes it once to the block's row of the partial buffer.
//  hidden_reduce_kernel sums the partials in order. No atomics: dW/db are
//  bitwise stable run to run. The scratch holds at most SCRATCH_MAX floats:
//  a wide stack runs in chunks of rows, each chunk's dW kernel adding to the
//  partials of the last. The vertex coords are data: no dx.
#include "per_row_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WIDTH = 512;
constexpr int NB = 32;          // output columns of a warp's tile (4 n8 tiles)
constexpr int CHAIN_K = 128;    // contraction depth per zeroed accumulator
constexpr int FWD_GRID = 8192;  // the forward's blocks walk the tiles past this
constexpr int BWD_BLOCKS = 264; // two blocks per SM of an H100
constexpr int SMEM_MAX = 232448;
// the dW kernel: a block's tile of dW (DW_T x DW_T), rows a stage, stage stride
constexpr int DW_T = 64;
constexpr int DW_K = 32;
constexpr int DW_LD = DW_T + 8;  // = 8 (mod 32): the fragment loads hit 32 banks
constexpr int DW_NST = 2;        // stages of its cp.async ring
constexpr int DW_PER = DW_K * DW_T / THREADS;  // elements of each operand a thread stages
constexpr int DW_STAGE = 2 * DW_K * DW_LD;  // floats of a stage: act rows, then g rows
constexpr int DW_BLOCKS = 528;   // two waves of two blocks per SM of an H100
// backward partial buffer: blocks x packed params <= this many floats
constexpr size_t PARTIAL_MAX = (size_t)32 << 20;
// the act / g scratch of a chunk of rows: at most this many floats
constexpr size_t SCRATCH_MAX = (size_t)64 << 20;

using per_row::mma_ld;
using per_row::round32;

#ifdef HIDDEN_PHASES
constexpr int K3A_PHASES = 9;  // x load, then layers 0 .. 7 (deeper layers in the last)
constexpr int K3B_PHASES = 4;  // load, recompute, g_n mask, g W^T
__device__ unsigned long long k3a_phase[K3A_PHASES];
__device__ unsigned long long k3b_phase[K3B_PHASES];
#endif

int check_widths(int n, const int* w) {
  if (n < 1 || w[0] < 1 || w[0] > MAX_WIDTH) return ERR_SHAPE;
  for (int l = 1; l <= n; ++l)
    if (w[l] < 8 || w[l] > MAX_WIDTH || w[l] % 8) return ERR_SHAPE;
  return 0;
}

int total_params(int n, const int* w) {
  int t = 0;
  for (int l = 0; l < n; ++l) t += w[l] * w[l + 1] + w[l + 1];
  return t;
}

int max_out(int n, const int* w) {
  int m = 0;
  for (int l = 1; l <= n; ++l) m = w[l] > m ? w[l] : m;
  return m;
}

int tiles(int u, int rt) { return (u + rt - 1) / rt; }

// Row stride of a staged weight W_l (wi x wo) in shared memory: = 8 (mod
// 32), so the recompute's B fragments hit 32 banks.
__host__ __device__ __forceinline__ int w_ld(int wo) { return round32(wo) + 8; }

// floats of every layer's staged weight and bias
size_t staged_floats(int n, const int* w) {
  size_t f = 0;
  for (int l = 0; l < n; ++l) f += (size_t)w[l] * w_ld(w[l + 1]) + w[l + 1];
  return f;
}

// ------------------------------- forward plan ------------------------------ //

struct FwdPlan {
  int rt, blocks;
  size_t smem;
};

// floats of the forward's two ping-pong buffers at rt rows
size_t fwd_floats(int n, const int* w, int rt) {
  const int wide = w[0] > max_out(n, w) ? w[0] : max_out(n, w);
  return 2 * (size_t)rt * mma_ld(wide);
}

// The widest row tile of 64, 32 or 16 rows whose buffers leave room for two
// blocks an SM (16 rows always do: 70 KB at width 512).
FwdPlan plan_fwd(int u, int n, const int* w) {
  FwdPlan p{};
  p.rt = 16;
  for (int rt = 64; rt > 16 && p.rt == 16; rt /= 2)
    if (sizeof(float) * fwd_floats(n, w, rt) <= SMEM_MAX / 2) p.rt = rt;
  p.smem = sizeof(float) * fwd_floats(n, w, p.rt);
  const int nt = tiles(u, p.rt);
  p.blocks = nt < FWD_GRID ? nt : FWD_GRID;
  return p;
}

// ------------------------------ backward plan ------------------------------ //

// The backward's plan. Its scratch (floats, in this order): a chunk's act_l
// for l = 1 .. n - 1, then its g_l for l = 0 .. n - 1, each chunk x width,
// row-major; then, if the tile's activations do not fit in shared memory,
// each block's activation area.
struct BwdPlan {
  int rt;             // the backward kernel's row tile
  size_t work;        // floats of a block's activation area: x tile, pre tiles
  bool work_smem;     // that area in shared memory (else in the scratch)
  bool w_smem;        // the weights staged in shared memory
  int blocks;         // the backward kernel's blocks
  int chunk;          // rows of a chunk
  int dw_tiles;       // the dW kernel's tiles over all layers
  int splits;         // its row ranges a chunk = rows of the partial buffer
  int total;          // packed parameter count
  size_t row_floats;  // scratch floats a row
  size_t scratch;     // scratch floats in all
};

// floats of the x tile and every layer's pre-activations at rt rows
size_t bwd_floats(int n, const int* w, int rt) {
  size_t cols = mma_ld(w[0]);
  for (int l = 1; l <= n; ++l) cols += mma_ld(w[l]);
  return (size_t)rt * cols;
}

int dw_tiles(int n, const int* w) {
  int t = 0;
  for (int l = 0; l < n; ++l) t += (w[l] + DW_T - 1) / DW_T * ((w[l + 1] + DW_T - 1) / DW_T);
  return t;
}

// The backward kernel: its tile and the staged weights within half the
// shared memory (two blocks an SM) at the widest row tile that allows it;
// else the tile alone, two blocks an SM, then one; else (a stack too deep
// for 16 rows of it) the activations in the scratch. The dW kernel: enough
// row ranges for DW_BLOCKS blocks, within PARTIAL_MAX floats of partials.
BwdPlan plan_bwd(int u, int n, const int* w) {
  BwdPlan p{};
  p.total = total_params(n, w);
  const size_t wf = staged_floats(n, w);
  for (int pass = 0; pass < 3 && !p.rt; ++pass) {
    const size_t budget = pass < 2 ? SMEM_MAX / 2 : SMEM_MAX;
    const bool staged = pass == 0;
    for (int rt = 64; rt >= 16 && !p.rt; rt /= 2) {
      if (sizeof(float) * (bwd_floats(n, w, rt) + (staged ? wf : 0)) <= budget) {
        p.rt = rt;
        p.w_smem = staged;
      }
    }
  }
  p.work_smem = p.rt != 0;
  if (!p.rt) p.rt = 16;
  p.work = bwd_floats(n, w, p.rt);
  p.row_floats = 0;
  for (int l = 1; l < n; ++l) p.row_floats += w[l];
  for (int l = 1; l <= n; ++l) p.row_floats += w[l];
  const size_t cap = SCRATCH_MAX / p.row_floats;
  p.chunk = u < (long long)cap ? u : (int)(cap > (size_t)p.rt ? cap / p.rt * p.rt : p.rt);
  int nb = tiles(p.chunk, p.rt);
  p.blocks = nb < BWD_BLOCKS ? nb : BWD_BLOCKS;
  p.scratch = (size_t)p.chunk * p.row_floats + (p.work_smem ? 0 : (size_t)p.blocks * p.work);
  p.dw_tiles = dw_tiles(n, w);
  int s = (DW_BLOCKS + p.dw_tiles - 1) / p.dw_tiles;
  const int by_rows = (p.chunk + DW_K - 1) / DW_K;
  const int by_mem = (int)(PARTIAL_MAX / (size_t)p.total);
  s = s < by_rows ? s : by_rows;
  s = s < by_mem ? s : by_mem;
  p.splits = s > 0 ? s : 1;
  return p;
}

// ------------------------------ the products ------------------------------ //

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);  // .x: the lower k
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: A 16 x 16 row-major, B 16 x 8 column-major, bf16, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (hi, lo) bf16 pairs of two k-adjacent values under P (lo unused for P = 2)
template <int P>
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const float h0 = bf16r(x0), h1 = bf16r(x1);
  hi = pack_bf16(h0, h1);
  if (P == 1) lo = pack_bf16(x0 - h0, x1 - h1);
}

// run (+)= the 16 x NB tile at (m0, n0) of A B over K under P: a(m, k) and
// b(k, n) read the operands (b called only for k < K, n < N; a for k < K
// and every row of the tile). Chains of CHAIN_K k from zeroed accumulators,
// added in order in fp32 into run (its old value first when add).
// run[j][q] is element (m0 + g + 8 (q >> 1), n0 + 8 j + 2 t + (q & 1)) of
// the tile, g = lane / 4, t = lane % 4.
template <int P, typename FA, typename FB>
__device__ __forceinline__ void item_mm(int m0, int n0, int N, int K, FA a, FB b,
                                        float (&run)[4][4], bool add) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < K; kc += CHAIN_K) {
    const int ke = kc + CHAIN_K < K ? kc + CHAIN_K : K;
    float d[4][4] = {}, dl[4][4] = {};
    if (P == 0) {
      for (int k0 = kc; k0 < ke; k0 += 8) {
        const int ka = k0 + t, kb = k0 + t + 4;
        const float av[4] = {ka < K ? a(m0 + g, ka) : 0.f, ka < K ? a(m0 + g + 8, ka) : 0.f,
                             kb < K ? a(m0 + g, kb) : 0.f, kb < K ? a(m0 + g + 8, kb) : 0.f};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) per_row::split(av[q], ah[q], al[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + g;
          const float b0 = ka < K && n < N ? b(ka, n) : 0.f;
          const float b1 = kb < K && n < N ? b(kb, n) : 0.f;
          uint32_t bh[2], bl[2];
          per_row::split(b0, bh[0], bl[0]);
          per_row::split(b1, bh[1], bl[1]);
          per_row::mma_tf32(dl[j], al, bh);
          per_row::mma_tf32(d[j], ah, bh);
          per_row::mma_tf32(dl[j], ah, bl);
        }
      }
    } else {
      for (int k0 = kc; k0 < ke; k0 += 16) {
        const int k[4] = {k0 + 2 * t, k0 + 2 * t + 1, k0 + 2 * t + 8, k0 + 2 * t + 9};
        float av[8];  // (g, k0..1), (g + 8, k0..1), (g, k2..3), (g + 8, k2..3)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = k[(q >> 1) * 2], r = m0 + g + 8 * (q & 1);
          av[2 * q] = kk < K ? a(r, kk) : 0.f;
          av[2 * q + 1] = kk + 1 < K ? a(r, kk + 1) : 0.f;
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_bf16<P>(av[2 * q], av[2 * q + 1], ah[q], al[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + g;
          float bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = k[q] < K && n < N ? b(k[q], n) : 0.f;
          uint32_t bh[2], bl[2];
          split_bf16<P>(bv[0], bv[1], bh[0], bl[0]);
          split_bf16<P>(bv[2], bv[3], bh[1], bl[1]);
          if (P == 1) {
            mma_bf16(dl[j], al, bh);
            mma_bf16(d[j], ah, bh);
            mma_bf16(dl[j], ah, bl);
          } else {
            mma_bf16(d[j], ah, bh);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c = d[j][q] + dl[j][q];
        run[j][q] = kc == 0 && !add ? c : run[j][q] + c;
      }
  }
}

// C = A B for an M x N output over K >= 1 under P: a and b as item_mm's (a
// read for rows up to M rounded to 16); emit(m, n, c) takes each element of
// C with m < M, n < N once, always on the same thread for the same (M, N,
// K). Warp w takes the 16 x NB output tiles w, w + WARPS, ... (the tiles of
// one row block first).
template <int P, typename FA, typename FB, typename FE>
__device__ __forceinline__ void block_mm(int M, int N, int K, FA a, FB b, FE emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (N + NB - 1) / NB, items = (M + 15) / 16 * nt;
  for (int item = warp; item < items; item += WARPS) {
    const int m0 = item / nt * 16, n0 = item % nt * NB;
    float run[4][4];
    item_mm<P>(m0, n0, N, K, a, b, run, false);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + g + 8 * (q >> 1), n = n0 + 8 * j + 2 * t + (q & 1);
        if (m < M && n < N) emit(m, n, run[j][q]);
      }
  }
}

// rows [r0, r0 + rt) of x (u x d) into dst (stride ld), zero past u
__device__ __forceinline__ void load_x(const float* __restrict__ x, int u, int d, int r0, int rt,
                                       float* __restrict__ dst, int ld) {
  for (int i = threadIdx.x; i < rt * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    dst[r * ld + k] = r0 + r < u ? x[(size_t)(r0 + r) * d + k] : 0.f;
  }
}

// ------------------------------- forward ---------------------------------- //

template <int P, int RT>
__global__ void __launch_bounds__(THREADS)
hidden_fwd_kernel(const float* __restrict__ x, const float* __restrict__ params,
                  float* __restrict__ h, int u, int n, const int* __restrict__ w) {
  extern __shared__ float smem[];
  int wide = w[0];
  for (int l = 1; l <= n; ++l) wide = w[l] > wide ? w[l] : wide;
  const int ld = mma_ld(wide);
  float* buf0 = smem;
  float* buf1 = buf0 + RT * ld;
  const int ntiles = (u + RT - 1) / RT, d = w[0], wn = w[n];
  PHASE_START(K3A_PHASES);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * RT;
    __syncthreads();  // the previous tile's last layer has read buf0 / buf1
    load_x(x, u, d, r0, RT, buf0, ld);
    __syncthreads();
    PHASE_MARK(0);
    const float* in = buf0;
    float* out = buf1;
    int off = 0;
    for (int l = 0; l < n; ++l) {
      const int wi = w[l], wo = w[l + 1];
      const float* W = params + off;
      const float* B = W + wi * wo;
      off += wi * wo + wo;
      const auto a = [&](int m, int k) { return in[m * ld + k]; };
      const auto b = [&](int k, int c) { return __ldg(W + k * wo + c); };
      if (l == n - 1) {
        block_mm<P>(RT, wo, wi, a, b, [&](int m, int c, float v) {
          if (r0 + m < u) h[(size_t)(r0 + m) * wn + c] = fmaxf(v + __ldg(B + c), 0.f);
        });
      } else {
        block_mm<P>(RT, wo, wi, a, b, [&](int m, int c, float v) {
          out[m * ld + c] = fmaxf(v + __ldg(B + c), 0.f);
        });
        __syncthreads();
      }
      PHASE_MARK(1 + (l < K3A_PHASES - 2 ? l : K3A_PHASES - 2));
      const float* t = out;
      out = (float*)in;
      in = t;
    }
  }
  PHASE_END(k3a_phase, K3A_PHASES);
}

// ------------------------------- backward --------------------------------- //

// rows [r0, r0 + rt) of a tile (stride ld, width wd) into dst (u x wd,
// row-major), rows past u left out; relu applies max(., 0) on the way. A
// warp a row.
__device__ __forceinline__ void store_rows(const float* __restrict__ src, int ld, int wd, int r0,
                                           int rt, int u, bool relu, float* __restrict__ dst) {
  const int rows = u - r0 < rt ? u - r0 : rt;
  for (int r = threadIdx.x >> 5; r < rows; r += WARPS)
    for (int c = threadIdx.x & 31; c < wd; c += 32) {
      const float v = src[r * ld + c];
      dst[(size_t)(r0 + r) * wd + c] = relu ? fmaxf(v, 0.f) : v;
    }
}

// Per row tile of the chunk's u rows: the forward's recompute, then the
// ReLU-masked gradient of every layer's pre-activations, g_l, into `out`
// (act_l for l >= 1, then g_l, as BwdPlan lays them out at `cap` rows).
// WS: the weights staged in shared memory (stride w_ld), else read from L2.
template <int P, int RT, bool WS>
__global__ void __launch_bounds__(THREADS, 2)
hidden_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gh,
                  const float* __restrict__ params, float* __restrict__ out,
                  float* __restrict__ work_area, int u, int n, const int* __restrict__ w,
                  size_t cap, size_t work) {
  extern __shared__ float smem[];
  float* area = work_area ? work_area + (size_t)blockIdx.x * work : smem;
  float* ws = smem + (work_area ? 0 : work);
  if (WS) {
    int off = 0;
    float* dst = ws;
    for (int l = 0; l < n; ++l) {
      const int wi = w[l], wo = w[l + 1], ld = w_ld(wo);
      for (int i = threadIdx.x; i < wi * wo; i += THREADS) {
        const int k = i / wo, c = i - k * wo;
        dst[k * ld + c] = params[off + i];
      }
      for (int c = threadIdx.x; c < wo; c += THREADS) dst[wi * ld + c] = params[off + wi * wo + c];
      off += wi * wo + wo;
      dst += (size_t)wi * ld + wo;
    }
  }
  const int d = w[0], ldx = mma_ld(d), wn = w[n];
  float* xin = area;
  float* pre = xin + RT * ldx;  // layer l's pre-activations at pre + RT * (sum of ld below)
  int pre_total = 0, act_total = 0;
  for (int l = 1; l <= n; ++l) pre_total += mma_ld(w[l]);
  for (int l = 1; l < n; ++l) act_total += w[l];
  float* g_out = out + cap * act_total;  // g_0's rows; g_l follows g_{l-1}
  const int ntiles = (u + RT - 1) / RT;
  PHASE_START(K3B_PHASES);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * RT;
    __syncthreads();  // the previous tile is done with every buffer (and the staging)
    load_x(x, u, d, r0, RT, xin, ldx);
    {
      const int rows = u - r0 < RT ? u - r0 : RT;
      const char* gh_tile = reinterpret_cast<const char*>(gh + (size_t)r0 * wn);
      for (int i = threadIdx.x * 128; i < rows * wn * 4; i += THREADS * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(gh_tile + i));
    }
    __syncthreads();
    PHASE_MARK(0);
    // recompute the forward, keeping the pre-activations; act_l to `out`
    {
      const float* in = xin;
      int ldi = ldx, off = 0;
      size_t soff = 0, aoff = 0;
      float* cur = pre;
      for (int l = 0; l < n; ++l) {
        const int wi = w[l], wo = w[l + 1], ldo = mma_ld(wo), ldw = w_ld(wo);
        const float* W = WS ? ws + soff : params + off;
        const float* B = W + (WS ? wi * ldw : wi * wo);
        off += wi * wo + wo;
        soff += (size_t)wi * ldw + wo;
        const bool relu = l > 0;
        block_mm<P>(
            RT, wo, wi,
            [&](int m, int k) { return relu ? fmaxf(in[m * ldi + k], 0.f) : in[m * ldi + k]; },
            [&](int k, int c) { return WS ? W[k * ldw + c] : __ldg(W + k * wo + c); },
            [&](int m, int c, float v) { cur[m * ldo + c] = v + (WS ? B[c] : __ldg(B + c)); });
        __syncthreads();
        if (l + 1 < n) {
          store_rows(cur, ldo, wo, r0, RT, u, true, out + cap * aoff);
          aoff += wo;
        }
        in = cur;
        ldi = ldo;
        cur += RT * ldo;
      }
    }
    PHASE_MARK(1);
    // g_{n-1} = gh masked by the last layer's pre >= 0, over that layer's pre
    // (gh's rows were prefetched to L2 with the x tile; a warp loads all of
    // its rows' 128-column batch before it uses them)
    size_t goff = act_total;  // g_{n-1}'s region: past g_0 .. g_{n-2}, of widths w[1 .. n-1]
    {
      constexpr int RW = RT / WARPS;  // rows a warp: warp + WARPS i
      float* pl = pre + RT * (pre_total - mma_ld(wn));
      float* go = g_out + cap * goff;
      const int ldl = mma_ld(wn), rows = u - r0 < RT ? u - r0 : RT;
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int c0 = 0; c0 < wn; c0 += 128) {
        float v[RW][4];
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = warp + WARPS * i, c = c0 + lane + 32 * q;
            v[i][q] = r < rows && c < wn ? gh[(size_t)(r0 + r) * wn + c] : 0.f;
          }
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = warp + WARPS * i, c = c0 + lane + 32 * q;
            if (c < wn) {
              const float m = pl[r * ldl + c] >= 0.f ? v[i][q] : 0.f;
              pl[r * ldl + c] = m;
              if (r < rows) go[(size_t)(r0 + r) * wn + c] = m;
            }
          }
      }
    }
    __syncthreads();
    PHASE_MARK(2);
    // g_{l-1} = (g_l W_l^T) masked by the layer below's pre >= 0, over it
    int poff = pre_total - mma_ld(wn);
    size_t soff = 0;  // layer n - 1's staged weight, then its packed one
    int woff = 0;
    for (int l = 0; l + 1 < n; ++l) {
      soff += (size_t)w[l] * w_ld(w[l + 1]) + w[l + 1];
      woff += w[l] * w[l + 1] + w[l + 1];
    }
    for (int l = n - 1; l > 0; --l) {
      const int wi = w[l], wo = w[l + 1], ldg = mma_ld(wo), ldw = w_ld(wo);
      const float* W = WS ? ws + soff : params + woff;
      const float* g = pre + RT * poff;
      poff -= mma_ld(wi);
      float* gn = pre + RT * poff;
      const int ldn = mma_ld(wi);
      block_mm<P>(
          RT, wi, wo, [&](int m, int k) { return g[m * ldg + k]; },
          [&](int k, int c) { return WS ? W[c * ldw + k] : __ldg(W + c * wo + k); },
          [&](int m, int c, float v) { gn[m * ldn + c] = gn[m * ldn + c] >= 0.f ? v : 0.f; });
      __syncthreads();
      goff -= wi;
      store_rows(gn, ldn, wi, r0, RT, u, false, g_out + cap * goff);
      if (l > 1) {
        soff -= (size_t)w[l - 1] * w_ld(wi) + wi;
        woff -= w[l - 1] * wi + wi;
      }
    }
    PHASE_MARK(3);
  }
  PHASE_END(k3b_phase, K3B_PHASES);
}

// dst <- *src (4 bytes) asynchronously, or 0 if !valid (src then unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// dst[0:4] <- src[0:4] (both 16-byte aligned) asynchronously, or zeros if !valid
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// dW_l = act_l^T g_l and db_l = sum of g_l's rows over the chunk's u rows,
// into the block's row blockIdx.y of the partials (added to it if add).
// blockIdx.x: a DW_T x DW_T tile of one layer's dW (the layers in order,
// each row-major over its tiles); blockIdx.y: a range of rows, staged DW_K
// rows at a time through a ring of DW_NST cp.async stages. act_0 is x; the
// rest, and g, come from `scr` as hidden_bwd_kernel wrote them (16-byte
// aligned rows: their widths are multiples of 8), in 16-byte copies; x in
// 4-byte ones. A warp whose 16 rows of dW lie past w_l has nothing to do.
// db: thread t sums rows t / DW_T (mod 4) of column t % DW_T of each stage;
// the four sums of a column add in order at the end.
template <int P>
__global__ void __launch_bounds__(THREADS, 2)
hidden_dw_kernel(const float* __restrict__ x, const float* __restrict__ scr,
                 float* __restrict__ partials, int u, int n, const int* __restrict__ w,
                 size_t cap, int total, int add) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float db_s[THREADS];
  int b = blockIdx.x, l = 0, woff = 0;
  size_t aoff = 0, goff = 0;
  for (; l < n; ++l) {
    const int nt = (w[l] + DW_T - 1) / DW_T * ((w[l + 1] + DW_T - 1) / DW_T);
    if (b < nt) break;
    b -= nt;
    woff += w[l] * w[l + 1] + w[l + 1];
    if (l > 0) aoff += w[l];
    goff += w[l + 1];
  }
  for (int j = 1; j < n; ++j) goff += w[j];
  const int wi = w[l], wo = w[l + 1];
  const int tc = (wo + DW_T - 1) / DW_T;
  const int i0 = b / tc * DW_T, c0 = b % tc * DW_T;
  const float* A = l == 0 ? x : scr + cap * aoff;
  const float* G = scr + cap * goff;
  const int per = ((u + gridDim.y - 1) / gridDim.y + DW_K - 1) / DW_K * DW_K;
  const int rb = blockIdx.y * per, re = rb + per < u ? rb + per : u;
  const int nst = rb < re ? (re - rb + DW_K - 1) / DW_K : 0;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * NB;
  const bool busy = i0 + m0 < wi && c0 + n0 < wo;
  float run[4][4] = {};
  float db = 0.f;
  // stage s: DW_K rows from rb + s DW_K; each thread DW_PER / 4 vectors of
  // each operand (DW_PER elements of x)
  const auto issue = [&](int s) {
    if (s >= nst) return;
    float* st = ring + (s % DW_NST) * DW_STAGE;
    const int rs = rb + s * DW_K;
#pragma unroll
    for (int q = 0; q < DW_PER / 4; ++q) {
      const int e = threadIdx.x + THREADS * q, r = e / (DW_T / 4), cc = 4 * (e % (DW_T / 4));
      const int rr = rs + r;
      const bool vg = rr < re && c0 + cc < wo;
      cp_async16z(st + (DW_K + r) * DW_LD + cc, vg ? G + (size_t)rr * wo + c0 + cc : G, vg);
      if (l > 0) {
        const bool va = rr < re && i0 + cc < wi;
        cp_async16z(st + r * DW_LD + cc, va ? A + (size_t)rr * wi + i0 + cc : A, va);
      }
    }
    if (l == 0)
#pragma unroll
      for (int q = 0; q < DW_PER; ++q) {
        const int e = threadIdx.x + THREADS * q, rr = rs + e / DW_T, cc = e % DW_T;
        const bool va = rr < re && i0 + cc < wi;
        cp_async4(st + e / DW_T * DW_LD + cc, va ? A + (size_t)rr * wi + i0 + cc : A, va);
      }
  };
#pragma unroll
  for (int s = 0; s < DW_NST - 1; ++s) {
    issue(s);
    per_row::cp_commit();
  }
  for (int s = 0; s < nst; ++s) {
    per_row::cp_wait<DW_NST - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is read
    issue(s + DW_NST - 1);
    per_row::cp_commit();
    const float* As = ring + (s % DW_NST) * DW_STAGE;
    const float* Gs = As + DW_K * DW_LD;
    if (busy)
      item_mm<P>(m0, n0, DW_T, DW_K, [&](int m, int k) { return As[k * DW_LD + m]; },
                 [&](int k, int c) { return Gs[k * DW_LD + c]; }, run, s > 0);
    if (i0 == 0)
#pragma unroll
      for (int k = threadIdx.x / DW_T; k < DW_K; k += THREADS / DW_T)
        db += Gs[k * DW_LD + threadIdx.x % DW_T];
  }
  per_row::cp_wait<0>();
  db_s[threadIdx.x] = db;
  __syncthreads();
  if (threadIdx.x < DW_T) {
    db = 0.f;
    for (int q = 0; q < THREADS / DW_T; ++q) db += db_s[q * DW_T + threadIdx.x];
  }
  float* part = partials + (size_t)blockIdx.y * total + woff;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + m0 + g + 8 * (q >> 1), c = c0 + n0 + 8 * j + 2 * t + (q & 1);
      if (i < wi && c < wo) {
        float* dst = part + (size_t)i * wo + c;
        *dst = add ? *dst + run[j][q] : run[j][q];
      }
    }
  if (i0 == 0 && threadIdx.x < DW_T && c0 + threadIdx.x < wo) {
    float* dst = part + (size_t)wi * wo + c0 + threadIdx.x;
    *dst = add ? *dst + db : db;
  }
}

__global__ void hidden_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int nblocks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * total + i];
  out[i] = s;
}

#define DISPATCH_RT(rt, ...)                            \
  switch (rt) {                                         \
    case 64: { constexpr int RT = 64; __VA_ARGS__; } break; \
    case 32: { constexpr int RT = 32; __VA_ARGS__; } break; \
    default: { constexpr int RT = 16; __VA_ARGS__; } break; \
  }

#define DISPATCH_WS(ws, ...)                              \
  if (ws) { constexpr bool WS = true; __VA_ARGS__; }      \
  else { constexpr bool WS = false; __VA_ARGS__; }

}  // namespace

extern "C" {

const char* hidden_error_string(int code) { return port_error_string(code); }

#ifdef HIDDEN_PHASES
// K3a's (hidden_fwd_phases) and K3b's backward kernel's (hidden_bwd_phases)
// clock64() ticks by phase, summed over the blocks of the launches since
// the last reset, into out[K3A_PHASES] / out[K3B_PHASES]; then zeroes them
// if reset.
int hidden_fwd_phases(unsigned long long* out, int reset) { return read_phases(k3a_phase, out, reset); }
int hidden_bwd_phases(unsigned long long* out, int reset) { return read_phases(k3b_phase, out, reset); }
int hidden_fwd_phase_count() { return K3A_PHASES; }
#endif

// Buffers hidden_stack_bwd needs for these widths (w: n + 1 ints, x's width
// first): out[0] = rows of the partial buffer, out[1] = floats of the
// scratch (a chunk's act / g, and the activation areas if they live there).
int hidden_stack_bwd_plan(int u, int n, const int* w, long long* out) {
  const int err = check_widths(n, w);
  if (err) return err;
  const BwdPlan p = plan_bwd(u > 0 ? u : 1, n, w);
  out[0] = p.splits;
  out[1] = (long long)p.scratch;
  return 0;
}

// x (u, w[0]), params packed [W0 (w0 x w1), b0, W1, b1, ...] -> h (u, w[n]).
// w: the widths on the host; w_dev: the same on the device.
int hidden_stack_fwd(const float* x, const float* params, float* h, int u, int n, const int* w,
                     const int* w_dev, int prec, void* stream) {
  int err = check_widths(n, w);
  if (err) return err;
  if (u <= 0) return 0;
  const FwdPlan p = plan_fwd(u, n, w);
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_PREC(prec, DISPATCH_RT(p.rt, {
    cudaFuncSetAttribute(hidden_fwd_kernel<P, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)p.smem);
    hidden_fwd_kernel<P, RT><<<p.blocks, THREADS, p.smem, s>>>(x, params, h, u, n, w_dev);
  }));
  return (int)cudaGetLastError();
}

// dparams (packed like params) of sum(h * gh). partials: (plan[0], packed
// count); scratch: plan[1] floats (hidden_stack_bwd_plan).
int hidden_stack_bwd(const float* x, const float* gh, const float* params, float* partials,
                     float* scratch, float* dparams, int u, int n, const int* w,
                     const int* w_dev, int prec, void* stream) {
  int err = check_widths(n, w);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (u <= 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * total_params(n, w), s);
  const BwdPlan p = plan_bwd(u, n, w);
  const size_t smem = sizeof(float) * ((p.work_smem ? p.work : 0) +
                                       (p.w_smem ? staged_floats(n, w) : 0));
  float* work_area = p.work_smem ? nullptr : scratch + (size_t)p.chunk * p.row_floats;
  for (int c0 = 0; c0 < u; c0 += p.chunk) {
    const int rows = u - c0 < p.chunk ? u - c0 : p.chunk;
    const float* xc = x + (size_t)c0 * w[0];
    const int nb = tiles(rows, p.rt) < p.blocks ? tiles(rows, p.rt) : p.blocks;
    DISPATCH_PREC(prec, DISPATCH_RT(p.rt, DISPATCH_WS(p.w_smem, {
      cudaFuncSetAttribute(hidden_bwd_kernel<P, RT, WS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      hidden_bwd_kernel<P, RT, WS><<<nb, THREADS, smem, s>>>(
          xc, gh + (size_t)c0 * w[n], params, scratch, work_area, rows, n, w_dev,
          (size_t)p.chunk, p.work);
    })));
    err = (int)cudaGetLastError();
    if (err) return err;
    DISPATCH_PREC(prec, {
      constexpr int dw_smem = sizeof(float) * DW_NST * DW_STAGE;
      cudaFuncSetAttribute(hidden_dw_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dw_smem);
      hidden_dw_kernel<P><<<dim3(p.dw_tiles, p.splits), THREADS, dw_smem, s>>>(
          xc, scratch, partials, rows, n, w_dev, (size_t)p.chunk, p.total, c0 > 0);
    });
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  hidden_reduce_kernel<<<(p.total + 255) / 256, 256, 0, s>>>(partials, dparams, p.splits, p.total);
  return (int)cudaGetLastError();
}

}  // extern "C"
