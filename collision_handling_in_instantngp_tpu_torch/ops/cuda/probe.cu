// The roofline probes of the measurement path: the in-kernel dot rate per
// operand regime (K13) and the streaming rates of device memory (K14, K15).
//
// Replaces the three Pallas kernels of tools/mxu_probe.py (JAX package):
//   rowsum (K13, body rowsum_kernel): out (U, 1) = sum_t (h w)[:, t], the
//     (U, T) product never written, under four operand regimes.
//   writer (K14): a new fp32 array of ones.
//   copier (K15): y = 2 x into a new array.
//
// K13 on this card. Each block takes a row tile and sweeps every column
// tile, as the streamed tail's rows pass does; a row's sum is taken per
// tile first, then over the tiles in order, and comes from one block: no
// cross-block reduction, bitwise stable run to run.
//   regime 0 'highest': fp32 FMA on the CUDA cores, the tail's own tiling
//     (stream_tile.cuh: 64 x 128 tiles, pfma<0>), what K1-K7 run today.
//   regime 1 'default': the same tiling with pfma<2> (one bf16-rounded
//     product per term, fp32 sums), the port's 'default' contract.
//   regime 2 'bf16': bf16 operands on the tensor cores, fp32 accumulate
//     (mma.sync m16n8k16), 128 x 128 tiles, 8 warps of 32 x 64.
//   regime 3 'bf16x3': hi(h)hi(w) + hi(h)lo(w) + lo(h)hi(w) on the tensor
//     cores into one fp32 accumulator (the bf16 hi/lo split of 'high').
// Regimes 1 and 2 compute one function: bf16 products are exact in fp32.
// Bound: operations (2 U H T), at the fp32 CUDA-core peak for regimes 0/1
// and the bf16 tensor peak (x3 for regime 3) for 2/3. Each tensor-core
// block converts its own copy of every w tile to bf16 in shared memory:
// simple, and the first thing a faster version (wgmma, TMA, a bf16 w made
// once) would change.
//
// K14 / K15: grid-stride loops of 16-byte (float4) stores / loads, one pass;
// bound: bytes.
#include <stdint.h>

#include "stream_tile.cuh"

namespace {

// ------------------------- K13, CUDA-core regimes -------------------------- //

size_t rowsum_fp32_smem() { return sizeof(float) * (R * HP + BK * TT + R * NSUB); }

template <int P>
__global__ void __launch_bounds__(THREADS)
rowsum_fp32_kernel(const float* __restrict__ h, const float* __restrict__ w, int u, int H, int T,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* w_s = h_s + R * HP;
  float* ps = w_s + BK * TT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * R;
  load_rows(h, u, H, r0, h_s);
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < T; t0 += TT) {
    float acc[4][8];
    tile_dot<P>(h_s, w, H, T, t0, w_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += acc[i][j];
      run[i] += sum;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) ps[(ty * 4 + i) * NSUB + tx] = run[i];
  __syncthreads();
  if (threadIdx.x < R && r0 + threadIdx.x < u) {
    const int r = threadIdx.x;
    float s = 0.f;
    for (int sub = 0; sub < NSUB; ++sub) s += ps[r * NSUB + sub];
    out[r0 + r] = s;
  }
}

// ------------------------ K13, tensor-core regimes ------------------------- //

constexpr int TBM = 128;        // rows per block
constexpr int TBN = 128;        // columns per tile
constexpr int SK = HMAX + 8;    // bf16 row stride of the operand tiles (conflict-free fragments)
constexpr int SKW = SK / 2;     // the same in 32-bit words

__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(first)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(second)) << 16);
}

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), for a pair of values.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - bf16r(x0), x1 - bf16r(x1));
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

// Shared memory: A (TBM x SK) and B (TBN x SK, k contiguous per column) in
// bf16, hi and (X3) lo, then 2 x TBM fp32 row partials.
template <bool X3>
size_t rowsum_tc_smem() {
  return (X3 ? 2 : 1) * (size_t)(TBM + TBN) * SK * 2 + sizeof(float) * 2 * TBM;
}

template <bool X3>
__global__ void __launch_bounds__(THREADS)
rowsum_tc_kernel(const float* __restrict__ h, const float* __restrict__ w, int u, int H, int T,
                 float* __restrict__ out) {
  extern __shared__ uint32_t smem_u32[];
  constexpr int NP = X3 ? 2 : 1;
  uint32_t* a_hi = smem_u32;
  uint32_t* a_lo = a_hi + TBM * SKW;                  // used when X3
  uint32_t* b_hi = a_hi + NP * TBM * SKW;
  uint32_t* b_lo = b_hi + TBN * SKW;                  // used when X3
  float* part = (float*)(b_hi + NP * TBN * SKW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;           // warp tile: rows wr*32, columns wc*64
  const int r0 = blockIdx.x * TBM;
  const int hw = H / 2;                              // k pairs

  for (int i = threadIdx.x; i < TBM * hw; i += THREADS) {
    const int r = i / hw, kp = i - r * hw;
    float2 x = make_float2(0.f, 0.f);
    if (r0 + r < u) x = *reinterpret_cast<const float2*>(h + (size_t)(r0 + r) * H + 2 * kp);
    uint32_t hi, lo;
    split_pair(x.x, x.y, hi, lo);
    a_hi[r * SKW + kp] = hi;
    if (X3) a_lo[r * SKW + kp] = lo;
  }

  float run[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int t0 = 0; t0 < T; t0 += TBN) {
    __syncthreads();
    for (int i = threadIdx.x; i < TBN * hw; i += THREADS) {
      const int n = i & (TBN - 1), kp = i / TBN;
      const float x0 = w[(size_t)(2 * kp) * T + t0 + n];
      const float x1 = w[(size_t)(2 * kp + 1) * T + t0 + n];
      uint32_t hi, lo;
      split_pair(x0, x1, hi, lo);
      b_hi[n * SKW + kp] = hi;
      if (X3) b_lo[n * SKW + kp] = lo;
    }
    __syncthreads();
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nt][q] = 0.f;
    for (int kw = 0; kw < hw; kw += 8) {             // 16 k per step
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wr * 32 + mi * 16 + g;
        const int e[4] = {row * SKW + kw + tg, (row + 8) * SKW + kw + tg,
                          row * SKW + kw + 4 + tg, (row + 8) * SKW + kw + 4 + tg};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[mi][q] = a_hi[e[q]];
          if (X3) al[mi][q] = a_lo[e[q]];
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wc * 64 + nt * 8 + g;
        const uint32_t bh[2] = {b_hi[col * SKW + kw + tg], b_hi[col * SKW + kw + 4 + tg]};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][nt], ah[mi], bh);
        if (X3) {
          const uint32_t bl[2] = {b_lo[col * SKW + kw + tg], b_lo[col * SKW + kw + 4 + tg]};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][nt], ah[mi], bl);
            mma_bf16(acc[mi][nt], al[mi], bh);
          }
        }
      }
    }
    // the tile's partial of rows g and g + 8 (per sub-tile mi), over this
    // thread's columns, then into the running sums
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s0 += acc[mi][nt][0] + acc[mi][nt][1];
        s1 += acc[mi][nt][2] + acc[mi][nt][3];
      }
      run[mi][0] += s0;
      run[mi][1] += s1;
    }
  }
  // the four lanes of a row group hold its columns; then the two column warps
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = run[mi][half];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tg == 0) part[wc * TBM + wr * 32 + mi * 16 + half * 8 + g] = v;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < TBM; r += THREADS)
    if (r0 + r < u) out[r0 + r] = part[r] + part[TBM + r];
}

// ------------------------------- K14 / K15 --------------------------------- //

unsigned stream_blocks(size_t n4) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t want = (n4 + THREADS - 1) / THREADS;
  const size_t cap = (size_t)sms * 8;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

__global__ void __launch_bounds__(THREADS) hbm_write_kernel(float* __restrict__ out, size_t n,
                                                            size_t n4) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t i0 = (size_t)blockIdx.x * THREADS + threadIdx.x;
  float4* o4 = reinterpret_cast<float4*>(out);
  for (size_t i = i0; i < n4; i += stride) o4[i] = make_float4(1.f, 1.f, 1.f, 1.f);
  for (size_t i = 4 * n4 + i0; i < n; i += stride) out[i] = 1.f;
}

__global__ void __launch_bounds__(THREADS) hbm_scale_copy_kernel(const float* __restrict__ x,
                                                                 float* __restrict__ y, size_t n,
                                                                 size_t n4) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t i0 = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (size_t i = i0; i < n4; i += stride) {
    const float4 v = x4[i];
    y4[i] = make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
  }
  for (size_t i = 4 * n4 + i0; i < n; i += stride) y[i] = 2.f * x[i];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* probe_error_string(int code) { return port_error_string(code); }

// K13: h (u, H), w (H, T) -> out (u) = row sums of h w. regime: 0 'highest',
// 1 'default', 2 'bf16', 3 'bf16x3'. Takes H a multiple of 16 up to 128 and
// T a multiple of 128.
int rowsum_dot(const float* h, const float* w, int u, int H, int T, int regime, float* out,
               void* stream) {
  if (u < 0 || H < 16 || H > HMAX || H % 16 != 0 || T < TT || T % TT != 0) return ERR_SHAPE;
  if (regime < 0 || regime > 3) return ERR_PRECISION;
  if (u == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (regime == 0 || regime == 1) {
    const int blocks = (u + R - 1) / R;
    if (regime == 0) {
      set_smem(rowsum_fp32_kernel<0>, rowsum_fp32_smem());
      rowsum_fp32_kernel<0><<<blocks, THREADS, rowsum_fp32_smem(), st>>>(h, w, u, H, T, out);
    } else {
      set_smem(rowsum_fp32_kernel<2>, rowsum_fp32_smem());
      rowsum_fp32_kernel<2><<<blocks, THREADS, rowsum_fp32_smem(), st>>>(h, w, u, H, T, out);
    }
  } else {
    const int blocks = (u + TBM - 1) / TBM;
    if (regime == 2) {
      set_smem(rowsum_tc_kernel<false>, rowsum_tc_smem<false>());
      rowsum_tc_kernel<false><<<blocks, THREADS, rowsum_tc_smem<false>(), st>>>(h, w, u, H, T,
                                                                               out);
    } else {
      set_smem(rowsum_tc_kernel<true>, rowsum_tc_smem<true>());
      rowsum_tc_kernel<true><<<blocks, THREADS, rowsum_tc_smem<true>(), st>>>(h, w, u, H, T, out);
    }
  }
  return (int)cudaGetLastError();
}

// K14: out (n) = 1.
int hbm_write(float* out, long long n, void* stream) {
  if (n < 0) return ERR_SHAPE;
  if (n == 0) return 0;
  const size_t n4 = aligned16(out) ? (size_t)n / 4 : 0;
  hbm_write_kernel<<<stream_blocks(n4 ? n4 : (size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
      out, (size_t)n, n4);
  return (int)cudaGetLastError();
}

// K15: y (n) = 2 x.
int hbm_scale_copy(const float* x, float* y, long long n, void* stream) {
  if (n < 0) return ERR_SHAPE;
  if (n == 0) return 0;
  const size_t n4 = aligned16(x) && aligned16(y) ? (size_t)n / 4 : 0;
  hbm_scale_copy_kernel<<<stream_blocks(n4 ? n4 : (size_t)n), THREADS, 0,
                          (cudaStream_t)stream>>>(x, y, (size_t)n, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
