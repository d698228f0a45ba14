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
// tile; each (row, column) is one chain over k ascending from zero, a row's
// sum is taken over a thread's columns and the tiles in order, then over the
// row's threads by a fixed shuffle tree: it comes from one block, no
// cross-block reduction, bitwise stable run to run.
//   regime 0 'highest': fp32 FMA on the CUDA cores, an SGEMM main loop
//     (rowsum_sgemm_kernel): 128 x 128 block tiles, an 8 x 8 register tile
//     a thread fed by four float4 shared loads a k, the block's h tile
//     stored k-major once, w streamed in 32-deep slabs through a 3-stage
//     16-byte cp.async ring with one barrier a slab; two blocks an SM.
//     Bound: operations at the fp32 CUDA-core peak.
//   regimes 1 'default' and 2 'bf16': one function (a bf16 product is exact
//     in fp32, the sums are fp32), so one kernel: bf16 operands on the
//     tensor cores, fp32 accumulate (mma.sync m16n8k16), 256-row tiles,
//     8 warps of 64 rows x 64 columns, a 3-stage ring.
//   regime 3 'bf16x3': hi(h)hi(w) + hi(h)lo(w) + lo(h)hi(w) on the tensor
//     cores into one fp32 accumulator (the bf16 hi/lo split of 'high'),
//     128-row tiles, 8 warps of 32 x 64, a 2-stage ring.
//   For 1-3 a prep kernel writes w^T in bf16 (hi, and lo for 3) once a call
//   into the wrapper's scratch, each 128-column tile as the image its ring
//   stage holds (k contiguous, as the B fragments want); the main kernel
//   splits its h tile once, copies each image with 16-byte cp.async (one
//   barrier a tile) and reads both operands with ldmatrix. Bound:
//   operations at the bf16 tensor peak (x3 for 3). Next step: wgmma.
//
// K14: each thread issues four 16-byte stores, each block once over its own
// 16 KB (measured against the first design's grid-stride loop and against
// TMA bulk stores of a shared-memory tile of ones over 64 or 256 KB a
// block, both slower); scalar stores where out is not 16-byte aligned.
// Bound: bytes.
// K15: each thread issues four independent 16-byte loads before their
// stores, each block once over its own 16 KB (a grid-stride loop over a
// grid of whole waves, and streaming cache hints, measured slower); scalar
// accesses where an address is not 16-byte aligned. Bound: bytes.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HMAX = 128;   // widest h the K13 kernels take
constexpr int TN = 128;     // columns per tile (T must be a multiple)

template <typename F>
void set_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
// the same, zero-filled (nothing read) where !valid
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --------------------- K13 'highest': the CUDA cores ---------------------- //

constexpr int SG_M = 128;   // rows per block
constexpr int SG_BK = 32;   // k per w slab
constexpr int SG_NS = 3;    // slabs in the ring

// k rounded up to whole slabs: the h tile and the slabs are zero past H
__host__ __device__ constexpr int sgemm_kp(int H) { return (H + SG_BK - 1) / SG_BK * SG_BK; }

size_t rowsum_sgemm_smem(int H) {
  return sizeof(float) * ((size_t)sgemm_kp(H) * SG_M + SG_NS * SG_BK * TN);
}

// Thread (tx, ty) = (tid % 16, tid / 16) holds rows ty*4 + i and 64 + ty*4 + i
// and columns tx*4 + j and 64 + tx*4 + j (i, j < 4) of each 128 x 128 tile.
__global__ void __launch_bounds__(THREADS, 2)
rowsum_sgemm_kernel(const float* __restrict__ h, const float* __restrict__ w, int u, int H,
                    int T, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  const int kp = sgemm_kp(H);
  float* a_s = reinterpret_cast<float*>(smem_f4);  // kp x SG_M, k-major
  float* b_s = a_s + (size_t)kp * SG_M;             // SG_NS x SG_BK x TN
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * SG_M;
  const int ks = kp / SG_BK, slabs = (T / TN) * ks;

  // slab s: columns [(s / ks) TN, + TN), k [(s % ks) SG_BK, + SG_BK), rows
  // past H zero-filled; one commit group a call, empty past the last slab
  auto issue = [&](int s) {
    if (s < slabs) {
      const int t0 = (s / ks) * TN, k0 = (s % ks) * SG_BK;
      float* dst = b_s + (s % SG_NS) * SG_BK * TN;
#pragma unroll
      for (int c = tid; c < SG_BK * TN / 4; c += THREADS) {
        const int kk = c >> 5, q = c & 31;
        const bool in = k0 + kk < H;
        cp_async16z(dst + kk * TN + 4 * q, in ? w + (size_t)(k0 + kk) * T + t0 + 4 * q : w, in);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < SG_NS - 1; ++s) issue(s);

  // the h tile once, k-major (a warp stores 32 rows of one k: no conflicts)
  for (int c = tid; c < SG_M * (kp / 4); c += THREADS) {
    const int r = c & (SG_M - 1), k = 4 * (c >> 7);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < u && k < H) v = *reinterpret_cast<const float4*>(h + (size_t)(r0 + r) * H + k);
    a_s[(k + 0) * SG_M + r] = v.x;
    a_s[(k + 1) * SG_M + r] = v.y;
    a_s[(k + 2) * SG_M + r] = v.z;
    a_s[(k + 3) * SG_M + r] = v.w;
  }

  float acc[8][8], run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int s = 0; s < slabs; ++s) {
    cp_wait<SG_NS - 2>();
    __syncthreads();        // slab s landed for all; slab s - 1's stage is free
    issue(s + SG_NS - 1);
    const float* as = a_s + (s % ks) * SG_BK * SG_M + ty * 4;
    const float* bs = b_s + (s % SG_NS) * SG_BK * TN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * SG_M);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * SG_M + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * TN + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s % ks == ks - 1) {   // the column tile is complete
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sum += acc[i][j];
          acc[i][j] = 0.f;
        }
        run[i] += sum;
      }
    }
  }
  // a row's 16 threads (tx, lanes of one half-warp) by a fixed butterfly
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = run[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    const int r = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (tx == 0 && r < u) out[r] = v;
  }
}

// -------------------- K13 'default' / 'bf16' / 'bf16x3' -------------------- //

constexpr int SK = HMAX + 8;    // bf16 row stride of the operand tiles (272 bytes:
                                // the 8 rows of an ldmatrix phase on distinct banks)

__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(first)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(second)) << 16);
}

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), for a pair of values.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - bf16r(x0), x1 - bf16r(x1));
}

// d = a b + (ZERO ? 0 : d): A 16 x 16 row-major, B 16 x 8 column-major,
// bf16, fp32 accumulate.
template <bool ZERO = false>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if (ZERO) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// w^T in bf16 as the ring's stages hold it: column tile j is one image of
// NP parts (hi, then lo) x TN columns x SK (k contiguous, H used), so that a
// stage is one contiguous copy.
template <bool X3>
__host__ __device__ constexpr size_t tile_image() { return (size_t)(X3 ? 2 : 1) * TN * SK; }

// w (H, T) -> the images of w^T: hi = bf16(w), lo = bf16(w - hi) where X3.
// A block takes 32 columns of w through shared memory; reads and writes are
// whole rows.
template <bool X3>
__global__ void __launch_bounds__(THREADS)
rowsum_prep_kernel(const float* __restrict__ w, int H, int T, uint32_t* __restrict__ img) {
  __shared__ float s[HMAX][33];
  const int t0 = blockIdx.x * 32, hw = H / 2;
  for (int i = threadIdx.x; i < H * 32; i += THREADS) {
    const int k = i >> 5, c = i & 31;
    s[k][c] = w[(size_t)k * T + t0 + c];
  }
  __syncthreads();
  uint32_t* dst = img + (t0 / TN) * tile_image<X3>() / 2 + (t0 % TN) * (SK / 2);
  for (int i = threadIdx.x; i < 32 * hw; i += THREADS) {
    const int c = i / hw, kp = i - c * hw;
    uint32_t hi, lo;
    split_pair(s[2 * kp][c], s[2 * kp + 1][c], hi, lo);
    dst[c * (SK / 2) + kp] = hi;
    if (X3) dst[(TN + c) * (SK / 2) + kp] = lo;
  }
}

// A block: 4 x 2 warps, warp (wr, wc) rows wr * 16 MI + [0, 16 MI), columns
// wc * 64 + [0, 64) of each 128-column tile; NS stages of the w^T ring.
template <bool X3, int MI, int NS>
struct TcPlan {
  static constexpr int M = 64 * MI;           // rows a block
  static constexpr int NP = X3 ? 2 : 1;       // operand parts: hi (, lo)
  static constexpr size_t A_ELEMS = (size_t)NP * M * SK;
  static constexpr size_t STAGE = tile_image<X3>();
  static constexpr int CHUNKS = (int)(STAGE / 8);   // 16-byte copies a stage
  static constexpr size_t SMEM = 2 * (A_ELEMS + NS * STAGE) + sizeof(float) * 2 * M;
};

// One k step (16 deep) of a warp's tile: A from the split h tile, B from the
// stage, both by ldmatrix; FIRST starts every chain from zero.
template <bool X3, int MI, bool FIRST>
__device__ __forceinline__ void tc_kstep(float (&acc)[MI][8][4], const uint16_t* a_lane,
                                         const uint16_t* b_lane, int a_lo, int k) {
  uint32_t ah[MI][4], al[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    ldmatrix_x4(ah[mi], a_lane + mi * 16 * SK + k);
    if (X3) ldmatrix_x4(al[mi], a_lane + a_lo + mi * 16 * SK + k);
  }
#pragma unroll
  for (int np = 0; np < 4; ++np) {           // n8 tiles 2 np and 2 np + 1
    uint32_t bh[4], bl[4];
    ldmatrix_x4(bh, b_lane + np * 16 * SK + k);
    if (X3) ldmatrix_x4(bl, b_lane + TN * SK + np * 16 * SK + k);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * np + half;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16<FIRST>(acc[mi][nt], ah[mi], bh[2 * half], bh[2 * half + 1]);
        if (X3) {
          mma_bf16(acc[mi][nt], ah[mi], bl[2 * half], bl[2 * half + 1]);
          mma_bf16(acc[mi][nt], al[mi], bh[2 * half], bh[2 * half + 1]);
        }
      }
    }
  }
}

template <bool X3, int MI, int NS>
__global__ void __launch_bounds__(THREADS, 1)
rowsum_tc_kernel(const float* __restrict__ h, const uint16_t* __restrict__ img, int u, int H,
                 int T, float* __restrict__ out) {
  using P = TcPlan<X3, MI, NS>;
  constexpr int M = P::M;
  extern __shared__ float4 smem_f4[];
  uint16_t* a_s = reinterpret_cast<uint16_t*>(smem_f4);   // hi, then lo at M * SK
  uint16_t* b_s = a_s + P::A_ELEMS;                        // NS stage images
  float* part = reinterpret_cast<float*>(b_s + NS * P::STAGE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int r0 = blockIdx.x * M;

  // column tile j's image into its stage; one commit group a call
  auto issue = [&](int j) {
    if (j * TN < T) {
      const float4* src = reinterpret_cast<const float4*>(img + j * P::STAGE);
      float4* dst = reinterpret_cast<float4*>(b_s + (j % NS) * P::STAGE);
#pragma unroll
      for (int c = threadIdx.x; c < P::CHUNKS; c += THREADS) cp_async16(dst + c, src + c);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) issue(j);

  // the h tile, split once (zero past u)
  for (int c = threadIdx.x; c < M * (H / 4); c += THREADS) {
    const int r = c / (H / 4), k = 4 * (c - r * (H / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < u) v = *reinterpret_cast<const float4*>(h + (size_t)(r0 + r) * H + k);
    uint2 hi, lo;
    split_pair(v.x, v.y, hi.x, lo.x);
    split_pair(v.z, v.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(a_s + r * SK + k) = hi;
    if (X3) *reinterpret_cast<uint2*>(a_s + M * SK + r * SK + k) = lo;
  }

  // ldmatrix row addresses: A rows (lane % 16), k + 8 (lane / 16); B columns
  // 8 (lane / 16) + lane % 8, k + 8 ((lane / 8) % 2)
  const uint16_t* a_lane = a_s + (wr * 16 * MI + (lane & 15)) * SK + (lane >> 4) * 8;
  const int b_lane = (wc * 64 + ((lane >> 4) << 3) + (lane & 7)) * SK + ((lane >> 3) & 1) * 8;
  float run[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) run[mi][0] = run[mi][1] = 0.f;

  for (int j = 0; j * TN < T; ++j) {
    cp_wait<NS - 2>();
    __syncthreads();        // tile j landed for all; tile j - 1's stage is free
    issue(j + NS - 1);
    const uint16_t* b = b_s + (j % NS) * P::STAGE + b_lane;
    float acc[MI][8][4];
    tc_kstep<X3, MI, true>(acc, a_lane, b, M * SK, 0);
    for (int k = 16; k < H; k += 16) tc_kstep<X3, MI, false>(acc, a_lane, b, M * SK, k);
    // the tile's partial of rows g and g + 8 (per m16 tile), over this
    // thread's columns, then into the running sums
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
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
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = run[mi][half];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tg == 0) part[wc * M + wr * 16 * MI + mi * 16 + half * 8 + g] = v;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < M; r += THREADS)
    if (r0 + r < u) out[r0 + r] = part[r] + part[M + r];
}

template <bool X3, int MI, int NS>
int launch_rowsum_tc(const float* h, const float* w, int u, int H, int T, float* out,
                     void* scratch, cudaStream_t st) {
  using P = TcPlan<X3, MI, NS>;
  rowsum_prep_kernel<X3><<<T / 32, THREADS, 0, st>>>(w, H, T, (uint32_t*)scratch);
  set_smem(rowsum_tc_kernel<X3, MI, NS>, P::SMEM);
  rowsum_tc_kernel<X3, MI, NS><<<(u + P::M - 1) / P::M, THREADS, P::SMEM, st>>>(
      h, (const uint16_t*)scratch, u, H, T, out);
  return (int)cudaGetLastError();
}

// ------------------------------- K14 / K15 --------------------------------- //

constexpr int WRITE_UNROLL = 4;   // 16-byte stores a thread: a block writes 16 KB

// Each block writes THREADS * WRITE_UNROLL float4 once, no loop (a grid of
// about 160,000 blocks at the probe's size).
__global__ void __launch_bounds__(THREADS) hbm_write_kernel(float* __restrict__ out, size_t n,
                                                            size_t n4) {
  float4* o4 = reinterpret_cast<float4*>(out);
  const size_t base = (size_t)blockIdx.x * THREADS * WRITE_UNROLL + threadIdx.x;
  if (n4) {
#pragma unroll
    for (int q = 0; q < WRITE_UNROLL; ++q)
      if (base + q * THREADS < n4) o4[base + q * THREADS] = make_float4(1.f, 1.f, 1.f, 1.f);
    if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) out[4 * n4 + threadIdx.x] = 1.f;
  } else {
#pragma unroll
    for (int q = 0; q < WRITE_UNROLL; ++q)
      if (base + q * THREADS < n) out[base + q * THREADS] = 1.f;
  }
}

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

constexpr int COPY_UNROLL = 4;   // 16-byte loads in flight a thread

// Each block takes THREADS * COPY_UNROLL float4 once (a grid of about 160,000
// blocks at the probe's size): each thread's loads are all issued before
// its stores.
__global__ void __launch_bounds__(THREADS) hbm_scale_copy_kernel(const float* __restrict__ x,
                                                                 float* __restrict__ y, size_t n,
                                                                 size_t n4) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const size_t base = (size_t)blockIdx.x * THREADS * COPY_UNROLL + threadIdx.x;
  if (n4) {
    float4 v[COPY_UNROLL];
#pragma unroll
    for (int q = 0; q < COPY_UNROLL; ++q)
      if (base + q * THREADS < n4) v[q] = x4[base + q * THREADS];
#pragma unroll
    for (int q = 0; q < COPY_UNROLL; ++q)
      if (base + q * THREADS < n4) y4[base + q * THREADS] = twice(v[q]);
    if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)
      y[4 * n4 + threadIdx.x] = 2.f * x[4 * n4 + threadIdx.x];
  } else {
#pragma unroll
    for (int q = 0; q < COPY_UNROLL; ++q)
      if (base + q * THREADS < n) y[base + q * THREADS] = 2.f * x[base + q * THREADS];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* probe_error_string(int code) { return port_error_string(code); }

// K13: h (u, H), w (H, T) -> out (u) = row sums of h w. regime: 0 'highest',
// 1 'default', 2 'bf16', 3 'bf16x3'. Takes H a multiple of 16 up to 128 and
// T a multiple of 128; h, w 16-byte aligned. scratch: rowsum_scratch_elems
// bf16 (the images of w^T), 16-byte aligned.
int rowsum_dot(const float* h, const float* w, int u, int H, int T, int regime, float* out,
               void* scratch, void* stream) {
  if (u < 0 || H < 16 || H > HMAX || H % 16 != 0 || T < TN || T % TN != 0) return ERR_SHAPE;
  if (regime < 0 || regime > 3) return ERR_PRECISION;
  if (u == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (regime == 0) {
    const size_t smem = rowsum_sgemm_smem(H);
    set_smem(rowsum_sgemm_kernel, smem);
    rowsum_sgemm_kernel<<<(u + SG_M - 1) / SG_M, THREADS, smem, st>>>(h, w, u, H, T, out);
    return (int)cudaGetLastError();
  }
  if (regime == 3) return launch_rowsum_tc<true, 2, 2>(h, w, u, H, T, out, scratch, st);
  return launch_rowsum_tc<false, 4, 3>(h, w, u, H, T, out, scratch, st);
}

// bf16 elements of K13's scratch for a regime at T columns: the images of
// w^T (tile_image per 128-column tile), none for 'highest'.
long long rowsum_scratch_elems(int T, int regime) {
  if (regime == 0) return 0;
  const long long tiles = (T + TN - 1) / TN;
  return tiles * (long long)(regime == 3 ? tile_image<true>() : tile_image<false>());
}

// K14: out (n) = 1.
int hbm_write(float* out, long long n, void* stream) {
  if (n < 0) return ERR_SHAPE;
  if (n == 0) return 0;
  const size_t n4 = aligned16(out) ? (size_t)n / 4 : 0;
  const size_t units = n4 ? n4 : (size_t)n, per_block = (size_t)THREADS * WRITE_UNROLL;
  hbm_write_kernel<<<(unsigned)((units + per_block - 1) / per_block), THREADS, 0,
                     (cudaStream_t)stream>>>(out, (size_t)n, n4);
  return (int)cudaGetLastError();
}

// K15: y (n) = 2 x.
int hbm_scale_copy(const float* x, float* y, long long n, void* stream) {
  if (n < 0) return ERR_SHAPE;
  if (n == 0) return 0;
  const size_t n4 = aligned16(x) && aligned16(y) ? (size_t)n / 4 : 0;
  const size_t units = n4 ? n4 : (size_t)n, per_block = (size_t)THREADS * COPY_UNROLL;
  hbm_scale_copy_kernel<<<(unsigned)((units + per_block - 1) / per_block), THREADS, 0,
                          (cudaStream_t)stream>>>(x, y, (size_t)n, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
