// The streamed logits tiling of hpd_stream.cu's CUDA-core sweeps (the rows
// pass's exact fp32 fix-up and the wide passes, heads past HMAX; its other
// passes run on the tensor cores): a block of THREADS threads holds R rows
// of h in shared memory and computes the (R, TT) product tile by tile, fp32
// FMA on the CUDA cores under the precision contract of common.cuh.
#pragma once

#include "common.cuh"

namespace {

constexpr int R = 64;       // rows per tile
constexpr int TT = 128;     // columns per tile
constexpr int BK = 32;      // contraction chunk of the logits product
constexpr int HMAX = 128;   // widest head input
constexpr int HP = HMAX + 4;
constexpr int THREADS = 256;
constexpr int NSUB = 16;    // column sub-streams per row: thread tx holds columns tx + 16 j

// h rows [r0, r0 + R) into h_s (R x HP), zero past `limit` and past H.
__device__ __forceinline__ void load_rows(const float* __restrict__ h, int limit, int H,
                                          int r0, float* __restrict__ h_s) {
  for (int i = threadIdx.x; i < R * HMAX; i += THREADS) {
    const int r = i / HMAX, k = i - r * HMAX;
    h_s[r * HP + k] = (r0 + r < limit && k < H) ? h[(size_t)(r0 + r) * H + k] : 0.f;
  }
}

// acc += (h w)[rows, t0 + columns] of the tile over k < H, each element one
// fma chain over k ascending. Thread (ty, tx) holds rows ty*4 + i and
// columns tx + 16*j. Starts with a barrier.
template <int P>
__device__ __forceinline__ void tile_dot_acc(const float* __restrict__ h_s,
                                             const float* __restrict__ w, int H, int T, int t0,
                                             float* __restrict__ w_s, float (&acc)[4][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < H; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * TT; i += THREADS) {
      const int kk = i / TT, c = i - kk * TT;
      w_s[i] = (k0 + kk < H) ? w[(size_t)(k0 + kk) * T + t0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = h_s[(ty * 4 + i) * HP + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = w_s[kk * TT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = pfma<P>(a[i], bb[j], acc[i][j]);
    }
  }
}

// (h w)[rows, t0 + columns] of the tile, no bias, as tile_dot_acc from zero.
template <int P>
__device__ __forceinline__ void tile_dot(const float* __restrict__ h_s,
                                         const float* __restrict__ w, int H, int T, int t0,
                                         float* __restrict__ w_s, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  tile_dot_acc<P>(h_s, w, H, T, t0, w_s, acc);
}

// Logits h w + b of the tile rows x columns [t0, t0 + TT), laid out as in
// tile_dot. Starts with a barrier.
template <int P>
__device__ __forceinline__ void tile_logits(const float* __restrict__ h_s,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int H, int T,
                                            int t0, float* __restrict__ w_s,
                                            float (&acc)[4][8]) {
  const int tx = threadIdx.x & 15;
  tile_dot<P>(h_s, w, H, T, t0, w_s, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bj = b[t0 + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] += bj;
  }
}

template <typename F>
void set_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
