// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface,
// loaded with ctypes; see ops/cuda/build.py).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Matmul precision contract (ops/precision.py), applied per multiply-add:
//   P = 0 'highest': fp32 fma
//   P = 1 'high':    hi(a)hi(b) + hi(a)lo(b) + lo(a)hi(b), bf16 hi/lo split,
//                    each bf16 product exact in fp32
//   P = 2 'default': one bf16-rounded product
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int P>
__device__ __forceinline__ float pfma(float a, float b, float acc) {
  if (P == 0) return fmaf(a, b, acc);
  if (P == 2) return fmaf(bf16r(a), bf16r(b), acc);
  const float ah = bf16r(a), al = bf16r(a - ah);
  const float bh = bf16r(b), bl = bf16r(b - bh);
  acc = fmaf(ah, bh, acc);
  acc = fmaf(ah, bl, acc);
  return fmaf(al, bh, acc);
}

// Error codes returned to Python: >0 a cudaError_t, <0 a shape refusal.
#define ERR_SHAPE (-1)
#define ERR_PRECISION (-2)

#define DISPATCH_PREC(prec, ...)                     \
  switch (prec) {                                    \
    case 0: { constexpr int P = 0; __VA_ARGS__; } break; \
    case 1: { constexpr int P = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int P = 2; __VA_ARGS__; } break; \
    default: return ERR_PRECISION;                   \
  }

// Phase marks of the instrumented builds (tools/k11_phases.py builds
// hpd_full.cu with -DHPD_FULL_PHASES and hpd_tail.cu with -DHPD_TAIL_PHASES,
// tools/k3_phases.py hidden.cu with -DHIDDEN_PHASES): thread 0 of a block
// sums the clock64() ticks of each phase into a __device__ array (a phase
// that ends at a barrier counts the block's time). In a normal build the
// marks compile to nothing.
#if defined(HPD_FULL_PHASES) || defined(HIDDEN_PHASES) || defined(HPD_TAIL_PHASES)
// the ticks of src into out, then zeroed if reset
template <int NP>
int read_phases(unsigned long long (&src)[NP], unsigned long long* out, int reset) {
  int err = (int)cudaMemcpyFromSymbol(out, src, sizeof(unsigned long long) * NP);
  if (!err && reset) {
    const unsigned long long zero[NP] = {};
    err = (int)cudaMemcpyToSymbol(src, zero, sizeof(zero));
  }
  return err;
}
#define PHASE_START(n) unsigned long long ph_[n] = {}, tc0_ = clock64(), tc1_
#define PHASE_MARK(i)      \
  do {                     \
    tc1_ = clock64();      \
    ph_[i] += tc1_ - tc0_; \
    tc0_ = tc1_;           \
  } while (0)
#define PHASE_SYNC_MARK(i) \
  do {                     \
    __syncthreads();       \
    PHASE_MARK(i);         \
  } while (0)
#define PHASE_END(arr, n) \
  if (threadIdx.x == 0)   \
    for (int i_ = 0; i_ < n; ++i_) atomicAdd(&arr[i_], ph_[i_])
#else
#define PHASE_START(n)
#define PHASE_MARK(i)
#define PHASE_SYNC_MARK(i)
#define PHASE_END(arr, n)
#endif

static inline const char* port_error_string(int code) {
  if (code == ERR_SHAPE) return "shape not supported by the kernel";
  if (code == ERR_PRECISION) return "unknown precision code";
  return cudaGetErrorString((cudaError_t)code);
}
