// Deterministic serial scatter-add: out (T, C) = segment_sum(rows, idx, T).
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/scatter_probe.py:
// scatter_add_vmem, which holds the (T, C) accumulator in VMEM and adds the
// rows one after another in row order (one read-modify-write per row).
//
// On this card: the caller hands a stable permutation of the row ids by
// slot (`order`) and each slot's range in it (`offsets`, T + 1 entries).
// Each slot's rows are added in ascending row order starting from 0, one
// lane per column: slot by slot the same sequence of fp32 additions as the
// serial kernel, so bitwise its result, with no atomics.
//
// Bound: bytes (each row read once, 4 C bytes, plus the permutation; the
// output written once), but the function fixes one dependent add per row of
// the longest slot: top-K at random init puts 84,069 of 647,168 rows on one
// slot. The design takes every load off that chain:
//   1. scatter_gather_kernel copies the rows into slot order (`sorted`,
//      scratch of the caller): a plain gather over all SMs at the memory
//      rate, so that each slot's rows, and the rows of 8 neighbouring
//      slots, are contiguous;
//   2. scatter_serial_kernel: block b owns slots [8b, 8b + 8), one
//      contiguous range of `sorted`; all 8 warps stream it through a ring of
//      STAGES shared-memory chunks with cp.async (16 B a thread where the
//      rows allow it; no index is read on the way), while warp w adds slot
//      8b + w's rows from shared memory, the next 8 rows' loads in flight
//      during the current 8 adds.
// The hot slot's warp adds from shared memory while its 7 neighbours keep
// the ring full; what then holds the hot block is one SM streaming the
// slot's rows (PERF.md §6), not the adds. Short slots take the same path.
// Columns past 32 go to further blocks (grid.y).
// Narrow rows in short slots (C <= 4 and at most 32 rows a slot on average,
// chosen by the caller, scatter.py: narrow_path; the per-pixel gather's
// gradient, F = 2, 3.7 M rows on 2.6 M slots) take scatter_narrow_kernel
// after step 1 instead: one thread per
// (slot, column) adds the slot's rows in the same order. The ring would
// pay a block's set-up per 11 rows there, with all but C of each warp's
// lanes idle; where slots are long (the per-row blend's gradient: 3.7 M
// rows on 1,024 slots) a thread's serial chain would be slower than the
// ring.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;   // rows per ring stage
constexpr int STAGES = 6;
constexpr int CW = 32;       // columns per block
constexpr size_t SMEM = sizeof(float) * STAGES * CHUNK * CW;

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sorted[j] = rows[order[j]], V floats a thread (V = 4: 16 B).
template <int V>
__global__ void scatter_gather_kernel(const float* __restrict__ rows,
                                      const int* __restrict__ order, int n, int C,
                                      float* __restrict__ sorted) {
  const int per_row = C / V;
  const size_t tasks = (size_t)n * per_row;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < tasks;
       i += (size_t)gridDim.x * THREADS) {
    const size_t j = i / per_row, part = i - j * per_row;
    const float* src = rows + (size_t)order[j] * C + part * V;
    float* dst = sorted + j * C + part * V;
    if (V == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

// V floats per copy (4: 16 B; 1: 4 B). Each thread owns copy tasks
// threadIdx.x + THREADS q of a stage: row task / per_row, part task % per_row.
template <int V>
__global__ void __launch_bounds__(THREADS)
scatter_serial_kernel(const float* __restrict__ sorted, const int* __restrict__ offsets, int T,
                      int C, float* __restrict__ out) {
  constexpr int NQ = CHUNK * (CW / V) / THREADS;  // copy tasks per thread, most
  extern __shared__ float ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * WARPS;
  const int c0 = blockIdx.y * CW;
  const int cw = min(CW, C - c0);
  const int per_row = cw / V;
  const int tasks = CHUNK * per_row;
  const int rb = offsets[s0], re = offsets[min(s0 + WARPS, T)];
  const int nit = (re - rb + CHUNK - 1) / CHUNK;
  const int slot = s0 + warp;
  const int wb = slot < T ? offsets[slot] : re, we = slot < T ? offsets[slot + 1] : re;

  auto fetch = [&](int st) {
    float* buf = ring + (st % STAGES) * CHUNK * CW;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int task = threadIdx.x + THREADS * q;
      const int r = task / per_row, part = task - r * per_row;
      const int j = rb + st * CHUNK + r;
      if (st < nit && task < tasks && j < re)
        cp_async(buf + r * CW + part * V, sorted + (size_t)j * C + c0 + part * V, 4 * V);
    }
  };
  // the adds of stage `it`, in row order, by the warp that owns each slot;
  // the next group's shared-memory loads start before this group's adds
  float acc = 0.f;
  auto add_stage = [&](int it) {
    const int lo = rb + it * CHUNK;
    const int jb = max(wb, lo) - lo, je = min(we, lo + CHUNK) - lo;
    if (lane >= cw || jb >= je) return;
    const float* buf = ring + (it % STAGES) * CHUNK * CW + lane;
    int j = jb;
    float x[8];
    if (j + 8 <= je) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = buf[(j + e) * CW];
      for (; j + 16 <= je; j += 8) {
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = buf[(j + 8 + e) * CW];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += x[e];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = y[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += x[e];
      j += 8;
    }
    for (; j < je; ++j) acc += buf[j * CW];
  };

  for (int st = 0; st < STAGES - 1; ++st) {
    fetch(st);
    cp_commit();
  }
  for (int it = 0; it < nit; ++it) {
    fetch(it + STAGES - 1);
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncthreads();
    add_stage(it);
    __syncthreads();
  }
  cp_wait<0>();
  if (slot < T && lane < cw) out[(size_t)slot * C + c0 + lane] = acc;
}

// out[slot, c] = the slot's rows' column c, added in row order from 0.
__global__ void scatter_narrow_kernel(const float* __restrict__ sorted,
                                      const int* __restrict__ offsets, int T, int C,
                                      float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)T * C) return;
  const int slot = (int)(i / C), c = (int)(i - (size_t)slot * C);
  const int e = offsets[slot + 1];
  float acc = 0.f;
#pragma unroll 4
  for (int j = offsets[slot]; j < e; ++j) acc += sorted[(size_t)j * C + c];
  out[i] = acc;
}

}  // namespace

extern "C" {

const char* scatter_error_string(int code) { return port_error_string(code); }

// rows (n, C), order (n) row ids sorted stably by slot, offsets (T + 1)
// -> out (T, C). sorted: (n, C) scratch. narrow: sum with
// scatter_narrow_kernel (C <= 4) instead of the ring.
int scatter_add_serial(const float* rows, const int* order, const int* offsets, int n, int T,
                       int C, int narrow, float* out, float* sorted, void* stream) {
  if (n < 0 || T < 0 || C < 1 || (narrow && C > 4)) return ERR_SHAPE;
  if (T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = C % 4 == 0 && ((uintptr_t)rows & 15) == 0 && ((uintptr_t)sorted & 15) == 0;
  if (n > 0) {
    // 16 blocks per SM of the card, fewer where the rows need fewer
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const size_t need = ((size_t)n * C / (vec ? 4 : 1) + THREADS - 1) / THREADS;
    const unsigned blocks = (unsigned)std::max<size_t>(1, std::min<size_t>(need, (size_t)sms * 16));
    if (vec)
      scatter_gather_kernel<4><<<blocks, THREADS, 0, st>>>(rows, order, n, C, sorted);
    else
      scatter_gather_kernel<1><<<blocks, THREADS, 0, st>>>(rows, order, n, C, sorted);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (narrow) {
    const size_t cells = (size_t)T * C;
    scatter_narrow_kernel<<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        sorted, offsets, T, C, out);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((T + WARPS - 1) / WARPS), (unsigned)((C + CW - 1) / CW));
  if (vec) {
    cudaFuncSetAttribute(scatter_serial_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM);
    scatter_serial_kernel<4><<<grid, THREADS, SMEM, st>>>(sorted, offsets, T, C, out);
  } else {
    cudaFuncSetAttribute(scatter_serial_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM);
    scatter_serial_kernel<1><<<grid, THREADS, SMEM, st>>>(sorted, offsets, T, C, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
