// Deterministic serial scatter-add: out (T, C) = segment_sum(rows, idx, T).
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/scatter_probe.py:
// scatter_add_vmem, which holds the (T, C) accumulator in VMEM and adds the
// rows one after another in row order (one read-modify-write per row).
//
// On this card: the caller hands a stable permutation of the row ids by
// slot (`order`) and each slot's range in it (`offsets`, T + 1 entries);
// one warp per slot, one lane per column, adds the slot's rows in ascending
// row order starting from 0. That is, slot by slot, the same sequence of
// fp32 additions as the serial kernel: bitwise its result, with no atomics.
// Bound: bytes (each row read once, 4 C bytes, plus the permutation; the
// output written once). What holds it back is the longest slot, one warp's
// chain of adds: top-K at random init puts 84,069 of 647,168 rows on one
// slot (about 10 ms a launch on an H100 SXM, against a bound of 0.03 ms).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
scatter_serial_kernel(const float* __restrict__ rows, const int* __restrict__ order,
                      const int* __restrict__ offsets, int T, int C, float* __restrict__ out) {
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= T) return;
  const int beg = offsets[slot], end = offsets[slot + 1];
  for (int col = lane; col < C; col += 32) {
    float acc = 0.f;
    // unrolled so several loads are in flight; the adds stay in row order
#pragma unroll 8
    for (int j = beg; j < end; ++j) acc += rows[(size_t)order[j] * C + col];
    out[(size_t)slot * C + col] = acc;
  }
}

}  // namespace

extern "C" {

const char* scatter_error_string(int code) { return port_error_string(code); }

// rows (n, C), order (n) row ids sorted stably by slot, offsets (T + 1)
// -> out (T, C).
int scatter_add_serial(const float* rows, const int* order, const int* offsets, int T, int C,
                       float* out, void* stream) {
  if (T < 0 || C < 1) return ERR_SHAPE;
  if (T == 0) return 0;
  const unsigned blocks = (unsigned)((T + WARPS - 1) / WARPS);
  scatter_serial_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(rows, order, offsets, T, C,
                                                                     out);
  return (int)cudaGetLastError();
}

}  // extern "C"
