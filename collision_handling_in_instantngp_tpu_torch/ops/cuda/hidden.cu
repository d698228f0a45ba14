// Fused ReLU hidden stack of the HPD index network, forward and backward.
//
// Replaces collision_handling_in_instantngp_tpu/ops/pallas/hidden.py:
// hidden_stack_pallas (_fwd_kernel, _bwd_kernel): h = relu(...relu(x W0 + b0)
// ... W_{n-1} + b_{n-1}) over the U_c unique-vertex rows, [2 -> 32 -> 64 ->
// 128] on the main path.
//
// Bound on this card: operations. The contractions are 2/32/64 deep, so a
// library GEMM per layer runs far below peak and round-trips every
// activation through device memory; here a block keeps all weights (42 KB)
// and a 32-row tile's activations in shared memory, and only x (8 B/row) and
// h (512 B/row) touch device memory.
//
// Backward: recomputes the forward of each row tile, masks with the
// kernel's ReLU rule pre >= 0, and accumulates dW/db of every layer in
// shared memory. Each block owns a fixed, strided set of row tiles and
// writes one partial; a second kernel sums the partials in block order. No
// atomics, so dW/db are bitwise stable run to run. The vertex coords are
// data: no dx is produced.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int MAX_LAYERS = 4;
constexpr int MAX_WIDTH = 128;
constexpr int MAX_IN_WIDTH = 8;
constexpr int FWD_BLOCKS = 512;
constexpr int BWD_BLOCKS = 256;

struct Stack {
  int n;
  int w[MAX_LAYERS + 1];
  int woff[MAX_LAYERS];  // offset of W_l (w[l] x w[l+1], row-major) in params
  int boff[MAX_LAYERS];  // offset of b_l (w[l+1])
  int total;             // packed parameter count
  int maxw;              // widest layer output
  int pre_total;         // sum of layer output widths
};

int make_stack(int n, const int* widths, Stack* st) {
  if (n < 1 || n > MAX_LAYERS) return ERR_SHAPE;
  if (widths[0] < 1 || widths[0] > MAX_IN_WIDTH) return ERR_SHAPE;
  st->n = n;
  int off = 0, maxw = 0, pre = 0;
  for (int l = 0; l <= n; ++l) st->w[l] = widths[l];
  for (int l = 0; l < n; ++l) {
    if (widths[l + 1] < 1 || widths[l + 1] > MAX_WIDTH) return ERR_SHAPE;
    st->woff[l] = off;
    off += widths[l] * widths[l + 1];
    st->boff[l] = off;
    off += widths[l + 1];
    maxw = widths[l + 1] > maxw ? widths[l + 1] : maxw;
    pre += widths[l + 1];
  }
  st->total = off;
  st->maxw = maxw;
  st->pre_total = pre;
  return 0;
}

size_t fwd_smem(const Stack& st) {
  return sizeof(float) * (st.total + 2 * ROWS * (st.maxw > MAX_IN_WIDTH ? st.maxw : MAX_IN_WIDTH));
}

size_t bwd_smem(const Stack& st) {
  return sizeof(float) * (2 * st.total + ROWS * st.w[0] + ROWS * st.pre_total +
                          2 * ROWS * (st.maxw + 1));
}

template <int P>
__global__ void __launch_bounds__(THREADS)
hidden_fwd_kernel(const float* __restrict__ x, const float* __restrict__ params,
                  float* __restrict__ h, int u, Stack st) {
  extern __shared__ float smem[];
  float* prm = smem;
  const int bw = st.maxw > MAX_IN_WIDTH ? st.maxw : MAX_IN_WIDTH;
  float* buf0 = prm + st.total;
  float* buf1 = buf0 + ROWS * bw;
  for (int i = threadIdx.x; i < st.total; i += THREADS) prm[i] = params[i];
  const int ntiles = (u + ROWS - 1) / ROWS;
  const int d = st.w[0];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * ROWS;
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * d; i += THREADS) {
      const int r = i / d;
      buf0[i] = (r0 + r < u) ? x[(size_t)r0 * d + i] : 0.f;
    }
    __syncthreads();
    float* in = buf0;
    float* out = buf1;
    for (int l = 0; l < st.n; ++l) {
      const int wi = st.w[l], wo = st.w[l + 1];
      const float* W = prm + st.woff[l];
      const float* B = prm + st.boff[l];
      const bool last = (l == st.n - 1);
      for (int i = threadIdx.x; i < ROWS * wo; i += THREADS) {
        const int r = i / wo, j = i - r * wo;
        float acc = 0.f;
        for (int k = 0; k < wi; ++k) acc = pfma<P>(in[r * wi + k], W[k * wo + j], acc);
        const float v = fmaxf(acc + B[j], 0.f);
        if (last) {
          if (r0 + r < u) h[(size_t)(r0 + r) * wo + j] = v;
        } else {
          out[i] = v;
        }
      }
      __syncthreads();
      float* t = in;
      in = out;
      out = t;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
hidden_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gh,
                  const float* __restrict__ params, float* __restrict__ partials,
                  int u, Stack st) {
  extern __shared__ float smem[];
  const int d = st.w[0];
  const int gs = st.maxw + 1;  // padded row stride of the gradient buffers
  float* prm = smem;
  float* acc = prm + st.total;
  float* xin = acc + st.total;
  float* pre = xin + ROWS * d;
  float* g0 = pre + ROWS * st.pre_total;
  float* g1 = g0 + ROWS * gs;
  int preoff[MAX_LAYERS];
  {
    int o = 0;
    for (int l = 0; l < st.n; ++l) {
      preoff[l] = o;
      o += ROWS * st.w[l + 1];
    }
  }
  for (int i = threadIdx.x; i < st.total; i += THREADS) {
    prm[i] = params[i];
    acc[i] = 0.f;
  }
  const int ntiles = (u + ROWS - 1) / ROWS;
  const int wl = st.w[st.n];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * ROWS;
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * d; i += THREADS) {
      const int r = i / d;
      xin[i] = (r0 + r < u) ? x[(size_t)r0 * d + i] : 0.f;
    }
    for (int i = threadIdx.x; i < ROWS * wl; i += THREADS) {
      const int r = i / wl, j = i - r * wl;
      g0[r * gs + j] = (r0 + r < u) ? gh[(size_t)(r0 + r) * wl + j] : 0.f;
    }
    __syncthreads();
    // recompute the forward, keeping pre-activations
    for (int l = 0; l < st.n; ++l) {
      const int wi = st.w[l], wo = st.w[l + 1];
      const float* W = prm + st.woff[l];
      const float* B = prm + st.boff[l];
      const float* prev = l == 0 ? xin : pre + preoff[l - 1];
      float* cur = pre + preoff[l];
      for (int i = threadIdx.x; i < ROWS * wo; i += THREADS) {
        const int r = i / wo, j = i - r * wo;
        float a = 0.f;
        for (int k = 0; k < wi; ++k) {
          const float in = l == 0 ? prev[r * wi + k] : fmaxf(prev[r * wi + k], 0.f);
          a = pfma<P>(in, W[k * wo + j], a);
        }
        cur[i] = a + B[j];
      }
      __syncthreads();
    }
    float* g = g0;
    float* gn = g1;
    for (int l = st.n - 1; l >= 0; --l) {
      const int wi = st.w[l], wo = st.w[l + 1];
      const float* W = prm + st.woff[l];
      const float* cur = pre + preoff[l];
      const float* prev = l == 0 ? xin : pre + preoff[l - 1];
      for (int i = threadIdx.x; i < ROWS * wo; i += THREADS) {
        const int r = i / wo, j = i - r * wo;
        if (!(cur[i] >= 0.f)) g[r * gs + j] = 0.f;  // ReLU mask: pre >= 0 passes
      }
      __syncthreads();
      for (int i = threadIdx.x; i < wi * wo; i += THREADS) {
        const int a = i / wo, j = i - a * wo;
        float s = acc[st.woff[l] + i];
        for (int r = 0; r < ROWS; ++r) {
          const float in = l == 0 ? prev[r * wi + a] : fmaxf(prev[r * wi + a], 0.f);
          s = pfma<P>(in, g[r * gs + j], s);
        }
        acc[st.woff[l] + i] = s;
      }
      for (int j = threadIdx.x; j < wo; j += THREADS) {
        float s = acc[st.boff[l] + j];
        for (int r = 0; r < ROWS; ++r) s += g[r * gs + j];
        acc[st.boff[l] + j] = s;
      }
      if (l > 0) {
        // gn = g @ W^T; r fastest so the padded g rows hit distinct banks
        for (int i = threadIdx.x; i < ROWS * wi; i += THREADS) {
          const int a = i / ROWS, r = i - a * ROWS;
          float s = 0.f;
          for (int j = 0; j < wo; ++j) s = pfma<P>(g[r * gs + j], W[a * wo + j], s);
          gn[r * gs + a] = s;
        }
      }
      __syncthreads();
      float* t = g;
      g = gn;
      gn = t;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < st.total; i += THREADS)
    partials[(size_t)blockIdx.x * st.total + i] = acc[i];
}

__global__ void hidden_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int nblocks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * total + i];
  out[i] = s;
}

int bwd_blocks(int u) {
  const int ntiles = (u + ROWS - 1) / ROWS;
  return ntiles < BWD_BLOCKS ? ntiles : BWD_BLOCKS;
}

}  // namespace

extern "C" {

const char* hidden_error_string(int code) { return port_error_string(code); }

// Rows of the partial buffer hidden_stack_bwd needs: (blocks, packed count).
int hidden_stack_bwd_blocks(int u) { return bwd_blocks(u); }

// x (u, w0), params packed [W0 (w0 x w1), b0, W1, b1, ...] -> h (u, w_n).
int hidden_stack_fwd(const float* x, const float* params, float* h, int u,
                     int n_layers, int w0, int w1, int w2, int w3, int w4,
                     int prec, void* stream) {
  const int widths[MAX_LAYERS + 1] = {w0, w1, w2, w3, w4};
  Stack st;
  int err = make_stack(n_layers, widths, &st);
  if (err) return err;
  if (u <= 0) return 0;
  const size_t smem = fwd_smem(st);
  const int ntiles = (u + ROWS - 1) / ROWS;
  const int grid = ntiles < FWD_BLOCKS ? ntiles : FWD_BLOCKS;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_PREC(prec, {
    cudaFuncSetAttribute(hidden_fwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    hidden_fwd_kernel<P><<<grid, THREADS, smem, s>>>(x, params, h, u, st);
  });
  return (int)cudaGetLastError();
}

// dparams (packed like params) of sum(h * gh); partials: (bwd_blocks(u), total).
int hidden_stack_bwd(const float* x, const float* gh, const float* params,
                     float* partials, float* dparams, int u, int n_layers,
                     int w0, int w1, int w2, int w3, int w4, int prec, void* stream) {
  const int widths[MAX_LAYERS + 1] = {w0, w1, w2, w3, w4};
  Stack st;
  int err = make_stack(n_layers, widths, &st);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (u <= 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * st.total, s);
  const size_t smem = bwd_smem(st);
  const int nb = bwd_blocks(u);
  DISPATCH_PREC(prec, {
    cudaFuncSetAttribute(hidden_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    hidden_bwd_kernel<P><<<nb, THREADS, smem, s>>>(x, gh, params, partials, u, st);
  });
  err = (int)cudaGetLastError();
  if (err) return err;
  hidden_reduce_kernel<<<(st.total + 255) / 256, 256, 0, s>>>(partials, dparams, nb, st.total);
  return (int)cudaGetLastError();
}

}  // extern "C"
