// Block-banded transpose matvec: y[t, j] = sum_i W[t]_ij x[t, i], read
// straight from the forward window tiles (no W^T band is built).
//
// Replaces pyqsm_tpu/ops/pallas_kernels.py:227 band_matvec_t_pallas (the
// TPU kernel that loads the three neighbouring [256, 768] tiles of each
// output block into VMEM and contracts their column slices over the row
// axis on the MXU).
//
// Layout: bw[T, nb, 256, 768]; row tile a holds W[a*256 + r, (a-1)*256 + col]
// for col in [0, 768). Output block c therefore sums
//   - tile c,   columns [256, 512), times x block c;
//   - tile c-1, columns [512, 768), times x block c-1;
//   - tile c+1, columns [0, 256),   times x block c+1;
// a neighbour tile past either end counts as zero. x and y are
// [T, nb*256, 3] float32, row-major.
//
// Bound: memory, like the forward kernel. Every weight is read once over
// the whole launch (each tile's three column thirds feed three different
// output blocks) for 2*3 flops per 4-byte weight, far below the card's
// float32 ridge. The design streams W coalesced and keeps everything else
// on chip:
//   - one thread block per (output block, tree), one thread per output
//     row j; lane j reads W[a, i, off + j], so a warp reads 128 contiguous
//     bytes of a tile row per step;
//   - the three x blocks it needs (768 x 3 floats, 9 KB) are staged in
//     shared memory once; every lane reads the same row i in the same step,
//     so those reads are broadcasts;
//   - the row loop is unrolled so that each thread keeps several
//     independent loads in flight; sums are float32 in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kBS = 256;       // rows per band block
constexpr int kW3 = 3 * kBS;   // window width
constexpr int kC = 3;          // x width on the contraction path
constexpr int kThreads = kBS;  // one thread per output row of the block
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
band_matvec_t_c3_kernel(const float* __restrict__ bw, const float* __restrict__ x,
                        float* __restrict__ y, int nb) {
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int j = threadIdx.x;
  const long long n = static_cast<long long>(nb) * kBS;
  // xs[s] holds x block c-1+s (s = 0, 1, 2), zero past either end
  __shared__ float xs[3][kBS * kC];

  const float* xt = x + static_cast<long long>(t) * n * kC;
  const long long base = (static_cast<long long>(c) - 1) * kBS;
  for (int k = threadIdx.x; k < kW3 * kC; k += kThreads) {
    const long long r = base + k / kC;
    xs[k / (kBS * kC)][k % (kBS * kC)] = (r >= 0 && r < n) ? xt[base * kC + k] : 0.0f;
  }
  __syncthreads();

  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  // (source block offset s, column offset of block c inside that tile)
  const int offs[3] = {2 * kBS, kBS, 0};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int a = c - 1 + s;
    if (a < 0 || a >= nb) continue;
    const float* col = bw + (static_cast<long long>(t) * nb + a) * kBS * kW3 + offs[s] + j;
    const float* xa = xs[s];
    for (int i0 = 0; i0 < kBS; i0 += kUnroll) {
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(col + static_cast<long long>(i0 + u) * kW3);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* xr = xa + (i0 + u) * kC;
        a0 += w[u] * xr[0];
        a1 += w[u] * xr[1];
        a2 += w[u] * xr[2];
      }
    }
  }
  float* yr = y + (static_cast<long long>(t) * n + static_cast<long long>(c) * kBS + j) * kC;
  yr[0] = a0;
  yr[1] = a1;
  yr[2] = a2;
}

}  // namespace

extern "C" {

// bw [trees, nb, 256, 768], x and y [trees, nb*256, 3], all float32 and
// contiguous. Launches on `stream`; returns the launch's cudaError_t
// (0 = success). Does not synchronise.
int band_matvec_t_f32_c3(const float* bw, const float* x, float* y, int trees, int nb,
                         void* stream) {
  if (trees <= 0 || nb <= 0) return 0;
  if (trees > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(trees));
  band_matvec_t_c3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bw, x, y, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* band_matvec_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
