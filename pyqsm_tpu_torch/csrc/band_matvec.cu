// Block-banded matvec for the contraction CG: y[t, i] = sum_j W[t]_ij x[t, j].
//
// Replaces pyqsm_tpu/ops/pallas_kernels.py:183 band_matvec_pallas (the TPU
// kernel that streams each [256, 768] window tile into VMEM once and runs
// the window product on the MXU).
//
// Layout: W is stored as window tiles bw[T, nb, 256, 768]; output block b of
// tree t multiplies its tile by the concatenated x blocks b-1, b, b+1 (zero
// halo past either end). x and y are [T, nb*256, 3] float32, row-major.
//
// Bound: memory. Each apply reads every tile once (768 floats per output
// row, 3 KB) and does 2*3 flops per 4-byte weight (1.5 flop/byte at C = 3),
// far below the card's ~20 flop/byte float32 ridge. So the design only
// tries to stream W at full rate:
//   - one thread block per (band block, tree); the three x blocks it needs
//     (768 x 3 floats, 9 KB) are staged in shared memory once, channel-major
//     so that 16-byte reads by neighbouring lanes are conflict-free; rows
//     past the ends read as zeros by bounds (no padded copy of x);
//   - each warp walks rows of the tile; a row is 192 float4, so every lane
//     issues 6 independent 16-byte __ldg loads (fully coalesced, all in
//     flight before the first FMA), accumulates 3 float32 sums and the warp
//     reduces them with shuffles;
//   - W is touched exactly once, x comes from L2/shared, y is 12 B per row.
// Tensor cores would not help: the product is a [256 x 768] x [768 x 3]
// GEMV-like shape whose time is the tile read.

#include <cuda_runtime.h>

namespace {

constexpr int kBS = 256;            // rows per band block
constexpr int kW3 = 3 * kBS;        // window width
constexpr int kC = 3;               // x width on the contraction path
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVecPerLane = kW3 / 4 / 32;  // float4 loads per lane per row

__global__ void __launch_bounds__(kThreads)
band_matvec_c3_kernel(const float* __restrict__ bw, const float* __restrict__ x,
                      float* __restrict__ y, int nb) {
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const long long n = static_cast<long long>(nb) * kBS;
  __shared__ __align__(16) float xs[kC][kW3];

  const float* xt = x + static_cast<long long>(t) * n * kC;
  const long long base = (static_cast<long long>(b) - 1) * kBS;
  for (int i = threadIdx.x; i < kW3; i += kThreads) {
    const long long r = base + i;
    const bool in = (r >= 0) && (r < n);
#pragma unroll
    for (int c = 0; c < kC; ++c) xs[c][i] = in ? xt[r * kC + c] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* tile = reinterpret_cast<const float4*>(
      bw + (static_cast<long long>(t) * nb + b) * kBS * kW3);
  float* yt = y + (static_cast<long long>(t) * n + static_cast<long long>(b) * kBS) * kC;

  for (int row = warp; row < kBS; row += kWarps) {
    const float4* wr = tile + static_cast<long long>(row) * (kW3 / 4);
    float4 w[kVecPerLane];
#pragma unroll
    for (int v = 0; v < kVecPerLane; ++v) w[v] = __ldg(wr + v * 32 + lane);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int v = 0; v < kVecPerLane; ++v) {
      const int j = (v * 32 + lane) * 4;
      const float4 x0 = *reinterpret_cast<const float4*>(&xs[0][j]);
      const float4 x1 = *reinterpret_cast<const float4*>(&xs[1][j]);
      const float4 x2 = *reinterpret_cast<const float4*>(&xs[2][j]);
      a0 += w[v].x * x0.x + w[v].y * x0.y + w[v].z * x0.z + w[v].w * x0.w;
      a1 += w[v].x * x1.x + w[v].y * x1.y + w[v].z * x1.z + w[v].w * x1.w;
      a2 += w[v].x * x2.x + w[v].y * x2.y + w[v].z * x2.z + w[v].w * x2.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    if (lane == 0) {
      yt[row * kC + 0] = a0;
      yt[row * kC + 1] = a1;
      yt[row * kC + 2] = a2;
    }
  }
}

}  // namespace

extern "C" {

// bw [trees, nb, 256, 768], x and y [trees, nb*256, 3], all float32,
// contiguous, 16-byte aligned. Launches on `stream`; returns the launch's
// cudaError_t (0 = success). Does not synchronise.
int band_matvec_f32_c3(const float* bw, const float* x, float* y, int trees,
                       int nb, void* stream) {
  if (trees <= 0 || nb <= 0) return 0;
  if (trees > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(trees));
  band_matvec_c3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bw, x, y, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* band_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
