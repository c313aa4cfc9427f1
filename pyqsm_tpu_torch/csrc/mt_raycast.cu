// Fused Moller-Trumbore closest hit + any-hit count.
//
// Replaces pyqsm_tpu/ops/pallas_kernels.py:110 mt_raycast (the TPU kernel
// that keeps every triangle resident in VMEM as structure-of-arrays rows
// and walks 512-ray tiles through 512-triangle chunks, so the [R, T]
// intersection matrix never reaches HBM).
//
// Inputs: soa[10, T] float32 rows v0 xyz | e1 xyz | e2 xyz | valid (built
// by the wrapper with the same torch ops as the plain version), origins
// and dirs [R, 3] float32. Outputs: t [R] (inf = miss), tri [R] int32
// (-1 = miss), uv [R, 2] (0 on a miss), count [R] int32.
//
// Bound: operations. Each ray-triangle pair costs 46 float32 operations
// (27 multiplies, 18 adds/subtracts, one IEEE reciprocal) plus six
// compares, while the bytes are tiny (24 B in and 20 B out per ray, 40 B
// per triangle). The design keeps the arithmetic fed and nothing else:
//   - one thread per ray, its origin, direction and running best hit in
//     registers;
//   - the block stages 512 triangles at a time into shared memory as SoA
//     rows (20 KB); every lane reads the same triangle in the same step,
//     so those reads are broadcasts with no bank conflicts;
//   - a running closest hit with a strict '<' walked in triangle order, so
//     on equal t the lowest id wins (the rule of both JAX routes), and an
//     int32 count of every finite hit.
// Built with -fmad=false and written in the plain version's order of
// operations: torch's CUDA elementwise ops are unfused and its division is
// IEEE, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // rays per block
constexpr int kChunk = 512;    // triangles staged per step
constexpr int kRows = 10;      // SoA rows
constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = static_cast<float>(1.0 + 1e-9);  // rounds to 1.0f
constexpr float kTMin = 1e-6f;

__global__ void __launch_bounds__(kThreads)
mt_raycast_kernel(const float* __restrict__ soa, int n_tri, const float* __restrict__ o,
                  const float* __restrict__ d, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ uv_out,
                  int* __restrict__ cnt_out, int n_rays) {
  __shared__ float s[kRows][kChunk];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = o[3 * static_cast<long long>(r)];
    oy = o[3 * static_cast<long long>(r) + 1];
    oz = o[3 * static_cast<long long>(r) + 2];
    dx = d[3 * static_cast<long long>(r)];
    dy = d[3 * static_cast<long long>(r) + 1];
    dz = d[3 * static_cast<long long>(r) + 2];
  }
  float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1, cnt = 0;

  for (int c0 = 0; c0 < n_tri; c0 += kChunk) {
    const int n = min(kChunk, n_tri - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < kRows * kChunk; k += kThreads) {
      const int row = k / kChunk, col = k % kChunk;
      if (col < n) s[row][col] = soa[static_cast<long long>(row) * n_tri + c0 + col];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < n; ++k) {
      const float v0x = s[0][k], v0y = s[1][k], v0z = s[2][k];
      const float e1x = s[3][k], e1y = s[4][k], e1z = s[5][k];
      const float e2x = s[6][k], e2y = s[7][k], e2z = s[8][k];
      const bool ok = s[9][k] > 0.0f;
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool big = fabsf(det) > kEps;
      const float inv = big ? 1.0f / det : 0.0f;
      const float tvx = ox - v0x;
      const float tvy = oy - v0y;
      const float tvz = oz - v0z;
      const float u = (tvx * px + tvy * py + tvz * pz) * inv;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
      const bool hit = big && (u >= -kEps) && (v >= -kEps) && (u + v <= kOnePlusEps) &&
                       (t > kTMin) && ok;
      const float tm = hit ? t : CUDART_INF_F;
      cnt += (tm < CUDART_INF_F) ? 1 : 0;
      if (tm < best_t) {
        best_t = tm;
        best_id = c0 + k;
        best_u = u;
        best_v = v;
      }
    }
  }
  if (live) {
    t_out[r] = best_t;
    tri_out[r] = best_id;
    uv_out[2 * static_cast<long long>(r)] = best_u;
    uv_out[2 * static_cast<long long>(r) + 1] = best_v;
    cnt_out[r] = cnt;
  }
}

}  // namespace

extern "C" {

// soa [10, n_tri], origins and dirs [n_rays, 3], t and uv float32; tri and
// count int32; all contiguous. Launches on `stream`; returns the launch's
// cudaError_t (0 = success). Does not synchronise.
int mt_raycast_f32(const float* soa, int n_tri, const float* origins, const float* dirs,
                   float* t, int* tri, float* uv, int* count, int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
  mt_raycast_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      soa, n_tri, origins, dirs, t, tri, uv, count, n_rays);
  return static_cast<int>(cudaGetLastError());
}

const char* mt_raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
