// Block-banded matvec of the banded region-grow claim, bf16 in, f32 out:
// y[t, i, :] = sum_j W[t]_ij x[t, j, :].
//
// Replaces pyqsm_tpu/ops/pallas_kernels.py:183 band_matvec_pallas in the form
// the claim feeds it (pyqsm_tpu/models/isolation.py:182-235 through
// ops/sparse._band_apply): W is the 0/1 adjacency of the masked radius
// graph in bf16, x the one-hot frontier [n, C] in bf16 with
// C = cluster_cap in {16, 32, 64, 128}, accumulated in float32.
//
// Layout: W is stored as window tiles bw[T, nb, 256, 768]; output block b of
// tree t multiplies its tile by the concatenated x blocks b-1, b, b+1 (zero
// past either end). x is [T, nb*256, C] bf16 and y [T, nb*256, C] float32,
// both row-major.
//
// Bound: memory at every C <= 128. Per output row the tile is 1536 B and
// the product 2*768*C flops: at C = 128 that is 128 flop/byte, below the
// card's ~295 flop/byte bf16 tensor-core ridge. So the design streams W once
// and keeps the arithmetic on the tensor cores:
//   - one thread block per (band block, tree), 8 warps; warp w owns output
//     rows [32w, 32w + 32) and all C columns as 2 x C/16 wmma 16x16 float32
//     accumulators;
//   - K (the 768-wide window) runs in 12 chunks of 64. Each chunk's W slab
//     [256, 64] and x slab [64, C] are copied into shared memory with 16-byte
//     cp.async (W rows are 128 contiguous bytes per chunk, so 8 lanes read
//     one row), double-buffered so the next chunk's copy overlaps this
//     chunk's MMAs; x rows past the ends are zero-filled by the copy itself;
//   - rows are padded by 8 bf16 in shared memory against bank conflicts;
//   - bf16 x bf16 products are exact in float32, so 0/1 inputs give exact
//     integer counts (<= 768 terms): equal to the plain version bit for bit.
// Shared memory: 2 * (256*72 + 64*(C+8)) * 2 B = 79 872 B at C = 16,
// 108 544 B at C = 128 (dynamic, above the 48 KB static limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBS = 256;             // rows per band block
constexpr int kW3 = 3 * kBS;         // window width (K)
constexpr int kKC = 64;              // K chunk staged per step
constexpr int kChunks = kW3 / kKC;   // 12
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBS / kWarps;  // 32 = two 16-row MMA tiles
constexpr int kLdA = kKC + 8;        // padded W slab row (bf16 elements)

template <int C>
struct Layout {
  static constexpr int kLdB = C + 8;                  // padded x slab row
  static constexpr int kAElems = kBS * kLdA;          // W slab
  static constexpr int kBElems = kKC * kLdB;          // x slab
  static constexpr int kStage = kAElems + kBElems;
  static constexpr int kBytes = 2 * kStage * static_cast<int>(sizeof(bf16));
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy chunk `chunk` of the tile's W columns and of the x window into one
// shared-memory stage. x window row r is global row base + r.
template <int C>
__device__ __forceinline__ void load_chunk(bf16* sa, bf16* sb, const bf16* tile,
                                           const bf16* xt, long long base, long long n,
                                           int chunk) {
  constexpr int kVecA = kKC / 8;  // 16-byte vectors per W slab row
  for (int i = threadIdx.x; i < kBS * kVecA; i += kThreads) {
    const int r = i / kVecA, v = i % kVecA;
    cp_async16(sa + r * kLdA + v * 8,
               tile + static_cast<long long>(r) * kW3 + chunk * kKC + v * 8, 16);
  }
  constexpr int kVecB = C / 8;
  for (int i = threadIdx.x; i < kKC * kVecB; i += kThreads) {
    const int r = i / kVecB, v = i % kVecB;
    const long long g = base + chunk * kKC + r;
    const bool in = (g >= 0) && (g < n);
    // out-of-range rows: a zero-byte source zero-fills the 16 bytes
    cp_async16(sb + r * Layout<C>::kLdB + v * 8, xt + (in ? g : 0) * C + v * 8, in ? 16 : 0);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
band_matvec_bf16_kernel(const bf16* __restrict__ bw, const bf16* __restrict__ x,
                        float* __restrict__ y, int nb) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  using L = Layout<C>;
  constexpr int kNT = C / 16;  // 16-column MMA tiles

  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(nb) * kBS;
  const bf16* tile = bw + (static_cast<long long>(t) * nb + b) * kBS * kW3;
  const bf16* xt = x + static_cast<long long>(t) * n * C;
  const long long base = (static_cast<long long>(b) - 1) * kBS;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kNT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_chunk<C>(smem, smem + L::kAElems, tile, xt, base, n, 0);
  cp_async_commit();
  for (int c = 0; c < kChunks; ++c) {
    bf16* nxt = smem + ((c + 1) & 1) * L::kStage;
    if (c + 1 < kChunks) load_chunk<C>(nxt, nxt + L::kAElems, tile, xt, base, n, c + 1);
    cp_async_commit();   // possibly empty group: keeps the wait count uniform
    cp_async_wait_one(); // this thread's copies of chunk c have landed
    __syncthreads();     // ... and everyone else's
    const bf16* sa = smem + (c & 1) * L::kStage + warp * kRowsPerWarp * kLdA;
    const bf16* sb = smem + (c & 1) * L::kStage + L::kAElems;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::load_matrix_sync(fa[0], sa + kk, kLdA);
      wmma::load_matrix_sync(fa[1], sa + 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sb + kk * L::kLdB + j * 16, L::kLdB);
        wmma::mma_sync(acc[0][j], fa[0], fb, acc[0][j]);
        wmma::mma_sync(acc[1][j], fa[1], fb, acc[1][j]);
      }
    }
    __syncthreads();  // stage c & 1 is refilled by the next iteration's copy
  }

  float* yt = y + (static_cast<long long>(t) * n + static_cast<long long>(b) * kBS +
                   warp * kRowsPerWarp) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      wmma::store_matrix_sync(yt + i * 16 * C + j * 16, acc[i][j], C, wmma::mem_row_major);
}

template <int C>
int launch(const bf16* bw, const bf16* x, float* y, int trees, int nb, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_matvec_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<C>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(trees));
  band_matvec_bf16_kernel<C><<<grid, kThreads, Layout<C>::kBytes, stream>>>(bw, x, y, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bw [trees, nb, 256, 768] bf16, x [trees, nb*256, c] bf16, y [trees,
// nb*256, c] float32; all contiguous, bw and x 16-byte and y 32-byte
// aligned; c in {16, 32, 64, 128}. Launches on `stream`; returns the
// launch's cudaError_t (0 = success). Does not synchronise.
int band_matvec_bf16(const void* bw, const void* x, float* y, int trees, int nb, int c,
                     void* stream) {
  if (trees <= 0 || nb <= 0) return 0;
  if (trees > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* w = static_cast<const bf16*>(bw);
  const bf16* xv = static_cast<const bf16*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 16: return launch<16>(w, xv, y, trees, nb, s);
    case 32: return launch<32>(w, xv, y, trees, nb, s);
    case 64: return launch<64>(w, xv, y, trees, nb, s);
    case 128: return launch<128>(w, xv, y, trees, nb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* band_matvec_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
