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
// past either end of the tree). x is [T, nb*256, C] bf16 and y
// [T, nb*256, C] float32, both row-major.
//
// Halo form (band_matvec_bf16_halo; the sharded claim of
// pyqsm_tpu/parallel/growth.py:84-164, _band_apply(prepadded=True)): x is
// [T, (nb + 2)*256, C] and carries one halo block on each side, the
// neighbouring shards' rows; block b's window is padded rows
// [b*256, b*256 + 768). The same kernel: only the x tensor map's row extent
// and the window's first row differ.
//
// Bound: memory at every C <= 128. Per output row the tile is 1536 B and the
// product 2*768*C flops: at C = 128 that is 128 flop/byte, below the card's
// ~295 flop/byte bf16 tensor-core ridge. Bytes: n*(1536 + 6C) (W and x read
// once, y written once; n = T*nb*256 output rows), halo
// n*(1536 + 4C) + (n + 512*T)*2C. The design streams W once at the memory
// rate and keeps every other unit off that path:
//   - persistent blocks, one an SM (the grid is the SM count, read at run
//     time), each walking the (tree, band block) tiles with a stride of the
//     grid: a block's tile count differs by at most one from any other's, and
//     the SMs work on neighbouring band blocks at the same time, so the x
//     blocks that three windows share come from L2 and W is read as one
//     moving front (a contiguous run of tiles a block measured slower);
//   - warp specialisation: one thread of the third warpgroup (its other warps
//     exit) issues every load with TMA (cp.async.bulk.tensor) into a ring of
//     3-6 stages, each one W slab [256 rows, 64 columns] (32 KB, 128-byte
//     rows, 128-byte swizzle, L2 promotion to 256 B) and the matching x slab
//     [64 rows, C]; one mbarrier a stage counts the slab bytes in ("full"),
//     another the consumers' release ("empty"). The producer runs ahead
//     across tile boundaries, so the next tile's loads overlap this tile's
//     epilogue. x loads carry an evict-last L2 policy: each x row is read by
//     three windows;
//   - x has a 3-D tensor map (C, rows, trees): a window that starts at row
//     -256 or runs past row n reads TMA's out-of-bounds zeros, never the
//     neighbouring tree's rows, with no branch per row;
//   - two consumer warpgroups multiply with wgmma.mma_async: each owns 128 of
//     the tile's 256 output rows as two m64 tiles, A = the W slab (K-major),
//     B = the x slab read MN-major (x rows are C-wide, so the transpose bit
//     is set): at C = 16, 32 and 64 one x box whose row width sets the
//     swizzle (32, 64, 128 B) and one m64nCk16 a step; at C = 128 two
//     64-column boxes and two m64n64k16 a step, so every B operand lies in
//     one swizzle atom along N and the descriptor's leading-byte offset (the
//     stride between atoms) is never read (one m64n128k16 over both boxes
//     measured no faster). Each stage's products stay in flight while the
//     previous stage is released (wgmma.wait_group 1). Accumulators stay in
//     float32 registers, C per thread; setmaxnreg gives the consumers 232
//     registers and the producer 40;
//   - epilogue: each warpgroup writes its accumulators, one m64 tile at a
//     time, into a staging buffer in the swizzled layout of y's TMA boxes
//     ([64 rows, 32 floats], 128-byte swizzle; 16 floats, 64-byte, at
//     C = 16), fences them to the async proxy and stores them with
//     cp.async.bulk.tensor, which runs on while the warpgroup multiplies the
//     next tile (stores straight from registers stalled the consumers until
//     they drained, and measured slower at C >= 64);
//   - the ring is written only by TMA and read only by wgmma (both the async
//     proxy), its barriers initialised before the roles split
//     (fence.mbarrier_init); the staging buffers, written by generic stores
//     and read by TMA, take fence.proxy.async before each store;
//   - bf16 x bf16 products are exact in float32, so 0/1 inputs give exact
//     integer counts (<= 768 terms): equal to the plain version bit for bit.
// Shared memory (dynamic, one block an SM; band_matvec_bf16_smem_bytes): stages * (32 KB + 128*C B) +
// 2 * 256*C B of y staging + 1 KB of alignment + barriers: 6 * 34 816 +
// 8 192 at C = 16, 5 * 36 864 + 16 384 at 32, 4 * 40 960 + 32 768 at 64,
// 3 * 49 152 + 65 536 at 128.
//
// The tensor maps (W, x, y) are encoded on the host at each call (x and y
// are new tensors every cycle) with libcuda's cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links against the
// runtime alone, and are passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBS = 256;             // rows per band block = output rows per tile
constexpr int kW3 = 3 * kBS;         // window width (K)
constexpr int kKC = 64;              // K per stage: 64 bf16 = one 128-byte row
constexpr int kChunks = kW3 / kKC;   // 12 stages per tile
constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kWBytes = kBS * kKC * 2;  // W slab, 32 KB
constexpr int kSmemLimit = 232448;      // an H100 block's dynamic shared memory

template <int C>
struct Cfg {
  static constexpr int kN = C < 64 ? C : 64;      // N of one wgmma
  static constexpr int kNH = C / kN;              // wgmmas per m64 tile and k step
  static constexpr int kRowBytes = kN * 2;        // x slab row (one box)
  static constexpr int kBoxBytes = kKC * kRowBytes;  // one x box: 64 rows
  static constexpr int kXBytes = kKC * C * 2;     // x slab
  static constexpr int kStage = kWBytes + kXBytes;   // a multiple of 1024
  // y staging: one m64 tile of f32 per consumer warpgroup, stored by TMA in
  // boxes of [64 rows, 32 floats] (128-byte swizzle; C = 16: 16 floats, 64-byte)
  static constexpr int kYBox = C < 32 ? C : 32;
  static constexpr int kYBoxes = C / kYBox;
  static constexpr int kYRowBytes = kYBox * 4;
  static constexpr int kYBoxBytes = 64 * kYRowBytes;
  static constexpr int kYStage = 64 * C * 4;
  static constexpr uint32_t kYSwizzleMask = kYRowBytes == 128 ? 7 : 3;
  static constexpr int kFree = kSmemLimit - 2 * kYStage - 1024 - 128;
  static constexpr int kStages = kFree / kStage < 6 ? kFree / kStage : 6;
  static constexpr int kSmem = kStages * kStage + 2 * kYStage + 1024 + 16 * kStages;
  // wgmma layout type of the x slab: 3 = 32-byte, 2 = 64-byte, 1 = 128-byte swizzle
  static constexpr uint64_t kBLayout = kRowBytes == 32 ? 3 : kRowBytes == 64 ? 2 : 1;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// with an L2 eviction policy (x rows are read by three windows: kept last)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the bulk stores this thread committed have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading- and
// stride-byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, N] (+)= A[64, 16] B[16, N], A K-major, B MN-major (trans-b = 1);
// scale_d = 0 starts the sum afresh.
__device__ __forceinline__ void wgmma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
band_matvec_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap ymap, int nb, int tiles, int halo) {
  using K = Cfg<C>;
  extern __shared__ unsigned char smem_raw[];
  // the ring starts on a 1024-byte boundary: the 128-byte swizzle's period
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ystage = ring + K::kStages * K::kStage;  // 2 x kYStage
  const uint32_t full = ystage + 2 * K::kYStage;         // kStages barriers
  const uint32_t empty = full + 8 * K::kStages;         // kStages barriers

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::kStages; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumerThreads);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread issues every load; the rest exit
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumerThreads) {
      uint64_t keep;
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int t = tile / nb;
        const int row0 = (tile - t * nb - 1 + halo) * kBS;  // first x row of the window
        for (int c = 0; c < kChunks; ++c) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t dst = ring + stage * K::kStage;
          mbar_expect_tx(bar, K::kStage);
          tma_load_2d(dst, &wmap, c * kKC, tile * kBS, bar);
#pragma unroll
          for (int h = 0; h < K::kNH; ++h)
            tma_load_3d(dst + kWBytes + h * K::kBoxBytes, &xmap, h * K::kN, row0 + c * kKC, t,
                        bar, keep);
          if (++stage == K::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 0 and 1: output rows [128 wg, 128 wg + 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    float acc[2][K::kNH][K::kN / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < K::kNH; ++h)
#pragma unroll
        for (int i = 0; i < K::kN / 2; ++i) acc[m][h][i] = 0.0f;
    const int tid = threadIdx.x & 127;
    const uint32_t ys = ystage + wg * K::kYStage;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int c = 0; c < kChunks; ++c) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a0 = ring + stage * K::kStage + wg * 128 * (kKC * 2);
        const uint32_t b0 = ring + stage * K::kStage + kWBytes;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < K::kNH; ++h) fence_regs(acc[m][h]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKC / 16; ++k) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // W rows [64 m, 64 m + 64) of this warpgroup, columns [16 k, 16 k + 16):
            // 8-row groups 1024 B apart, the step inside the 128-byte swizzled row
            const uint64_t da = smem_desc(a0 + m * 64 * (kKC * 2) + k * 32, 16, 1024, 1);
#pragma unroll
            for (int h = 0; h < K::kNH; ++h) {
              // x rows [16 k, 16 k + 16) of box h: 8-row groups 8 rows apart
              const uint64_t db =
                  smem_desc(b0 + h * K::kBoxBytes + k * 16 * K::kRowBytes, K::kBoxBytes,
                            8 * K::kRowBytes, K::kBLayout);
              wgmma(acc[m][h], da, db, (c | k) != 0);
            }
          }
        }
        wgmma_commit();
        // this stage's products stay in flight; the previous stage's are done
        wgmma_wait<1>();
        if (c > 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == K::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < K::kNH; ++h) fence_regs(acc[m][h]);
      mbar_arrive(empty + 8 * prev);

      // Epilogue, one m64 tile at a time through this warpgroup's staging
      // buffer: accumulator value 4i + j of a thread is row 16 warp + lane/4
      // (+ 8 for j >= 2), column 8i + 2 (lane % 4) + (j & 1) of its m64nN
      // tile; it is written into the swizzled box layout the TMA store reads,
      // and the store runs on while the warpgroup multiplies the next tile.
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (tid == 0) bulk_wait_read();  // the buffer's last store has read it
        warpgroup_sync(1 + wg);
#pragma unroll
        for (int h = 0; h < K::kNH; ++h)
#pragma unroll
          for (int i = 0; i < K::kN / 8; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = warp * 16 + (lane >> 2) + 8 * j;
              const int col = h * K::kN + 8 * i + 2 * (lane & 3);
              const uint32_t off = (col % K::kYBox) * 4 + r * K::kYRowBytes;
              st_shared_f2(ys + (col / K::kYBox) * K::kYBoxBytes +
                               (off ^ (((off >> 7) & K::kYSwizzleMask) << 4)),
                           acc[m][h][4 * i + 2 * j], acc[m][h][4 * i + 2 * j + 1]);
            }
        // generic stores, then the async proxy reads them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(1 + wg);
        if (tid == 0) {
#pragma unroll
          for (int b = 0; b < K::kYBoxes; ++b)
            tma_store_2d(&ymap, ys + b * K::kYBoxBytes, b * K::kYBox,
                         tile * kBS + wg * 128 + m * 64);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait();  // the last stores are out before the block exits
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int C>
int launch(const void* bw, const void* x, float* y, int trees, int nb, int halo,
           cudaStream_t stream) {
  using K = Cfg<C>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int tiles = trees * nb;
  const cuuint32_t ones[3] = {1, 1, 1};
  // W as [T*nb*256 rows, 768] bf16: one box is a [256, 64] slab
  CUtensorMap wmap, xmap;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(kW3),
                              static_cast<cuuint64_t>(tiles) * kBS};
  const cuuint64_t wstride[1] = {kW3 * 2};
  const cuuint32_t wbox[2] = {kKC, kBS};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(bw), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  // x as (C, rows, trees): rows outside [0, rows) of a tree read zeros
  const cuuint64_t rows = static_cast<cuuint64_t>(nb + (halo ? 2 : 0)) * kBS;
  const cuuint64_t xdim[3] = {static_cast<cuuint64_t>(C), rows, static_cast<cuuint64_t>(trees)};
  const cuuint64_t xstride[2] = {static_cast<cuuint64_t>(C) * 2, rows * C * 2};
  const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(K::kN), kKC, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), xdim, xstride,
             xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, K::kSwizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  // y as [T*nb*256 rows, C] float32, stored in [64, kYBox] boxes
  CUtensorMap ymap;
  const cuuint64_t ydim[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(tiles) * kBS};
  const cuuint64_t ystride[1] = {static_cast<cuuint64_t>(C) * 4};
  const cuuint32_t ybox[2] = {static_cast<cuuint32_t>(K::kYBox), 64};
  if (encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, y, ydim, ystride, ybox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             K::kYRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(band_matvec_bf16_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = tiles < sms ? tiles : sms;
  band_matvec_bf16_kernel<C><<<grid, kThreads, K::kSmem, stream>>>(wmap, xmap, ymap, nb, tiles, halo);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* bw, const void* x, float* y, int trees, int nb, int c, int halo,
             void* stream) {
  if (trees <= 0 || nb <= 0) return 0;
  if (static_cast<long long>(trees) * nb * kBS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 16: return launch<16>(bw, x, y, trees, nb, halo, s);
    case 32: return launch<32>(bw, x, y, trees, nb, halo, s);
    case 64: return launch<64>(bw, x, y, trees, nb, halo, s);
    case 128: return launch<128>(bw, x, y, trees, nb, halo, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// bw [trees, nb, 256, 768] bf16, x [trees, nb*256, c] bf16, y [trees,
// nb*256, c] float32; all contiguous and 16-byte aligned; c in {16, 32, 64,
// 128}. Launches on `stream`; returns the
// launch's cudaError_t (0 = success). Does not synchronise.
int band_matvec_bf16(const void* bw, const void* x, float* y, int trees, int nb, int c,
                     void* stream) {
  return dispatch(bw, x, y, trees, nb, c, 0, stream);
}

// The halo form: as band_matvec_bf16, but x is [trees, (nb + 2)*256, c] with
// one halo block on each side, and block b's window is x rows
// [b*256, b*256 + 768) of its tree.
int band_matvec_bf16_halo(const void* bw, const void* x, float* y, int trees, int nb, int c,
                          void* stream) {
  return dispatch(bw, x, y, trees, nb, c, 1, stream);
}

// Dynamic shared memory a block of the kernel for width c takes (0 for a
// width it does not take).
int band_matvec_bf16_smem_bytes(int c) {
  switch (c) {
    case 16: return Cfg<16>::kSmem;
    case 32: return Cfg<32>::kSmem;
    case 64: return Cfg<64>::kSmem;
    case 128: return Cfg<128>::kSmem;
    default: return 0;
  }
}

const char* band_matvec_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
