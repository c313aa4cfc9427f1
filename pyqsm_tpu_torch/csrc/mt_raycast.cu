// Fused Moller-Trumbore closest hit + any-hit count, for Hopper (sm_90a).
//
// Replaces pyqsm_tpu/ops/pallas_kernels.py:110 mt_raycast (the TPU kernel
// that keeps every triangle resident in VMEM as structure-of-arrays rows
// and walks 512-ray tiles through 512-triangle chunks, so the [R, T]
// intersection matrix never reaches HBM).
//
// Inputs: vertices [V, 3] float32, triangles [T, 3] int32 (a row whose
// first index is -1 is padding; negative indices clamp to 0, as the plain
// version's table does), origins and dirs [R, 3] float32. Outputs: t [R]
// (inf = miss), tri [R] int32 (-1 = miss), uv [R, 2] (0 on a miss),
// count [R] int32. The launch plan (threads, triangle slices, chunk) comes
// from the host (ops/mt_raycast.py plan()).
//
// Bound: operations. Written out, a ray-triangle pair costs 46 float32
// operations (27 multiplies, 18 adds/subtracts, one IEEE reciprocal) and
// six compares, while the bytes are tiny (24 B in and 20 B out a ray, 64 B
// a staged triangle). The function needs fewer: a pair that fails stage 1
// (below) needs no more, and in a bundle of one direction p, det and the
// reciprocal belong to the triangle (chip_smoke.py phase 8 counts what each
// shape's rays need). Built with -fmad=false so that kernel and plain
// version agree bit for bit, each operation is one instruction, and the
// card issues at most ~33.5 T of them a second: what bounds the kernel is
// the instructions it issues a pair. The design cuts them and keeps every
// SM busy:
//   - exact warp-uniform early-out. A pair hits only if stage 1 (p, det,
//     the reciprocal, tv, u) gives big && u >= -eps, and stage 2 (q, v)
//     gives v >= -eps && u + v <= 1 + eps; stage 3 (t) and the bookkeeping
//     follow. When __any_sync finds no lane of the warp that passes a
//     stage, the warp skips the rest of that pair: each of those lanes
//     would have computed hit == false, so count and best are untouched.
//     A lane that computes a stage only because a neighbour passes still
//     fails `hit`. Every value on the path of a pair that can hit is
//     computed by the plain version's operations in its order, so the
//     results are the same bits;
//   - the one-direction form. Where every ray of a tile has one direction
//     (a sun bundle, occupancy's rays), p = d x e2 and det's reciprocal do
//     not depend on the ray: the block stages them with each triangle, by
//     the same operations on the same bits, and stage 1 shrinks to tv and
//     u. The block finds this from its rays (their directions compared bit
//     for bit), so no caller chooses it;
//   - triangles staged as four float4 a triangle (v0 | e1 | e2 | p), read
//     as two or three broadcast LDS.128 a pair, built in the
//     staging step from vertices and triangles (the plain version's
//     subtractions: the same bits) with no table pass before the launch.
//     A padding row gets e1 = e2 = 0, so det is 0 (or NaN) and `big`
//     fails: it can never hit, as the plain version's valid flag says;
//   - a slice of triangles a block. The host splits the triangles into up
//     to 8 contiguous slices, one a block of a thread-block cluster, where
//     the table is large or the rays alone cannot fill the card; every
//     block of the cluster walks the same ray tile through its slice with
//     a running best (strict '<' in triangle order, so the lowest id wins
//     a tie), then the blocks merge through distributed shared memory: the
//     lexicographic least (t, id) wins, carrying its u, v, and the counts
//     are summed. Slices are contiguous and taken in ascending order with
//     a strict '<', so the least t with the lowest id wins, the tie rule of
//     both JAX routes; integer sums and that minimum do not depend on the
//     order of the blocks, so the result is deterministic;
//   - a slice larger than the host's whole-slice limit is staged in
//     chunks into two buffers: chunk c+1 is built while chunk c is read,
//     one barrier a chunk, so any T runs;
//   - one ray a thread (two a thread measured no faster).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = static_cast<float>(1.0 + 1e-9);  // rounds to 1.0f
constexpr float kTMin = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlices = 8;  // portable cluster size
constexpr int kMaxThreads = 256;  // a block: 128 or 256 threads, one ray each

struct Params {
  const float* verts;
  const int* tris;
  const float* o;
  const float* d;
  float* t_out;
  int* tri_out;
  float* uv_out;
  int* cnt_out;
  int n_verts, n_tri, n_rays;
  int slices;     // blocks of a cluster = triangle slices
  int per_slice;  // triangles a slice (the last may hold fewer)
  int chunk;      // triangles a staging buffer
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float bt, bu, bv;
  int bid, cnt;
};

// One triangle into the staged table, four float4: v0 | e1 | e2 | p. In
// the one-direction form (every ray of the tile has direction u, bit for
// bit) the ray-independent terms are staged too, by the same operations
// in the same order as each lane would compute them: p = u x e2 in the
// fourth float4 and, in v0's w, 1.0f / det where big holds and NaN where
// it does not (u is then NaN and fails its test, as !big fails it).
__device__ __forceinline__ void stage_triangle(float4* tab, const Params& p, int id,
                                               bool one_dir, float ux, float uy, float uz) {
  const long long b = 3LL * id;
  int i0 = p.tris[b], i1 = p.tris[b + 1], i2 = p.tris[b + 2];
  const bool valid = i0 >= 0;
  // the plain table clamps at 0; the upper clamp only keeps a bad index
  // inside the buffer (torch indexing would raise there)
  const int hi = p.n_verts - 1;
  i0 = min(max(i0, 0), hi);
  i1 = min(max(i1, 0), hi);
  i2 = min(max(i2, 0), hi);
  const float v0x = p.verts[3LL * i0], v0y = p.verts[3LL * i0 + 1], v0z = p.verts[3LL * i0 + 2];
  float e1x = p.verts[3LL * i1] - v0x, e1y = p.verts[3LL * i1 + 1] - v0y,
        e1z = p.verts[3LL * i1 + 2] - v0z;
  float e2x = p.verts[3LL * i2] - v0x, e2y = p.verts[3LL * i2 + 1] - v0y,
        e2z = p.verts[3LL * i2 + 2] - v0z;
  if (!valid) e1x = e1y = e1z = e2x = e2y = e2z = 0.0f;
  float w = 0.0f;
  if (one_dir) {
    const float px = uy * e2z - uz * e2y;
    const float py = uz * e2x - ux * e2z;
    const float pz = ux * e2y - uy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    w = fabsf(det) > kEps ? 1.0f / det : CUDART_NAN_F;
    tab[3] = make_float4(px, py, pz, 0.0f);
  }
  tab[0] = make_float4(v0x, v0y, v0z, w);
  tab[1] = make_float4(e1x, e1y, e1z, 0.0f);
  tab[2] = make_float4(e2x, e2y, e2z, 0.0f);
}

__device__ __forceinline__ void stage_chunk(float4* tab, const Params& p, int c0, int n,
                                            bool one_dir, float ux, float uy, float uz) {
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    stage_triangle(tab + 4 * k, p, c0 + k, one_dir, ux, uy, uz);
}

// Stage 1 of one ray against one staged triangle, in the plain version's
// order of operations (mt_components): p = d x e2, det, the IEEE
// reciprocal, tv, u. The reciprocal is taken of `big ? det : 1`: the same
// 1.0f / det wherever big holds (only those lanes use it); written so, it
// compiles without a divergent branch around the reciprocal.
struct Stage1 {
  float tvx, tvy, tvz, inv, u;
  bool pass;  // big && u >= -eps: the pair may still hit
};

__device__ __forceinline__ Stage1 stage1(const Ray& r, const float4 a, const float4 b,
                                         const float4 c) {
  const float px = r.dy * c.z - r.dz * c.y;
  const float py = r.dz * c.x - r.dx * c.z;
  const float pz = r.dx * c.y - r.dy * c.x;
  const float det = b.x * px + b.y * py + b.z * pz;
  const bool big = fabsf(det) > kEps;
  const float rcp = 1.0f / (big ? det : 1.0f);
  const float inv = big ? rcp : 0.0f;
  Stage1 s;
  s.tvx = r.ox - a.x;
  s.tvy = r.oy - a.y;
  s.tvz = r.oz - a.z;
  s.u = (s.tvx * px + s.tvy * py + s.tvz * pz) * inv;
  s.inv = inv;
  s.pass = big && (s.u >= -kEps);
  return s;
}

// Stage 1 in the one-direction form: tv and u from the staged p and
// reciprocal (a.w); the lane values equal stage1()'s bit for bit wherever
// big holds, and where it does not u is NaN and the pair fails.
__device__ __forceinline__ Stage1 stage1_one_dir(const Ray& r, const float4 a, const float4 e) {
  Stage1 s;
  s.tvx = r.ox - a.x;
  s.tvy = r.oy - a.y;
  s.tvz = r.oz - a.z;
  s.inv = a.w;
  s.u = (s.tvx * e.x + s.tvy * e.y + s.tvz * e.z) * s.inv;
  s.pass = s.u >= -kEps;
  return s;
}

// Stages 2 and 3, for a warp in which some lane passed stage 1: q = tv x
// e1, v, u + v, then t, the count and the running best. Every lane of the
// warp calls it together.
__device__ __forceinline__ void finish(Ray& r, const Stage1& s, const float4 b, const float4 c,
                                       int id) {
  const float qx = s.tvy * b.z - s.tvz * b.y;
  const float qy = s.tvz * b.x - s.tvx * b.z;
  const float qz = s.tvx * b.y - s.tvy * b.x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * s.inv;
  const bool pass2 = s.pass && (v >= -kEps) && (s.u + v <= kOnePlusEps);
  if (!__any_sync(kFull, pass2)) return;  // no lane can hit: exact skip
  const float t = (c.x * qx + c.y * qy + c.z * qz) * s.inv;
  const float tm = (pass2 && t > kTMin) ? t : CUDART_INF_F;
  r.cnt += (tm < CUDART_INF_F) ? 1 : 0;
  if (tm < r.bt) {
    r.bt = tm;
    r.bid = id;
    r.bu = s.u;
    r.bv = v;
  }
}

// One ray a thread: a block of n threads (128 or 256) walks a tile of n
// neighbouring rays (a warp holds 32 of them). Blocks blockIdx.x =
// tile * slices + s form one cluster; block s walks triangle slice s.
// At least 1280 threads an SM: 48 registers a thread at most.
__global__ void __launch_bounds__(kMaxThreads, 1280 / kMaxThreads)
    mt_raycast_kernel(const Params p) {
  extern __shared__ float4 smem[];
  const int n_threads = static_cast<int>(blockDim.x);
  const int slices = p.slices;
  const int slice = static_cast<int>(blockIdx.x) % slices;
  const int tile = static_cast<int>(blockIdx.x) / slices;
  // merge arrays (t, u, v, id, count a ray of the tile) at the same offset
  // in every block of the cluster, the triangle buffers after them
  float4* tab0 = smem + (slices > 1 ? (5 * n_threads) / 4 : 0);
  float4* tab1 = tab0 + 4 * p.chunk;

  const long long r_first = static_cast<long long>(tile) * n_threads;
  const long long r = r_first + threadIdx.x;
  const bool live = r < p.n_rays;
  Ray ray;
  // a lane past the last ray casts from NaN along 0: det is 0 and tv is
  // NaN, so it never passes a stage in either form
  ray.ox = ray.oy = ray.oz = CUDART_NAN_F;
  ray.dx = ray.dy = ray.dz = 0.0f;
  if (live) {
    ray.ox = p.o[3 * r];
    ray.oy = p.o[3 * r + 1];
    ray.oz = p.o[3 * r + 2];
    ray.dx = p.d[3 * r];
    ray.dy = p.d[3 * r + 1];
    ray.dz = p.d[3 * r + 2];
  }
  ray.bt = CUDART_INF_F;
  ray.bu = ray.bv = 0.0f;
  ray.bid = -1;
  ray.cnt = 0;

  // the one-direction form: every live ray of the tile has the direction
  // of its first ray, bit for bit (so the staged terms are each lane's own)
  const float ux = p.d[3 * r_first], uy = p.d[3 * r_first + 1], uz = p.d[3 * r_first + 2];
  const bool same = !live || (__float_as_uint(ray.dx) == __float_as_uint(ux) &&
                              __float_as_uint(ray.dy) == __float_as_uint(uy) &&
                              __float_as_uint(ray.dz) == __float_as_uint(uz));
  const bool one_dir = __syncthreads_and(same) != 0;

  const int t_lo = static_cast<int>(
      min(static_cast<long long>(slice) * p.per_slice, static_cast<long long>(p.n_tri)));
  const int t_hi = static_cast<int>(
      min(static_cast<long long>(t_lo) + p.per_slice, static_cast<long long>(p.n_tri)));
  const int n_chunks = (t_hi - t_lo + p.chunk - 1) / p.chunk;
  if (n_chunks > 0)
    stage_chunk(tab0, p, t_lo, min(p.chunk, t_hi - t_lo), one_dir, ux, uy, uz);
  __syncthreads();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = t_lo + ci * p.chunk;
    const int n = min(p.chunk, t_hi - c0);
    // the other buffer was last read in chunk ci - 1, which ended in a barrier
    if (ci + 1 < n_chunks)
      stage_chunk((ci & 1) ? tab0 : tab1, p, c0 + p.chunk,
                            min(p.chunk, t_hi - c0 - p.chunk), one_dir, ux, uy, uz);
    const float4* tab = (ci & 1) ? tab1 : tab0;
    if (one_dir) {
      for (int k = 0; k < n; ++k) {
        const float4* tk = tab + 4 * k;
        const Stage1 s = stage1_one_dir(ray, tk[0], tk[3]);
        if (__any_sync(kFull, s.pass)) finish(ray, s, tk[1], tk[2], c0 + k);
      }
    } else {
      for (int k = 0; k < n; ++k) {
        const float4* tk = tab + 4 * k;
        const float4 b = tk[1], c = tk[2];
        const Stage1 s = stage1(ray, tk[0], b, c);
        if (__any_sync(kFull, s.pass)) finish(ray, s, b, c, c0 + k);
      }
    }
    __syncthreads();  // chunk ci + 1 is staged and chunk ci no longer read
  }

  if (slices == 1) {
    if (live) {
      p.t_out[r] = ray.bt;
      p.tri_out[r] = ray.bid;
      reinterpret_cast<float2*>(p.uv_out)[r] = make_float2(ray.bu, ray.bv);
      p.cnt_out[r] = ray.cnt;
    }
    return;
  }

  // merge the cluster's slices through distributed shared memory
  float* m_t = reinterpret_cast<float*>(smem);
  float* m_u = m_t + n_threads;
  float* m_v = m_u + n_threads;
  int* m_id = reinterpret_cast<int*>(m_v + n_threads);
  int* m_cnt = m_id + n_threads;
  m_t[threadIdx.x] = ray.bt;
  m_u[threadIdx.x] = ray.bu;
  m_v[threadIdx.x] = ray.bv;
  m_id[threadIdx.x] = ray.bid;
  m_cnt[threadIdx.x] = ray.cnt;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every slice's results are written and visible
  // block s writes rays [s * share, (s + 1) * share) of the tile
  const int share = (n_threads + slices - 1) / slices;
  const int i = slice * share + static_cast<int>(threadIdx.x);
  if (static_cast<int>(threadIdx.x) < share && i < n_threads && r_first + i < p.n_rays) {
    float bt = CUDART_INF_F, bu = 0.0f, bv = 0.0f;
    int bid = -1, cnt = 0;
    for (int s = 0; s < slices; ++s) {  // ascending slices, strict '<'
      const float ts = cluster.map_shared_rank(m_t, s)[i];
      cnt += cluster.map_shared_rank(m_cnt, s)[i];
      if (ts < bt) {
        bt = ts;
        bid = cluster.map_shared_rank(m_id, s)[i];
        bu = cluster.map_shared_rank(m_u, s)[i];
        bv = cluster.map_shared_rank(m_v, s)[i];
      }
    }
    const long long ro = r_first + i;
    p.t_out[ro] = bt;
    p.tri_out[ro] = bid;
    reinterpret_cast<float2*>(p.uv_out)[ro] = make_float2(bu, bv);
    p.cnt_out[ro] = cnt;
  }
  cluster.sync();  // no block leaves while another still reads its slice
}

int launch(const Params& p, int threads, int tiles, int smem_bytes, cudaStream_t stream) {
  auto kernel = mt_raycast_kernel;
  if (smem_bytes > 48 * 1024) {  // above the default limit of dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * static_cast<unsigned>(p.slices));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.slices);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.slices > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// vertices [n_verts, 3] f32, triangles [n_tri, 3] i32, origins and dirs
// [n_rays, 3] f32, t and uv f32, tri and count i32; all contiguous. The
// plan: threads a block (128 or 256; one ray a thread), slices (1-8,
// the cluster size), triangles a slice, triangles a staging buffer, ray
// tiles (the grid is tiles * slices blocks) and the dynamic shared memory
// a block. Launches on `stream`; returns the launch's cudaError_t (0 =
// success; cudaErrorInvalidValue for a plan it does not take). Does not
// synchronise.
int mt_raycast_f32(const float* vertices, int n_verts, const int* triangles, int n_tri,
                   const float* origins, const float* dirs, float* t, int* tri, float* uv,
                   int* count, int n_rays, int threads, int slices, int per_slice, int chunk,
                   int tiles, int smem_bytes, void* stream) {
  if (n_rays <= 0) return 0;
  if ((threads != 128 && threads != kMaxThreads) || slices < 1 || slices > kMaxSlices ||
      chunk < 1 || per_slice < 0 || tiles < 1 ||
      static_cast<long long>(slices) * per_slice < n_tri ||
      static_cast<long long>(tiles) * threads < n_rays ||
      static_cast<long long>(tiles - 1) * threads >= n_rays || (n_tri > 0 && n_verts < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{vertices, triangles, origins, dirs,   t,      tri,       uv,
                 count,    n_verts,   n_tri,   n_rays, slices, per_slice, chunk};
  return launch(p, threads, tiles, smem_bytes, static_cast<cudaStream_t>(stream));
}

const char* mt_raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
