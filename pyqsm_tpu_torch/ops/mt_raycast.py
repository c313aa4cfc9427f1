"""Fused Möller–Trumbore closest hit + any-hit count: the hand-written CUDA
kernel, its plain PyTorch version, the kernel's launch plan and its launch
counter.

Replaces ``pyqsm_tpu/ops/pallas_kernels.py:110`` ``mt_raycast``. Returns
``(t, tri, uv, count)``: the closest hit distance (inf on a miss, in units
of the direction, which need not be normalised), its triangle id (-1 on a
miss; on equal t the lowest id wins), its barycentric (u, v) (0 on a miss)
and the number of triangles the ray crosses.

``mt_raycast`` sends CUDA tensors to the kernel (``csrc/mt_raycast.cu``) or
raises, and CPU tensors to ``mt_raycast_plain``. Both apply the same
operations in the same order to the same triangle rows (the plain version
reads ``triangle_soa``, the kernel builds the rows while it stages them);
the kernel is built with ``-fmad=false`` so that on the card the two agree
bit for bit. Where the table is large or the rays alone cannot fill the
card, ``plan`` splits the triangles into slices, one a block of a
thread-block cluster, which the kernel merges: the least (t, id) wins,
carrying its (u, v), and the counts are summed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pyqsm_tpu_torch.ops.cuda_build import I, P, CudaLib

_EPS = 1e-9

# Launches of the CUDA kernel, counted by ``_launch`` (behind
# ``mt_raycast_cuda``; the only place that launches it).
LAUNCHES = 0

LIB = CudaLib("mt_raycast.cu",
              {"mt_raycast_f32": ([P, I, P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, P], I)},
              extra_flags=("-fmad=false",))

MAX_SLICES = 8  # the portable thread-block cluster size
MIN_SLICE = 64  # triangles a slice at least, where the rays ask for slices
WHOLE_TRIANGLES = 576  # a slice up to this many triangles is staged whole
CHUNK_TRIANGLES = 512  # a larger slice: two buffers of this many
TRI_BYTES = 64  # a staged triangle: four float4 (v0 | e1 | e2 | p)
MERGE_BYTES = 20  # a ray's slice result: t, u, v, id, count
WIDE_FROM = 64 * 256  # 256 threads a block from this many rays, else 128


class Plan(NamedTuple):
    """One launch: ``tiles`` ray tiles of ``threads`` rays (one a thread),
    each walked by ``slices`` blocks of one cluster, block s through
    triangles [s·per_slice, (s + 1)·per_slice) ∩ [0, T), staged
    ``chunk`` at a time into ``buffers`` shared-memory buffers."""

    threads: int
    slices: int
    per_slice: int
    chunk: int
    buffers: int
    tiles: int

    @property
    def smem_bytes(self) -> int:
        merge = MERGE_BYTES * self.threads if self.slices > 1 else 0
        return self.buffers * self.chunk * TRI_BYTES + merge

    def chunks(self, n_tri: int) -> list[list[tuple[int, int]]]:
        """Each slice's staged chunks as (first, end) triangle ids, as the
        kernel walks them."""
        out = []
        for s in range(self.slices):
            lo = min(s * self.per_slice, n_tri)
            hi = min(lo + self.per_slice, n_tri)
            out.append([(c, min(c + self.chunk, hi)) for c in range(lo, hi, self.chunk)])
        return out


def plan(n_rays: int, n_tri: int, sm_count: int) -> Plan:
    """The kernel's launch plan for R rays and T triangles on a card of
    ``sm_count`` SMs. Blocks of 256 rays from ``WIDE_FROM`` rays, else
    128. Slices: enough that each holds at most ``WHOLE_TRIANGLES`` (up to
    8), then doubled while the grid has fewer than two blocks an SM and
    each slice keeps ``MIN_SLICE`` triangles."""
    threads = 256 if n_rays >= WIDE_FROM else 128
    tiles = max(1, math.ceil(n_rays / threads))
    slices = min(MAX_SLICES, max(1, math.ceil(n_tri / WHOLE_TRIANGLES)))
    while (slices < MAX_SLICES and tiles * slices < 2 * sm_count
           and math.ceil(n_tri / (2 * slices)) >= MIN_SLICE):
        slices = min(MAX_SLICES, 2 * slices)
    return _sliced(n_rays, n_tri, threads, slices)


def _sliced(n_rays: int, n_tri: int, threads: int, slices: int) -> Plan:
    """The plan for a given block size and slice count: a slice up to
    ``WHOLE_TRIANGLES`` is staged whole, a larger one in two buffers of
    ``CHUNK_TRIANGLES``."""
    if not 1 <= slices <= MAX_SLICES:
        raise ValueError(f"mt_raycast: {slices} slices, the cluster takes 1 to {MAX_SLICES}")
    per = math.ceil(n_tri / slices)
    chunk = max(1, per if per <= WHOLE_TRIANGLES else CHUNK_TRIANGLES)
    return Plan(threads, slices, per, chunk, 1 if per <= chunk else 2,
                max(1, math.ceil(n_rays / threads)))


def mt_components(ov, dv, v0, e1, e2, ok):
    """Component-unrolled Möller–Trumbore core shared by every caster (the
    JAX package's ``raytrace.mt_components``). ``ov``/``dv``/``v0``/``e1``/
    ``e2`` are (x, y, z) tuples of tensors that broadcast against each
    other; ``ok`` is the candidate mask at the broadcast shape. Returns
    (t with inf = miss, u, v)."""
    px = dv[1] * e2[2] - dv[2] * e2[1]
    py = dv[2] * e2[0] - dv[0] * e2[2]
    pz = dv[0] * e2[1] - dv[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    big = det.abs() > _EPS
    inv = torch.where(big, torch.reciprocal(det), 0.0)
    tvx = ov[0] - v0[0]
    tvy = ov[1] - v0[1]
    tvz = ov[2] - v0[2]
    u = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1[2] - tvz * e1[1]
    qy = tvz * e1[0] - tvx * e1[2]
    qz = tvx * e1[1] - tvy * e1[0]
    v = (dv[0] * qx + dv[1] * qy + dv[2] * qz) * inv
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
    hit = big & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > 1e-6) & ok
    return torch.where(hit, t, torch.inf), u, v


def triangle_soa(vertices: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """[10, T] f32 rows v0 xyz | e1 xyz | e2 xyz | valid, where a triangle
    row holding -1 is invalid."""
    valid = triangles[:, 0] >= 0
    tri = triangles.clamp(min=0).long()
    v0 = vertices[tri[:, 0]]
    e1 = vertices[tri[:, 1]] - v0
    e2 = vertices[tri[:, 2]] - v0
    return torch.cat([v0.T, e1.T, e2.T, valid[None].to(vertices.dtype)]).contiguous()


def mt_raycast_plain(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
                     triangles: torch.Tensor, ray_tile: int = 4096, tri_tile: int = 1024):
    """Plain version: ray tiles against triangle tiles with a running
    closest hit (first index inside a tile, strict ``<`` across tiles, so
    the lowest id wins on equal t) and a running hit count."""
    soa = triangle_soa(vertices.to(torch.float32), triangles)
    n_tri = soa.shape[1]
    r = origins.shape[0]
    dev = origins.device
    t_out = torch.full((r,), torch.inf, device=dev)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    uv_out = torch.zeros((r, 2), device=dev)
    cnt_out = torch.zeros((r,), dtype=torch.int32, device=dev)
    for r0 in range(0, r, ray_tile):
        o = origins[r0:r0 + ray_tile].to(torch.float32)
        d = dirs[r0:r0 + ray_tile].to(torch.float32)
        ov = tuple(o[:, a:a + 1] for a in range(3))
        dv = tuple(d[:, a:a + 1] for a in range(3))
        best_t, best_id = t_out[r0:r0 + ray_tile], tri_out[r0:r0 + ray_tile]
        best_uv, cnt = uv_out[r0:r0 + ray_tile], cnt_out[r0:r0 + ray_tile]
        for t0 in range(0, n_tri, tri_tile):
            s = soa[:, t0:t0 + tri_tile]
            t, u, v = mt_components(ov, dv, (s[0], s[1], s[2]), (s[3], s[4], s[5]),
                                    (s[6], s[7], s[8]), s[9] > 0)
            cnt += torch.isfinite(t).sum(dim=1, dtype=torch.int32)
            jmin = torch.argmin(t, dim=1, keepdim=True)
            tmin = t.gather(1, jmin)[:, 0]
            better = tmin < best_t
            best_id.copy_(torch.where(better, (jmin[:, 0] + t0).to(torch.int32), best_id))
            uv = torch.cat([u.gather(1, jmin), v.gather(1, jmin)], dim=1)
            best_uv.copy_(torch.where(better[:, None], uv, best_uv))
            best_t.copy_(torch.minimum(best_t, tmin))
    return t_out, tri_out, uv_out, cnt_out


def mt_raycast_cuda(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
                    triangles: torch.Tensor):
    """The CUDA kernel: origins/dirs [R, 3] f32, vertices [V, 3] f32,
    triangles [T, 3] int32, all contiguous on one CUDA device. Raises on
    anything else."""
    return _launch(origins, dirs, vertices, triangles)


def _launch(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
            triangles: torch.Tensor, slices: int | None = None):
    """``mt_raycast_cuda`` under the host's plan, or with ``slices``
    triangle slices (the card's checks run every slice count)."""
    global LAUNCHES
    named = (("origins", origins, torch.float32), ("dirs", dirs, torch.float32),
             ("vertices", vertices, torch.float32), ("triangles", triangles, torch.int32))
    for name, x, dt in named:
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"mt_raycast: {name} must be [n, 3], got {tuple(x.shape)}")
        if x.dtype != dt:
            raise TypeError(f"mt_raycast: {name} must be {dt}, got {x.dtype}")
    for name, x, _ in named:
        if not x.is_cuda or x.device != origins.device:
            raise ValueError("mt_raycast kernel needs every input on one CUDA device")
        if not x.is_contiguous() or x.data_ptr() % 4:
            raise ValueError(f"mt_raycast kernel needs contiguous, aligned {name}")
    r = origins.shape[0]
    if dirs.shape[0] != r:
        raise ValueError("mt_raycast: origins and dirs differ in length")
    n_tri, n_verts = triangles.shape[0], vertices.shape[0]
    if r >= 2 ** 31 or n_tri >= 2 ** 31:
        raise ValueError("mt_raycast: more than 2³¹ rays or triangles")
    if n_tri and not n_verts:
        raise ValueError("mt_raycast: triangles index an empty vertex array")
    dev = origins.device
    pl = plan(r, n_tri, torch.cuda.get_device_properties(dev).multi_processor_count)
    if slices is not None:
        pl = _sliced(r, n_tri, pl.threads, slices)
    t = torch.empty(r, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    uv = torch.empty(r, 2, device=dev)
    cnt = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = LIB.load().mt_raycast_f32(
            vertices.data_ptr(), n_verts, triangles.data_ptr(), n_tri, origins.data_ptr(),
            dirs.data_ptr(), t.data_ptr(), tri.data_ptr(), uv.data_ptr(), cnt.data_ptr(), r,
            pl.threads, pl.slices, pl.per_slice, pl.chunk, pl.tiles, pl.smem_bytes, stream)
    LIB.check(rc, "mt_raycast")
    LAUNCHES += 1
    return t, tri, uv, cnt


def mt_raycast(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
               triangles: torch.Tensor):
    """Closest hit + hit count: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if origins.is_cuda:
        return mt_raycast_cuda(origins.contiguous(), dirs.contiguous(),
                               vertices.contiguous(), triangles.contiguous())
    if origins.device.type == "cpu":
        return mt_raycast_plain(origins, dirs, vertices, triangles)
    raise ValueError(f"mt_raycast: unsupported device {origins.device}")
