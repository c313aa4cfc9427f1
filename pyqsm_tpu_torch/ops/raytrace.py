"""Ray–triangle intersection engine (counterpart of
``pyqsm_tpu/ops/raytrace.py``): closest-hit casting with an any-hit count,
per-ray enumeration of every crossing, ray generators, occupancy by
crossing parity, hit reconstruction, exposed areas and unsigned distance.

``cast_rays`` routes like the JAX package does on the TPU: below 4096
triangles to the fused kernel (``ops/mt_raycast.py``), at 4096 or more to
the uniform-grid caster (``ops/grid3d.py``, ``two_level_cast`` with every
crossing counted), whose grid is built once per mesh and kept in a small
cache keyed on the mesh's tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pyqsm_tpu_torch.device import input_device
from pyqsm_tpu_torch.ops.mt_raycast import (mt_components, mt_raycast, mt_raycast_plain,
                                            triangle_soa)

GRID_TRIANGLES = 4096  # ``cast_rays(backend="auto")`` switches to the grid here
_POINT_TILE = 256  # unsigned_distance: points per [P, T, 3] block


class Hits(NamedTuple):
    t: torch.Tensor  # [R] hit distance (inf = miss)
    tri: torch.Tensor  # [R] i32 triangle id (-1 = miss)
    uv: torch.Tensor  # [R, 2] barycentric (u, v) at hit
    count: torch.Tensor  # [R] i32 number of intersections along the ray


class HitList(NamedTuple):
    """Per-ray enumeration of every crossing, nearest-first (-1/inf pad)."""

    t: torch.Tensor  # [R, K] ascending hit distances, inf past count
    tri: torch.Tensor  # [R, K] i32 triangle ids, -1 past count
    uv: torch.Tensor  # [R, K, 2]
    count: torch.Tensor  # [R] i32 TOTAL crossings (may exceed K)


_GRID_CACHE: list = []  # [(weakref(vertices), weakref(triangles), grid)]
_GRID_CACHE_MAX = 2
_GRID_CACHE_BYTES = 2 << 30  # total bytes across cached grids


def clear_grid_cache() -> None:
    """Drop every cached grid (and the device memory its packed rows hold)."""
    _GRID_CACHE.clear()


def _grid_nbytes(g) -> int:
    return sum(_grid_nbytes(a) if isinstance(a, tuple)
               else int(a.nbytes) if isinstance(a, torch.Tensor) else 0 for a in g)


def _cached_grid3d(vertices: torch.Tensor, triangles: torch.Tensor):
    """Build or reuse the grid of a mesh, keyed on its tensor OBJECTS
    (weakrefs: a freed mesh drops out). At most ``_GRID_CACHE_MAX`` grids
    and ``_GRID_CACHE_BYTES`` in all are kept (one is kept whatever its
    size), oldest evicted first; ``clear_grid_cache`` frees them all."""
    import weakref

    from pyqsm_tpu_torch.ops.grid3d import build_grid3d_two_level

    live = []
    hit = None
    for wv, wt, g in _GRID_CACHE:
        v, t = wv(), wt()
        if v is None or t is None:
            continue
        live.append((wv, wt, g))
        if v is vertices and t is triangles:
            hit = g
    _GRID_CACHE[:] = live
    if hit is not None:
        return hit
    g = build_grid3d_two_level(vertices, triangles)
    _GRID_CACHE.append((weakref.ref(vertices), weakref.ref(triangles), g))
    del _GRID_CACHE[:-_GRID_CACHE_MAX]
    while (len(_GRID_CACHE) > 1
           and sum(_grid_nbytes(e[2]) for e in _GRID_CACHE) > _GRID_CACHE_BYTES):
        _GRID_CACHE.pop(0)
    return g


def cast_rays(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
              triangles: torch.Tensor, backend: str = "auto", grid=None) -> Hits:
    """Closest hit + hit count of every ray (directions need not be
    normalised; t is in direction units).

    ``backend``: "kernel" (the fused kernel, ``ops.mt_raycast``; its plain
    version for CPU tensors), "plain" (the tiled torch cast), "grid" (the
    uniform-grid DDA of ``ops.grid3d``, every crossing counted; the grid is
    cached per mesh tensor, or pass a prebuilt ``grid=``, a ``Grid3D`` or a
    ``TwoLevelGrid``) or "auto" ("kernel" below 4096 triangles, "grid" from
    4096, the JAX package's routing on the TPU)."""
    if grid is not None:
        backend = "grid"
    if backend == "auto":
        backend = "grid" if triangles.shape[0] >= GRID_TRIANGLES else "kernel"
    if backend == "grid":
        from pyqsm_tpu_torch.ops.grid3d import two_level_cast

        if grid is None:
            grid = _cached_grid3d(vertices, triangles)
        return two_level_cast(grid, origins, dirs, count_all=True)
    if backend == "kernel":
        return Hits(*mt_raycast(origins, dirs, vertices, triangles))
    if backend == "plain":
        return Hits(*mt_raycast_plain(origins, dirs, vertices, triangles))
    raise ValueError(f"cast_rays: unknown backend {backend!r}")


def list_intersections(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
                       triangles: torch.Tensor, max_hits: int = 8, ray_tile: int = 2048,
                       tri_tile: int = 1024) -> HitList:
    """Every crossing of every ray, nearest-first, up to ``max_hits`` per ray
    (Embree ``list_intersections``). Each triangle tile's candidates merge
    into the running K nearest by a stable sort, so equal t keeps the lower
    index first, as ``lax.top_k`` does. ``count`` is exact past K."""
    k = max_hits
    soa = triangle_soa(vertices.to(torch.float32), triangles)
    n_tri = soa.shape[1]
    r = origins.shape[0]
    dev = origins.device
    out_t = torch.full((r, k), torch.inf, device=dev)
    out_id = torch.full((r, k), -1, dtype=torch.int32, device=dev)
    out_uv = torch.zeros((r, k, 2), device=dev)
    out_cnt = torch.zeros((r,), dtype=torch.int32, device=dev)
    for r0 in range(0, r, ray_tile):
        o = origins[r0:r0 + ray_tile].to(torch.float32)
        d = dirs[r0:r0 + ray_tile].to(torch.float32)
        n = o.shape[0]
        ov = tuple(o[:, a:a + 1] for a in range(3))
        dv = tuple(d[:, a:a + 1] for a in range(3))
        best_t, best_id = out_t[r0:r0 + n], out_id[r0:r0 + n]
        best_uv, cnt = out_uv[r0:r0 + n], out_cnt[r0:r0 + n]
        for t0 in range(0, n_tri, tri_tile):
            s = soa[:, t0:t0 + tri_tile]
            t, u, v = mt_components(ov, dv, (s[0], s[1], s[2]), (s[3], s[4], s[5]),
                                    (s[6], s[7], s[8]), s[9] > 0)
            cnt += torch.isfinite(t).sum(dim=1, dtype=torch.int32)
            ids = torch.arange(t0, t0 + t.shape[1], dtype=torch.int32, device=dev)
            cat_t = torch.cat([best_t, t], dim=1)
            cat_id = torch.cat([best_id, ids.expand(n, -1)], dim=1)
            cat_uv = torch.cat([best_uv, torch.stack([u, v], dim=-1)], dim=1)
            sel = torch.sort(cat_t, dim=1, stable=True).indices[:, :k]
            new_t = cat_t.gather(1, sel)
            best_id.copy_(torch.where(torch.isfinite(new_t), cat_id.gather(1, sel), -1))
            best_uv.copy_(cat_uv.gather(1, sel[..., None].expand(-1, -1, 2)))
            best_t.copy_(new_t)
    return HitList(out_t, out_id, out_uv, out_cnt)


def hit_points_list(origins: torch.Tensor, dirs: torch.Tensor, hits: HitList) -> torch.Tensor:
    """[R, K, 3] world-space location of every enumerated crossing
    (o + t·d); NaN past each ray's count or K."""
    p = origins[:, None, :] + hits.t[..., None] * dirs[:, None, :]
    return torch.where((hits.tri >= 0)[..., None], p, torch.nan)


def _as_vec(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=1e-12)


def pinhole_rays(eye, center, up, fov_deg: float, width_px: int, height_px: int,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pinhole camera ray bundle (Open3D ``create_rays_pinhole`` semantics);
    on ``device``, or on ``eye``'s device when that is a tensor, else on
    the card."""
    device = input_device(eye, device)
    eye, center, up = (_as_vec(x, device) for x in (eye, center, up))
    fwd = _normalize(center - eye)
    right = _normalize(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    half = math.tan(math.radians(fov_deg) / 2.0)
    aspect = width_px / height_px
    xs = (torch.arange(width_px, device=device) + 0.5) / width_px * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height_px, device=device) + 0.5) / height_px * 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs = (fwd + gx[..., None] * half * aspect * right
            + gy[..., None] * half * true_up).reshape(-1, 3)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return eye.expand_as(dirs), dirs


def parallel_rays(lo, hi, direction, nx: int, ny: int, z_offset: float = 1.0,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Grid of parallel rays covering the AABB from any direction, laid out
    on the plane perpendicular to it, sized to the scene's bounding sphere
    and set back so every ray starts outside the scene. Per-ray cell area
    = (2R/nx)·(2R/ny). On ``device``, or on ``lo``'s device when that is a
    tensor, else on the card."""
    device = input_device(lo, device)
    lo, hi, direction = (_as_vec(x, device) for x in (lo, hi, direction))
    d = _normalize(direction)
    center = (lo + hi) / 2.0
    radius = torch.linalg.vector_norm(hi - lo) / 2.0 + 1e-3
    ref = _as_vec([0.0, 0.0, 1.0] if abs(float(d[2])) < 0.9 else [1.0, 0.0, 0.0], device)
    u = _normalize(torch.linalg.cross(d, ref))
    v = torch.linalg.cross(d, u)
    xs = torch.linspace(-1.0, 1.0, nx, device=device) * radius
    ys = torch.linspace(-1.0, 1.0, ny, device=device) * radius
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = center - d * (radius + z_offset)
    origins = (base + gx[..., None] * u + gy[..., None] * v).reshape(-1, 3)
    return origins, d.expand_as(origins)


# off-axis +z: rays do not run along shared triangle edges, where an edge
# hit would be counted by both neighbours and flip the parity
_OCC_DIR = (1.73205e-4, 2.23607e-4, 1.0)


def occupancy(points: torch.Tensor, vertices: torch.Tensor, triangles: torch.Tensor,
              backend: str = "auto") -> torch.Tensor:
    """Inside/outside by crossing parity along a slightly off-axis +z ray
    (the reference's ``compute_occupancy``)."""
    dirs = _as_vec(_OCC_DIR, points.device).expand_as(points)
    return (cast_rays(points, dirs, vertices, triangles, backend=backend).count % 2) == 1


def _corners(vertices: torch.Tensor, triangles: torch.Tensor):
    tri = triangles.clamp(min=0).long()
    return vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]]


def hit_points(hits: Hits, vertices: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """Barycentric reconstruction of hit locations; NaN rows are misses."""
    t0, t1, t2 = _corners(vertices, triangles)
    tid = hits.tri.clamp(min=0).long()
    u = hits.uv[:, 0:1]
    v = hits.uv[:, 1:2]
    p = (1 - u - v) * t0[tid] + u * t1[tid] + v * t2[tid]
    return torch.where((hits.tri >= 0)[:, None], p, torch.nan)


def triangle_areas(vertices: torch.Tensor, triangles: torch.Tensor,
                   flatten_z: bool = False) -> torch.Tensor:
    """Per-triangle area (0 on padding rows); ``flatten_z`` projects to
    z = 0 first (the 2D surface-area variant)."""
    a, b, c = _corners(vertices, triangles)
    scale = _as_vec([1.0, 1.0, 0.0] if flatten_z else [1.0, 1.0, 1.0], vertices.device)
    area = 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross((b - a) * scale, (c - a) * scale), dim=-1)
    return torch.where(triangles[:, 0] >= 0, area, 0.0)


def exposed_surface_area(hits: Hits, vertices: torch.Tensor,
                         triangles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(3D, z-flattened 2D) area of the triangles hit by any ray. Miss rows
    (tri = -1) are dropped from the scatter, as ``.at[].max(mode="drop")``
    drops their out-of-range index."""
    n = triangles.shape[0]
    hit_mask = torch.zeros(n + 1, dtype=torch.bool, device=vertices.device)
    hit_mask[torch.where(hits.tri >= 0, hits.tri.long(), n)] = True
    hit_mask = hit_mask[:n]
    a3 = triangle_areas(vertices, triangles, flatten_z=False)
    a2 = triangle_areas(vertices, triangles, flatten_z=True)
    return (torch.where(hit_mask, a3, 0.0).sum(), torch.where(hit_mask, a2, 0.0).sum())


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def unsigned_distance(points: torch.Tensor, vertices: torch.Tensor,
                      triangles: torch.Tensor) -> torch.Tensor:
    """Distance of every point to the closest valid triangle: the plane
    projection where it falls inside the triangle, else the closest of the
    three edges."""
    a, b, c = _corners(vertices, triangles)
    valid = triangles[:, 0] >= 0
    ab, ac = b - a, c - a
    nrm = torch.linalg.cross(ab, ac)
    nn = torch.clamp(_dot(nrm, nrm), min=1e-20)
    d00, d01, d11 = _dot(ab, ab), _dot(ab, ac), _dot(ac, ac)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)

    def seg_dist2(p, s0, s1):
        e = s1 - s0
        t = _dot(p - s0, e) / torch.clamp(_dot(e, e), min=1e-20)
        q = s0 + torch.clamp(t, 0.0, 1.0)[..., None] * e
        return _dot(p - q, p - q)

    out = []
    for p0 in range(0, points.shape[0], _POINT_TILE):
        p = points[p0:p0 + _POINT_TILE, None, :]  # [P, 1, 3] against [T, 3]
        dist_plane = _dot(p - a, nrm)
        proj = p - dist_plane[..., None] * nrm / nn[:, None]
        pv = proj - a
        d20, d21 = _dot(pv, ab), _dot(pv, ac)
        v = (d11 * d20 - d01 * d21) / denom
        w = (d00 * d21 - d01 * d20) / denom
        inside = (v >= 0) & (w >= 0) & (v + w <= 1)
        d2 = torch.minimum(
            torch.minimum(torch.where(inside, dist_plane * dist_plane / nn, torch.inf),
                          seg_dist2(p, a, b)),
            torch.minimum(seg_dist2(p, b, c), seg_dist2(p, a, c)))
        out.append(torch.sqrt(torch.where(valid, d2, torch.inf).amin(dim=1)))
    if not out:
        return torch.zeros(0, device=points.device)
    return torch.cat(out)
