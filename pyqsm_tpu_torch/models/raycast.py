"""Environmental ray-casting workflows (counterpart of
``pyqsm_tpu/models/raycast.py``): exposed surface areas from camera or sun
bundles, swept sun angles (the canopy-exposure study), hit-point clouds,
every crossing of a nadir grid, and signed-distance slabs.

Every entry point runs on ``device`` (``cuda`` unless the caller asks for
the CPU) and moves the mesh there. ``cast_scene`` casts through the
screen-space image grid (``ops.raygrid.image_cast``) at 2048 triangles or
more and through ``ops.raytrace.cast_rays`` below; ``cast_rays`` sends
scenes below 4096 triangles to the fused kernel and larger ones to the 3D
grid (``ops.grid3d``), which is where ``occupancy``, ``mri_slices`` and the
brute fallback of ``sun_exposure`` go on large meshes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.config import RaycastConfig
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pyqsm_tpu_torch.ops.mesh import TriMesh
from pyqsm_tpu_torch.ops.raygrid import (build_image_grid, build_ray_grid, grid_cast_parallel,
                                         image_cast)
from pyqsm_tpu_torch.ops.raytrace import (HitList, Hits, cast_rays, exposed_surface_area,
                                          hit_points, hit_points_list, list_intersections,
                                          occupancy, parallel_rays, pinhole_rays,
                                          unsigned_distance)

IMAGE_GRID_TRIANGLES = 2048  # ``cast_scene`` switches to the image grid here


class ExposureResult(NamedTuple):
    hits: Hits
    surface_area_3d: float
    surface_area_2d: float
    hit_fraction: float


def _exposure(hits: Hits, mesh: TriMesh) -> ExposureResult:
    a3, a2 = exposed_surface_area(hits, mesh.vertices, mesh.triangles)
    frac = float((hits.tri >= 0).to(torch.float32).mean())
    return ExposureResult(hits, float(a3), float(a2), frac)


def cast_scene(mesh: TriMesh, eye=None, center=None, cfg: RaycastConfig | None = None,
               device: str | torch.device = DEFAULT_DEVICE) -> ExposureResult:
    """Pinhole cast + exposed-surface-area metrics (the reference's
    ``cast_rays``: the eye defaults to center + 10 z, the center to the
    vertex mean). Meshes of ``IMAGE_GRID_TRIANGLES`` or more cast through
    the screen-space image grid, exact like the brute cast."""
    dev = resolve_device(device)
    cfg = cfg or RaycastConfig()
    mesh = mesh.to(dev)
    center = mesh.vertices.mean(dim=0) if center is None else \
        torch.as_tensor(center, dtype=torch.float32, device=dev)
    eye = center + torch.tensor([0.0, 0.0, 10.0], device=dev) if eye is None else \
        torch.as_tensor(eye, dtype=torch.float32, device=dev)
    up = [0.0, 1.0, 0.0]
    if mesh.triangles.shape[0] >= IMAGE_GRID_TRIANGLES:
        grid = build_image_grid(mesh.vertices, mesh.triangles, eye, center, up, cfg.fov_deg,
                                cfg.width_px, cfg.height_px)
        return _exposure(image_cast(grid), mesh)
    origins, dirs = pinhole_rays(eye, center, up, cfg.fov_deg, cfg.width_px, cfg.height_px,
                                 device=dev)
    return _exposure(cast_rays(origins, dirs, mesh.vertices, mesh.triangles), mesh)


def _sun_direction(azimuth_deg: float, elevation_deg: float) -> np.ndarray:
    az, el = np.radians(azimuth_deg), np.radians(elevation_deg)
    return -np.asarray([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)],
                       dtype=np.float32)


def _bounds(mesh: TriMesh) -> tuple[torch.Tensor, torch.Tensor]:
    return mesh.vertices.amin(dim=0), mesh.vertices.amax(dim=0)


def sun_exposure(mesh: TriMesh, azimuth_deg: float = 0.0, elevation_deg: float = 90.0,
                 nx: int = 256, ny: int = 256, backend: str = "grid",
                 device: str | torch.device = DEFAULT_DEVICE) -> ExposureResult:
    """Parallel-ray (sun/rain) exposure from one sun angle.

    ``backend="grid"`` bins triangles on the plane perpendicular to the
    bundle (``ops.raygrid``) so each ray tests only its own cell; a cell
    holding more than 256 triangles makes the build raise, and the cast
    then takes the brute route, as in the JAX package. ``"brute"`` casts
    every ray against every triangle (``cast_rays``)."""
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    direction = _sun_direction(azimuth_deg, elevation_deg)
    lo, hi = _bounds(mesh)
    origins, dirs = parallel_rays(lo, hi, direction, nx, ny, z_offset=1.0, device=dev)
    if backend not in ("grid", "brute"):
        raise ValueError(f"sun_exposure: unknown backend {backend!r}")
    grid = None
    if backend == "grid":
        try:
            grid = build_ray_grid(mesh.vertices, mesh.triangles, direction, cell_cap=256)
        except ValueError:  # a cell holds more than 256 triangles: brute, as the JAX package
            grid = None
    hits = grid_cast_parallel(grid, origins, dirs) if grid is not None else \
        cast_rays(origins, dirs, mesh.vertices, mesh.triangles)
    return _exposure(hits, mesh)


def sun_sweep(mesh: TriMesh, elevations: tuple[float, ...] = (30.0, 45.0, 60.0, 75.0, 90.0),
              azimuth_deg: float = 180.0, nx: int = 256, ny: int = 256,
              device: str | torch.device = DEFAULT_DEVICE) -> dict[float, ExposureResult]:
    """Swept sun-angle exposure table (the methods' raycasting projection)."""
    return {el: sun_exposure(mesh, azimuth_deg, el, nx, ny, device=device) for el in elevations}


def raycast_to_pcd(mesh: TriMesh, hits: Hits,
                   device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """Hit-point cloud (the reference's ``raycast_to_pcd``): NaN rows are
    misses."""
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    return hit_points(Hits(*(x.to(dev) for x in hits)), mesh.vertices, mesh.triangles)


def sparse_cast_with_intersections(mesh: TriMesh, nx: int = 64, ny: int = 64,
                                   max_hits: int = 8, direction=(0.0, 0.0, -1.0),
                                   device: str | torch.device = DEFAULT_DEVICE,
                                   ) -> tuple[HitList, torch.Tensor]:
    """Parallel-ray grid (nadir by default) with every crossing enumerated
    per ray (the reference's ``sparse_cast_w_intersections``). Returns the
    [R, max_hits] hit list and the [R, max_hits, 3] crossing cloud (NaN past
    each ray's count)."""
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    lo, hi = _bounds(mesh)
    origins, dirs = parallel_rays(lo, hi, direction, nx, ny, z_offset=1.0, device=dev)
    hl = list_intersections(origins, dirs, mesh.vertices, mesh.triangles, max_hits=max_hits)
    return hl, hit_points_list(origins, dirs, hl)


def mri_slices(mesh: TriMesh, axis: int = 2, n_slices: int = 8, resolution: int = 64,
               device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """Signed-distance slabs through the mesh (the reference's ``mri``):
    [n_slices, res, res], negative inside (crossing parity)."""
    dev = resolve_device(device)
    mesh = mesh.to(dev)
    v = mesh.vertices.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    other = [i for i in range(3) if i != axis]
    slabs = np.linspace(lo[axis], hi[axis], n_slices)
    xs = np.linspace(lo[other[0]], hi[other[0]], resolution)
    ys = np.linspace(lo[other[1]], hi[other[1]], resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    out = []
    for s in slabs:
        pts = np.zeros((resolution * resolution, 3), np.float32)
        pts[:, other[0]] = gx.ravel()
        pts[:, other[1]] = gy.ravel()
        pts[:, axis] = s
        p = torch.as_tensor(pts, device=dev)
        d = unsigned_distance(p, mesh.vertices, mesh.triangles)
        inside = occupancy(p, mesh.vertices, mesh.triangles)
        out.append(torch.where(inside, -d, d).reshape(resolution, resolution))
    return torch.stack(out)
