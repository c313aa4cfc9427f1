"""Sharded ray casting over a process mesh (counterpart of
``pyqsm_tpu/parallel/raycast.py``).

Every rank calls an entry point with the same full inputs and gets the
same full result back, as the JAX package returns replicated outputs. The
scene and its grid tables are replicated on each rank's device; the ray,
cell or pixel-tile axis splits over the mesh axis ``axis`` into contiguous
parts, each rank casts its part with the single-device body on
``mesh.device``, and ``all_gather_rows`` returns the parts in order. Every
ray (cell, tile) is cast on its own, so the result equals the single-device
call bit for bit.

- ``sharded_cast_rays``: the ray axis, each part through
  ``cast_rays(backend="kernel")`` (the ``mt_raycast`` kernel on a card);
- ``sharded_grid_cast``: the ray axis through the 3D grid's DDA;
- ``sharded_cell_cast``: the cell axis of a parallel-bundle grid, padded
  to whole ``cell_tile`` strips a rank, through ``raygrid._cell_cast_rows``;
- ``sharded_image_cast``: each occupancy bucket's live tiles, through
  ``raygrid._image_cast_tiles``; the eye-straddling residual pass splits
  the pixels and casts them through ``mt_raycast``.

On a mesh of several axes the other axes hold copies: their ranks compute
the same parts, and the gather keeps one copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pyqsm_tpu_torch.device import as_tensor, to_numpy
from pyqsm_tpu_torch.ops.grid3d import grid_cast
from pyqsm_tpu_torch.ops.raygrid import (CellCastResult, _assemble_image, _cell_cast_rows,
                                         _image_cast_tiles, _merge_residual)
from pyqsm_tpu_torch.ops.raytrace import Hits, cast_rays
from pyqsm_tpu_torch.parallel.mesh import Mesh, all_gather_rows


def _axis(mesh: Mesh, axis: str) -> tuple[int, int, int]:
    """(parts, this rank's part, the rank stride of one step along ``axis``)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no axis {axis!r}")
    i = mesh.axis_names.index(axis)
    return mesh.axis_sizes[i], mesh.coords()[axis], math.prod(mesh.axis_sizes[i + 1:])


def _gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every part of ``axis`` in order: the rows of the ranks at coordinate
    0 of every other axis."""
    k, _, stride = _axis(mesh, axis)
    rows = all_gather_rows(x, mesh)
    if k == mesh.size:
        return rows
    parts = rows.reshape((mesh.size, x.shape[0]) + tuple(x.shape[1:]))
    return parts[torch.arange(k, device=x.device) * stride].reshape((-1,) + tuple(x.shape[1:]))


def _ray_part(n: int, mesh: Mesh, axis: str, name: str) -> slice:
    """This rank's rays of ``n``, which the axis must divide (as the JAX
    package's ``shard_map`` requires)."""
    k, p, _ = _axis(mesh, axis)
    if n % k:
        raise ValueError(f"{name}: {n} rays do not split over {axis}={k}; pad the bundle")
    per = n // k
    return slice(p * per, (p + 1) * per)


def _padded_part(x: torch.Tensor, n: int, k: int, p: int, value: float) -> torch.Tensor:
    """Part ``p`` of ``k`` of the first ``n`` rows of ``x``, cut after
    padding them with ``value`` rows to a multiple of ``k``."""
    per = -(-n // k)
    part = x[min(p * per, n):min((p + 1) * per, n)]
    pad = per - part.shape[0]
    return F.pad(part, (0, 0) * (x.dim() - 1) + (0, pad), value=value) if pad else part


def _on(grid, dev: torch.device):
    """A grid (NamedTuple) with its tensors, also those in tuples such as an
    image grid's buckets, on ``dev``."""
    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple) and not hasattr(x, "_fields"):
            return tuple(mv(y) for y in x)
        return x

    return type(grid)(*(mv(x) for x in grid))


def sharded_cast_rays(mesh: Mesh, origins, dirs, vertices, triangles,
                      axis: str = "points") -> Hits:
    """Closest hits and counts with the ray axis split over ``axis``, the
    triangles replicated. The ray count must divide the axis size."""
    dev = mesh.device
    part = _ray_part(origins.shape[0], mesh, axis, "sharded_cast_rays")
    h = cast_rays(as_tensor(origins[part], dev, torch.float32).contiguous(),
                  as_tensor(dirs[part], dev, torch.float32).contiguous(),
                  as_tensor(vertices, dev, torch.float32), as_tensor(triangles, dev, torch.int32),
                  backend="kernel")
    return Hits(*(_gather(x, mesh, axis) for x in h))


def sharded_grid_cast(mesh: Mesh, grid, origins, dirs, axis: str = "points",
                      ray_tile: int = 4096, count_all: bool = False) -> Hits:
    """``grid_cast`` (the 3D grid's DDA) with the ray axis split over
    ``axis`` and the grid replicated. The ray count must divide the axis
    size."""
    dev = mesh.device
    part = _ray_part(origins.shape[0], mesh, axis, "sharded_grid_cast")
    h = grid_cast(_on(grid, dev), as_tensor(origins[part], dev, torch.float32),
                  as_tensor(dirs[part], dev, torch.float32), ray_tile=ray_tile,
                  count_all=count_all)
    return Hits(*(_gather(x, mesh, axis) for x in h))


def sharded_cell_cast(mesh: Mesh, grid, direction, rays_per_cell_side: int = 4,
                      cell_tile: int = 256, back_dist: float = 1e3,
                      axis: str = "points") -> CellCastResult:
    """``cell_cast_parallel`` with the cell axis split over ``axis``: it is
    padded to ``ceil(cells / (parts · cell_tile)) · cell_tile`` cells a
    part (padding cells hold no triangle), and each rank casts one
    contiguous strip of cells, its triangle rows with it."""
    dev = mesh.device
    k, p, _ = _axis(mesh, axis)
    g = _on(grid, dev)
    ncells = g.nx * g.ny
    per = -(-ncells // (k * cell_tile)) * cell_tile
    start, stop = min(p * per, ncells), min((p + 1) * per, ncells)
    pad = per - (stop - start)
    table = F.pad(g.tri_of_slot[start:stop], (0, 0, 0, pad), value=-1)
    packed = bool(g.packed_cells)
    rows = F.pad(g.cell_rows[start:stop], (0, 0, 0, pad)) if packed else None
    cell_ids = torch.arange(p * per, (p + 1) * per, dtype=torch.int32, device=dev)
    d = torch.as_tensor(to_numpy(direction), dtype=torch.float32, device=dev)
    t, tri, cnt = _cell_cast_rows(d, g.u, g.v, g.origin_uv, g.cell, g.nx, g.ny, table, cell_ids,
                                  g.v0, g.e1, g.e2, g.valid, rays_per_cell_side, cell_tile,
                                  back_dist, rows_strip=rows, packed_cells=packed)
    t, tri, cnt = (_gather(x, mesh, axis)[:ncells] for x in (t, tri, cnt))
    return CellCastResult(t=t, tri=tri, count=cnt, ray_area=(g.cell / rays_per_cell_side) ** 2)


def sharded_image_cast(mesh: Mesh, grid, axis: str = "points") -> Hits:
    """``image_cast`` with each occupancy bucket's live tiles split over
    ``axis`` (padded with empty tiles to a multiple of its size) and the
    scene replicated; the parts are gathered, scattered to their tiles and
    assembled into the row-major image. The eye-straddling residual
    triangles are cast by every pixel, the pixels split over ``axis``,
    through ``cast_rays(backend="kernel")`` on ``image_rays``' rays, and
    merged as ``image_cast`` merges them."""
    dev = mesh.device
    k, p, _ = _axis(mesh, axis)
    g = _on(grid, dev)

    def parts():
        for cap, ids, rows in g.buckets:
            m = int((ids >= 0).sum())  # the live ids are front-packed
            ids_p = _padded_part(ids[:, None], m, k, p, -1)[:, 0]
            res = _image_cast_tiles(ids_p, g.eye, g.right, g.true_up, g.fwd, g.half, g.aspect,
                                    g.width, g.height, g.tile_px, g.tri_of_slot[:, :cap], g.v0,
                                    g.e1, g.e2, g.valid, tiles_per_block=max(ids_p.shape[0], 1),
                                    rows_aligned=_padded_part(rows, m, k, p, 0.0),
                                    packed_cells=True)
            ids_all = torch.cat([_padded_part(ids[:, None], m, k, q, -1)[:, 0] for q in range(k)])
            yield ids_all, tuple(_gather(x, mesh, axis) for x in res)

    t, tri, u, v, cnt = _assemble_image(parts(), g.width, g.height, g.tile_px, dev)
    return _merge_residual(g, t, tri, torch.stack([u, v], 1), cnt,
                           lambda o, d, verts, tris: _pixel_cast(mesh, axis, o, d, verts, tris))


def _pixel_cast(mesh: Mesh, axis: str, origins, dirs, vertices, triangles) -> Hits:
    """``cast_rays(backend="kernel")`` of every pixel's ray, the pixels
    split over ``axis`` (padded to a multiple of its size)."""
    k, p, _ = _axis(mesh, axis)
    n = origins.shape[0]
    h = cast_rays(_padded_part(origins, n, k, p, 0.0).contiguous(),
                  _padded_part(dirs, n, k, p, 1.0).contiguous(), vertices, triangles,
                  backend="kernel")
    return Hits(*(_gather(x, mesh, axis)[:n] for x in h))
