"""Surface reconstruction on the device: density field → marching
tetrahedra (counterpart of ``pyqsm_tpu/ops/voxelmesh.py``).

Points are splatted into a voxel density grid (scatter-add of ones, exact
in float32 whatever the order of the atomics), smoothed by a separable box
blur and contoured with marching tetrahedra: each cube splits into 6 Kuhn
tetrahedra around its 0-7 diagonal, a 16-case table that stays watertight
across cube faces. The splat, the blur, the active-cell test and the
triangle emission run on the device; the grid bounds, the iso level
(``np.percentile``) and the compaction of emitted triangles stay on the
host, as in the JAX package. ``simplify_mesh`` and ``weld_vertices`` are
host numpy, as there.

The output mesh has duplicated (unwelded) vertices — exact for area, ray
casting and occupancy; ``weld_vertices`` merges them for topology audits.
"""

from __future__ import annotations

import numpy as np
import torch

from pyqsm_tpu_torch.ops.mesh import TriMesh, empty_mesh

# Kuhn decomposition: 6 tetrahedra around the 0-7 cube diagonal. Cube
# corners are bit-indexed (x<<2 | y<<1 | z) offsets.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int64)

# tet edges: pairs of local tet-corner indices (0..3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# case (4-bit: bit i set = corner i ≥ iso) → up to 2 triangles of edge ids
_TET_TRIS = -np.ones((16, 2, 3), np.int64)
_TET_TRIS[1, 0] = [0, 1, 2]   # corner 0 inside
_TET_TRIS[14, 0] = [0, 1, 2]
_TET_TRIS[2, 0] = [0, 3, 4]   # corner 1
_TET_TRIS[13, 0] = [0, 3, 4]
_TET_TRIS[4, 0] = [1, 3, 5]   # corner 2
_TET_TRIS[11, 0] = [1, 3, 5]
_TET_TRIS[8, 0] = [2, 4, 5]   # corner 3
_TET_TRIS[7, 0] = [2, 4, 5]
_TET_TRIS[3] = [[1, 2, 4], [1, 4, 3]]    # corners 0,1
_TET_TRIS[12] = [[1, 2, 4], [1, 4, 3]]
_TET_TRIS[5] = [[0, 2, 5], [0, 5, 3]]    # corners 0,2
_TET_TRIS[10] = [[0, 2, 5], [0, 5, 3]]
_TET_TRIS[9] = [[0, 1, 5], [0, 5, 4]]    # corners 0,3
_TET_TRIS[6] = [[0, 1, 5], [0, 5, 4]]

_CORNER_OFF = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)], np.int64)


def density_grid(points: torch.Tensor, mask: torch.Tensor, lo, voxel: float, nx: int,
                 ny: int, nz: int, blur_iters: int = 2) -> torch.Tensor:
    """Point-count density field on an (nx, ny, nz) corner lattice, box-
    blurred ``blur_iters`` times (each pass widens the support by a cell)."""
    dev = points.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    c = torch.floor((points - lo) / voxel).to(torch.int32)
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    ok = mask & ((c >= 0) & (c < dims)).all(dim=1)
    flat = torch.where(ok, (c[:, 0].long() * ny + c[:, 1]) * nz + c[:, 2], nx * ny * nz)
    field = torch.zeros(nx * ny * nz + 1, dtype=torch.float32, device=dev).index_add_(
        0, flat, torch.ones(flat.shape[0], device=dev))[:-1].reshape(nx, ny, nz)

    def blur_axis(f, axis):
        n = f.shape[axis]
        zero = torch.zeros_like(f.narrow(axis, 0, 1))
        lo_ = torch.cat([zero, f.narrow(axis, 0, n - 1)], dim=axis)  # f[i-1], 0 outside
        hi_ = torch.cat([f.narrow(axis, 1, n - 1), zero], dim=axis)  # f[i+1], 0 outside
        return (f + lo_ + hi_) / 3.0

    for _ in range(blur_iters):
        for ax in range(3):
            field = blur_axis(field, ax)
    return field


def _cell_active(field: torch.Tensor, iso: float) -> torch.Tensor:
    """[ncells] bool: the cube has corners on both sides of iso."""
    nx, ny, nz = field.shape
    above = field >= iso
    cells_any = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.bool, device=field.device)
    cells_all = torch.ones_like(cells_any)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                a = above[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
                cells_any = cells_any | a
                cells_all = cells_all & a
    return (cells_any & ~cells_all).reshape(-1)


def _emit_triangles(field: torch.Tensor, iso: float, cell_ids: torch.Tensor, lo,
                    voxel: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangles of the given cells: (verts [M, 12, 3, 3], valid [M, 12]) —
    6 tets × 2 triangle slots per cell."""
    nx, ny, nz = field.shape
    dev = field.device
    f = field.reshape(-1)
    m = cell_ids.shape[0]
    cid = cell_ids.long()
    cz = cid % (nz - 1)
    cy = (cid // (nz - 1)) % (ny - 1)
    cx = cid // ((nz - 1) * (ny - 1))
    off = torch.as_tensor(_CORNER_OFF, device=dev)
    gx = cx[:, None] + off[None, :, 0]
    gy = cy[:, None] + off[None, :, 1]
    gz = cz[:, None] + off[None, :, 2]
    vals = f[(gx * ny + gy) * nz + gz]  # [M, 8]
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    pos = lo + voxel * torch.stack([gx, gy, gz], dim=-1).to(torch.float32)  # [M, 8, 3]

    tets = torch.as_tensor(_TETS, device=dev)
    edges = torch.as_tensor(_TET_EDGES, device=dev)
    tvals = vals[:, tets]  # [M, 6, 4]
    tpos = pos[:, tets]  # [M, 6, 4, 3]
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    case = ((tvals >= iso).long() * bits).sum(dim=-1)  # [M, 6]

    a = tpos[:, :, edges[:, 0]]  # [M, 6, 6e, 3]
    b = tpos[:, :, edges[:, 1]]
    va = tvals[:, :, edges[:, 0]]
    vb = tvals[:, :, edges[:, 1]]
    denom = vb - va
    t = torch.clamp((iso - va) / torch.where(denom.abs() < 1e-12, 1e-12, denom), 0.0, 1.0)
    epts = a + t[..., None] * (b - a)  # [M, 6, 6e, 3]

    tri_edges = torch.as_tensor(_TET_TRIS, device=dev)[case]  # [M, 6, 2, 3]
    ok = tri_edges[..., 0] >= 0  # [M, 6, 2]
    safe = tri_edges.clamp(min=0)
    verts = torch.gather(epts[:, :, None].expand(-1, -1, 2, -1, -1), 3,
                         safe[..., None].expand(-1, -1, -1, -1, 3))  # [M, 6, 2, 3, 3]
    return verts.reshape(m, 12, 3, 3), ok.reshape(m, 12)


def marching_tetrahedra(field: torch.Tensor, lo, voxel: float, iso: float,
                        cell_chunk: int = 1 << 16) -> TriMesh:
    """Isosurface of a [nx, ny, nz] field: active cells found on the
    device, triangles emitted there in chunks of ``cell_chunk`` cells and
    compacted in cell order."""
    rows = torch.nonzero(_cell_active(field, iso))[:, 0]
    if rows.numel() == 0:
        return empty_mesh(field.device)
    kept = []
    for c0 in range(0, rows.numel(), cell_chunk):
        verts, ok = _emit_triangles(field, iso, rows[c0:c0 + cell_chunk], lo, voxel)
        kept.append(verts.reshape(-1, 3, 3)[ok.reshape(-1)])
    v = torch.cat(kept)
    nt = v.shape[0]
    triangles = torch.arange(nt * 3, dtype=torch.int32, device=field.device).reshape(nt, 3)
    return TriMesh(v.reshape(-1, 3).contiguous(), triangles)


def poisson_like_mesh(points: torch.Tensor, mask: torch.Tensor | None = None,
                      voxel: float = 0.1, blur_iters: int = 2, iso_pctile: float = 30.0,
                      max_cells_per_axis: int = 192) -> TriMesh:
    """Watertight-style surface around a point cloud: density splat + blur +
    marching tetrahedra, on the points' device (the Poisson-reconstruction
    stand-in of the JAX package)."""
    dev = points.device
    m = torch.ones(points.shape[0], dtype=torch.bool, device=dev) if mask is None else mask
    live = points[m]
    if live.shape[0] < 4:
        return empty_mesh(dev)
    lo = live.amin(0).cpu().numpy()
    hi = live.amax(0).cpu().numpy()
    span = np.maximum(hi - lo, 1e-6)
    voxel = max(voxel, float(span.max()) / max_cells_per_axis)
    pad = (blur_iters + 2) * voxel
    lo = lo - pad
    dims = np.ceil((span + 2 * pad) / voxel).astype(int) + 1
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    field = density_grid(points.to(torch.float32), m, lo, float(voxel), nx, ny, nz,
                         blur_iters=blur_iters)
    positive = field[field > 1e-6].cpu().numpy()
    if len(positive) == 0:
        return empty_mesh(dev)
    iso = float(np.percentile(positive, iso_pctile))
    return marching_tetrahedra(field, lo, voxel, iso)


def simplify_mesh(mesh: TriMesh, target_triangles: int, max_rounds: int = 6) -> TriMesh:
    """Vertex-clustering decimation: snap vertices to the centroid of their
    grid cell, drop degenerate and duplicate triangles, and grow the cell
    until the count lands at ``target_triangles`` (triangle count scales
    ~(1/cell)²). Host numpy, as in the JAX package; the result is welded
    and goes back to the mesh's device."""
    v = mesh.vertices.cpu().numpy()
    t = mesh.triangles.cpu().numpy()
    t = t[t[:, 0] >= 0]
    n0 = len(t)
    if n0 <= target_triangles:
        return mesh
    lo = v.min(0)
    e = np.linalg.norm(v[t[:, 1]] - v[t[:, 0]], axis=1)
    r0 = float(np.median(e)) + 1e-9
    cell = r0 * float(np.sqrt(n0 / target_triangles))
    best = None
    for _ in range(max_rounds):
        key = np.floor((v - lo) / cell).astype(np.int64)
        _, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        cnt = np.bincount(inv).astype(np.float64)
        cx = np.stack([np.bincount(inv, weights=v[:, i]) for i in range(3)], 1) / cnt[:, None]
        t2 = inv[t]
        nondegen = (t2[:, 0] != t2[:, 1]) & (t2[:, 1] != t2[:, 2]) & (t2[:, 0] != t2[:, 2])
        t2 = t2[nondegen]
        _, uidx = np.unique(np.sort(t2, 1), axis=0, return_index=True)
        t2 = t2[np.sort(uidx)]
        best = (cx, t2)
        if len(t2) <= target_triangles:
            break
        cell *= float(np.sqrt(len(t2) / target_triangles)) * 1.05
    cx, t2 = best
    dev = mesh.vertices.device
    return TriMesh(torch.as_tensor(cx.astype(np.float32), device=dev),
                   torch.as_tensor(t2.astype(np.int32), device=dev))


def weld_vertices(mesh: TriMesh, tol: float = 1e-6) -> TriMesh:
    """Merge duplicated vertices (host) so topology audits see shared edges."""
    v = mesh.vertices.cpu().numpy()
    t = mesh.triangles.cpu().numpy()
    t = t[t[:, 0] >= 0]
    key = np.round(v / tol).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    dev = mesh.vertices.device
    return TriMesh(torch.as_tensor(v[first].astype(np.float32), device=dev),
                   torch.as_tensor(inv.reshape(-1)[t].astype(np.int32), device=dev))
