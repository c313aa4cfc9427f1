"""Grid-accelerated casting of parallel ray bundles (counterpart of the
parallel-bundle half of ``pyqsm_tpu/ops/raygrid.py:40-260``).

Triangle AABBs are binned on the plane perpendicular to the bundle
direction (host numpy build, one sort), so every ray tests only its own
cell's list: a fixed-shape [rays × cap] Möller–Trumbore block per ray tile.
Exact: every triangle is registered in every cell its projected AABB
touches. The image grid (``build_image_grid``/``image_cast``) and
``cell_cast_parallel`` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.ops.raytrace import Hits, mt_components


class RayGrid(NamedTuple):
    u: torch.Tensor  # [3] bundle-plane basis
    v: torch.Tensor  # [3]
    origin_uv: torch.Tensor  # [2] grid origin in (u, v)
    cell: float  # cell size
    nx: int  # grid dims
    ny: int
    tri_of_slot: torch.Tensor  # [ncells, cap] i32 triangle ids (-1 padded)
    v0: torch.Tensor  # [T, 3] triangle data (input order)
    e1: torch.Tensor
    e2: torch.Tensor
    valid: torch.Tensor  # [T] bool
    # per-cell packed triangle rows (v0|e1|e2|valid|tri_id_bits|pad × cap):
    # one contiguous row gather per ray instead of cap separate ones
    cell_rows: torch.Tensor | None = None  # [ncells, cap*16] f32
    packed_cells: bool = False


def build_ray_grid(vertices: torch.Tensor, triangles: torch.Tensor, direction,
                   cell_cap: int | None = None, max_cells: int = 512) -> RayGrid:
    """Host-built grid for bundles along ``direction``, returned on the
    mesh's device. ``cell_cap=None`` sizes the table to the fullest cell;
    a given ``cell_cap`` below it raises ``ValueError``."""
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    ref = np.array([0.0, 0, 1]) if abs(d[2]) < 0.9 else np.array([1.0, 0, 0])
    u = np.cross(d, ref)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)

    tris = triangles.cpu().numpy()
    live = tris[:, 0] >= 0
    verts = vertices.cpu().numpy()
    t = np.maximum(tris, 0)
    p0, p1, p2 = verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]
    uv = np.stack([np.stack([p @ u, p @ v], -1) for p in (p0, p1, p2)], axis=1)  # [T, 3, 2]
    lo = uv.min(1)
    hi = uv.max(1)
    extent = np.where(live[:, None], hi - lo, 0.0)
    typical = float(np.percentile(extent[live], 50)) if live.any() else 1.0
    scene_lo = np.where(live[:, None], lo, np.inf).min(0)
    scene_hi = np.where(live[:, None], hi, -np.inf).max(0)
    span = np.maximum(scene_hi - scene_lo, 1e-6)
    # small cells maximise ray parallelism per triangle test; oversized
    # triangles simply register in more cells
    cell = max(typical, float(span.max()) / max_cells) + 1e-9
    nx = int(span[0] / cell) + 2
    ny = int(span[1] / cell) + 2

    c_lo = np.clip(np.floor((lo - scene_lo) / cell).astype(np.int64), 0, [nx - 1, ny - 1])
    c_hi = np.clip(np.floor((hi - scene_lo) / cell).astype(np.int64), 0, [nx - 1, ny - 1])
    span_x = int((c_hi[:, 0] - c_lo[:, 0]).max() + 1) if live.any() else 1
    span_y = int((c_hi[:, 1] - c_lo[:, 1]).max() + 1) if live.any() else 1
    entries_cell, entries_tri = [], []
    tri_ids = np.arange(len(tris))
    for dx in range(span_x):
        for dy in range(span_y):
            cx = c_lo[:, 0] + dx
            cy = c_lo[:, 1] + dy
            touch = (cx <= c_hi[:, 0]) & (cy <= c_hi[:, 1]) & live
            entries_cell.append(np.where(touch, cx * ny + cy, np.int64(-1)))
            entries_tri.append(np.where(touch, tri_ids, -1))
    ec = np.concatenate(entries_cell)
    et = np.concatenate(entries_tri)
    keep = ec >= 0
    ec, et = ec[keep], et[keep]

    ncells = nx * ny
    order = np.argsort(ec, kind="stable")
    ec, et = ec[order], et[order]
    starts = np.searchsorted(ec, np.arange(ncells))
    counts = np.diff(np.append(starts, len(ec)))
    occupancy = int(counts.max()) if len(counts) else 0
    if cell_cap is not None and occupancy > cell_cap:
        raise ValueError(f"cell_cap {cell_cap} < max triangles per cell {occupancy}; "
                         f"raise cell_cap or max_cells")
    cap = occupancy if cell_cap is None else cell_cap
    cap = max(-8 * (-cap // 8), 8)  # multiple of 8
    within = np.arange(len(ec)) - starts[ec]
    table = np.full((ncells, cap), -1, np.int32)
    table[ec, within] = et.astype(np.int32)

    v0 = p0.astype(np.float32)
    e1 = (p1 - p0).astype(np.float32)
    e2 = (p2 - p0).astype(np.float32)
    rows_flat, packed_cells = _pack_cell_rows(table, v0, e1, e2, live)
    dev = vertices.device

    def dv(x):
        return torch.as_tensor(x, device=dev)

    return RayGrid(u=dv(u.astype(np.float32)), v=dv(v.astype(np.float32)),
                   origin_uv=dv(scene_lo.astype(np.float32)), cell=float(cell), nx=nx, ny=ny,
                   tri_of_slot=dv(table), v0=dv(v0), e1=dv(e1), e2=dv(e2), valid=dv(live),
                   cell_rows=dv(rows_flat), packed_cells=packed_cells)


def _packed_rows_np(v0, e1, e2, live) -> np.ndarray:
    """[T, 16] f32 rows v0|e1|e2|valid|tri_id_bits|pad; the id's int32 bits
    sit in a float32 lane (read back with ``.view(torch.int32)`` — exact for
    any id)."""
    t = len(v0)
    rows = np.zeros((t, 16), np.float32)
    rows[:, 0:3] = v0
    rows[:, 3:6] = e1
    rows[:, 6:9] = e2
    rows[:, 9] = live.astype(np.float32)
    rows[:, 10] = np.arange(t, dtype=np.int32).view(np.float32)
    return rows


def _pack_cell_rows(table, v0, e1, e2, live, budget: int = 1 << 30) -> tuple[np.ndarray, bool]:
    """Per-cell packed rows [ncells, cap*16]; (zeros(8, 16), False) when the
    table would exceed ``budget`` bytes."""
    ncells, cap = table.shape
    if ncells * cap * 64 > budget:
        return np.zeros((8, 16), np.float32), False
    rows = _packed_rows_np(v0, e1, e2, live)[np.maximum(table, 0)]
    rows[table < 0] = 0.0
    return rows.reshape(ncells, cap * 16), True


def _grid_cast(origins: torch.Tensor, dirs: torch.Tensor, grid: RayGrid,
               ray_tile: int = 4096) -> Hits:
    r = origins.shape[0]
    cap = grid.tri_of_slot.shape[1]
    dev = origins.device
    out_t = torch.empty(r, device=dev)
    out_tri = torch.empty(r, dtype=torch.int32, device=dev)
    out_uv = torch.empty(r, 2, device=dev)
    out_cnt = torch.empty(r, dtype=torch.int32, device=dev)
    for r0 in range(0, r, ray_tile):
        ot = origins[r0:r0 + ray_tile].to(torch.float32)
        dt = dirs[r0:r0 + ray_tile].to(torch.float32)
        n = ot.shape[0]
        cx = torch.clamp(((ot @ grid.u - grid.origin_uv[0]) / grid.cell).to(torch.int32),
                         0, grid.nx - 1)
        cy = torch.clamp(((ot @ grid.v - grid.origin_uv[1]) / grid.cell).to(torch.int32),
                         0, grid.ny - 1)
        cells = (cx.long() * grid.ny + cy)
        if grid.packed_cells:
            rows = grid.cell_rows[cells].reshape(n, cap, 16)
            ok_tri = rows[..., 9] > 0.5
            slots = torch.where(ok_tri, rows[..., 10].contiguous().view(torch.int32), -1)
            tv0, te1, te2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
        else:
            slots = grid.tri_of_slot[cells]  # [RT, cap]
            tid = slots.clamp(min=0).long()
            ok_tri = (slots >= 0) & grid.valid[tid]
            tv0, te1, te2 = grid.v0[tid], grid.e1[tid], grid.e2[tid]
        tt, uu, vv = mt_components(
            tuple(ot[:, a:a + 1] for a in range(3)), tuple(dt[:, a:a + 1] for a in range(3)),
            tuple(tv0[..., a] for a in range(3)), tuple(te1[..., a] for a in range(3)),
            tuple(te2[..., a] for a in range(3)), ok_tri)
        j = torch.argmin(tt, dim=1, keepdim=True)
        tmin = tt.gather(1, j)[:, 0]
        sl = slice(r0, r0 + n)
        out_t[sl] = tmin
        out_tri[sl] = torch.where(torch.isfinite(tmin), slots.gather(1, j)[:, 0], -1)
        out_uv[sl] = torch.cat([uu.gather(1, j), vv.gather(1, j)], dim=1)
        out_cnt[sl] = torch.isfinite(tt).sum(dim=1, dtype=torch.int32)
    return Hits(out_t, out_tri, out_uv, out_cnt)


def grid_cast_parallel(grid: RayGrid, origins: torch.Tensor, dirs: torch.Tensor,
                       ray_tile: int = 4096) -> Hits:
    """Cast a parallel bundle against the prebuilt grid (directions must
    match the build direction)."""
    return _grid_cast(origins, dirs, grid, ray_tile=ray_tile)
