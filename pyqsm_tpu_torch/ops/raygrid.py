"""Grid-accelerated casting of structured ray bundles (counterpart of
``pyqsm_tpu/ops/raygrid.py``): parallel (sun) bundles and pinhole bundles.

Each family admits a 2D binning in which the bundle is axis-aligned, built
on the host with numpy (one sort):

- parallel bundles: triangle AABBs binned on the plane perpendicular to
  the direction (``build_ray_grid``); ``grid_cast_parallel`` casts given
  rays, each against its own cell's list, and ``cell_cast_parallel``
  makes ``rays_per_cell_side²`` rays a cell and tests each cell's list
  once for its whole block of rays;
- pinhole bundles: projected triangle AABBs binned in image space
  (``build_image_grid``); ``image_cast`` casts every pixel against its own
  tile's list, with tiles bucketed by occupancy so a dense tile does not
  set the Möller–Trumbore width of every tile. Triangles at or behind the
  eye plane go to a residual list that every pixel tests through
  ``cast_rays(backend="kernel")`` (the ``mt_raycast`` kernel on a card).

Exact: every triangle is registered in every cell or tile its (projected)
AABB touches. The casts are plain torch on the caller's device; blocks of
tiles or cells are sized so that no intermediate passes ``_BLOCK_ELEMS``
elements, which changes no result (blocks are independent).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import to_numpy
from pyqsm_tpu_torch.ops.neighbors import _fma, _sq3, _sqrt
from pyqsm_tpu_torch.ops.raytrace import Hits, cast_rays, mt_components

# elements of one [tiles or cells, cap, rays] intermediate of a block
_BLOCK_ELEMS = 1 << 23


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


def _block_size(limit: int, cap: int, rays: int) -> int:
    """Tiles or cells a block: at most ``limit`` and ``_BLOCK_ELEMS`` elements
    an intermediate, a power of two."""
    b = 1
    while b * 2 <= limit and b * 2 * cap * rays <= _BLOCK_ELEMS:
        b *= 2
    return b


class ImageGrid(NamedTuple):
    """Screen-space tiled binning for PINHOLE bundles: triangles are
    registered in every pixel tile their projected AABB touches, and each
    pixel tests only its own tile's list. Exact closest hits and crossing
    counts; triangles with any vertex at or behind the eye plane go to
    ``residual`` and are tested by every pixel."""

    eye: torch.Tensor  # [3]
    right: torch.Tensor  # [3] camera basis
    true_up: torch.Tensor
    fwd: torch.Tensor
    half: float  # tan(fov/2)
    aspect: float
    width: int
    height: int
    tile_px: int
    tri_of_slot: torch.Tensor  # [ntiles, cap] i32
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    valid: torch.Tensor
    residual: torch.Tensor  # [nr] i32 behind/straddling-eye triangles (-1 pad)
    # occupancy buckets ((cap, tile_ids, rows), ...): ``tile_ids`` [M] the
    # tiles of occupancy in (cap/2, cap] front-packed, -1 padded to a power
    # of two ≥ 512; ``rows`` [M, cap*16] their packed triangle rows
    buckets: tuple = ()


def build_image_grid(vertices: torch.Tensor, triangles: torch.Tensor, eye, center, up,
                     fov_deg: float, width_px: int, height_px: int,
                     tile_px: int = 8) -> ImageGrid:
    """Host-built screen-space grid (one sort) for the pinhole bundle of
    ``pinhole_rays(eye, center, up, fov_deg, width_px, height_px)``,
    returned on the mesh's device."""
    eye = to_numpy(eye).astype(np.float64)
    center = to_numpy(center).astype(np.float64)
    up = to_numpy(up).astype(np.float64)
    fwd = center - eye
    fwd /= max(np.linalg.norm(fwd), 1e-12)
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-12)
    true_up = np.cross(right, fwd)
    half = float(np.tan(np.radians(fov_deg) / 2.0))
    aspect = width_px / height_px

    tris = to_numpy(triangles)
    live = tris[:, 0] >= 0
    verts = to_numpy(vertices).astype(np.float64)
    t = np.maximum(tris, 0)
    p = np.stack([verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]], 1)  # [T, 3, 3]
    rel = p - eye
    x = rel @ right
    y = rel @ true_up
    w = rel @ fwd
    front = live & (w > 1e-6).all(1)
    # pixel coords of each vertex (perspective divide), matching pinhole_rays
    sx = x / np.maximum(w, 1e-12) / (half * aspect)
    sy = y / np.maximum(w, 1e-12) / half
    px = (sx + 1.0) / 2.0 * width_px
    py = (1.0 - sy) / 2.0 * height_px
    ntx = -(-width_px // tile_px)
    nty = -(-height_px // tile_px)
    tx_lo = np.clip(np.floor(px.min(1) / tile_px).astype(np.int64), 0, ntx - 1)
    tx_hi = np.clip(np.floor(px.max(1) / tile_px).astype(np.int64), 0, ntx - 1)
    ty_lo = np.clip(np.floor(py.min(1) / tile_px).astype(np.int64), 0, nty - 1)
    ty_hi = np.clip(np.floor(py.max(1) / tile_px).astype(np.int64), 0, nty - 1)
    # cull triangles fully outside the image
    visible = front & (px.max(1) >= 0) & (px.min(1) < width_px) \
        & (py.max(1) >= 0) & (py.min(1) < height_px)

    tri_ids = np.arange(len(tris), dtype=np.int64)
    sx_span = int((tx_hi - tx_lo)[visible].max() + 1) if visible.any() else 1
    sy_span = int((ty_hi - ty_lo)[visible].max() + 1) if visible.any() else 1
    entries_cell, entries_tri = [], []
    for dx in range(sx_span):
        for dy in range(sy_span):
            cx = tx_lo + dx
            cy = ty_lo + dy
            touch = (cx <= tx_hi) & (cy <= ty_hi) & visible
            if not touch.any():
                continue
            entries_cell.append(np.where(touch, cx * nty + cy, -1))
            entries_tri.append(np.where(touch, tri_ids, -1))
    if entries_cell:
        ec = np.concatenate(entries_cell)
        et = np.concatenate(entries_tri)
        keep = ec >= 0
        ec, et = ec[keep], et[keep]
    else:
        ec = np.zeros(0, np.int64)
        et = np.zeros(0, np.int64)
    ntiles = ntx * nty
    order = np.argsort(ec, kind="stable")
    ec, et = ec[order], et[order]
    starts = np.searchsorted(ec, np.arange(ntiles))
    within = np.arange(len(ec)) - starts[ec]
    cap = int(within.max() + 1) if len(within) else 1
    cap = max(-8 * (-cap // 8), 8)
    table = np.full((ntiles, cap), -1, np.int32)
    table[ec, within] = et.astype(np.int32)

    res_ids = tri_ids[live & ~front & ~(w <= 1e-6).all(1)]
    nr = max(-8 * (-len(res_ids) // 8), 8)
    residual = np.full(nr, -1, np.int32)
    residual[: len(res_ids)] = res_ids.astype(np.int32)

    v0 = p[:, 0].astype(np.float32)
    e1np = (p[:, 1] - p[:, 0]).astype(np.float32)
    e2np = (p[:, 2] - p[:, 0]).astype(np.float32)
    packed = _packed_rows_np(v0, e1np, e2np, live)
    dev = vertices.device

    def dv(a):
        return torch.as_tensor(a, device=dev)

    occ = (table >= 0).sum(1)
    buckets = []
    bcap, lo_occ = 8, 0
    max_occ = int(occ.max()) if len(occ) else 0
    while lo_occ < max_occ:
        sel = np.flatnonzero((occ > lo_occ) & (occ <= bcap))
        if len(sel):
            padded = 512
            while padded < len(sel):
                padded *= 2
            ids = np.concatenate([sel, np.full(padded - len(sel), -1)]).astype(np.int32)
            bc = min(bcap, cap)
            sub = table[sel, :bc]
            rows = packed[np.maximum(sub, 0)]
            rows[sub < 0] = 0.0
            rows_b = np.zeros((padded, bc * 16), np.float32)
            rows_b[: len(sel)] = rows.reshape(len(sel), bc * 16)
            buckets.append((bc, dv(ids), dv(rows_b)))
        lo_occ = bcap
        bcap *= 2

    return ImageGrid(
        eye=dv(eye.astype(np.float32)), right=dv(right.astype(np.float32)),
        true_up=dv(true_up.astype(np.float32)), fwd=dv(fwd.astype(np.float32)),
        half=half, aspect=aspect, width=width_px, height=height_px, tile_px=tile_px,
        tri_of_slot=dv(table), v0=dv(v0), e1=dv(e1np), e2=dv(e2np), valid=dv(live),
        residual=dv(residual), buckets=tuple(buckets))


def _closest(tt: torch.Tensor, slots: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor):
    """Closest hit along the candidate axis 1 of [B, C, R] results (the first
    index on equal t, as ``jnp.argmin``); ``slots`` [B, C] triangle ids. Returns
    (t, tri, u, v, count), each [B, R]."""
    j = torch.argmin(tt, dim=1, keepdim=True)
    tmin = tt.gather(1, j)[:, 0]
    ids = slots[:, :, None].expand(-1, -1, tt.shape[2]).gather(1, j)[:, 0]
    return (tmin, torch.where(torch.isfinite(tmin), ids, -1), uu.gather(1, j)[:, 0],
            vv.gather(1, j)[:, 0], torch.isfinite(tt).sum(dim=1, dtype=torch.int32))


def _row_slots(rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Triangle ids from packed rows [..., 16] (the id's int32 bits in lane
    10), -1 where ``ok`` is false."""
    return torch.where(ok, rows[..., 10].contiguous().view(torch.int32), -1)


def _pixel_dirs(pxs, pys, right, true_up, fwd, half, aspect, width, height):
    """Unit directions [..., 3] through pixel centres (pxs, pys), rounded
    as XLA's CPU code rounds the JAX package's: ``x / c`` as a product,
    the direction sum as fused multiply-adds, a correctly rounded norm."""
    sx = _fma(pxs, float(np.float32(2.0 / width)), -1.0)
    sy = _fma(pys, -float(np.float32(2.0 / height)), 1.0)
    a = (sx * float(np.float32(half * aspect)))[..., None]
    b = (sy * float(np.float32(half)))[..., None]
    d = _fma(b, true_up, _fma(a, right, fwd))
    return d / _sqrt(_sq3(d))[..., None]


def image_rays(grid: ImageGrid) -> tuple[torch.Tensor, torch.Tensor]:
    """The rays ``image_cast`` casts, bit for bit: (origins, unit
    directions), each [H·W, 3] in row-major pixel order."""
    dev = grid.eye.device
    py, px = torch.meshgrid(torch.arange(grid.height, device=dev),
                            torch.arange(grid.width, device=dev), indexing="ij")
    d = _pixel_dirs(px.reshape(-1).float() + 0.5, py.reshape(-1).float() + 0.5, grid.right,
                    grid.true_up, grid.fwd, grid.half, grid.aspect, grid.width, grid.height)
    return grid.eye.expand_as(d), d


def _image_cast_tiles(tile_ids: torch.Tensor, eye, right, true_up, fwd, half: float,
                      aspect: float, width: int, height: int, tile_px: int,
                      tri_of_slot, v0, e1, e2, valid, tiles_per_block: int = 512,
                      rows_aligned: torch.Tensor | None = None, packed_cells: bool = False):
    """Cast the pixels of the listed tiles (-1 = padding) at this table's
    cap: ``(t, tri, u, v, count)``, each [M, tile_px²]. With
    ``packed_cells``, ``rows_aligned`` [M, cap*16] holds each listed tile's
    packed triangle rows in ``tile_ids`` order (a slice a block, no
    gathers). The pixel directions round as XLA's CPU code does
    (multiply-adds fused, division by a constant as a product)."""
    nty = -(-height // tile_px)
    cap = tri_of_slot.shape[1]
    rpc = tile_px * tile_px
    dev = tile_ids.device
    oy, ox = torch.meshgrid(torch.arange(tile_px, device=dev),
                            torch.arange(tile_px, device=dev), indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    m = tile_ids.shape[0]
    tb = _block_size(tiles_per_block, cap, rpc)
    outs = []
    for b0 in range(0, m, tb):
        tids = tile_ids[b0:b0 + tb]
        n = tids.shape[0]
        live_tile = tids >= 0
        tids = tids.clamp(min=0).long()
        tx, ty = tids // nty, tids % nty
        pxs = (tx[:, None] * tile_px + ox[None, :]).float() + 0.5
        pys = (ty[:, None] * tile_px + oy[None, :]).float() + 0.5
        d = _pixel_dirs(pxs, pys, right, true_up, fwd, half, aspect, width, height)
        if packed_cells:
            rows = rows_aligned[b0:b0 + tb].reshape(n, cap, 16)
            ok_tri = (rows[..., 9] > 0.5) & live_tile[:, None]
            slots = _row_slots(rows, ok_tri)
            tv0, te1, te2 = rows[..., 0:3] - eye, rows[..., 3:6], rows[..., 6:9]
        else:
            slots = tri_of_slot[tids]  # [TB, cap]
            tid = slots.clamp(min=0).long()
            ok_tri = (slots >= 0) & valid[tid] & live_tile[:, None]
            tv0, te1, te2 = v0[tid] - eye, e1[tid], e2[tid]
        tt, uu, vv = mt_components(
            (0.0, 0.0, 0.0), tuple(d[..., i][:, None, :] for i in range(3)),
            tuple(tv0[..., i][:, :, None] for i in range(3)),
            tuple(te1[..., i][:, :, None] for i in range(3)),
            tuple(te2[..., i][:, :, None] for i in range(3)), ok_tri[:, :, None])
        outs.append(_closest(tt, slots, uu, vv))
    if not outs:
        z = torch.zeros((0, rpc), device=dev)
        return z, z.int(), z, z, z.int()
    return tuple(torch.cat(x) for x in zip(*outs))


def _assemble_image(parts, width: int, height: int, tile_px: int, dev):
    """Row-major pixel images ``(t, tri, u, v, count)``, each [H·W], from
    ``parts``: pairs of tile ids (-1 = padding) and their cast rows
    ``(t, tri, u, v, count)``, each [M, tile_px²]."""
    ntx = -(-width // tile_px)
    nty = -(-height // tile_px)
    tp = tile_px
    rpc = tp * tp
    ntiles = ntx * nty
    # an (ntiles + 1)-row buffer whose last row takes the padding tiles and
    # is dropped: ``.at[row].set(mode="drop")``
    bufs = (torch.full((ntiles + 1, rpc), torch.inf, device=dev),
            torch.full((ntiles + 1, rpc), -1, dtype=torch.int32, device=dev),
            torch.zeros((ntiles + 1, rpc), device=dev),
            torch.zeros((ntiles + 1, rpc), device=dev),
            torch.zeros((ntiles + 1, rpc), dtype=torch.int32, device=dev))
    for ids, res in parts:
        row = torch.where(ids >= 0, ids, ntiles).long()
        for buf, x in zip(bufs, res):
            buf[row] = x

    def to_image(flat):
        img = flat[:ntiles].reshape(ntx, nty, tp, tp).permute(1, 2, 0, 3)  # [ty, oy, tx, ox]
        return img.reshape(nty * tp, ntx * tp)[:height, :width].reshape(-1)

    return tuple(to_image(x) for x in bufs)


def _image_cast_fused(ids_list, eye, right, true_up, fwd, half: float, aspect: float,
                      width: int, height: int, tile_px: int, tri_of_slot, v0, e1, e2, valid,
                      caps: tuple, tiles_per_block: int, rows_list=(),
                      packed_cells: bool = False):
    """Every bucket, assembled into row-major pixel images. Each bucket's
    tiles are cast up to its last live id (the padding ids past it would
    land in the dropped row). Returns (t, tri, u, v, count), each [H·W]."""
    def parts():
        for bi, (cap, ids) in enumerate(zip(caps, ids_list)):
            m = int((ids >= 0).sum())  # live ids are front-packed
            ids = ids[:m]
            yield ids, _image_cast_tiles(
                ids, eye, right, true_up, fwd, half, aspect, width, height, tile_px,
                tri_of_slot[:, :cap], v0, e1, e2, valid, tiles_per_block=tiles_per_block,
                rows_aligned=rows_list[bi][:m] if packed_cells else None,
                packed_cells=packed_cells)

    return _assemble_image(parts(), width, height, tile_px, eye.device)


def _residual_scene(grid: ImageGrid):
    """What the residual pass casts: ``(origins, dirs, vertices, triangles,
    ids)``, every pixel's ray (``image_rays``) and the eye-straddling
    triangles as a soup of their own with their grid ids; None when the
    grid has no residual triangle."""
    if not (grid.residual.shape[0] and bool(grid.residual[0] >= 0)):
        return None
    # the tiles' own pixel rays (the JAX package regenerates them with
    # pinhole_rays, whose directions round otherwise by an ulp)
    origins, dirs = image_rays(grid)
    rid = grid.residual[grid.residual >= 0].long()
    verts_r = torch.stack([grid.v0[rid], (grid.v0 + grid.e1)[rid],
                           (grid.v0 + grid.e2)[rid]], 1).reshape(-1, 3)
    tris_flat = torch.arange(verts_r.shape[0], dtype=torch.int32,
                             device=verts_r.device).reshape(-1, 3)
    return origins, dirs, verts_r, tris_flat, rid


def _merge_residual(grid: ImageGrid, t, tri, uv, cnt, cast) -> Hits:
    """The tiles' hits merged with the residual triangles' hits, which
    ``cast(origins, dirs, vertices, triangles) -> Hits`` computes on
    ``_residual_scene``'s inputs; the tiles' hits alone without a
    residual."""
    scene = _residual_scene(grid)
    if scene is not None:
        origins, dirs, verts_r, tris_flat, rid = scene
        h = cast(origins, dirs, verts_r, tris_flat)
        better = h.t < t
        t = torch.minimum(t, h.t)
        tri = torch.where(better, rid.int()[h.tri.clamp(0, len(rid) - 1).long()], tri)
        uv = torch.where(better[:, None], h.uv, uv)
        cnt = cnt + h.count
    return Hits(t=t, tri=tri, uv=uv, count=cnt)


def image_cast(grid: ImageGrid, tiles_per_block: int = 512) -> Hits:
    """Cast the full pinhole image against the prebuilt screen-space grid:
    Hits in row-major pixel order (the layout of ``raytrace.pinhole_rays``).
    Tiles are bucketed by occupancy (powers of two), so a tile's pixels test
    a list sized to its own load; empty tiles are never cast. The few
    eye-straddling residual triangles go brute through the fused kernel."""
    caps = tuple(int(c) for c, _, _ in grid.buckets)
    ids_list = tuple(ids for _, ids, _ in grid.buckets)
    rows_list = tuple(rows for _, _, rows in grid.buckets)
    t, tri, u_, v_, cnt = _image_cast_fused(
        ids_list, grid.eye, grid.right, grid.true_up, grid.fwd, grid.half, grid.aspect,
        grid.width, grid.height, grid.tile_px, grid.tri_of_slot, grid.v0, grid.e1, grid.e2,
        grid.valid, caps=caps, tiles_per_block=tiles_per_block, rows_list=rows_list,
        packed_cells=True)
    return _merge_residual(grid, t, tri, torch.stack([u_, v_], 1), cnt,
                           lambda o, d, v, f: cast_rays(o.contiguous(), d, v, f, backend="kernel"))


class CellCastResult(NamedTuple):
    t: torch.Tensor  # [ncells, rpc] hit distance per ray (inf = miss)
    tri: torch.Tensor  # [ncells, rpc] winning triangle id
    count: torch.Tensor  # [ncells, rpc] crossings
    ray_area: float  # swept area per ray (for flux integrals)


def _unit(direction: torch.Tensor) -> torch.Tensor:
    return direction / torch.clamp(_sqrt(_sq3(direction)), min=1e-12)


def _cell_origins(d, u, v, origin_uv, cell, ny, cids, rpc_side, back_dist) -> torch.Tensor:
    """Ray origins [C, rpc_side², 3] of the cells ``cids``: cell-centred
    samples on the bundle plane, set back ``back_dist`` along -d."""
    # sub-grid offsets within a cell
    su = ((torch.arange(rpc_side, device=cids.device) + 0.5)
          * float(np.float32(1.0 / rpc_side)) * float(np.float32(cell)))
    gv, gu = torch.meshgrid(su, su, indexing="ij")
    cx = (cids // ny).float()[:, None]
    cy = (cids % ny).float()[:, None]
    uu = _fma(cx, float(np.float32(cell)), origin_uv[0]) + gu.reshape(1, -1)
    vv = _fma(cy, float(np.float32(cell)), origin_uv[1]) + gv.reshape(1, -1)
    return _fma(vv[..., None], v, _fma(uu[..., None], u, -(float(np.float32(back_dist)) * d)))


def cell_cast_origins(grid: RayGrid, direction, rays_per_cell_side: int = 4,
                      back_dist: float = 1e3, cell_ids: torch.Tensor | None = None):
    """The ray origins ``cell_cast_parallel`` makes for ``cell_ids`` (every
    cell by default): [C, rays_per_cell_side², 3], bit for bit; each ray
    runs along the normalised ``direction``."""
    dev = grid.u.device
    if cell_ids is None:
        cell_ids = torch.arange(grid.nx * grid.ny, dtype=torch.int32, device=dev)
    d = _unit(torch.as_tensor(to_numpy(direction), dtype=torch.float32, device=dev))
    return _cell_origins(d, grid.u, grid.v, grid.origin_uv, grid.cell, grid.ny, cell_ids,
                         rays_per_cell_side, back_dist)


def _cell_cast_rows(direction, u, v, origin_uv, cell, nx, ny, table, cell_ids, v0, e1, e2,
                    valid, rpc_side, cell_tile, back_dist, rows_strip=None, packed_cells=False):
    """Cell-aligned cast over a table strip [C, cap] and its cell ids [C]:
    ``rpc_side²`` rays a cell, made in the cell and tested against its list
    once for the whole block. The one body of the single-device
    ``_cell_cast`` and of a sharded cell cast. With ``packed_cells``,
    ``rows_strip`` [C, cap*16] holds the strip's packed triangle rows.
    Returns (t, tri, count), each [C, rpc_side²]."""
    ncells_local, cap = table.shape
    rpc = rpc_side * rpc_side
    d = _unit(direction)
    ct = _block_size(cell_tile, cap, rpc)
    outs = []
    for c0 in range(0, ncells_local, ct):
        cids = cell_ids[c0:c0 + ct]
        n = cids.shape[0]
        if packed_cells:
            rows = rows_strip[c0:c0 + ct].reshape(n, cap, 16)
            ok_tri = rows[..., 9] > 0.5  # [CT, cap]
            slots = _row_slots(rows, ok_tri)
            tv0, te1, te2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
        else:
            slots = table[c0:c0 + ct]
            tid = slots.clamp(min=0).long()
            ok_tri = (slots >= 0) & valid[tid]
            tv0, te1, te2 = v0[tid], e1[tid], e2[tid]
        o = _cell_origins(d, u, v, origin_uv, cell, ny, cids, rpc_side, back_dist)
        tt, uu_, vv_ = mt_components(
            tuple(o[..., i][:, None, :] for i in range(3)), tuple(d[i] for i in range(3)),
            tuple(tv0[..., i][:, :, None] for i in range(3)),
            tuple(te1[..., i][:, :, None] for i in range(3)),
            tuple(te2[..., i][:, :, None] for i in range(3)), ok_tri[:, :, None])
        tmin, tri, _, _, cnt = _closest(tt, slots, uu_, vv_)
        outs.append((tmin, tri, cnt))
    return tuple(torch.cat(x) for x in zip(*outs))


def _cell_cast(direction, u, v, origin_uv, cell, nx, ny, tri_of_slot, v0, e1, e2, valid,
               rpc_side, cell_tile, back_dist, cell_rows=None, packed_cells=False):
    ncells = nx * ny
    cell_ids = torch.arange(ncells, dtype=torch.int32, device=tri_of_slot.device)
    return _cell_cast_rows(direction, u, v, origin_uv, cell, nx, ny, tri_of_slot, cell_ids,
                           v0, e1, e2, valid, rpc_side, cell_tile, back_dist,
                           rows_strip=cell_rows if packed_cells else None,
                           packed_cells=packed_cells)


def cell_cast_parallel(grid: RayGrid, direction, rays_per_cell_side: int = 4,
                       cell_tile: int = 256, back_dist: float = 1e3) -> CellCastResult:
    """Cell-aligned parallel-bundle cast: ``rays_per_cell_side²`` rays made
    in each grid cell, set back ``back_dist`` against the direction, so
    each cell's triangle list is loaded once for its whole block of rays
    (the sun/rain flux path; ray density = rays_per_cell_side / cell)."""
    dev = grid.u.device
    t, tri, cnt = _cell_cast(
        torch.as_tensor(to_numpy(direction), dtype=torch.float32, device=dev), grid.u, grid.v,
        grid.origin_uv, grid.cell, grid.nx, grid.ny, grid.tri_of_slot, grid.v0, grid.e1,
        grid.e2, grid.valid, rpc_side=rays_per_cell_side, cell_tile=cell_tile,
        back_dist=back_dist, cell_rows=grid.cell_rows, packed_cells=bool(grid.packed_cells))
    ray_area = (grid.cell / rays_per_cell_side) ** 2
    return CellCastResult(t=t, tri=tri, count=cnt, ray_area=ray_area)
