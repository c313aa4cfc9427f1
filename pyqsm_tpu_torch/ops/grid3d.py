"""3D uniform-grid acceleration for general ray bundles (counterpart of
``pyqsm_tpu/ops/grid3d.py``, its DDA caster; the wavefront caster is not
ported yet and raises).

The build is host numpy (one sort), as in the JAX package: every triangle
is registered in all cells its AABB touches, the cell cap is the
``cap_percentile`` occupancy and triangles past it spill to a ``residual``
list that every ray tests, a Chebyshev skip table lets rays jump through
empty space, and each occupied cell's triangles are packed into one row.

The cast is plain torch on the caller's device: each ray tile marches a
3-DDA in a host loop (a skip phase through empty cells, then one
Möller–Trumbore batch against the current cell's row). A ray retires once
its best hit lies inside the current cell (``count_all=False``); crossings
are counted in the cell that holds the hit point, with the build's
floor arithmetic. The host reads the alive count every ``_CHECK_EVERY``
steps and compacts the tile's working set to the live rays: a dead ray's
update is masked, so neither changes a result. The cell arithmetic rounds
as XLA's CPU code does (``o + t·d`` fused, ``x / cell`` as
``x · f32(1/cell)``), so the crossings land in the same cells.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.ops.neighbors import _fma
from pyqsm_tpu_torch.ops.raygrid import _host
from pyqsm_tpu_torch.ops.raytrace import Hits, mt_components
from pyqsm_tpu_torch.ops.sampling import nonzero_rows

# the DDA reads its alive count from the device every this many steps
_CHECK_EVERY = 4
# below this many live rays a tile's working set is not compacted further
_COMPACT_MIN = 4096
# host reads of the DDA's loop tests (alive counts, skip-phase flags),
# counted so a caller can weigh the host loop's syncs
SYNCS = 0

# ROADMAP item that ports ``grid_cast_wavefront`` and its helpers
_WAVEFRONT_TODO = ("the wavefront caster (grid_cast_wavefront, pyqsm_tpu/ops/grid3d.py:789-1308, "
                   "1341-1537) is not ported yet: ROADMAP §1 item 1, the wavefront and "
                   "parallel/raycast.py")


class Grid3D(NamedTuple):
    lo: torch.Tensor  # [3] grid origin (scene AABB min)
    cell: float  # cell edge
    nx: int  # dims
    ny: int
    nz: int
    tri_of_slot: torch.Tensor  # [ncells, cap] i32 triangle ids, -1 padded
    v0: torch.Tensor  # [T, 3] triangle origin (input order)
    e1: torch.Tensor  # [T, 3]
    e2: torch.Tensor  # [T, 3]
    valid: torch.Tensor  # [T] bool
    residual: torch.Tensor  # [nr] i32 ids tested by every ray (-1 pad)
    skip: torch.Tensor  # [ncells] u8 Chebyshev distance to the nearest occupied cell
    packed: torch.Tensor  # [T, 16] f32 rows v0 | e1 | e2 | valid | id bits | pad
    n_residual: int = 0  # count of live residual ids
    n_occupied: int = 0  # count of occupied cells
    cell_rank: torch.Tensor | None = None  # [ncells] i32 occupied-cell rank, -1 empty
    cell_rows: torch.Tensor | None = None  # [n_occ_pad, cap*16] f32 packed rows a cell
    packed_cells: bool = False  # cell_rows is populated

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def cap(self) -> int:
        return self.tri_of_slot.shape[1]


class TwoLevelGrid(NamedTuple):
    """Two-level grid for teapot-in-stadium scenes: the top grid's spilled
    hotspot gets its own fine grid over its (compact) AABB. The two triangle
    sets are disjoint, so ``two_level_cast`` merges both closest hits and
    adds the counts."""

    primary: Grid3D  # residual stripped to the large spanning triangles
    sub: Grid3D  # fine grid over ONLY the spilled hotspot (compact ids)
    sub_tri_ids: torch.Tensor  # [S_pad] i32 compact → global triangle id, -1 pad


def build_grid3d(vertices, triangles, target_tris_per_cell: float = 4.0,
                 max_cells_per_axis: int = 256, cell_cap: int | None = None,
                 cap_percentile: float = 99.5, cell_rows_budget: int = 1 << 30) -> Grid3D:
    """Host-built uniform grid (one argsort), returned on the mesh's device.

    The cell balances ~``target_tris_per_cell`` triangles a cell against the
    DDA's step count, floored at the median triangle extent and at
    ``span / max_cells_per_axis``. The cap is the ``cap_percentile`` cell
    occupancy: triangles past their cell's cap leave the grid entirely for
    ``residual``. An explicit ``cell_cap`` raises ``ValueError`` when a cell
    holds more."""
    dev = vertices.device if isinstance(vertices, torch.Tensor) else torch.device("cpu")
    verts = _host(vertices).astype(np.float64)
    tris = _host(triangles)
    live = tris[:, 0] >= 0
    t = np.maximum(tris, 0)
    p0, p1, p2 = verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]
    tlo = np.minimum(np.minimum(p0, p1), p2)
    thi = np.maximum(np.maximum(p0, p1), p2)

    scene_lo = np.where(live[:, None], tlo, np.inf).min(0)
    scene_hi = np.where(live[:, None], thi, -np.inf).max(0)
    if not np.isfinite(scene_lo).all():
        scene_lo = np.zeros(3)
        scene_hi = np.ones(3)
    span = np.maximum(scene_hi - scene_lo, 1e-6)

    n_live = max(int(live.sum()), 1)
    vol = float(span.prod())
    cell = (vol * target_tris_per_cell / n_live) ** (1.0 / 3.0)
    ext = np.where(live[:, None], thi - tlo, 0.0)
    if live.any():
        med_ext = float(np.percentile(ext[live].max(1), 50))
        cell = max(cell, med_ext)
    cell = max(cell, float(span.max()) / max_cells_per_axis)
    cell += 1e-9

    dims = np.maximum((span / cell).astype(np.int64) + 1, 1)
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])

    c_lo = np.clip(np.floor((tlo - scene_lo) / cell).astype(np.int64), 0, dims - 1)
    c_hi = np.clip(np.floor((thi - scene_lo) / cell).astype(np.int64), 0, dims - 1)
    spans = np.where(live[:, None], c_hi - c_lo + 1, 0)
    sx = int(spans[:, 0].max()) if live.any() else 1
    sy = int(spans[:, 1].max()) if live.any() else 1
    sz = int(spans[:, 2].max()) if live.any() else 1

    tri_ids = np.arange(len(tris), dtype=np.int64)
    entries_cell, entries_tri = [], []
    for dx in range(max(sx, 1)):
        for dy in range(max(sy, 1)):
            for dz in range(max(sz, 1)):
                cx = c_lo[:, 0] + dx
                cy = c_lo[:, 1] + dy
                cz = c_lo[:, 2] + dz
                touch = (cx <= c_hi[:, 0]) & (cy <= c_hi[:, 1]) & (cz <= c_hi[:, 2]) & live
                if not touch.any():
                    continue
                entries_cell.append(np.where(touch, (cx * ny + cy) * nz + cz, -1))
                entries_tri.append(np.where(touch, tri_ids, -1))
    if entries_cell:
        ec = np.concatenate(entries_cell)
        et = np.concatenate(entries_tri)
        keep = ec >= 0
        ec, et = ec[keep], et[keep]
    else:
        ec = np.zeros(0, np.int64)
        et = np.zeros(0, np.int64)

    ncells = nx * ny * nz
    order = np.argsort(ec, kind="stable")
    ec, et = ec[order], et[order]
    starts = np.searchsorted(ec, np.arange(ncells))
    counts = np.diff(np.append(starts, len(ec)))
    occupancy = int(counts.max()) if len(counts) else 0
    if cell_cap is not None:
        if occupancy > cell_cap:
            raise ValueError(f"cell_cap {cell_cap} < max triangles per cell {occupancy}; "
                             f"raise cell_cap or lower target_tris_per_cell")
        cap = cell_cap
        residual_ids = np.zeros(0, np.int64)
    else:
        nonzero = counts[counts > 0]
        cap = int(np.percentile(nonzero, cap_percentile)) if len(nonzero) else 8
        cap = min(max(cap, 8), max(occupancy, 8))
        # overflow spill: a triangle past its cell's cap leaves the grid
        # ENTIRELY (every registration), so no crossing is counted twice
        within_all = np.arange(len(ec)) - starts[ec]
        residual_ids = np.unique(et[within_all >= cap])
        if len(residual_ids):
            drop = np.isin(et, residual_ids)
            ec, et = ec[~drop], et[~drop]
            starts = np.searchsorted(ec, np.arange(ncells))
    cap = max(-8 * (-cap // 8), 8)  # a multiple of 8
    within = np.arange(len(ec)) - starts[ec]
    table = np.full((ncells, cap), -1, np.int32)
    table[ec, within] = et.astype(np.int32)

    nr = max(-8 * (-len(residual_ids) // 8), 8)
    residual = np.full(nr, -1, np.int32)
    residual[: len(residual_ids)] = residual_ids.astype(np.int32)

    # proximity clouds: each cell's Chebyshev distance to the nearest
    # occupied cell, so the DDA jumps (skip - 1) cells through empty space
    occ = np.zeros(ncells, bool)
    if len(ec):
        occ[np.unique(ec)] = True
    if occ.any() and not occ.all():
        try:
            from scipy.ndimage import distance_transform_cdt

            dist = distance_transform_cdt(~occ.reshape(nx, ny, nz),
                                          metric="chessboard").reshape(-1)
        except ImportError:  # scipy is an optional extra
            dist = _chebyshev_dt(occ.reshape(nx, ny, nz)).reshape(-1)
    else:
        dist = np.zeros(ncells, np.int64)
    skip = np.minimum(dist, 255).astype(np.uint8)

    packed_np = np.concatenate([p0, p1 - p0, p2 - p0, live[:, None].astype(np.float64),
                                np.zeros((len(tris), 6))], axis=1).astype(np.float32)
    # lane 10 carries the triangle id as raw int32 bits (exact for any id)
    packed_np[:, 10] = np.arange(len(tris), dtype=np.int32).view(np.float32)

    occ_ids = np.flatnonzero(occ)
    n_occ = len(occ_ids)
    packed_cells = (n_occ + 8) * cap * 64 <= cell_rows_budget
    if packed_cells:
        rank = np.full(ncells, -1, np.int32)
        rank[occ_ids] = np.arange(n_occ, dtype=np.int32)
        slot_tab = table[occ_ids] if n_occ else np.zeros((0, cap), np.int32)
        rows = packed_np[np.maximum(slot_tab, 0)]
        rows[slot_tab < 0] = 0.0
        n_occ_pad = max(-8 * (-(n_occ + 1) // 8), 8)
        rows_flat = np.zeros((n_occ_pad, cap * 16), np.float32)
        if n_occ:
            rows_flat[:n_occ] = rows.reshape(n_occ, cap * 16)
    else:
        rank = np.zeros(1, np.int32)
        rows_flat = np.zeros((8, 16), np.float32)

    def dv(a):
        return torch.as_tensor(a, device=dev)

    return Grid3D(lo=dv(scene_lo.astype(np.float32)), cell=float(cell), nx=nx, ny=ny, nz=nz,
                  tri_of_slot=dv(table), v0=dv(p0.astype(np.float32)),
                  e1=dv((p1 - p0).astype(np.float32)), e2=dv((p2 - p0).astype(np.float32)),
                  valid=dv(live), residual=dv(residual), skip=dv(skip), packed=dv(packed_np),
                  n_residual=int(len(residual_ids)), n_occupied=int(occ.sum()),
                  cell_rank=dv(rank), cell_rows=dv(rows_flat), packed_cells=packed_cells)


def build_grid3d_two_level(vertices, triangles, min_residual: int = 256,
                           **build_kw) -> Grid3D | TwoLevelGrid:
    """A grid, escalated to :class:`TwoLevelGrid` when ``min_residual`` or
    more triangles spilled: the small ones among them (extent ≤ 8× the
    spill's median) get their own fine grid, the large ones stay on the
    primary's residual. Below the threshold the plain grid comes back."""
    g = build_grid3d(vertices, triangles, **build_kw)
    if g.n_residual < min_residual:
        return g
    res_ids = _host(g.residual)[: g.n_residual]
    tris = _host(triangles)
    verts = _host(vertices)
    t = np.maximum(tris[res_ids], 0)
    ext = (np.max([verts[t[:, i]] for i in range(3)], axis=0)
           - np.min([verts[t[:, i]] for i in range(3)], axis=0)).max(1)
    med = max(float(np.median(ext)), 1e-9)
    small = ext <= 8.0 * med
    sub_ids = res_ids[small]
    if len(sub_ids) < min_residual:
        return g
    brute_ids = res_ids[~small]
    nr = max(-8 * (-len(brute_ids) // 8), 8)
    brute = np.full(nr, -1, np.int32)
    brute[: len(brute_ids)] = brute_ids
    # the sub grid stores only the spilled subset; its hits come back with
    # compact ids that two_level_cast maps to global ones
    ns = max(-8 * (-len(sub_ids) // 8), 8)
    sub_tris = np.full((ns, 3), -1, tris.dtype)
    sub_tris[: len(sub_ids)] = tris[sub_ids]
    id_map = np.full(ns, -1, np.int32)
    id_map[: len(sub_ids)] = sub_ids
    dev = g.lo.device
    sub = build_grid3d(vertices, torch.as_tensor(sub_tris, device=dev), **build_kw)
    primary = g._replace(residual=torch.as_tensor(brute, device=dev),
                         n_residual=int(len(brute_ids)))
    return TwoLevelGrid(primary=primary, sub=sub,
                        sub_tri_ids=torch.as_tensor(id_map, device=dev))


def merge_hits(a: Hits, b: Hits) -> Hits:
    """Closest-hit merge of two casts over DISJOINT triangle sets: the
    smaller t wins (``a`` on equal t); crossing counts add."""
    b_wins = b.t < a.t
    return Hits(t=torch.minimum(a.t, b.t), tri=torch.where(b_wins, b.tri, a.tri),
                uv=torch.where(b_wins[:, None], b.uv, a.uv), count=a.count + b.count)


def _slabs(o: torch.Tensor, d: torch.Tensor, inv_d: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor):
    """Per-axis slab entry and exit parameters of rays against [lo, hi];
    a d = 0 axis is (-inf, inf) inside its slab and empty outside."""
    t0 = (lo[None, :] - o) * inv_d
    t1 = (hi[None, :] - o) * inv_d
    inside = (o >= lo[None, :]) & (o <= hi[None, :])
    nz = d != 0
    inf = torch.tensor(torch.inf, device=o.device)
    tmin = torch.where(nz, torch.minimum(t0, t1), torch.where(inside, -inf, inf))
    tmax = torch.where(nz, torch.maximum(t0, t1), torch.where(inside, inf, -inf))
    return tmin, tmax


def _inverse(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), torch.inf)


def _aabb_mask(origins: torch.Tensor, dirs: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Conservative slab test: ``touch`` for rays whose forward segment
    touches the epsilon-padded [lo, hi] box, and ``t_enter``, the forward
    parameter where they enter it (0 from inside)."""
    eps = 1e-4 * (hi - lo).max()
    tmin, tmax = _slabs(origins, dirs, _inverse(dirs), lo - eps, hi + eps)
    t_enter = torch.clamp(tmin.amax(dim=1), min=0.0)
    return t_enter <= tmax.amin(dim=1), t_enter


def _scatter_sub_hits(a: Hits, bs_t, bs_tri, bs_uv, bs_count, safe, live,
                      sub_tri_ids) -> Hits:
    """Merge a culled sub-grid cast into the primary hits: the compacted sub
    results scattered to their bundle rows (padding rows to a dropped row),
    compact ids mapped to global, then ``merge_hits``."""
    r = a.t.shape[0]
    dev = a.t.device
    row = torch.where(live, safe, r).long()
    t_b = torch.full((r + 1,), torch.inf, device=dev)
    t_b[row] = torch.where(live, bs_t, torch.inf)
    tri_b = torch.full((r + 1,), -1, dtype=torch.int32, device=dev)
    tri_b[row] = torch.where(live, bs_tri, -1)
    uv_b = torch.zeros((r + 1, 2), device=dev)
    uv_b[row] = torch.where(live[:, None], bs_uv, 0.0)
    cnt_b = torch.zeros((r + 1,), dtype=torch.int32, device=dev)
    cnt_b[row] = torch.where(live, bs_count, 0)
    tri_b = tri_b[:r]
    b = Hits(t=t_b[:r], tri=torch.where(tri_b >= 0, sub_tri_ids[tri_b.clamp(min=0).long()],
                                        tri_b), uv=uv_b[:r], count=cnt_b[:r])
    return merge_hits(a, b)


def two_level_cast(grid, origins: torch.Tensor, dirs: torch.Tensor, wavefront: bool = False,
                   **cast_kw) -> Hits:
    """``grid_cast`` against a :class:`Grid3D` or a :class:`TwoLevelGrid`.
    The sub cast takes only the rays whose segment touches the sub grid's
    AABB (and, for closest hits, enter it before their primary hit): the
    whole bundle when that is half of it or more, else a front-packed
    sub-bundle of a power-of-two capacity whose results are scattered back.
    ``wavefront=True`` raises: the wavefront caster is not ported."""
    if wavefront:
        raise NotImplementedError(f"two_level_cast(wavefront=True): {_WAVEFRONT_TODO}")
    if isinstance(grid, Grid3D):
        return grid_cast(grid, origins, dirs, **cast_kw)
    a = grid_cast(grid.primary, origins, dirs, **cast_kw)
    sub = grid.sub
    lo = sub.lo
    hi = lo + torch.tensor([sub.nx, sub.ny, sub.nz], dtype=torch.float32,
                           device=lo.device) * sub.cell
    o32, d32 = origins.to(torch.float32), dirs.to(torch.float32)
    touch, t_enter_sub = _aabb_mask(o32, d32, lo, hi)
    if not cast_kw.get("count_all", False):
        # occlusion cull: a sub-grid triangle can win only for rays that
        # enter the sub AABB before their primary closest hit
        touch = touch & (t_enter_sub <= a.t + 1e-4)
    r = origins.shape[0]
    m = int(touch.sum())  # host read: the cull count sizes the sub bundle
    if m == 0:
        return a
    if m >= r // 2:
        b = grid_cast(sub, origins, dirs, **cast_kw)
        b = b._replace(tri=torch.where(b.tri >= 0, grid.sub_tri_ids[b.tri.clamp(min=0).long()],
                                       b.tri))
        return merge_hits(a, b)
    mc = 256
    while mc < m:
        mc *= 2  # power-of-two capacity buckets
    sel = nonzero_rows(touch, mc)
    safe = sel.clamp(min=0).long()
    live = sel >= 0
    # padding rows alias ray 0; their results are dropped by the scatter
    bs = grid_cast(sub, origins[safe], dirs[safe], **cast_kw)
    return _scatter_sub_hits(a, bs.t, bs.tri, bs.uv, bs.count, safe, live, grid.sub_tri_ids)


def grid_cast_wavefront(grid: Grid3D, origins: torch.Tensor, dirs: torch.Tensor, **kw) -> Hits:
    """The JAX package's cell-major caster: not ported yet, raises."""
    raise NotImplementedError(f"grid_cast_wavefront: {_WAVEFRONT_TODO}")


def _chebyshev_dt(occ3: np.ndarray, max_dist: int = 64) -> np.ndarray:
    """Chebyshev (chessboard) distance to the nearest occupied cell, numpy
    alone (the fallback without scipy): binary dilation by a 3×3×3
    chessboard element, so after ``i`` rounds the dilated set is the cells
    within distance i. Cells farther than ``max_dist`` saturate there — an
    underestimated skip is conservative (the DDA takes more jumps)."""
    dist = np.zeros(occ3.shape, np.int64)
    reached = occ3.copy()
    for i in range(1, max_dist + 1):
        if reached.all():
            break
        grown = reached.copy()
        for ax in range(3):
            lo = np.roll(grown, 1, axis=ax)
            hi = np.roll(grown, -1, axis=ax)
            # np.roll wraps; sever the wrap so distance never crosses edges
            idx_lo = [slice(None)] * 3
            idx_lo[ax] = 0
            lo[tuple(idx_lo)] = False
            idx_hi = [slice(None)] * 3
            idx_hi[ax] = -1
            hi[tuple(idx_hi)] = False
            grown |= lo | hi
        new = grown & ~reached
        if not new.any():
            dist[~reached] = max_dist
            break
        dist[new] = i
        reached = grown
    else:
        dist[~reached] = max_dist
    return dist


def _mt_rows(o: torch.Tensor, d: torch.Tensor, rows: torch.Tensor, ok: torch.Tensor):
    """Möller–Trumbore of rays o/d [R, 3] against packed triangle rows
    [R, C, 16] with candidate mask ``ok`` [R, C]: (t inf = miss, u, v)."""
    return mt_components(tuple(o[:, a:a + 1] for a in range(3)),
                         tuple(d[:, a:a + 1] for a in range(3)),
                         tuple(rows[..., a] for a in range(3)),
                         tuple(rows[..., 3 + a] for a in range(3)),
                         tuple(rows[..., 6 + a] for a in range(3)), ok)


def _mt_batch(o, d, slots, packed, alive):
    """Each ray against its own candidate list ``slots`` [R, C] (-1 pad),
    one packed-row gather a candidate: (t [R, C], u, v)."""
    rows = packed[slots.clamp(min=0).long()]  # [R, C, 16]
    ok = (slots >= 0) & (rows[..., 9] > 0.5) & alive[:, None]
    return _mt_rows(o, d, rows, ok)


def _mt_batch_cells(o, d, rank, cell_rows, alive):
    """Each ray against its cell's packed row (``rank`` [R] the occupied-cell
    rank, -1 = empty or dead): one contiguous gather a ray. Returns
    (t [R, cap], u, v, slots [R, cap] triangle ids, -1 pad)."""
    cap = cell_rows.shape[1] // 16
    rows = cell_rows[rank.clamp(min=0).long()].reshape(o.shape[0], cap, 16)
    ok = (rank >= 0)[:, None] & (rows[..., 9] > 0.5) & alive[:, None]
    slots = torch.where(ok, rows[..., 10].contiguous().view(torch.int32), -1)
    tt, u, v = _mt_rows(o, d, rows, ok)
    return tt, u, v, slots


def _floor_cell(x: torch.Tensor, top) -> torch.Tensor:
    """``clip(floor(x).astype(int32), 0, top)`` with XLA's saturating
    conversion (±inf to the int range's ends, NaN to 0)."""
    f = torch.nan_to_num(torch.floor(x), nan=0.0).clamp(-1.0, 2.0 ** 30)
    return f.to(torch.int32).clamp(min=0).minimum(top)


def _closest_update(best_t, best_tri, best_uv, tt, u, v, slots):
    """Running closest hit: the tile's first minimum (``jnp.argmin``) replaces
    the best where strictly closer."""
    j = torch.argmin(tt, dim=1, keepdim=True)
    tmin = tt.gather(1, j)[:, 0]
    better = tmin < best_t
    best_tri = torch.where(better, slots.gather(1, j)[:, 0], best_tri)
    uv = torch.cat([u.gather(1, j), v.gather(1, j)], dim=1)
    best_uv = torch.where(better[:, None], uv, best_uv)
    return torch.minimum(best_t, tmin), best_tri, best_uv


def _dda_tile(o, d, lo, cell, dims, tri_of_slot, packed, residual, skip_tab, max_steps,
              count_all, cell_rank, cell_rows, packed_cells):
    """One ray tile's DDA march and residual pass: (t, tri, uv, count)."""
    rt = o.shape[0]
    dev = o.device
    ny, nz = int(dims[1]), int(dims[2])
    dims_t = torch.tensor(dims, dtype=torch.int32, device=dev)
    top = dims_t - 1
    cell32 = float(np.float32(cell))
    inv_cell = float(np.float32(1.0 / cell))
    hi = _fma(dims_t.float(), cell32, lo)
    inv_d = _inverse(d)
    tmin_ax, tmax_ax = _slabs(o, d, inv_d, lo, hi)
    t_enter = torch.clamp(tmin_ax.amax(dim=1), min=0.0)
    t_exit_grid = tmax_ax.amin(dim=1)
    alive0 = t_enter <= t_exit_grid

    pos = _fma((t_enter + 1e-6)[:, None], d, o)
    c0 = _floor_cell((pos - lo) * inv_cell, top)
    step = torch.sign(d).to(torch.int32)
    t_delta = torch.where(d != 0, cell32 * inv_d.abs(), torch.inf)
    # moving τ along the ray moves ≤ τ/t_delta_i cells on axis i, so
    # τ = k·min(t_delta) stays within k cells of the start on every axis
    min_td = t_delta.amin(dim=1)

    def cell_id(c):
        return (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]

    def skip_of(c, alive):
        return torch.where(alive, skip_tab[torch.where(alive, cell_id(c), 0).long()], 0) \
            .to(torch.int32)

    # working set: per-ray constants and state, compacted to the live rays
    w = dict(row=torch.arange(rt, device=dev), o=o, d=d, inv_d=inv_d, step=step,
             min_td=min_td, t_exit_grid=t_exit_grid, c=c0, t_cur=t_enter, alive=alive0,
             k=skip_of(c0, alive0), best_t=torch.full((rt,), torch.inf, device=dev),
             best_tri=torch.full((rt,), -1, dtype=torch.int32, device=dev),
             best_uv=torch.zeros((rt, 2), device=dev),
             count=torch.zeros((rt,), dtype=torch.int32, device=dev))
    out = {f: w[f].clone() for f in ("best_t", "best_tri", "best_uv", "count")}

    def t_max_of(c, w):
        """Exit parameter of cell c along each axis (closed form)."""
        cf = torch.where(w["d"] >= 0, c + 1, c).float()
        nb = _fma(cf, cell32, lo)
        return torch.where(w["d"] != 0, (nb - w["o"]) * w["inv_d"], torch.inf)

    def dda_step(c, move, w):
        """One DDA advance for rays in ``move``: (c', t_exit, stay_alive)."""
        tm = t_max_of(c, w)
        t_exit = tm.amin(dim=1)
        ax = tm.argmin(dim=1, keepdim=True)
        c_new = c + torch.zeros_like(c).scatter_(1, ax, 1) * w["step"]
        oob = ((c_new < 0) | (c_new > top)).any(dim=1)
        c_new = torch.where(move[:, None], torch.minimum(c_new.clamp(min=0), top), c)
        return c_new, t_exit, ~(move & oob)

    def flush(w):
        for f in out:
            out[f][w["row"]] = w[f]

    global SYNCS
    it = 0
    while it < max_steps:
        if it % _CHECK_EVERY == 0:
            SYNCS += 1
            n_alive = int(w["alive"].sum())
            if n_alive == 0:
                break
            if n_alive <= w["row"].shape[0] // 4 and w["row"].shape[0] > _COMPACT_MIN:
                flush(w)
                keep = torch.nonzero(w["alive"])[:, 0]
                w = {f: x[keep] for f, x in w.items()}
        # skip phase: march every alive ray to its next occupied cell
        jt = 0
        while jt < max_steps:
            if jt % 2 == 0:
                SYNCS += 1
                if not bool((w["alive"] & (w["k"] > 0)).any()):
                    break
            c, t_cur, alive, k = w["c"], w["t_cur"], w["alive"], w["k"]
            move = alive & (k > 0)
            jump = move & (k >= 2)
            t_jump = _fma((k - 1).float(), w["min_td"], t_cur)
            c_jump = _floor_cell((_fma(t_jump[:, None], w["d"], w["o"]) - lo) * inv_cell, top)
            c_step, t_exit, ok_step = dda_step(c, move & ~jump, w)
            c_new = torch.where(jump[:, None], c_jump, c_step)
            t_new = torch.where(jump, t_jump, torch.where(move, t_exit, t_cur))
            dead = (jump & (t_new >= w["t_exit_grid"])) | ~ok_step
            alive = alive & ~dead
            w.update(c=c_new, t_cur=t_new, alive=alive, k=skip_of(c_new, alive))
            jt += 1
        # test phase: every alive ray sits in an occupied cell
        c, alive, o_w, d_w = w["c"], w["alive"], w["o"], w["d"]
        cid = torch.where(alive, cell_id(c), 0).long()
        if packed_cells:
            rnk = torch.where(alive, cell_rank[cid], -1)
            tt, u, v, slots = _mt_batch_cells(o_w, d_w, rnk, cell_rows, alive)
        else:
            slots = tri_of_slot[cid]
            tt, u, v = _mt_batch(o_w, d_w, slots, packed, alive)
        hit = torch.isfinite(tt)
        # a crossing counts in the one cell that holds its hit point, by the
        # build's floor arithmetic
        t_hit = torch.where(hit, tt, 0.0)
        in_cell = hit
        for a in range(3):
            x = (_fma(t_hit, d_w[:, a:a + 1], o_w[:, a:a + 1]) - lo[a]) * inv_cell
            in_cell = in_cell & (_floor_cell(x, top[a]) == c[:, a:a + 1])
        count = w["count"] + in_cell.sum(dim=1, dtype=torch.int32)
        best_t, best_tri, best_uv = _closest_update(w["best_t"], w["best_tri"], w["best_uv"],
                                                    tt, u, v, slots)
        c_new, t_exit, ok_step = dda_step(c, alive, w)
        alive = alive & ok_step
        if not count_all:
            alive = alive & ~(best_t <= t_exit + 1e-6)
        w.update(c=c_new, t_cur=torch.where(alive, t_exit, w["t_cur"]), alive=alive,
                 k=skip_of(c_new, alive), best_t=best_t, best_tri=best_tri, best_uv=best_uv,
                 count=count)
        it += 1
    flush(w)
    best_t, best_tri, best_uv, count = (out[f] for f in ("best_t", "best_tri", "best_uv",
                                                         "count"))
    # residual pass: the spilled triangles, absent from every cell, once a ray
    if residual.shape[0] > 0:
        r_slots = residual[None, :].expand(rt, -1)
        tt, u, v = _mt_batch(o, d, r_slots, packed, alive0)
        count = count + torch.isfinite(tt).sum(dim=1, dtype=torch.int32)
        best_t, best_tri, best_uv = _closest_update(best_t, best_tri, best_uv, tt, u, v, r_slots)
    return best_t, torch.where(torch.isinf(best_t), -1, best_tri), best_uv, count


def _grid_cast3d(origins, dirs, lo, cell: float, nx: int, ny: int, nz: int, tri_of_slot,
                 packed, residual, skip_tab, ray_tile: int, max_steps: int, count_all: bool,
                 cell_rank=None, cell_rows=None, packed_cells: bool = False) -> Hits:
    """The DDA cast of a bundle, ``ray_tile`` rays at a time (a tile's size
    changes no result: every ray's march is its own)."""
    r = origins.shape[0]
    dev = origins.device
    out_t = torch.empty(r, device=dev)
    out_tri = torch.empty(r, dtype=torch.int32, device=dev)
    out_uv = torch.empty(r, 2, device=dev)
    out_cnt = torch.empty(r, dtype=torch.int32, device=dev)
    for r0 in range(0, r, ray_tile):
        sl = slice(r0, r0 + ray_tile)
        res = _dda_tile(origins[sl].to(torch.float32), dirs[sl].to(torch.float32), lo, cell,
                        (nx, ny, nz), tri_of_slot, packed, residual, skip_tab, max_steps,
                        count_all, cell_rank, cell_rows, packed_cells)
        for buf, x in zip((out_t, out_tri, out_uv, out_cnt), res):
            buf[sl] = x
    return Hits(t=out_t, tri=out_tri, uv=out_uv, count=out_cnt)


def grid_cast(grid: Grid3D, origins: torch.Tensor, dirs: torch.Tensor, ray_tile: int = 8192,
              count_all: bool = False, rays_per_dispatch: int = 1 << 21) -> Hits:
    """Cast arbitrary rays against a prebuilt grid. ``count_all=True``
    marches every ray to the grid's boundary, so ``count`` is the exact
    crossing total (occupancy parity); otherwise a ray retires at its first
    confirmed-closest hit. Bundles larger than ``rays_per_dispatch`` go in
    chunks of that many rays."""
    # each outer step advances every alive ray ≥ 1 cell and each skip phase
    # is bounded on its own, so the path length bounds both
    max_steps = grid.nx + grid.ny + grid.nz + 4
    residual = grid.residual if grid.n_residual > 0 else grid.residual[:0]

    def one(o, d):
        return _grid_cast3d(o, d, grid.lo, grid.cell, grid.nx, grid.ny, grid.nz,
                            grid.tri_of_slot, grid.packed, residual, grid.skip,
                            ray_tile=ray_tile, max_steps=max_steps, count_all=count_all,
                            cell_rank=grid.cell_rank, cell_rows=grid.cell_rows,
                            packed_cells=bool(grid.packed_cells))

    r = origins.shape[0]
    if r <= rays_per_dispatch:
        return one(origins, dirs)
    chunks = [one(origins[s:s + rays_per_dispatch], dirs[s:s + rays_per_dispatch])
              for s in range(0, r, rays_per_dispatch)]
    return Hits(*(torch.cat(x) for x in zip(*chunks)))


def grid_occupancy(grid: Grid3D, points: torch.Tensor, ray_tile: int = 4096) -> torch.Tensor:
    """Inside/outside by crossing parity along the slightly off-axis +z ray
    of ``raytrace.occupancy``, through the grid."""
    dirs = torch.tensor([1.73205e-4, 2.23607e-4, 1.0], dtype=torch.float32,
                        device=points.device).expand_as(points)
    hits = grid_cast(grid, points, dirs, ray_tile=ray_tile, count_all=True)
    return (hits.count % 2) == 1
