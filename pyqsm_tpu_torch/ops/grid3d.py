"""3D uniform-grid acceleration for general ray bundles (counterpart of
``pyqsm_tpu/ops/grid3d.py``): the build, the DDA caster and the wavefront
caster.

The build is host numpy (one sort), as in the JAX package: every triangle
is registered in all cells its AABB touches, the cell cap is the
``cap_percentile`` occupancy and triangles past it spill to a ``residual``
list that every ray tests, a Chebyshev skip table lets rays jump through
empty space, and each occupied cell's triangles are packed into one row.

The casts are plain torch on the caller's device.

- ``grid_cast``, the DDA: each ray tile marches a 3-DDA in a host loop (a
  skip phase through empty cells, then one Möller–Trumbore batch against
  the current cell's row). A ray retires once its best hit lies inside
  the current cell (``count_all=False``). The host reads the alive count
  every ``_CHECK_EVERY`` steps and compacts the tile's working set to the
  live rays: a dead ray's update is masked, so neither changes a result.
- ``grid_cast_wavefront``, cell-major: each round enumerates the occupied
  cells every live ray visits next (``_enumerate_visits``), sorts the
  (ray, cell) pairs by cell into blocks that never span two cells
  (``_sort_pairs``) and tests each block against its one cell's row
  (``_mt_blocks``), then folds the round into the bundle's best hits and
  retires the rays whose closest hit lies inside the covered interval
  (``_merge_round``). Two host reads a round (the live block count and
  the frontier) size the next; the rounds' schedule is the JAX package's,
  since it decides which pairs share a block and so which of two triangles
  at equal t wins.

Crossings are counted in the cell that holds the hit point, with the
build's floor arithmetic. The cell arithmetic rounds as XLA's CPU code
does (``o + t·d`` fused, ``x / cell`` for the static cell as
``x · f32(1/cell)``), so the crossings land in the same cells. ``SYNCS``
counts every host read of the casts' loops.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import input_device
from pyqsm_tpu_torch.ops.neighbors import _fma
from pyqsm_tpu_torch.ops.raygrid import _host
from pyqsm_tpu_torch.ops.raytrace import Hits, mt_components
from pyqsm_tpu_torch.ops.sampling import nonzero_rows

# the DDA reads its alive count from the device every this many steps
_CHECK_EVERY = 4
# below this many live rays a tile's working set is not compacted further
_COMPACT_MIN = 4096
# host reads of the casts' loop tests (the DDA's alive counts and skip-phase
# flags, the wavefront's walk tests, block counts and frontier sizes),
# counted so a caller can weigh the host loops' syncs
SYNCS = 0
_INT_MAX = int(np.iinfo(np.int32).max)


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
                 cap_percentile: float = 99.5, cell_rows_budget: int = 1 << 30,
                 device=None) -> Grid3D:
    """Host-built uniform grid (one argsort), returned on ``device``, else on
    the vertices' device when they are a tensor, else on the card.

    The cell balances ~``target_tris_per_cell`` triangles a cell against the
    DDA's step count, floored at the median triangle extent and at
    ``span / max_cells_per_axis``. The cap is the ``cap_percentile`` cell
    occupancy: triangles past their cell's cap leave the grid entirely for
    ``residual``. An explicit ``cell_cap`` raises ``ValueError`` when a cell
    holds more."""
    dev = input_device(vertices, device)
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
    """``grid_cast`` against a :class:`Grid3D` or a :class:`TwoLevelGrid`
    (``wavefront=True``: ``grid_cast_wavefront`` for both levels). The sub
    cast takes only the rays whose segment touches the sub grid's AABB
    (and, for closest hits, enter it before their primary hit): the whole
    bundle when that is half of it or more, else a front-packed sub-bundle
    of a power-of-two capacity whose results are scattered back."""
    caster = grid_cast_wavefront if wavefront else grid_cast
    if isinstance(grid, Grid3D):
        return caster(grid, origins, dirs, **cast_kw)
    debug = cast_kw.get("debug", False)
    t0 = time.perf_counter()
    a = caster(grid.primary, origins, dirs, **cast_kw)
    if debug:
        print(f"# two_level primary dt={time.perf_counter() - t0:.3f}s", flush=True)
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
    if debug:
        print(f"# two_level sub cull m={m}/{r} (sub {sub.nx}x{sub.ny}x{sub.nz} occ "
              f"{sub.n_occupied})", flush=True)
    if m == 0:
        return a
    if m >= r // 2:
        b = caster(sub, origins, dirs, **cast_kw)
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
    bs = caster(sub, origins[safe], dirs[safe], **cast_kw)
    return _scatter_sub_hits(a, bs.t, bs.tri, bs.uv, bs.count, safe, live, grid.sub_tri_ids)


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
    f = torch.nan_to_num(torch.floor(x), nan=0.0).clamp(-1.0, 2.0 ** 30).to(torch.int32)
    return f.clamp(min=0).minimum(top) if isinstance(top, torch.Tensor) else f.clamp(0, top)


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


# ---------------------------------------------------------------------------
# the wavefront (cell-major) caster
# ---------------------------------------------------------------------------


def _enumerate_visits(origins, dirs, t_start, alive_in, c_start, lo, cell: float, nx: int, ny: int,
                      nz: int, skip_tab, ray_tile: int, visits: int, max_steps: int,
                      first_round: bool = True, it_budget: int | None = None, unroll: int = 8):
    """March each ray from ``t_start`` and record up to ``visits`` occupied
    cell ids: ``(vis [R, V] i32 (-1 pad), t_cov [R] — the march parameter
    at the end of the recorded segment (inf once the ray left the grid),
    more [R] — still inside the grid with cells left to visit, c_next
    [R, 3] the resume cell, t_next [R] the resume parameter)``.

    A resume round (``first_round=False``) walks on from the carried cell
    ``c_start``, and ``t_start`` is the carried ``t_next``. One advance
    records the ray's cell when it is occupied, then takes one DDA step or
    jumps (skip - 1) minimum cell widths through verified-empty space. The
    advance count is capped at ``it_budget`` (and at ``max_steps + visits``)
    and tested every ``unroll`` advances, a host read each; a ray frozen by
    the cap resumes next round. An advance leaves a ray whose quota is full
    or that left the grid as it is, so the result of a ray does not depend
    on the rays marched with it: groups of ``min(16, tiles)`` tiles of
    ``ray_tile`` rays are marched together, as the JAX package's
    ``lax.map`` batches them."""
    global SYNCS
    r = origins.shape[0]
    dev = origins.device
    dims = (nx, ny, nz)
    top = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32, device=dev)
    cell32 = float(np.float32(cell))
    inv_cell = float(np.float32(1.0 / cell))
    # the JAX package adds a Python float product to lo: f32(dims·cell)
    hi = lo + torch.tensor([np.float32(dims[a] * cell) for a in range(3)], device=dev)
    it_cap = max_steps + visits if it_budget is None else min(it_budget, max_steps + visits)
    group = ray_tile * min(16, -(-r // ray_tile))
    outs = []
    for r0 in range(0, r, group):
        sl = slice(r0, r0 + group)
        o = origins[sl].to(torch.float32)
        d = dirs[sl].to(torch.float32)
        ts = t_start[sl].to(torch.float32)
        rt = o.shape[0]
        inv = _inverse(d)
        tmin_ax, tmax_ax = _slabs(o, d, inv, lo, hi)
        t_enter = torch.maximum(torch.clamp(tmin_ax.amax(dim=1), min=0.0), ts)
        t_exit_grid = tmax_ax.amin(dim=1)
        alive = alive_in[sl] & (t_enter <= t_exit_grid)
        if first_round:
            c = _floor_cell((_fma((t_enter + 1e-6)[:, None], d, o) - lo) * inv_cell, top)
        else:
            c = torch.minimum(c_start[sl].to(torch.int32).clamp(min=0), top)
        step = torch.sign(d).to(torch.int32)
        min_td = torch.where(d != 0, cell32 * inv.abs(), torch.inf).amin(dim=1)
        nrec = torch.zeros(rt, dtype=torch.int32, device=dev)
        # [R, V + 1]: column V takes the writes of rays that record nothing
        vis = torch.full((rt, visits + 1), -1, dtype=torch.int32, device=dev)
        rows = torch.arange(rt, device=dev)
        t_cur = t_enter
        t_cov = torch.where(alive, t_enter, ts)

        def dda_step(c, move):
            """One DDA step for rays in ``move``, the first minimum's axis
            on ties: (c', t_exit, stay_alive)."""
            nb = _fma(torch.where(d >= 0, c + 1, c).float(), cell32, lo)
            tm = torch.where(d != 0, (nb - o) * inv, torch.inf)
            t_exit = torch.minimum(torch.minimum(tm[:, 0], tm[:, 1]), tm[:, 2])
            mvx = (tm[:, 0] <= tm[:, 1]) & (tm[:, 0] <= tm[:, 2])
            mvy = ~mvx & (tm[:, 1] <= tm[:, 2])
            mv = torch.stack([mvx, mvy, ~mvx & ~mvy], 1)
            c_new = c + torch.where(mv, step, 0)
            oob = ((c_new < 0) | (c_new > top)).any(dim=1)
            c_out = torch.where(move[:, None], torch.minimum(c_new.clamp(min=0), top), c)
            return c_out, t_exit, ~(move & oob)

        it = 0
        while it < it_cap:
            SYNCS += 1
            if not bool((alive & (nrec < visits)).any()):
                break
            for _ in range(unroll):
                act = alive & (nrec < visits)
                cid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
                k = torch.where(act, skip_tab[torch.where(act, cid, 0).long()], 0).to(torch.int32)
                occ = act & (k == 0)
                vis[rows, torch.where(occ, nrec, visits).long()] = torch.where(occ, cid, -1)
                nrec = nrec + occ.to(torch.int32)
                jump = act & (k >= 2)
                t_jump = _fma((k - 1).float(), min_td, t_cur)
                c_jump = _floor_cell((_fma(t_jump[:, None], d, o) - lo) * inv_cell, top)
                c_step, t_exit, ok_step = dda_step(c, act & ~jump)
                c = torch.where(act[:, None], torch.where(jump[:, None], c_jump, c_step), c)
                t_cur = torch.where(jump, t_jump, torch.where(act, t_exit, t_cur))
                # the recorded cell's exit closes the covered interval
                t_cov = torch.where(occ, t_exit, t_cov)
                alive = alive & ~((jump & (t_jump >= t_exit_grid)) | ~ok_step)
            it += unroll
        outs.append((vis[:, :visits], torch.where(alive, t_cov, torch.inf), alive, c, t_cur))
    return tuple(torch.cat(x) for x in zip(*outs))


def _sort_pairs(visit_cids: torch.Tensor, block: int, alive: torch.Tensor | None = None):
    """Sort the (ray, visited cell) pairs cell-major (stable: a cell's pairs
    keep ray order) and cut them into blocks of at most ``block`` pairs
    that never span two cells. Returns (skeys, srays, blk_id, pos_in_blk,
    live_pair, n_blk), ``n_blk`` the exact number of live blocks (a
    0-dim tensor); dead pairs sort last under the key int32 max."""
    r, v = visit_cids.shape
    dev = visit_cids.device
    if alive is not None:
        visit_cids = torch.where(alive[:, None], visit_cids, -1)
    keys = torch.where(visit_cids >= 0, visit_cids, _INT_MAX).reshape(-1)
    ray_of = torch.arange(r, dtype=torch.int32, device=dev).repeat_interleave(v)
    skeys, order = torch.sort(keys, stable=True)
    srays = ray_of[order]
    idx = torch.arange(r * v, dtype=torch.int32, device=dev)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    seg_start = torch.cummax(torch.where(first, idx, -1), 0).values
    first_blk = first | ((idx - seg_start) % block == 0)
    blk_id = torch.cumsum(first_blk.to(torch.int32), 0, dtype=torch.int32) - 1
    pos_in_blk = idx - torch.cummax(torch.where(first_blk, idx, -1), 0).values
    live_pair = skeys < _INT_MAX
    n_blk = torch.where(live_pair, blk_id, -1).amax() + 1
    return skeys, srays, blk_id, pos_in_blk, live_pair, n_blk


def _mt_blocks(origins, dirs, skeys, srays, blk_id, pos_in_blk, live_pair, tri_of_slot, packed,
               lo, cell_size: float, dims, block: int, nb_cap: int, n_blk: int,
               cell_rank=None, cell_rows=None, packed_cells: bool = False):
    """Möller–Trumbore over the live blocks of :func:`_sort_pairs`: each
    block's one cell row against its rays, a dense [blocks, cap, block]
    test, as many blocks a step as keep an intermediate within
    ``raygrid._BLOCK_ELEMS`` elements (blocks are independent, so the step
    changes no result). The ``nb_cap - n_blk`` blocks past the live ones
    hold no pair and are not tested. Returns each ray's best of the round
    (t, tri, u, v, count): the least t, the crossings summed, the winner
    the lowest block slot among the pairs at that t."""
    from pyqsm_tpu_torch.ops.raygrid import _BLOCK_ELEMS

    r = origins.shape[0]
    dev = origins.device
    blk_safe = torch.where(live_pair, torch.clamp(blk_id, max=nb_cap - 1), nb_cap).long()
    block_cell = torch.full((nb_cap + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, blk_safe, torch.where(live_pair, skeys, -1), "amax")[:n_blk]
    pair_ray = torch.full((nb_cap * block + 1,), -1, dtype=torch.int32, device=dev)
    pair_ray[torch.clamp(blk_safe * block + pos_in_blk, max=nb_cap * block)] = \
        torch.where(live_pair, srays, -1)
    pair_ray = pair_ray[:n_blk * block].reshape(n_blk, block)
    cap = cell_rows.shape[1] // 16 if packed_cells else tri_of_slot.shape[1]
    step = 1
    while step * 2 <= max(n_blk, 1) and step * 2 * cap * block <= _BLOCK_ELEMS:
        step *= 2
    shape = (n_blk, block)
    t_b = torch.empty(shape, device=dev)
    tri_b = torch.empty(shape, dtype=torch.int32, device=dev)
    u_b = torch.empty(shape, device=dev)
    v_b = torch.empty(shape, device=dev)
    c_b = torch.empty(shape, dtype=torch.int32, device=dev)
    cell32 = float(np.float32(cell_size))
    for b0 in range(0, n_blk, step):
        cells = block_cell[b0:b0 + step]
        rays = pair_ray[b0:b0 + step]
        n = cells.shape[0]
        if packed_cells:
            rnk = torch.where(cells >= 0, cell_rank[cells.clamp(min=0).long()], -1)
            rows = cell_rows[rnk.clamp(min=0).long()].reshape(n, cap, 16)
            ok_tri = (rnk >= 0)[:, None] & (rows[..., 9] > 0.5)
            slots = torch.where(ok_tri, rows[..., 10].contiguous().view(torch.int32), -1)
        else:
            slots = tri_of_slot[cells.clamp(min=0).long()]
            rows = packed[slots.clamp(min=0).long()]
            ok_tri = (slots >= 0) & (cells >= 0)[:, None] & (rows[..., 9] > 0.5)
        rid = rays.clamp(min=0).long()
        o, d = origins[rid], dirs[rid]  # [n, block, 3]
        ov = tuple(o[..., a][:, None, :] for a in range(3))
        dv = tuple(d[..., a][:, None, :] for a in range(3))
        tt, u, v = mt_components(ov, dv, tuple(rows[..., a][:, :, None] for a in range(3)),
                                 tuple(rows[..., 3 + a][:, :, None] for a in range(3)),
                                 tuple(rows[..., 6 + a][:, :, None] for a in range(3)),
                                 ok_tri[:, :, None] & (rays >= 0)[:, None, :])
        hit = torch.isfinite(tt)
        t_hit = torch.where(hit, tt, 0.0)
        # a crossing counts in the cell that holds its hit point; the cell
        # size is a traced argument in the JAX package, so a true division
        hcid = None
        for a in range(3):
            hca = _floor_cell((_fma(t_hit, dv[a], ov[a]) - lo[a]) / cell32, dims[a] - 1)
            hcid = hca if hcid is None else hcid * dims[a] + hca
        sl = slice(b0, b0 + n)
        c_b[sl] = (hit & (hcid == cells[:, None, None])).sum(dim=1, dtype=torch.int32)
        j = torch.argmin(tt, dim=1, keepdim=True)  # over cap: the first minimum
        tmin = tt.gather(1, j)[:, 0]
        t_b[sl] = tmin
        tri_b[sl] = torch.where(torch.isfinite(tmin),
                                slots[:, :, None].expand(-1, -1, block).gather(1, j)[:, 0], -1)
        u_b[sl] = u.gather(1, j)[:, 0]
        v_b[sl] = v.gather(1, j)[:, 0]
    # each ray's reduction straight from the block layout (pad slots carry
    # ray -1 and land in the dropped row r)
    t_flat = t_b.reshape(-1)
    wr = torch.where(pair_ray >= 0, pair_ray, r).reshape(-1).long()
    best_t = torch.full((r + 1,), torch.inf, device=dev).scatter_reduce(0, wr, t_flat, "amin")
    count = torch.zeros(r + 1, dtype=torch.int32, device=dev).scatter_reduce(
        0, wr, c_b.reshape(-1), "sum")[:r]
    is_best = torch.isfinite(t_flat) & (t_flat <= best_t[wr])
    n_slots = t_flat.shape[0]
    win = torch.full((r + 1,), _INT_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(is_best, wr, r), torch.arange(n_slots, dtype=torch.int32, device=dev),
        "amin")[:r]
    best_t = best_t[:r]
    has = torch.isfinite(best_t)
    safe = torch.where(has, torch.clamp(win, max=n_slots - 1), 0).long()
    return (best_t, torch.where(has, tri_b.reshape(-1)[safe], -1),
            torch.where(has, u_b.reshape(-1)[safe], 0.0),
            torch.where(has, v_b.reshape(-1)[safe], 0.0), count)


def _merge_round(best_t, best_tri, best_u, best_v, count, ridx, alive, more, t, tri, u, v, cnt,
                 t_cov, count_all: bool) -> torch.Tensor:
    """Fold one round's results of the (compacted) rows into the bundle's
    best arrays, in place, and return the surviving frontier. The best
    arrays hold one row past the bundle, which takes the writes of rows
    that are not alive (compaction padding aliases ray 0). A ray retires
    when its closest hit lies inside the covered interval (unless
    ``count_all``) or it left the grid."""
    n = best_t.shape[0] - 1
    ridx = ridx.long()
    bt = best_t[ridx]
    t_eff = torch.where(alive, t, torch.inf)
    better = t_eff < bt
    wr = torch.where(alive, ridx, n)
    wr_b = torch.where(better, wr, n)
    bt_after = torch.minimum(bt, t_eff)
    best_t[wr] = bt_after
    best_tri[wr_b] = tri
    best_u[wr_b] = u
    best_v[wr_b] = v
    count.index_put_((wr,), torch.where(alive, cnt, 0), accumulate=True)
    if count_all:
        return alive & more
    return alive & more & ~(bt_after <= t_cov + 1e-6)


def _compact_frontier(alive, o_c, d_c, t_walk, c_resume, ridx, cap: int):
    """The surviving frontier front-packed into ``cap`` rows (padding rows
    alias row 0 and come back not alive)."""
    sel = nonzero_rows(alive, cap)
    safe = sel.clamp(min=0).long()
    return o_c[safe], d_c[safe], t_walk[safe], c_resume[safe], ridx[safe], sel >= 0


def _gather_tail(alive, o_c, d_c, ridx, cap: int):
    """The stragglers for the tail fallback: their rays, their bundle rows
    and which of the ``cap`` rows are live."""
    sel = nonzero_rows(alive, cap)
    safe = sel.clamp(min=0).long()
    return o_c[safe], d_c[safe], ridx[safe], sel >= 0


def _scatter_tail(best_t, best_tri, best_u, best_v, count, rows_live, live, hf: Hits):
    """The tail fallback's results REPLACE the stragglers' rows, in place
    (``grid_cast`` walks from the origin, so they are complete); returns
    the ``handled`` mask that keeps these rays out of the residual pass."""
    n = best_t.shape[0] - 1
    rows = torch.where(live, rows_live, n).long()
    best_t[rows] = torch.where(live, hf.t, torch.inf)
    best_tri[rows] = torch.where(live, hf.tri, -1)
    best_u[rows] = torch.where(live, hf.uv[:, 0], 0.0)
    best_v[rows] = torch.where(live, hf.uv[:, 1], 0.0)
    count[rows] = torch.where(live, hf.count, 0)
    handled = torch.zeros(n + 1, dtype=torch.bool, device=best_t.device)
    handled[rows] = live
    return handled[:n]


def _residual_merge(o, d, rows_r, res, best_t, best_tri, best_u, best_v, count, handled):
    """Every ray against the spilled triangles ``res`` (packed rows
    ``rows_r``), folded into the best arrays in place: a strictly closer
    hit replaces, crossings add. Rays in ``handled`` (the tail fallback's,
    whose DDA tested the spill itself) are left out. Rays go in chunks
    that keep the [spill, rays] intermediate within ``_BLOCK_ELEMS``."""
    from pyqsm_tpu_torch.ops.raygrid import _BLOCK_ELEMS

    r = o.shape[0]
    nr = rows_r.shape[0]
    ok_r = ((res >= 0) & (rows_r[:, 9] > 0.5))[:, None]
    v0c, e1c, e2c = (tuple(rows_r[:, b + a][:, None] for a in range(3)) for b in (0, 3, 6))
    chunk = max(1, _BLOCK_ELEMS // max(nr, 1))
    for c0 in range(0, r, chunk):
        sl = slice(c0, c0 + chunk)
        oc, dc = o[sl], d[sl]
        tt, uu, vv = mt_components(tuple(oc[:, a][None, :] for a in range(3)),
                                   tuple(dc[:, a][None, :] for a in range(3)), v0c, e1c, e2c, ok_r)
        cm = torch.isfinite(tt).sum(dim=0, dtype=torch.int32)
        jj = torch.argmin(tt, dim=0, keepdim=True)
        tm = tt.gather(0, jj)[0]
        trm = torch.where(torch.isfinite(tm), res[jj[0]], -1)
        if handled is not None:
            tm = torch.where(handled[sl], torch.inf, tm)
            cm = torch.where(handled[sl], 0, cm)
        better = tm < best_t[sl]
        best_tri[sl] = torch.where(better, trm, best_tri[sl])
        best_u[sl] = torch.where(better, uu.gather(0, jj)[0], best_u[sl])
        best_v[sl] = torch.where(better, vv.gather(0, jj)[0], best_v[sl])
        best_t[sl] = torch.minimum(best_t[sl], tm)
        count[sl] = count[sl] + cm


def grid_cast_wavefront(grid: Grid3D, origins: torch.Tensor, dirs: torch.Tensor, visits: int = 4,
                        block: int = 256, count_all: bool = False, ray_tile: int = 65536,
                        max_rounds: int | None = None, it_budget: int = 32,
                        tail_fallback: int = 2048, debug: bool = False) -> Hits:
    """Exact casting of an arbitrary bundle, cell-major (``grid_cast``'s
    results; the module docstring has the design).

    ``visits``: occupied cells a ray covers in round 0; ``it_budget``: its
    advance cap there. Later rounds escalate: 4× both while more than
    32 768 rows remain (the caller's schedule above 131 072), else 8×
    ``visits`` and a budget that finishes the walk. Once the frontier is
    a quarter of its buffer or less (and the buffer above 2048 rows), the
    survivors are front-packed into a buffer of 2048·4^k rows. From round
    1, once at most ``tail_fallback`` rays are alive, they finish in one
    ``grid_cast`` of that many rays, whose results replace theirs
    (``tail_fallback=0`` keeps every ray on the rounds). ``debug`` prints a
    line a round (``rc=``, ``blocks=``, ``alive=``, phase seconds).

    A host-stepped loop: each round reads the live block count and the
    frontier's size (counted in ``SYNCS`` with the walk's tests)."""
    global SYNCS
    dev = origins.device
    r = origins.shape[0]

    def tick() -> float:
        if debug and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    o = origins.to(torch.float32)
    d = dirs.to(torch.float32)
    dims = (grid.nx, grid.ny, grid.nz)
    max_steps = grid.nx + grid.ny + grid.nz + 4
    if max_rounds is None:
        # each round advances a live ray by ≥ it_budget cells or retires it;
        # the visits quota binds only when every advance lands in an occupied cell
        max_rounds = -(-max_steps // visits) + -(-max_steps // it_budget) + 2
    # the best arrays hold one row past the bundle for dropped writes
    best_t = torch.full((r + 1,), torch.inf, device=dev)
    best_tri = torch.full((r + 1,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r + 1, device=dev)
    best_v = torch.zeros(r + 1, device=dev)
    count = torch.zeros(r + 1, dtype=torch.int32, device=dev)
    handled = None  # the rays the tail fallback finished (residual included)

    # the working set: the whole bundle, front-packed as the frontier shrinks
    o_c, d_c = o, d
    ridx = torch.arange(r, dtype=torch.int32, device=dev)
    t_walk = torch.zeros(r, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    c_resume = torch.zeros((r, 3), dtype=torch.int32, device=dev)
    rc = r
    for rnd in range(max_rounds if r else 0):
        t_rnd = tick()
        if rnd == 0 or rc > 131072:
            v_rnd, b_rnd = visits, it_budget
        elif rc > 32768:
            v_rnd, b_rnd = 4 * visits, 4 * it_budget
        else:
            v_rnd = 8 * visits
            b_rnd = max_steps + v_rnd
        vis, t_cov, more, c_resume, t_walk = _enumerate_visits(
            o_c, d_c, t_walk, alive, c_resume, grid.lo, grid.cell, grid.nx, grid.ny, grid.nz,
            grid.skip, ray_tile=min(ray_tile, max(256, 1 << (rc - 1).bit_length())),
            visits=v_rnd, max_steps=max_steps, first_round=rnd == 0, it_budget=b_rnd)
        t_enum = tick()
        skeys, srays, blk_id, pos_in_blk, live_pair, n_blk_d = _sort_pairs(vis, block, alive)
        SYNCS += 1
        n_blk = int(n_blk_d)  # host read: the exact live block count
        t_sort = time.perf_counter()
        if n_blk > 0:
            # power-of-two buckets up to 4096 blocks, then steps of 4096
            if n_blk <= 4096:
                nb_cap = 256
                while nb_cap < n_blk:
                    nb_cap *= 2
            else:
                nb_cap = -4096 * (-n_blk // 4096)
            t, tri, u, v, cnt = _mt_blocks(
                o_c, d_c, skeys, srays, blk_id, pos_in_blk, live_pair, grid.tri_of_slot,
                grid.packed, grid.lo, grid.cell, dims, block=block, nb_cap=nb_cap, n_blk=n_blk,
                cell_rank=grid.cell_rank, cell_rows=grid.cell_rows,
                packed_cells=bool(grid.packed_cells))
        else:
            t = torch.full((rc,), torch.inf, device=dev)
            tri = torch.full((rc,), -1, dtype=torch.int32, device=dev)
            u = v = torch.zeros(rc, device=dev)
            cnt = torch.zeros(rc, dtype=torch.int32, device=dev)
        t_mt = tick()
        alive = _merge_round(best_t, best_tri, best_u, best_v, count, ridx, alive, more, t, tri,
                             u, v, cnt, t_cov, count_all)
        SYNCS += 1
        n_alive = int(alive.sum())  # host read: the frontier's size
        if debug:
            print(f"# wavefront rnd={rnd} rc={rc} blocks={n_blk} alive={n_alive} "
                  f"dt={time.perf_counter() - t_rnd:.3f}s (enum={t_enum - t_rnd:.3f} "
                  f"sort={t_sort - t_enum:.3f} mt={t_mt - t_sort:.3f} "
                  f"merge={time.perf_counter() - t_mt:.3f})", flush=True)
        if n_alive == 0:
            break
        if rnd >= 1 and n_alive <= tail_fallback:
            # the stragglers finish in one DDA cast of tail_fallback rays
            t_fb = time.perf_counter()
            o_t, d_t, rows_live, live = _gather_tail(alive, o_c, d_c, ridx, tail_fallback)
            hf = grid_cast(grid, o_t, d_t, ray_tile=tail_fallback, count_all=count_all)
            handled = _scatter_tail(best_t, best_tri, best_u, best_v, count, rows_live, live, hf)
            if debug:
                print(f"# wavefront tail-fallback n={n_alive} dt={tick() - t_fb:.3f}s",
                      flush=True)
            break
        if n_alive <= rc // 4 and rc > 2048:
            rc_new = 2048
            while rc_new < n_alive:
                rc_new *= 4
            o_c, d_c, t_walk, c_resume, ridx, alive = _compact_frontier(
                alive, o_c, d_c, t_walk, c_resume, ridx, rc_new)
            rc = rc_new

    best_t, best_tri, best_u, best_v, count = (x[:r] for x in (best_t, best_tri, best_u, best_v,
                                                               count))
    if grid.n_residual > 0:
        # the spilled triangles, absent from every cell, once a ray
        t_res = time.perf_counter()
        res = grid.residual
        _residual_merge(o, d, grid.packed[res.clamp(min=0).long()], res, best_t, best_tri,
                        best_u, best_v, count, handled)
        if debug:
            print(f"# wavefront residual n={grid.n_residual} dt={tick() - t_res:.3f}s",
                  flush=True)
    return Hits(t=best_t, tri=best_tri, uv=torch.stack([best_u, best_v], 1), count=count)


def grid_occupancy(grid: Grid3D, points: torch.Tensor, ray_tile: int = 4096) -> torch.Tensor:
    """Inside/outside by crossing parity along the slightly off-axis +z ray
    of ``raytrace.occupancy``, through the grid."""
    dirs = torch.tensor([1.73205e-4, 2.23607e-4, 1.0], dtype=torch.float32,
                        device=points.device).expand_as(points)
    hits = grid_cast(grid, points, dirs, ray_tile=ray_tile, count_all=True)
    return (hits.count % 2) == 1
