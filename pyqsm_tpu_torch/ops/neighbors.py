"""Neighbor engine (counterpart of ``pyqsm_tpu/ops/neighbors.py``).

- ``knn``: exact brute force over the ``|q|² + |p|² − 2·q·pᵀ`` expansion,
  tiled over queries; equal distances rank by ascending index exactly as
  ``lax.top_k`` ranks them, on every device. The JAX package's
  ``approx=True`` lowers to this exact query on the CPU.
- ``radius_knn``/``radius_count``: the same distance tiles, thresholded.
- ``GridIndex``/``build_grid``: points sorted by voxel cell (stable), with
  ``max_cell_occupancy`` and ``recommend_cell_cap``; ``grid_radius_knn``
  (the k nearest within the radius, ascending) and ``grid_radius_any_k``
  (the first k in slot order) for external queries, candidates the 27
  neighbour cells' first ``cell_cap`` rows, distances ``Σ (q − c)²``.
- ``grid_self_radius_knn``: the self query over a cloud; sorted, the
  cell-blocked query (a cell's rows against its 27 neighbour buckets,
  distances ``q² + c² − 2·q·c`` with the dot product in XLA's CPU order,
  elementwise, so the card gives the CPU's bits); unsorted, the bucket-row
  any-k query (the first k in-radius candidates in (27-cell offset,
  in-cell row) order).

All distance products are float32 without TF32.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import as_tensor, input_device
from pyqsm_tpu_torch.ops.sampling import INT32_MAX, _scalar

# elements of one [B, QT, N] distance tile (bounds the tile's memory)
_TILE_ELEMS = 1 << 27


def _sq3(x: torch.Tensor) -> torch.Tensor:
    """x² + y² + z² of float32 [..., 3] rows as XLA computes it: a fused
    multiply-add chain ``fma(z, z, fma(y, y, x·x))``, emulated in float64
    (each product is exact there; one rounding to float32 per step)."""
    x64 = x.double()
    s = (x64[..., 0] * x64[..., 0]).float().double()
    s = (x64[..., 1] * x64[..., 1] + s).float().double()
    return (x64[..., 2] * x64[..., 2] + s).float()


def _fma(a, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once, as the multiply-adds XLA contracts on
    the CPU: through float64, where the product is exact."""
    wide = [x.double() if isinstance(x, torch.Tensor) else x for x in (a, b, c)]
    return (wide[0] * wide[1] + wide[2]).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's: through float64
    (torch's vectorised CPU float32 sqrt misrounds about 0.7 % of inputs
    by one ulp)."""
    return torch.sqrt(x.double()).float()


def _dist2(q_sq: torch.Tensor, p_sq: torch.Tensor, qf: torch.Tensor,
           pf: torch.Tensor) -> torch.Tensor:
    """[B, QT, N] squared distances ``(|q|² + |p|²) − 2·q·pᵀ`` as one
    batched GEMM with the sum as its addend, in full float32 (TF32 off for
    the call: the expansion cancels catastrophically when d << |coords|).
    Dead candidates carry |p|² = inf, so their d² is inf."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.baddbmm(q_sq[..., None] + p_sq[:, None, :], qf, pf.transpose(1, 2),
                             beta=1.0, alpha=-2.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _live(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device) if mask is None else mask


def _prep_points(points: torch.Tensor, point_mask: torch.Tensor):
    """Candidate side: inf-filled masked rows, |p|² (inf on dead rows),
    zero-filled coordinates."""
    pts = torch.where(point_mask[..., None], points, float("inf"))
    p_sq = _sq3(pts)
    p_sq = torch.where(torch.isfinite(p_sq), p_sq, float("inf"))
    pf = torch.where(torch.isfinite(pts), pts, 0.0)
    return p_sq, pf


def _prep_queries(queries: torch.Tensor, query_mask: torch.Tensor):
    q = torch.where(query_mask[..., None], queries, float("inf"))
    q_sq = _sq3(q)
    q_sq = torch.where(torch.isfinite(q_sq), q_sq, 1e30)
    qf = torch.where(torch.isfinite(q), q, 0.0)
    return q_sq, qf


def _query_tile(b: int, nq: int, npt: int) -> int:
    return max(1, min(nq, _TILE_ELEMS // max(b * npt, 1)))


def _ordered_key(d2: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (d², column) lexicographically: the
    order-preserving bits of d² above the column index."""
    bits = d2.contiguous().view(torch.int32)
    mono = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    col = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    return (mono << 32) | col


def smallest_k(d2: torch.Tensor, k: int, live_rows: torch.Tensor) -> torch.Tensor:
    """Columns of the k smallest entries of each row of [B, Q, N] ``d2``,
    ascending, with equal values in ascending column order (``lax.top_k``'s
    order). A float top-k decides every row without a finite tie among its
    k + 1 smallest; the (rare) rows with one are redone on exact
    (value, column) keys. Rows not in ``live_rows`` [B, Q] are not
    repaired (their results are masked by the caller)."""
    # one extra place: a tie across the k-th place shows as equal values
    # at places k and k+1
    kk = min(k + 1, d2.shape[-1])
    vals, cols = torch.topk(d2, kk, dim=-1, largest=False, sorted=True)
    tie = ((vals[..., 1:] == vals[..., :-1]) & torch.isfinite(vals[..., 1:])).any(-1)
    cols = cols[..., :k]
    tie &= live_rows
    if bool(tie.any()):
        bi, qi = torch.nonzero(tie, as_tuple=True)
        key = torch.topk(_ordered_key(d2[bi, qi]), k, dim=-1, largest=False, sorted=True).values
        cols[bi, qi] = key & 0xFFFFFFFF
    return cols


def knn(queries: torch.Tensor, points: torch.Tensor, k: int,
        query_mask: torch.Tensor | None = None,
        point_mask: torch.Tensor | None = None, query_tile: int = 1024,
        candidate_tile: int = 2048, approx: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of [..., Q, 3] queries among [..., N, 3] points (one
    optional leading batch axis). Returns ``(dists [.., Q, k] f32, idx
    [.., Q, k] i32)`` sorted ascending, ``(inf, -1)`` padded; equal
    distances rank by ascending index. Self-matches are kept (ask for k+1
    and drop column 0).

    ``query_tile`` and ``candidate_tile`` are the JAX package's tiles,
    accepted at its positions and unused: the port sizes its query blocks
    from ``_TILE_ELEMS`` and scans every candidate at once, and no result
    depends on a tile. ``approx=True`` runs the same exact top-k, as the
    JAX package's does on the CPU."""
    unbatched = queries.dim() == 2
    if unbatched:
        queries, points = queries[None], points[None]
        query_mask = None if query_mask is None else query_mask[None]
        point_mask = None if point_mask is None else point_mask[None]
    b, nq, _ = queries.shape
    npt = points.shape[1]
    dev = queries.device
    query_mask, point_mask = _live(queries, query_mask), _live(points, point_mask)
    p_sq, pf = _prep_points(points, point_mask)
    idx = torch.where(point_mask, torch.arange(npt, dtype=torch.int32, device=dev), -1)
    if npt < k:  # pad candidates so top-k always has k columns
        pad = k - npt
        p_sq = torch.cat([p_sq, p_sq.new_full((b, pad), float("inf"))], 1)
        pf = torch.cat([pf, pf.new_zeros((b, pad, 3))], 1)
        idx = torch.cat([idx, idx.new_full((b, pad), -1)], 1)
    q_sq, qf = _prep_queries(queries, query_mask)
    out_d = torch.empty(b, nq, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(b, nq, k, dtype=torch.int32, device=dev)
    qt = _query_tile(b, nq, pf.shape[1])
    for s in range(0, nq, qt):
        e = min(nq, s + qt)
        d2 = _dist2(q_sq[:, s:e], p_sq, qf[:, s:e], pf)
        col = smallest_k(d2, k, query_mask[:, s:e])
        out_d[:, s:e] = torch.gather(d2, -1, col)
        out_i[:, s:e] = torch.gather(idx[:, None, :].expand(-1, e - s, -1), -1, col)
    out_d = torch.where(query_mask[..., None], out_d, float("inf"))
    out_i = torch.where(query_mask[..., None], out_i, -1)
    out_d = torch.sqrt(torch.clamp(out_d, min=0.0))
    if unbatched:
        return out_d[0], out_i[0]
    return out_d, out_i


def radius_knn(queries, points, radius: float, k: int, query_mask=None, point_mask=None):
    """k nearest within ``radius``; entries beyond it become ``(inf, -1)``."""
    d, i = knn(queries, points, k, query_mask=query_mask, point_mask=point_mask)
    ok = d <= radius
    return torch.where(ok, d, float("inf")), torch.where(ok, i, -1)


def radius_count(queries: torch.Tensor, points: torch.Tensor, radius: float,
                 query_mask: torch.Tensor | None = None,
                 point_mask: torch.Tensor | None = None, query_tile: int = 1024,
                 candidate_tile: int = 2048,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Number (i32) of live points within ``radius`` of each query, or with
    ``weights`` [N] the f32 sum of their weights. ``query_tile`` and
    ``candidate_tile`` are the JAX package's tiles, accepted at its
    positions and unused (the query blocks come from ``_TILE_ELEMS``)."""
    nq, npt = queries.shape[0], points.shape[0]
    dev = queries.device
    query_mask, point_mask = _live(queries, query_mask), _live(points, point_mask)
    p_sq, pf = _prep_points(points, point_mask)
    q_sq, qf = _prep_queries(queries, query_mask)
    r2 = radius * radius
    if weights is None:
        out = torch.zeros(nq, dtype=torch.int32, device=dev)
    else:
        w = weights.to(torch.float32)
        out = torch.zeros(nq, dtype=torch.float32, device=dev)
    qt = _query_tile(1, nq, npt)
    for s in range(0, nq, qt):
        e = min(nq, s + qt)
        inr = _dist2(q_sq[None, s:e], p_sq[None], qf[None, s:e], pf[None])[0] <= r2
        if weights is None:
            out[s:e] = inr.sum(dim=1, dtype=torch.int32)
        else:
            out[s:e] = torch.where(inr, w[None, :], 0.0).sum(dim=1)
    return torch.where(query_mask, out, 0)


# ---------------------------------------------------------------------------
# Sorted voxel grid: the index, per-query grid queries, self queries
# ---------------------------------------------------------------------------

_MAX_BUCKET = 64  # per-cell occupancy the grid query serves exactly
_CELL_TILE = 4096  # occupied cells per query tile, at most
_NBR_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


class GridIndex(NamedTuple):
    """Points sorted by voxel cell id. ``cell_size >= query radius`` so the
    27-cell neighbourhood is complete."""

    sorted_points: torch.Tensor  # [N, 3] (inf on dead rows, at the tail)
    sorted_idx: torch.Tensor  # [N] i32 original rows (-1 for dead rows)
    sorted_cell: torch.Tensor  # [N] i32 cell ids, ascending (dead rows INT32_MAX)
    origin: torch.Tensor  # [3]
    dims: torch.Tensor  # [3] i32 cells per axis
    cell_size: float = 0.1

    def to(self, device) -> "GridIndex":
        return GridIndex(*(as_tensor(f, torch.device(device)) for f in self[:5]),
                         self.cell_size)


def _cell_coords(points: torch.Tensor, origin: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor((points - origin) / _scalar(cell_size, points)).to(torch.int32)


def _cell_id(coords: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = coords[..., 0], coords[..., 1], coords[..., 2]
    inb = ((cx >= 0) & (cx < dims[0]) & (cy >= 0) & (cy < dims[1])
           & (cz >= 0) & (cz < dims[2]))
    cid = (cx * dims[1] + cy) * dims[2] + cz
    return torch.where(inb, cid, INT32_MAX)


def build_grid(points, cell_size: float, mask=None, device=None) -> GridIndex:
    """The sorted-grid index: points sorted by voxel cell id (stable), dead
    rows last. ``device``: where to build it (default: that of a tensor
    ``points``, else the card)."""
    dev = input_device(points, device)
    points = as_tensor(points, dev, torch.float32)
    n = points.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
            else as_tensor(mask, dev, torch.bool))
    finite = torch.isfinite(points).all(dim=-1) & mask
    safe = torch.where(finite[:, None], points, 0.0)
    lo = torch.where(finite[:, None], safe, float("inf")).amin(0)
    hi = torch.where(finite[:, None], safe, float("-inf")).amax(0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    cs = _scalar(cell_size, points)
    origin = lo - cs
    dims = torch.clamp(((hi - origin) / cs).to(torch.int32) + 2, min=1)
    cid = torch.where(finite, _cell_id(_cell_coords(safe, origin, cell_size), dims), INT32_MAX)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    live = cid_s < INT32_MAX
    pts_s = torch.where(live[:, None], points[order], float("inf"))
    idx_s = torch.where(live, order.to(torch.int32), -1)
    return GridIndex(pts_s, idx_s, cid_s, origin, dims, float(cell_size))


def max_cell_occupancy(index: GridIndex) -> torch.Tensor:
    """Largest number of points in any occupied cell (to validate
    ``cell_cap``), a 0-d int32 tensor."""
    sc = index.sorted_cell
    new = torch.ones_like(sc, dtype=torch.bool)
    new[1:] = sc[1:] != sc[:-1]
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    counts = torch.zeros(sc.shape[0], dtype=torch.int32, device=sc.device)
    counts.index_add_(0, seg, (sc < INT32_MAX).to(torch.int32))
    return counts.max()


def recommend_cell_cap(index: GridIndex) -> int:
    """Host helper: the next power of two ≥ the largest occupancy, at
    least 8."""
    occ = int(max_cell_occupancy(index))
    cap = 8
    while cap < occ:
        cap *= 2
    return cap


def _grid_candidates(index: GridIndex, q: torch.Tensor, cell_cap: int):
    """Candidate rows of [QT, 3] queries: the 27 neighbour cells in
    ``_NBR_OFFSETS`` order, the first ``cell_cap`` rows of each. Returns
    (points [QT, 27·cap, 3], original ids [QT, 27·cap], -1 where empty)."""
    n = index.sorted_points.shape[0]
    qf = torch.where(torch.isfinite(q), q, 0.0)
    coords = _cell_coords(qf, index.origin, index.cell_size)
    offs27 = torch.as_tensor(_NBR_OFFSETS, device=q.device)
    cids = _cell_id(coords[:, None, :] + offs27[None], index.dims)  # [QT, 27]
    starts = torch.searchsorted(index.sorted_cell, cids, side="left")
    ends = torch.searchsorted(index.sorted_cell, cids, side="right")
    gather = starts[..., None] + torch.arange(cell_cap, device=q.device)
    valid = ((gather < ends[..., None]) & (cids[..., None] < INT32_MAX)).reshape(q.shape[0], -1)
    gather = gather.clamp(0, n - 1).reshape(q.shape[0], -1)
    return index.sorted_points[gather], torch.where(valid, index.sorted_idx[gather], -1)


def _grid_query(index: GridIndex, queries, radius: float, k: int, query_mask, cell_cap: int,
                query_tile: int, device, sorted_: bool):
    if radius > index.cell_size + 1e-9:
        raise ValueError(f"radius {radius} exceeds cell_size {index.cell_size}")
    dev = input_device(queries, device)
    index = index.to(dev)
    queries = as_tensor(queries, dev, torch.float32)
    nq = queries.shape[0]
    query_mask = (torch.ones(nq, dtype=torch.bool, device=dev) if query_mask is None
                  else as_tensor(query_mask, dev, torch.bool))
    q_all = torch.where(query_mask[:, None], queries, float("inf"))
    out_d = torch.full((nq, k), float("inf"), device=dev)
    out_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    r2 = radius * radius
    # rows a tile: the JAX package's tile, grown while the [rows, 27·cap]
    # float64 distance temporaries stay small (results are per row)
    tile = max(query_tile, (_TILE_ELEMS >> 3) // (27 * cell_cap))
    cols = torch.arange(27 * cell_cap, device=dev)
    for s in range(0, nq, tile):
        e = min(nq, s + tile)
        q = q_all[s:e]
        cand_p, cand_i = _grid_candidates(index, q, cell_cap)
        d2 = _sq3(cand_p - q[:, None, :])
        ok = (cand_i >= 0) & (d2 <= r2)
        if sorted_:
            d2 = torch.where(ok, d2, float("inf"))
            col = smallest_k(d2[None], k, query_mask[None, s:e])[0]
            best = torch.gather(d2, 1, col)
            out_i[s:e] = torch.where(torch.isfinite(best), torch.gather(cand_i, 1, col), -1)
            out_d[s:e] = _sqrt(torch.clamp(best, min=0.0))
        else:
            out_i[s:e] = _first_k(ok, cand_i, k)
            pos = _first_k(ok, cols, k)
            d_sel = torch.gather(d2, 1, pos.clamp(min=0).long())
            out_d[s:e] = torch.where(pos >= 0, _sqrt(torch.clamp(d_sel, min=0.0)), float("inf"))
    out_d = torch.where(query_mask[:, None], out_d, float("inf"))
    out_i = torch.where(query_mask[:, None], out_i, -1)
    return out_d, out_i


def grid_radius_knn(index: GridIndex, queries, radius: float, k: int, query_mask=None,
                    cell_cap: int = 64, query_tile: int = 1024, device=None):
    """k nearest within ``radius`` through the grid index, ascending, equal
    distances in candidate-slot order; ``(inf, -1)`` padded. Exact when
    every cell holds ≤ ``cell_cap`` points (see ``max_cell_occupancy``);
    ``radius`` must be ≤ ``index.cell_size``. Runs on ``device`` (default:
    that of a tensor ``queries``, else the card), the index moved there."""
    return _grid_query(index, queries, radius, k, query_mask, cell_cap, query_tile, device,
                       sorted_=True)


def grid_radius_any_k(index: GridIndex, queries, radius: float, k: int, query_mask=None,
                      cell_cap: int = 64, query_tile: int = 1024, device=None):
    """Up to k points within ``radius`` a query, unsorted: the first k
    in-radius candidates in slot order (the radius-graph primitive)."""
    return _grid_query(index, queries, radius, k, query_mask, cell_cap, query_tile, device,
                       sorted_=False)


def _first_k(ok: torch.Tensor, cand: torch.Tensor, k: int) -> torch.Tensor:
    """First k ``cand`` entries where ``ok`` along the last axis (in
    order), -1 padded — one scatter by running position."""
    pos = torch.cumsum(ok.to(torch.int32), dim=-1) - 1
    slot = torch.where(ok & (pos < k), pos, k).long()
    out = torch.full(ok.shape[:-1] + (k + 1,), -1, dtype=torch.int32, device=ok.device)
    out.scatter_(-1, slot, cand.expand_as(ok).to(torch.int32))
    return out[..., :k]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b of float32 [..., 3] rows (broadcast) as XLA's CPU dot computes a
    three-term contraction: ``fma(a2, b2, fma(a1, b1, a0·b0))``, emulated
    in float64 elementwise, so the card gives the CPU's bits."""
    a64, b64 = a.double(), b.double()
    s = (a64[..., 0] * b64[..., 0]).float().double()
    s = (a64[..., 1] * b64[..., 1] + s).float().double()
    return (a64[..., 2] * b64[..., 2] + s).float()


def _buckets(index: GridIndex):
    """Occupied cells of the index: (cell ids [NC], first sorted row [NC],
    rows [NC], the 27 neighbour buckets' first rows and row counts
    [NC, 27], 0 where a neighbour cell is empty or outside)."""
    sc = index.sorted_cell
    dev = sc.device
    live = sc < INT32_MAX
    first = torch.ones_like(live)
    first[1:] = sc[1:] != sc[:-1]
    first &= live
    starts = torch.nonzero(first).flatten()  # [NC] ascending
    counts = torch.diff(torch.cat([starts, live.sum().reshape(1)]))
    cell_ids = sc[starts]
    dims = index.dims
    coords = torch.stack([cell_ids // (dims[1] * dims[2]), (cell_ids // dims[2]) % dims[1],
                          cell_ids % dims[2]], 1)
    nbr_cid = _cell_id(coords[:, None, :] + torch.as_tensor(_NBR_OFFSETS, device=dev)[None],
                       dims)  # [NC, 27]
    pos = torch.clamp(torch.searchsorted(cell_ids, nbr_cid), max=max(len(starts) - 1, 0))
    found = (nbr_cid < INT32_MAX) & (cell_ids[pos] == nbr_cid)
    return (cell_ids, starts, counts, torch.where(found, starts[pos], 0),
            torch.where(found, counts[pos], 0))


def _cell_blocked_query(index: GridIndex, radius: float, k: int, cap: int):
    """Self radius-kNN of all indexed points, sorted (the JAX package's
    cell-blocked query): a cell's first ``cap`` rows query its 27
    neighbour buckets' first ``cap`` rows with the expanded distance
    ``q² + c² − 2·q·c``; overflow rows get ``(inf, -1)``. Results in the
    original row order."""
    sp, sidx = index.sorted_points, index.sorted_idx
    n = sp.shape[0]
    dev = sp.device
    out_d = torch.full((n, k), float("inf"), device=dev)
    out_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    _, starts, counts, c_start, c_count = _buckets(index)
    n_cells = starts.shape[0]
    offs = torch.arange(cap, device=dev)
    r2 = radius * radius
    # cells a tile: [ct, cap, 27·cap] float64 temporaries within _TILE_ELEMS / 4
    ct = max(1, min(_CELL_TILE * 16, (_TILE_ELEMS >> 2) // (27 * cap * cap)))
    for s in range(0, n_cells, ct):
        e = min(n_cells, s + ct)
        q_idx = torch.clamp(starts[s:e, None] + offs, max=n - 1)
        q_valid = offs < counts[s:e, None]
        q = sp[q_idx]  # [ct, cap, 3]
        c_idx = torch.clamp(c_start[s:e, :, None] + offs, max=n - 1).reshape(e - s, -1)
        c_valid = (offs < c_count[s:e, :, None]).reshape(e - s, 1, -1)
        cp = sp[c_idx]  # [ct, 27·cap, 3]
        cross = _dot3(q[:, :, None, :], cp[:, None, :, :])
        d2 = (_sq3(q)[:, :, None] + _sq3(cp)[:, None, :]) - 2.0 * cross
        d2 = torch.where(c_valid & (d2 <= r2), d2, float("inf"))
        col = smallest_k(d2, k, q_valid)
        best = torch.gather(d2, 2, col)
        ids = sidx[torch.gather(c_idx[:, None, :].expand(-1, cap, -1), 2, col)]
        rows = torch.where(q_valid, sidx[q_idx], -1).reshape(-1)
        good = rows >= 0
        out_i[rows[good].long()] = torch.where(torch.isfinite(best), ids, -1).reshape(-1, k)[good]
        out_d[rows[good].long()] = _sqrt(torch.clamp(best, min=0.0)).reshape(-1, k)[good]
    return out_d, out_i


def _bucket_rows_any_k(index: GridIndex, radius: float, k: int, cap: int, need_dists: bool):
    """Self radius-any-k (the JAX package's bucket-row query): up to k
    in-radius neighbours a row in first-in-cell order (the 27 neighbour
    cells in offset order, rows in sorted-grid order within a cell), from
    the difference form ``Σ (q − c)²``. Results in the original row
    order."""
    sp, sidx = index.sorted_points, index.sorted_idx
    n = sp.shape[0]
    dev = sp.device
    out_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((n, k), float("inf"), device=dev)
    _, starts, counts, c_start, c_count = _buckets(index)
    n_cells = starts.shape[0]
    offs = torch.arange(cap, device=dev)
    r2 = radius * radius
    cols = torch.arange(27 * cap, device=dev)
    # cells a tile: [ct, cap, 27·cap] distances (float64 inside _sq3) within
    # _TILE_ELEMS elements
    ct = max(1, min(_CELL_TILE, _TILE_ELEMS // (27 * cap * cap)))
    for s in range(0, n_cells, ct):
        e = min(n_cells, s + ct)
        q_idx = torch.clamp(starts[s:e, None] + offs, max=n - 1)
        q_valid = offs < counts[s:e, None]
        c_idx = torch.clamp(c_start[s:e, :, None] + offs, max=n - 1).reshape(e - s, -1)
        c_valid = (offs < c_count[s:e, :, None]).reshape(e - s, -1)
        qf = torch.where(q_valid[..., None], sp[q_idx], 0.0)
        cf = torch.where(c_valid[..., None], sp[c_idx], 1e9)
        d2 = _sq3(qf[:, :, None, :] - cf[:, None, :, :])  # [ct, cap, 27·cap]
        ok = c_valid[:, None, :] & (d2 <= r2) & q_valid[:, :, None]
        sel = _first_k(ok, torch.where(c_valid, sidx[c_idx], -1)[:, None, :], k)
        rows = torch.where(q_valid, sidx[q_idx], -1).reshape(-1)
        good = rows >= 0
        out_i[rows[good].long()] = sel.reshape(-1, k)[good]
        if need_dists:  # the selected candidates' columns pick their d²
            pos = _first_k(ok, cols, k)
            d_sel = torch.gather(d2, -1, pos.clamp(min=0).long())
            out_d[rows[good].long()] = torch.where(
                pos >= 0, _sqrt(torch.clamp(d_sel, min=0.0)), float("inf")).reshape(-1, k)[good]
    if not need_dists:
        out_d = torch.where(out_i >= 0, 0.0, float("inf"))
    return out_d, out_i


def grid_self_radius_knn(points, radius: float, k: int, mask=None, cell_tile: int = 256,
                         max_bucket: int = _MAX_BUCKET, sort: bool = True,
                         need_dists: bool = True, device=None):
    """Self radius-kNN over a full cloud (self included, distance ~0):
    ``sort=True`` the k nearest within ``radius``, ascending, equal
    distances in candidate-slot order; ``sort=False`` up to k in-radius
    neighbours in first-in-cell order. ``(inf, -1)`` padded; with
    ``need_dists=False`` (unsorted only) distances are 0 on hits.

    Exact when per-cell occupancy ≤ ``max_bucket``: voxel-downsample at
    ``radius/2`` first (occupancy ≤ 8); a denser cell's overflow rows
    neither query nor serve, and a warning is logged. ``cell_tile`` is the
    JAX package's tiling argument: the port tiles by memory instead. Runs
    on ``device`` (default: that of a tensor ``points``, else the card)."""
    del cell_tile
    index = build_grid(points, radius, mask, device=device)
    n = index.sorted_points.shape[0]
    dev = index.sorted_points.device
    occ = int(max_cell_occupancy(index)) if n else 0
    # tight cap (multiple of 4): padding waste scales the whole query
    cap = min(max(4, -4 * (-occ // 4)), max_bucket)
    if occ > cap:
        logging.getLogger("pyqsm_tpu_torch.calc").warning(
            "grid_self_radius_knn: cell occupancy %d exceeds bucket %d — "
            "overflow points dropped; pre-voxelize at radius/2 for exactness", occ, cap)
    if not bool((index.sorted_cell < INT32_MAX).any()):
        return (torch.full((n, k), float("inf"), device=dev),
                torch.full((n, k), -1, dtype=torch.int32, device=dev))
    if sort:
        return _cell_blocked_query(index, radius, k, cap)
    return _bucket_rows_any_k(index, radius, k, cap, need_dists)
