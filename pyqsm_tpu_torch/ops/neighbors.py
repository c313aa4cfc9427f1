"""Neighbor engine, main-path subset (counterparts of
``pyqsm_tpu/ops/neighbors.py:125-290, 972-1039``).

- ``knn``: exact brute force over the ``|q|² + |p|² − 2·q·pᵀ`` expansion,
  tiled over queries; equal distances rank by ascending index exactly as
  ``lax.top_k`` ranks them, on every device. The JAX package's
  ``approx=True`` lowers to this exact query on the CPU.
- ``radius_knn``/``radius_count``: the same distance tiles, thresholded.
- ``grid_self_radius_knn``: the sorted-grid bucket-row any-k query; the
  first k in-radius candidates in (27-cell offset, in-cell row) order.

All distance products are float32 without TF32.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

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
        point_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of [..., Q, 3] queries among [..., N, 3] points (one
    optional leading batch axis). Returns ``(dists [.., Q, k] f32, idx
    [.., Q, k] i32)`` sorted ascending, ``(inf, -1)`` padded; equal
    distances rank by ascending index. Self-matches are kept (ask for k+1
    and drop column 0). The JAX package's ``approx=True`` is exact on the
    CPU, so the port has only the exact query."""
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
                 point_mask: torch.Tensor | None = None,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Number (i32) of live points within ``radius`` of each query, or with
    ``weights`` [N] the f32 sum of their weights."""
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
# Sorted voxel grid, bucket-row any-k self query
# ---------------------------------------------------------------------------

_MAX_BUCKET = 64  # per-cell occupancy the grid query serves exactly
_CELL_TILE = 4096  # occupied cells per query tile, at most
_NBR_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


def _cell_id(coords: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = coords[..., 0], coords[..., 1], coords[..., 2]
    inb = ((cx >= 0) & (cx < dims[0]) & (cy >= 0) & (cy < dims[1])
           & (cz >= 0) & (cz < dims[2]))
    cid = (cx * dims[1] + cy) * dims[2] + cz
    return torch.where(inb, cid, INT32_MAX)


def build_grid(points: torch.Tensor, cell_size: float, mask: torch.Tensor):
    """Points sorted by voxel cell id (stable): ``(sorted_points,
    sorted_idx, sorted_cell, origin, dims)``; dead rows sort last."""
    finite = torch.isfinite(points).all(dim=-1) & mask
    safe = torch.where(finite[:, None], points, 0.0)
    lo = torch.where(finite[:, None], safe, float("inf")).amin(0)
    hi = torch.where(finite[:, None], safe, float("-inf")).amax(0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    cs = _scalar(cell_size, points)
    origin = lo - cs
    dims = torch.clamp(((hi - origin) / cs).to(torch.int32) + 2, min=1)
    coords = torch.floor((safe - origin[None, :]) / cs).to(torch.int32)
    cid = torch.where(finite, _cell_id(coords, dims), INT32_MAX)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    live = cid_s < INT32_MAX
    pts_s = torch.where(live[:, None], points[order], float("inf"))
    idx_s = torch.where(live, order.to(torch.int32), -1)
    return pts_s, idx_s, cid_s, origin, dims


def _first_k(ok: torch.Tensor, cand: torch.Tensor, k: int) -> torch.Tensor:
    """First k ``cand`` entries where ``ok`` along the last axis (in
    order), -1 padded — one scatter by running position."""
    pos = torch.cumsum(ok.to(torch.int32), dim=-1) - 1
    slot = torch.where(ok & (pos < k), pos, k).long()
    out = torch.full(ok.shape[:-1] + (k + 1,), -1, dtype=torch.int32, device=ok.device)
    out.scatter_(-1, slot, cand.expand_as(ok).to(torch.int32))
    return out[..., :k]


def grid_self_radius_knn(points: torch.Tensor, radius: float, k: int,
                         mask: torch.Tensor | None = None, *, max_bucket: int = _MAX_BUCKET,
                         sort: bool = True, need_dists: bool = True):
    """Self radius-any-k over a full cloud: up to k in-radius neighbors of
    each point (self included) in first-in-cell order (the 27 neighbour
    cells in offset order, rows in sorted-grid order within a cell), -1
    padded. Exact when per-cell occupancy ≤ ``max_bucket`` (voxel-downsample
    at ``radius/2`` first: occupancy ≤ 8); a denser cell's overflow rows
    neither query nor serve, and a warning is logged. Distances are the
    rounded roots of the same squared distances the JAX package selects
    on, inf on padding; with ``need_dists=False`` they are 0 on hits.
    Only the JAX package's ``sort=False`` form is ported: ``sort=True``
    (the ``GridIndex`` route) raises."""
    if sort:
        raise NotImplementedError(
            "grid_self_radius_knn(sort=True) needs the GridIndex route, which is "
            "not ported yet; pass sort=False")
    n = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    sp, sidx, sc, _, dims = build_grid(points, radius, mask)
    live = sc < INT32_MAX
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sc[1:] != sc[:-1]]) & live
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    n_cells = int(first.sum())
    starts = torch.nonzero(first).flatten()  # [NC] ascending
    counts = torch.diff(torch.cat([starts, live.sum().reshape(1)]))
    occ = int(counts.max()) if n_cells else 0
    cap = min(max(4, -4 * (-occ // 4)), max_bucket)
    if occ > cap:
        logging.getLogger("pyqsm_tpu_torch.calc").warning(
            "grid_self_radius_knn: cell occupancy %d exceeds bucket %d — "
            "overflow points dropped; pre-voxelize at radius/2 for exactness", occ, cap)
    out_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((n, k), float("inf"), device=dev)
    if n_cells == 0:
        return out_d, out_i
    # densified buckets: [NC + 1, cap] (last row = empty)
    within = torch.arange(n, device=dev) - starts[torch.clamp(seg, min=0)]
    row_ok = live & (within < cap)
    b_row = torch.where(row_ok, seg, n_cells)
    b_slot = torch.where(row_ok, within, 0)
    bucket_pts = torch.full((n_cells + 1, cap, 3), float("inf"), device=dev)
    bucket_idx = torch.full((n_cells + 1, cap), -1, dtype=torch.int32, device=dev)
    keep = b_row < n_cells
    bucket_pts[b_row[keep], b_slot[keep]] = sp[keep]
    bucket_idx[b_row[keep], b_slot[keep]] = sidx[keep]
    # neighbor cells of every occupied cell -> bucket position (-1 empty)
    cell_ids = sc[starts]
    cz = cell_ids % dims[2]
    cy = (cell_ids // dims[2]) % dims[1]
    cx = cell_ids // (dims[1] * dims[2])
    coords = torch.stack([cx, cy, cz], 1)
    offs = torch.as_tensor(_NBR_OFFSETS, device=dev)
    nbr_cid = _cell_id(coords[:, None, :] + offs[None], dims)  # [NC, 27]
    pos = torch.clamp(torch.searchsorted(cell_ids, nbr_cid), max=n_cells - 1)
    nbr_pos = torch.where((nbr_cid < INT32_MAX) & (cell_ids[pos] == nbr_cid), pos, n_cells)
    r2 = radius * radius
    # cells a tile: [ct, cap, 27·cap] distances (float64 inside _sq3) within
    # _TILE_ELEMS elements
    ct = max(1, min(_CELL_TILE, _TILE_ELEMS // (27 * cap * cap)))
    for s in range(0, n_cells, ct):
        e = min(n_cells, s + ct)
        npos = nbr_pos[s:e]  # [ct, 27]
        cand_p = bucket_pts[npos]  # [ct, 27, cap, 3]
        cand_i = bucket_idx[npos]  # [ct, 27, cap]
        q_p = bucket_pts[s:e]  # [ct, cap, 3]
        q_i = bucket_idx[s:e]
        qf = torch.where(torch.isfinite(q_p), q_p, 0.0)
        cf = torch.where(torch.isfinite(cand_p), cand_p, 1e9)
        diff = qf[:, :, None, None, :] - cf[:, None, :, :, :]
        d2 = _sq3(diff).reshape(e - s, cap, 27 * cap)
        ok = ((cand_i >= 0).reshape(e - s, 1, -1) & (d2 <= r2) & (q_i >= 0)[:, :, None])
        sel = _first_k(ok, cand_i.reshape(e - s, 1, -1), k)  # [ct, cap, k]
        rows = q_i.reshape(-1)
        good = rows >= 0
        out_i[rows[good].long()] = sel.reshape(-1, k)[good]
        if need_dists:  # the selected candidates' columns pick their d²
            pos = _first_k(ok, torch.arange(27 * cap, device=dev), k)
            d_sel = torch.gather(d2, -1, pos.clamp(min=0).long())
            out_d[rows[good].long()] = torch.where(
                pos >= 0, _sqrt(torch.clamp(d_sel, min=0.0)), float("inf")).reshape(-1, k)[good]
    if not need_dists:
        out_d = torch.where(out_i >= 0, 0.0, float("inf"))
    return out_d, out_i
