"""Downsampling and compaction (counterparts of
``pyqsm_tpu/ops/sampling.py:26-272``).

Sorts that decide an order are stable (``jnp.argsort``/``lexsort`` are), so
voxel traces, compaction order and label segments equal the JAX package's.
Float segment sums go through ``ops/segment.segment_sum``: index order on
the CPU, the same bits on every run on CUDA.
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.segment import segment_sum

INT32_MAX = 2 ** 31 - 1


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 1-element f32 tensor on ``like``'s device: dividing by it is a true
    division on CUDA, where a Python-float divisor becomes a multiply by its
    reciprocal (other rounding than the JAX package's ``x / v``)."""
    return torch.full((1,), float(v), dtype=torch.float32, device=like.device)


def lexsort_rows(coords: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order of [..., N, 3] int rows, x primary —
    ``jnp.lexsort((c[:, 2], c[:, 1], c[:, 0]))`` along the last row axis."""
    order = torch.argsort(coords[..., 2], dim=-1, stable=True)
    for c in (1, 0):
        key = torch.gather(coords[..., c], -1, order)
        order = torch.gather(order, -1, torch.argsort(key, dim=-1, stable=True))
    return order


def _voxel_coords(points, voxel, mask):
    """finite mask, zero-filled points and int32 voxel coords (dead rows
    INT32_MAX) for [B, N, 3] points at per-batch voxel sizes [B]."""
    finite = mask & torch.isfinite(points).all(dim=-1)
    safe = torch.where(finite[..., None], points, 0.0)
    lo = torch.where(finite[..., None], safe, float("inf")).amin(dim=-2)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    coords = torch.floor((safe - lo[:, None, :]) / voxel[:, None, None]).to(torch.int32)
    coords = torch.where(finite[..., None], coords, INT32_MAX)
    return finite, safe, coords


def _new_segments(coords_s: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(coords_s[..., :1, 0], dtype=torch.bool)
    return torch.cat([first, (coords_s[..., 1:, :] != coords_s[..., :-1, :]).any(-1)], dim=-1)


def voxel_downsample_batch(points: torch.Tensor, voxel_sizes: torch.Tensor,
                           masks: torch.Tensor):
    """Voxel downsample of [B, N, 3] clouds at per-cloud voxel sizes [B].

    Returns ``(rep_points, rep_mask, trace)``: one representative row per
    occupied voxel (the lowest original row) carries the voxel centroid;
    ``trace[b, i]`` is point i's representative row (-1 for dead rows)."""
    b, n, _ = points.shape
    dev = points.device
    voxel = voxel_sizes.to(device=dev, dtype=torch.float32).reshape(b)
    finite, safe, coords = _voxel_coords(points, voxel, masks)
    order = lexsort_rows(coords)  # [B, N]
    coords_s = torch.gather(coords, 1, order[..., None].expand(-1, -1, 3))
    live_s = torch.gather(finite, 1, order)
    pts_s = torch.gather(safe, 1, order[..., None].expand(-1, -1, 3))
    new_seg = _new_segments(coords_s)
    seg = torch.cumsum(new_seg.to(torch.int64), dim=1) - 1
    gseg = (seg + torch.arange(b, device=dev)[:, None] * n).reshape(-1)
    # seg ascends: segments are numbered in sorted order
    seg_sum = segment_sum(torch.where(live_s[..., None], pts_s, 0.0), seg, n, sorted_index=True)
    seg_cnt = segment_sum(live_s.to(torch.float32), seg, n, sorted_index=True)
    centroid = (seg_sum / torch.clamp(seg_cnt, min=1.0)[..., None]).reshape(b * n, 3)
    first_orig = torch.full((b * n,), INT32_MAX, dtype=torch.int64, device=dev).scatter_reduce_(
        0, gseg, torch.where(live_s, order, INT32_MAX).reshape(-1), "amin")
    rep_row = first_orig[gseg].reshape(b, n)  # per sorted row
    trace = torch.full((b, n), -1, dtype=torch.int32, device=dev).scatter_(
        1, order, torch.where(live_s, rep_row, -1).to(torch.int32))
    first_in_seg = new_seg & live_s
    rows = torch.where(first_in_seg, rep_row, n)  # n = dropped
    rep_mask = torch.zeros(b, n + 1, dtype=torch.bool, device=dev).scatter_(
        1, rows, True)[:, :n]
    rep_points = torch.cat([points, torch.zeros_like(points[:, :1])], dim=1)
    cent = centroid.reshape(b, n, 3)
    rep_points = rep_points.scatter(1, rows[..., None].expand(-1, -1, 3),
                                    torch.gather(cent, 1, torch.where(first_in_seg, seg, 0)[..., None].expand(-1, -1, 3)))
    return rep_points[:, :n], rep_mask & finite, trace


def voxel_downsample(points: torch.Tensor, voxel_size, mask: torch.Tensor | None = None):
    """Single-cloud ``voxel_downsample_batch`` (``voxel_size`` a float)."""
    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    rp, rm, tr = voxel_downsample_batch(points[None], _scalar(voxel_size, points), mask[None])
    return rp[0], rm[0], tr[0]


def voxel_count_batch(points: torch.Tensor, voxel_sizes: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """Occupied-voxel count per cloud at per-cloud voxel sizes [B]."""
    b = points.shape[0]
    voxel = voxel_sizes.to(device=points.device, dtype=torch.float32).reshape(b)
    finite, _, coords = _voxel_coords(points, voxel, masks)
    order = lexsort_rows(coords)
    cs = torch.gather(coords, 1, order[..., None].expand(-1, -1, 3))
    live = torch.gather(finite, 1, order)
    return (_new_segments(cs) & live).sum(dim=1, dtype=torch.int32)


def compact_rows_batch(points: torch.Tensor, masks: torch.Tensor):
    """Per batch row, live entries moved to the front (stable)."""
    order = torch.argsort((~masks).to(torch.int8), dim=1, stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, points.shape[-1]))
    msk = torch.gather(masks, 1, order)
    return torch.where(msk[..., None], pts, 0.0), msk


def nonzero_rows(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Live row indices front-packed into a ``cap`` buffer (-1 padding),
    built without a host sync (cumsum positions + one scatter)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dst, torch.arange(n, dtype=torch.int32, device=mask.device))
    return out[:cap]


def label_segments(labels: torch.Tensor, u_cap: int):
    """``np.unique(labels[labels >= 0], return_counts=True)`` on the device:
    ``(order, slab, vals, counts, n_unique)`` with the stable sort order
    and sorted labels kept for :func:`rows_for_labels`."""
    order = torch.argsort(labels, stable=True)
    slab = labels[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=labels.device),
                       slab[1:] != slab[:-1]]) & (slab >= 0)
    starts = nonzero_rows(first, u_cap)
    vals = torch.where(starts >= 0, slab[torch.clamp(starts, min=0).long()], -1)
    ends = torch.searchsorted(slab, vals, right=True).to(torch.int32)
    begins = torch.searchsorted(slab, vals, right=False).to(torch.int32)
    counts = torch.where(starts >= 0, ends - begins, 0)
    return order.to(torch.int32), slab, vals, counts, first.sum(dtype=torch.int32)


def rows_for_labels(order: torch.Tensor, slab: torch.Tensor, kept: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """Row indices of each kept label as a ``[T, cap]`` buffer (-1 padded)."""
    n = order.shape[0]
    kept = kept.to(slab.dtype)
    starts = torch.searchsorted(slab, kept, right=False)
    counts = torch.searchsorted(slab, kept, right=True) - starts
    j = torch.arange(cap, device=slab.device)
    pos = torch.clamp(starts[:, None] + j[None, :], 0, n - 1)
    return torch.where(j[None, :] < counts[:, None], order[pos], -1)


def compact_rows(points: torch.Tensor, mask: torch.Tensor, *extra: torch.Tensor,
                 pad_multiple: int = 2048) -> tuple:
    """Live rows gathered into a fresh buffer padded to a multiple of
    ``pad_multiple``: ``(points', mask', rows, *extra')`` (``rows`` maps
    back to the input rows, -1 on padding). Syncs only the live count."""
    m = int(mask.sum())
    cap = max(pad_multiple, -pad_multiple * (-m // pad_multiple))
    rows = nonzero_rows(mask, cap)
    valid = rows >= 0
    safe = torch.clamp(rows, min=0).long()
    out_pts = torch.where(valid[:, None], points[safe], 0.0)
    outs = []
    for arr in extra:
        v = arr[safe]
        fill = -1 if v.dtype == torch.int32 else 0
        outs.append(torch.where(valid.reshape(-1, *([1] * (v.ndim - 1))), v, fill).to(v.dtype))
    return (out_pts, valid, rows, *outs)


def uniform_downsample(mask: torch.Tensor, every_k: int) -> torch.Tensor:
    """Keep every k-th live point in index order (Open3D's
    ``uniform_down_sample``). Returns the refined mask."""
    live_rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    return mask & (live_rank % every_k == 0)


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            mask: torch.Tensor | None = None, start: int = 0) -> torch.Tensor:
    """FPS: ``idx [n_samples]`` of selected rows, first = lowest live row at
    or after ``start``; ties go to the lowest row (``argmax`` semantics)."""
    n = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    safe = torch.where(mask[:, None], points, 0.0)
    live_idx = torch.where(mask, torch.arange(n, device=dev), n)
    first = torch.where(live_idx >= start, live_idx, n).min()
    first = torch.where(first >= n, mask.to(torch.int8).argmax(), first)
    min_d2 = torch.where(mask, float("inf"), float("-inf"))
    picks = torch.empty(n_samples, dtype=torch.int64, device=dev)
    last = first
    for s in range(n_samples):
        picks[s] = last
        diff = safe - safe[last]
        d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
        min_d2 = torch.minimum(min_d2, torch.where(mask, d2, float("-inf")))
        last = min_d2.argmax()
    return picks.to(torch.int32)
