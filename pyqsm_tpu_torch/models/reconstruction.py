"""Detail recovery and voxel-grid correspondence (counterpart of
``pyqsm_tpu/models/reconstruction.py``): the full-resolution cloud stays on
the device, so recovering the points behind a coarse selection is one
gather through the voxel trace (``recover_by_trace``) or a radius-bounded
kNN transfer (``recover_details``, ``transfer_attributes``); voxel-grid
occupancy is hashed-voxel set membership (a sort and a binary search).
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.neighbors import radius_knn
from pyqsm_tpu_torch.ops.sampling import _scalar

_INT32_MAX = 2 ** 31 - 1


def recover_by_trace(coarse_selection: torch.Tensor, trace: torch.Tensor,
                     full_mask: torch.Tensor) -> torch.Tensor:
    """Full-resolution mask of the points whose voxel representative is in
    the coarse selection (``trace`` from ``voxel_downsample``)."""
    return full_mask & (trace >= 0) & coarse_selection[torch.clamp(trace, min=0).long()]


def recover_details(coarse_points: torch.Tensor, coarse_selection: torch.Tensor,
                    full_points: torch.Tensor, full_mask: torch.Tensor, radius: float = 0.05,
                    k: int = 8) -> torch.Tensor:
    """A full point is recovered when one of its k nearest selected coarse
    points lies within ``radius``."""
    _, idx = radius_knn(full_points, coarse_points, radius=radius, k=k,
                        query_mask=full_mask, point_mask=coarse_selection)
    return full_mask & (idx >= 0).any(dim=1)


def _voxel_keys(points: torch.Tensor, origin: torch.Tensor, voxel: float) -> torch.Tensor:
    """int32 hash of each point's voxel: the products wrap in int32 on
    purpose, as the JAX package's do (collisions only matter across ~2000
    cells an axis)."""
    c = torch.floor((points - origin[None, :]) / _scalar(voxel, points)).to(torch.int32)
    return ((c[:, 0] * 73856093) ^ (c[:, 1] * 19349663) ^ (c[:, 2] * 83492791)).to(torch.int32)


def voxel_overlap_mask(query_points: torch.Tensor, query_mask: torch.Tensor,
                       occupied_points: torch.Tensor, occupied_mask: torch.Tensor,
                       voxel: float = 0.2) -> torch.Tensor:
    """Which query points fall in voxels occupied by the other cloud (the
    grid's origin is the occupied cloud's lower corner)."""
    finite = occupied_mask & torch.isfinite(occupied_points).all(dim=-1)
    safe = torch.where(finite[:, None], occupied_points, 0.0)
    lo = torch.where(finite[:, None], safe, float("inf")).amin(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    occ_keys = torch.where(finite, _voxel_keys(safe, lo, voxel), _INT32_MAX)
    occ_sorted = torch.sort(occ_keys).values
    qk = _voxel_keys(torch.where(query_mask[:, None], query_points, 0.0), lo, voxel)
    pos = torch.searchsorted(occ_sorted, qk)  # left side
    found = occ_sorted[torch.clamp(pos, 0, occ_sorted.shape[0] - 1)] == qk
    return query_mask & found


def transfer_attributes(src_points: torch.Tensor, src_values: torch.Tensor,
                        src_mask: torch.Tensor, dst_points: torch.Tensor,
                        dst_mask: torch.Tensor, radius: float = 0.05, k: int = 1):
    """Nearest-neighbour attribute transfer within ``radius`` (1-D or 2-D
    values). Returns ``(values, matched_mask)``; unmatched rows are 0."""
    _, idx = radius_knn(dst_points, src_points, radius=radius, k=k,
                        query_mask=dst_mask, point_mask=src_mask)
    matched = idx[:, 0] >= 0
    vals = src_values[torch.clamp(idx[:, 0], min=0).long()]
    keep = matched if src_values.dim() == 1 else matched[:, None]
    return torch.where(keep, vals, torch.zeros((), dtype=vals.dtype, device=vals.device)), \
        dst_mask & matched
