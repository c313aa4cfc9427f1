"""Radius-graph structural features: leaf/branch separation and density
masks (counterpart of ``pyqsm_tpu/models/graph_features.py``).

- ``leaf_mask_by_degree``: the degree-percentile split of the radius pair
  graph (low degree = branch, high degree = leaf clumps);
- ``exclude_dense_areas``: drop the largest connected components of the
  high-degree subgraph;
- ``leaf_mask_by_order_diff``: points claimed by region growing much later
  than their neighbourhood are leaves.
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.cluster import connected_components, top_clusters
from pyqsm_tpu_torch.ops.geometry import masked_percentile
from pyqsm_tpu_torch.ops.neighbors import radius_count, radius_knn


def leaf_mask_by_degree(points: torch.Tensor, mask: torch.Tensor, radius: float = 0.2,
                        degree_pctile: float = 50.0):
    """(leaf_mask, degree): live points split at the degree percentile of
    the radius pair graph (self excluded) — low degree = branch, high =
    leaf."""
    deg = radius_count(points, points, radius=radius, query_mask=mask, point_mask=mask) - 1
    # the percentile is an argument of the JAX package's jitted call
    thresh = masked_percentile(deg.to(torch.float32), mask, degree_pctile)
    return mask & (deg.to(torch.float32) > thresh), deg


def exclude_dense_areas(points: torch.Tensor, mask: torch.Tensor, radius: float = 0.2,
                        degree_pctile: float = 75.0, top_components: int = 4,
                        neighbor_cap: int = 16) -> torch.Tensor:
    """``mask`` without the ``top_components`` largest connected components
    of the high-degree subgraph (the foliage exclusion before the walk)."""
    dense, _ = leaf_mask_by_degree(points, mask, radius, degree_pctile)
    _, idx = radius_knn(points, points, radius=radius, k=neighbor_cap,
                        query_mask=dense, point_mask=dense)
    labels = connected_components(idx, idx >= 0, dense)
    big = top_clusters(labels, top_components)
    drop = torch.zeros_like(mask)
    for i in range(top_components):
        drop = drop | (labels == big[i]) & (big[i] >= 0)
    return mask & ~drop


def _nanmedian_rows(values: torch.Tensor) -> torch.Tensor:
    """Median of each row ignoring NaN, as ``jnp.nanmedian`` takes it: the
    mean of the two middle finite values of an even count (torch's
    ``nanmedian`` takes the lower one); NaN for a row without any."""
    s, _ = torch.sort(values, dim=1)  # NaN sorts last
    cnt = (~torch.isnan(values)).sum(dim=1, keepdim=True)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, max=values.shape[1] - 1)
    med = (torch.gather(s, 1, lo) * 0.5 + torch.gather(s, 1, hi) * 0.5)[:, 0]
    return torch.where(cnt[:, 0] > 0, med, float("nan"))


def leaf_mask_by_order_diff(points: torch.Tensor, order: torch.Tensor, mask: torch.Tensor,
                            radius: float = 0.2, k: int = 16,
                            diff_threshold: float = 3.0) -> torch.Tensor:
    """Points claimed more than ``diff_threshold`` growth cycles after the
    median of their radius neighbours (``order``: the cycle of
    ``GrowthResult.order``, -1 unclaimed) are leaves."""
    _, idx = radius_knn(points, points, radius=radius, k=k, query_mask=mask, point_mask=mask)
    valid = idx >= 0
    nbr_order = torch.where(valid, order[torch.clamp(idx, min=0).long()].to(torch.float32),
                            float("nan"))
    diff = order.to(torch.float32) - _nanmedian_rows(nbr_order)
    return mask & (order >= 0) & (diff > diff_threshold)
