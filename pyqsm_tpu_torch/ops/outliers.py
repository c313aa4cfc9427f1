"""Statistical outlier removal (Open3D ``remove_statistical_outlier``
semantics; counterpart of ``pyqsm_tpu/ops/outliers.py``)."""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.neighbors import knn


def statistical_outlier_mask(points: torch.Tensor, mask: torch.Tensor,
                             nb_neighbors: int = 20, std_ratio: float = 2.0) -> torch.Tensor:
    """Refined mask: drop live points whose mean kNN distance exceeds
    ``mean + std_ratio * std`` over the live points."""
    d, _ = knn(points, points, nb_neighbors + 1, query_mask=mask, point_mask=mask)
    d = d[:, 1:]
    finite = torch.isfinite(d)
    nfin = finite.sum(dim=1)
    mean_d = torch.where(finite, d, 0.0).sum(dim=1) / torch.clamp(nfin, min=1)
    live = mask & (nfin > 0)
    n_live = torch.clamp(live.sum(), min=1)
    mu = torch.where(live, mean_d, 0.0).sum() / n_live
    var = torch.where(live, (mean_d - mu) ** 2, 0.0).sum() / n_live
    thresh = mu + std_ratio * torch.sqrt(var)
    return mask & torch.where(live, mean_d <= thresh, False)
