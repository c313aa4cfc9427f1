"""Statistical outlier removal (Open3D ``remove_statistical_outlier``
semantics) and the reference's iterated clean policy (counterpart of
``pyqsm_tpu/ops/outliers.py``)."""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.device import as_tensor, input_device
from pyqsm_tpu_torch.ops.neighbors import knn
from pyqsm_tpu_torch.ops.sampling import voxel_downsample


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


def clean_cloud(points, mask, voxel_size: float = 0.04, neighbors: int = 2,
                ratio: float = 4.0, iters: int = 3, device=None):
    """Reference clean policy: voxel downsample, then ``iters`` rounds of
    outlier removal (neighbours doubled, ratio divided by 1.5 each round).
    Returns ``(points, mask, trace)``: trace maps original rows to their
    voxel representative (-1 if dead), or is the live rows' own index when
    ``voxel_size`` is 0. Runs on ``device`` (default: that of a tensor
    ``points``, else the card)."""
    dev = input_device(points, device)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    if voxel_size and voxel_size > 0:
        points, mask, trace = voxel_downsample(points, voxel_size, mask)
    else:
        trace = torch.where(mask, torch.arange(points.shape[0], dtype=torch.int32,
                                               device=dev), -1)
    nb, rt = neighbors, ratio
    for _ in range(iters):
        nb = int(nb * 2)
        rt = rt / 1.5
        mask = statistical_outlier_mask(points, mask, nb_neighbors=nb, std_ratio=rt)
    return points, mask, trace
