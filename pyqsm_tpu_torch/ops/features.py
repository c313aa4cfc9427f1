"""Per-point geometric eigenfeatures and kNN feature smoothing
(counterpart of ``pyqsm_tpu/ops/features.py``): neighbourhood covariance →
closed-form 3×3 eigendecomposition → the Weinmann eigenfeature set, and
gather-mean smoothing and nearest-neighbour expansion of a per-point value.
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.linalg3 import sym_eig3
from pyqsm_tpu_torch.ops.neighbors import _fma, knn

FEATURE_NAMES = (
    "verticality",
    "linearity",
    "planarity",
    "surface_variation",
    "anisotropy",
    "sphericity",
    "PCA1",
    "PCA2",
    "omnivariance",
    "eigenentropy",
    "eigenvalue_sum",
)


def compute_features(points: torch.Tensor, mask: torch.Tensor, k: int = 25) -> dict:
    """All eigenfeatures in one pass: name → [N] f32, 0 on dead rows and on
    rows with fewer than 3 live neighbours. The cube root and the
    logarithms are taken in float64."""
    _, idx = knn(points, points, k + 1, query_mask=mask, point_mask=mask)
    nbr_idx = idx[:, 1:]
    valid = nbr_idx >= 0
    pts = torch.where(mask[:, None], points, 0.0)
    nbrs = pts[torch.clamp(nbr_idx, min=0).long()]  # [N, k, 3]
    w = valid[..., None].to(points.dtype)
    n_valid = valid.sum(dim=1)
    cnt = torch.clamp(n_valid, min=1).to(points.dtype)[:, None]
    # XLA's CPU code sums over the neighbours in order, in float32, the
    # covariance's products fused into the running sum
    s = torch.zeros_like(nbrs[:, 0])
    for j in range(nbrs.shape[1]):
        s = s + nbrs[:, j] * w[:, j]
    mean = s / cnt
    centered = (nbrs - mean[:, None, :]) * w
    acc = torch.zeros(nbrs.shape[0], 3, 3, dtype=points.dtype, device=points.device)
    for j in range(nbrs.shape[1]):
        acc = _fma(centered[:, j, :, None], centered[:, j, None, :], acc)
    cov = acc / cnt[..., None]
    vals, vecs = sym_eig3(cov)
    # ascending → λ1 ≥ λ2 ≥ λ3 ≥ 0
    l1 = torch.clamp(vals[:, 2], min=1e-20)
    l2 = torch.clamp(vals[:, 1], min=0.0)
    l3 = torch.clamp(vals[:, 0], min=0.0)
    lsum = l1 + l2 + l3
    s = torch.clamp(lsum, min=1e-20)
    e1, e2, e3 = l1 / s, l2 / s, l3 / s
    normal = vecs[..., 0]  # smallest eigenvector

    def ent(e):
        return e.double() * torch.log(torch.clamp(e, min=1e-20).double())

    feats = {
        "verticality": 1.0 - normal[:, 2].abs(),
        "linearity": (l1 - l2) / l1,
        "planarity": (l2 - l3) / l1,
        "surface_variation": l3 / s,
        "anisotropy": (l1 - l3) / l1,
        "sphericity": l3 / l1,
        "PCA1": e1,
        "PCA2": e2,
        "omnivariance": torch.clamp(l1 * l2 * l3, min=0.0).double().pow(1.0 / 3.0).float(),
        "eigenentropy": (-(ent(e1) + ent(e2) + ent(e3))).float(),
        "eigenvalue_sum": lsum,
    }
    live = mask & (n_valid >= 3)
    return {name: torch.where(live, v, 0.0) for name, v in feats.items()}


def replace_nan_features(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """NaN → live-mean backfill; 0 on dead rows."""
    finite = torch.isfinite(values)
    ok = mask & finite
    mean = (torch.where(ok, values, 0.0).double().sum().float()
            / torch.clamp(ok.sum(), min=1).to(values.dtype))
    return torch.where(mask, torch.where(finite, values, mean), 0.0)


def _gather_mean(values: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    valid = idx >= 0
    vals = values[torch.clamp(idx, min=0).long()]
    num = torch.where(valid, vals, 0.0).double().sum(dim=1).float()
    den = torch.clamp(valid.sum(dim=1), min=1).to(values.dtype)
    return torch.where(mask, num / den, 0.0)


def smooth_feature(points: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                   k: int = 25) -> torch.Tensor:
    """Mean of a per-point scalar over each live point's k nearest live
    neighbours (self included)."""
    _, idx = knn(points, points, k, query_mask=mask, point_mask=mask)
    return _gather_mean(values, idx, mask)


def expand_to_original(coarse_points: torch.Tensor, coarse_values: torch.Tensor,
                       coarse_mask: torch.Tensor, full_points: torch.Tensor,
                       full_mask: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Per-point values of a downsampled cloud pushed back to full
    resolution: the mean over each full point's k nearest coarse points."""
    _, idx = knn(full_points, coarse_points, k, query_mask=full_mask, point_mask=coarse_mask)
    return _gather_mean(coarse_values, idx, full_mask)
