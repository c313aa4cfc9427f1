"""Normal estimation and orientation (counterpart of
``pyqsm_tpu/ops/normals.py``): the smallest eigenvector of each point's kNN
covariance, sign-aligned by iterated neighbour-majority votes from the +z
hemisphere, and the normal-angle stem filter.
"""

from __future__ import annotations

import math

import torch

from pyqsm_tpu_torch.ops.linalg3 import sym_eig3
from pyqsm_tpu_torch.ops.neighbors import _fma, _sqrt, knn

_DEG = torch.tensor(180.0 / math.pi, dtype=torch.float32)  # jnp.degrees' f32 factor


def _neighborhood_cov(points: torch.Tensor, nbr_idx: torch.Tensor):
    """Covariance of each point's neighbourhood, ``nbr_idx`` [N, k] with -1
    padding: ``(cov [N, 3, 3], n_valid [N])``. The sums over the k
    neighbours are rounded once from float64."""
    valid = nbr_idx >= 0
    nbrs = points[torch.clamp(nbr_idx, min=0).long()]  # [N, k, 3]
    w = valid[..., None].to(points.dtype)
    cnt = torch.clamp(valid.sum(dim=1), min=1).to(points.dtype)[:, None]
    mean = (nbrs * w).double().sum(dim=1).float() / cnt
    centered = ((nbrs - mean[:, None, :]) * w).double()
    cov = torch.einsum("nki,nkj->nij", centered, centered).float()
    return cov / torch.clamp(cnt[..., None] - 1.0, min=1.0), cnt[:, 0].to(torch.int32)


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, k: int = 30,
                     orient_iters: int = 8) -> torch.Tensor:
    """Per-point unit normals (smallest covariance eigenvector of the k
    nearest live neighbours), signed into the +z hemisphere (ties by +x)
    and then flipped ``orient_iters`` times by the sign majority of the
    neighbours' dot products. Dead rows are 0."""
    _, idx = knn(points, points, k + 1, query_mask=mask, point_mask=mask)
    nbr_idx = idx[:, 1:]
    cov, _ = _neighborhood_cov(torch.where(mask[:, None], points, 0.0), nbr_idx)
    _, vecs = sym_eig3(cov)
    normals = vecs[..., 0]
    sign = torch.where(normals[:, 2].abs() > 1e-6, torch.sign(normals[:, 2]),
                       torch.sign(normals[:, 0] + 1e-12))
    normals = normals * sign[:, None]
    valid = nbr_idx >= 0
    gidx = torch.clamp(nbr_idx, min=0).long()
    for _ in range(orient_iters):
        nbr_n = normals[gidx]  # [N, k, 3]
        dots = (nbr_n.double() * normals[:, None, :].double()).sum(-1)
        vote = torch.where(valid, torch.sign(dots), 0.0).sum(dim=1)
        normals = normals * torch.where(vote < 0, -1.0, 1.0).to(normals.dtype)[:, None]
    return torch.where(mask[:, None], normals, 0.0)


def angle_to_horizontal(normals: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between the normal and the XY plane; sign-invariant.
    The arctangent is taken in float64 and rounded once, so the card and
    the CPU give the same float32 angle."""
    nz = normals[:, 2].abs()
    nxy = _sqrt(torch.clamp(_fma(normals[:, 1], normals[:, 1], normals[:, 0] * normals[:, 0]),
                            min=1e-30))
    return torch.atan2(nz.double(), nxy.double()).float() * _DEG.to(normals.device)


def filter_by_norm(normals: torch.Tensor, mask: torch.Tensor,
                   angle_cutoff: float = 10.0) -> torch.Tensor:
    """Live rows whose normal lies within ``angle_cutoff`` degrees of
    horizontal: the surfaces of near-vertical structure (stems)."""
    return mask & (angle_to_horizontal(normals) <= angle_cutoff)
