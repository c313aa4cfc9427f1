"""Point-cloud Laplacian + mass matrix for contraction (counterpart of
``pyqsm_tpu/ops/laplacian.py:25-92``): kNN heat-kernel weights and a
kNN-ball area mass, in ELL form or block-banded with an exact spill."""

from __future__ import annotations

import math

import torch

from pyqsm_tpu_torch.ops.neighbors import knn
from pyqsm_tpu_torch.ops.sparse import (ELLLaplacian, band_transpose, build_banded,
                                        sort_spill_transpose, transpose_ell_sorted)


def point_cloud_laplacian(points: torch.Tensor, mask: torch.Tensor, n_neighbors: int = 20,
                          mollify_factor: float = 1e-6, banded: bool = False) -> ELLLaplacian:
    """Laplacian of [T, N, 3] (or [N, 3]) clouds; the result always carries
    the leading trees axis.

    - edges: kNN (self-match dropped);
    - weights: w_ij = exp(-d²/σ_i²), σ_i = mean kNN distance of i, floored
      at ``mollify_factor``;
    - mass: m_i = π·r̄_i² (r̄_i the mean kNN distance).
    ``banded``: rows must be Morton-ordered and N a multiple of 256."""
    if points.dim() == 2:
        points, mask = points[None], mask[None]
    n = points.shape[1]
    d, idx = knn(points, points, n_neighbors + 1, query_mask=mask, point_mask=mask)
    d, idx = d[..., 1:], idx[..., 1:]
    valid = idx >= 0
    dd = torch.where(valid, d, 0.0)
    cnt = torch.clamp(valid.sum(dim=-1), min=1)
    mean_d = dd.sum(dim=-1) / cnt
    sigma2 = torch.clamp(mean_d * mean_d, min=1e-12)
    w = torch.exp(-(dd * dd) / sigma2[..., None])
    w = torch.clamp(w, min=mollify_factor)
    w = torch.where(valid, w, 0.0)
    deg = w.sum(dim=-1)
    mass = torch.where(mask, math.pi * mean_d * mean_d, 1e-12)
    if banded:
        b_w, s_i, s_j, s_w, s_over = build_banded(idx, w, spill_cap=6 * n)
        st_i, st_j, st_w = sort_spill_transpose(s_i, s_j, s_w, n)
        return ELLLaplacian(nbr_idx=idx, w=w, deg=deg, mass=mass, b_w=b_w, s_i=s_i, s_j=s_j,
                            s_w=s_w, s_overflow=s_over, st_i=st_i, st_j=st_j, st_w=st_w,
                            b_w_t=band_transpose(b_w))
    t_idx, t_w, t_over, src, dst, sw = transpose_ell_sorted(idx, w, kt=2 * n_neighbors)
    return ELLLaplacian(nbr_idx=idx, w=w, deg=deg, mass=mass, t_idx=t_idx, t_w=t_w,
                        t_overflow=t_over, tx_src=src, tx_dst=dst, tx_w=sw,
                        t_overflow_any=bool(t_over.any()))
