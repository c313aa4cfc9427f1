"""Closed-form symmetric 3×3 eigendecomposition, batched over leading axes
(the trigonometric method of the JAX package's ``ops/linalg3.py``)."""

from __future__ import annotations

import math

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def sym_eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    detB = torch.linalg.det(B)
    denom = torch.clamp(2.0 * p ** 3, min=1e-30)
    r = torch.clamp(detB / denom, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1], dim=-1)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector for eigenvalue ``lam`` via the best-conditioned cross
    product of rows of (A - lam I)."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best = torch.stack([n01, n02, n12], dim=-1).argmax(dim=-1)
    v = torch.where((best == 0)[..., None], c01,
                    torch.where((best == 1)[..., None], c02, c12))
    norm = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-30))
    v = v / norm
    ok = (torch.maximum(torch.maximum(n01, n02), n12) > 1e-24)[..., None]
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(ok, v, fallback.expand_as(v))


def sym_eig3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors [..., 3(vec), 3(which)]."""
    vals = sym_eigvals3(A)
    v0 = _eigvec_for(A, vals[..., 0])
    v2 = _eigvec_for(A, vals[..., 2])
    v1 = _cross(v2, v0)
    n1 = torch.sqrt(torch.clamp((v1 * v1).sum(-1, keepdim=True), min=1e-30))
    v1 = v1 / n1
    return vals, torch.stack([v0, v1, v2], dim=-1)
