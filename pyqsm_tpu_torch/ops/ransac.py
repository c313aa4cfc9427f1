"""Batched RANSAC shape fitting (counterpart of ``pyqsm_tpu/ops/ransac.py``).

Every hypothesis is three drawn rows; its circumcircle is closed form and
its inliers are one masked reduction, so a fit is a few batched tensor ops
over ``[..., H, N]``. ``fit_cylinder`` rotates the cluster's axis onto +z,
fits the projected circle and lifts it back (the reference's
``z_align_and_fit``). Every function takes leading batch axes: one fit a
row, each with its own draws.

Deviation: the hypotheses' rows come from ``hypothesis_rows``, which draws
from a ``torch.Generator`` on the CPU (the card and the CPU draw alike);
torch cannot reproduce ``jax.random.choice``, so one seed picks other
hypotheses than the JAX package does. Every draw of this module goes
through that one function, and the parity tests replace it with the JAX
package's draws. Given the same draws, the winning hypothesis is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from pyqsm_tpu_torch.ops.geometry import rotation_matrix_from_vectors
from pyqsm_tpu_torch.ops.linalg3 import sym_eig3
from pyqsm_tpu_torch.ops.neighbors import _fma, _sq3, _sqrt


class CircleFit(NamedTuple):
    center: torch.Tensor  # [..., 2]
    radius: torch.Tensor  # [...]
    inliers: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor  # [...] i32
    ok: torch.Tensor  # [...] bool — some hypothesis passed the radius gates


class CylinderFit(NamedTuple):
    center: torch.Tensor  # [..., 3] midpoint on the axis
    axis: torch.Tensor  # [..., 3] unit
    radius: torch.Tensor
    height: torch.Tensor
    inliers: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def hypothesis_rows(mask: torch.Tensor, n_hypotheses: int,
                    generator: torch.Generator) -> torch.Tensor:
    """[H, 3] rows of ``mask`` [N] drawn uniformly among the live ones, with
    replacement, from ``generator`` (a CPU ``torch.Generator``): the one
    random draw of a fit. The JAX package draws them with
    ``jax.random.choice(key, N, (H, 3), p=mask/Σmask)``."""
    u = torch.rand((n_hypotheses, 3), generator=generator, dtype=torch.float64)
    live = torch.cumsum(mask.to(torch.int64), 0)
    n_live = live[-1]
    r = torch.minimum(torch.floor(u.to(mask.device) * n_live).to(torch.int64),
                      torch.clamp(n_live - 1, min=0))
    return torch.clamp(torch.searchsorted(live, r + 1), max=mask.shape[0] - 1)


def _draw(mask: torch.Tensor, n_hypotheses: int, generator) -> torch.Tensor:
    """Hypothesis rows for each leading row of ``mask`` [..., N]: one
    generator, or a sequence of one a row (flattened order)."""
    lead = mask.shape[:-1]
    if not lead:
        return hypothesis_rows(mask, n_hypotheses, generator)
    flat = mask.reshape(-1, mask.shape[-1])
    gens = list(generator) if isinstance(generator, Sequence) else [generator]
    if len(gens) != flat.shape[0]:
        raise ValueError(f"{len(gens)} generators for {flat.shape[0]} fits")
    rows = torch.stack([hypothesis_rows(m, n_hypotheses, g) for m, g in zip(flat, gens)])
    return rows.reshape(tuple(lead) + (n_hypotheses, 3))


def _circumcircle(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Circumcircle of the 2D points a, b, c ([..., 2] each) as XLA's CPU
    code rounds the JAX package's: the three-term sums are fused
    multiply-add chains. Collinear points give an infinite radius."""
    ax, ay, bx, by, cx, cy = a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0], c[..., 1]
    byc, cya, ayb = by - cy, cy - ay, ay - by
    d = 2.0 * _fma(cx, ayb, _fma(bx, cya, ax * byc))
    d = torch.where(d.abs() < 1e-12, math.inf, d)
    a2, b2, c2 = _sq2(a), _sq2(b), _sq2(c)
    ux = _fma(c2, ayb, _fma(b2, cya, a2 * byc)) / d
    uy = _fma(c2, bx - ax, _fma(b2, ax - cx, a2 * (cx - bx))) / d
    center = torch.stack([ux, uy], -1)
    return center, _sqrt(_sq2(a - center))


def _sq2(v: torch.Tensor) -> torch.Tensor:
    """x² + y² of [..., 2] rows as ``fma(y, y, x·x)``."""
    return _fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b for [..., 3, 3] A: Gaussian elimination with partial
    pivoting, elementwise (the same on every device)."""
    M = torch.cat([A, b[..., None]], -1)
    for col in range(3):
        piv = col + M[..., col:, col].abs().argmax(-1)
        idx = torch.arange(3, device=A.device).expand(M.shape[:-2] + (3,)).clone()
        rows = idx.clone()
        rows[..., col] = piv
        rows.scatter_(-1, piv[..., None], torch.full_like(piv[..., None], col))
        M = torch.gather(M, -2, rows[..., None].expand_as(M))
        for r in range(col + 1, 3):
            f = M[..., r, col] / M[..., col, col]
            M = M.clone()
            M[..., r, :] = M[..., r, :] - f[..., None] * M[..., col, :]
    x2 = M[..., 2, 3] / M[..., 2, 2]
    x1 = (M[..., 1, 3] - M[..., 1, 2] * x2) / M[..., 1, 1]
    x0 = (M[..., 0, 3] - M[..., 0, 1] * x1 - M[..., 0, 2] * x2) / M[..., 0, 0]
    return torch.stack([x0, x1, x2], -1)


def _as_batch(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(like.shape[:-2])


def ransac_circle_2d(pts2d: torch.Tensor, mask: torch.Tensor, generator,
                     threshold: float = 0.01, n_hypotheses: int = 1024,
                     max_radius=math.inf, min_radius=0.0) -> CircleFit:
    """Batched RANSAC circle fit of [..., N, 2] points with a Kåsa
    least-squares refinement on the winning hypothesis' inliers; radius
    gates reject hypotheses outside [min_radius, max_radius]. Scores are
    inlier counts; the first best hypothesis wins (``jnp.argmax``)."""
    rows = _draw(mask, n_hypotheses, generator)
    max_r = _as_batch(max_radius, pts2d)[..., None]
    min_r = _as_batch(min_radius, pts2d)[..., None]
    gidx = rows.reshape(rows.shape[:-2] + (-1,)).long()
    tri = torch.gather(pts2d, -2, gidx[..., None].expand(gidx.shape + (2,)))
    tri = tri.reshape(rows.shape + (2,))
    centers, radii = _circumcircle(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])  # [.., H, 2]
    diff = pts2d[..., None, :, :] - centers[..., :, None, :]  # [..., H, N, 2]
    resid = (_sqrt(_sq2(diff)) - radii[..., None]).abs()
    inl = (resid <= threshold) & mask[..., None, :]
    scores = inl.sum(-1, dtype=torch.int32)
    gate = (radii >= min_r) & (radii <= max_r) & torch.isfinite(radii)
    scores = torch.where(gate, scores, -1)
    best = scores.argmax(-1, keepdim=True)  # the first maximum
    any_ok = torch.gather(scores, -1, best)[..., 0] >= 0
    best_inl = torch.gather(inl, -2, best[..., None].expand(best.shape + (inl.shape[-1],)))
    best_inl = best_inl[..., 0, :] & any_ok[..., None]
    c_best = torch.gather(centers, -2, best[..., None].expand(best.shape + (2,)))[..., 0, :]
    r_best = torch.gather(radii, -1, best)[..., 0]

    # Kåsa refinement: [2x 2y 1][a b c]ᵀ = x² + y² over the inliers, in
    # float64 about the inliers' centroid (the same least-squares circle;
    # in float32 about the origin the normal equations lose up to 1e-2 m on
    # rotated coordinates a few metres out, and the card's and the CPU's
    # roundings would part by that much)
    wts = best_inl.to(torch.float64)
    n_in = torch.clamp(wts.sum(-1, keepdim=True), min=1.0)
    p64 = pts2d.double()
    mid = (p64 * wts[..., None]).sum(-2) / n_in
    q = p64 - mid[..., None, :]
    x, y = q[..., 0], q[..., 1]
    A = torch.stack([2 * x, 2 * y, torch.ones_like(x)], -1) * wts[..., None]
    bvec = (x * x + y * y) * wts
    eye = torch.eye(3, dtype=torch.float64, device=pts2d.device)
    ATA = A.transpose(-1, -2) @ A + 1e-9 * eye
    ATb = (A.transpose(-1, -2) @ bvec[..., None])[..., 0]
    sol = _solve3(ATA, ATb)
    c_ref = (sol[..., :2] + mid).float()
    r_ref = torch.sqrt(torch.clamp(sol[..., 2] + (sol[..., :2] ** 2).sum(-1), min=0.0)).float()
    use_ref = ((r_ref >= min_r[..., 0]) & (r_ref <= max_r[..., 0])
               & (best_inl.sum(-1) >= 3))
    center = torch.where(use_ref[..., None], c_ref, c_best)
    radius = torch.where(use_ref, r_ref, r_best)
    d2 = (_sqrt(_sq2(pts2d - center[..., None, :])) - radius[..., None]).abs()
    inliers = (d2 <= threshold) & mask & any_ok[..., None]
    return CircleFit(center, radius, inliers, inliers.sum(-1, dtype=torch.int32), any_ok)


def principal_axis(points: torch.Tensor, mask: torch.Tensor):
    """Largest-eigenvector direction of [..., N, 3] points (signed into +z)
    and the elongation e_max / e_mid (1 = isotropic). Sums are rounded
    once from float64."""
    w = mask.to(points.dtype)[..., None]
    n = torch.clamp(w.sum(-2), min=1.0)  # [..., 1]
    mean = (points * w).double().sum(-2).float() / n
    centered = ((points - mean[..., None, :]) * w).double()
    cov = (centered.transpose(-1, -2) @ centered).float() / n[..., None]
    vals, vecs = sym_eig3(cov)
    axis = vecs[..., :, 2]
    elong = vals[..., 2] / torch.clamp(vals[..., 1], min=1e-20)
    return axis * torch.where(axis[..., 2:] < 0, -1.0, 1.0), elong


def _apply3(p: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] rows times Rᵀ ([..., 3, 3]), elementwise: each entry a
    three-term sum rounded once from float64 (no TF32 on the card)."""
    return (p.double()[..., :, None, :] * R.double()[..., None, :, :]).sum(-1).float()


def fit_cylinder(points: torch.Tensor, mask: torch.Tensor, generator,
                 threshold: float = 0.02, n_hypotheses: int = 1024,
                 max_radius=math.inf, min_radius=0.0, align_axis: str = "auto") -> CylinderFit:
    """Cylinder of [..., N, 3] points by axis-align-then-circle: rotate the
    estimated axis onto +z, RANSAC-fit the projected circle, lift back.
    ``align_axis``: ``pca`` (principal axis), ``z`` (no rotation) or
    ``auto`` (the principal axis only when elongation > 4)."""
    pax, elong = principal_axis(points, mask)
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=points.dtype, device=points.device)
    if align_axis == "pca":
        axis = pax
    elif align_axis == "z":
        axis = zhat.expand_as(pax)
    elif align_axis == "auto":
        axis = torch.where((elong > 4.0)[..., None], pax, zhat)
    else:
        raise ValueError(align_axis)
    axis = axis / torch.clamp(_sqrt(_sq3(axis))[..., None], min=1e-12)
    R = rotation_matrix_from_vectors(axis, zhat.expand_as(axis))
    rot = _apply3(points, R)
    fit = ransac_circle_2d(rot[..., :2], mask, generator, threshold=threshold,
                           n_hypotheses=n_hypotheses, max_radius=max_radius,
                           min_radius=min_radius)
    z = rot[..., 2]
    zmin = torch.where(mask, z, math.inf).amin(-1)
    zmax = torch.where(mask, z, -math.inf).amax(-1)
    none = ~mask.any(-1)
    zmin = torch.where(none, math.nan, zmin)
    zmax = torch.where(none, math.nan, zmax)
    height = torch.clamp(zmax - zmin, min=1e-6)
    center_rot = torch.cat([fit.center, ((zmin + zmax) / 2.0)[..., None]], -1)
    center = _apply3(center_rot[..., None, :], R.transpose(-1, -2))[..., 0, :]
    return CylinderFit(center, axis, fit.radius, height, fit.inliers, fit.n_inliers, fit.ok)


def points_in_cylinder(points: torch.Tensor, center, axis, radius, height,
                       radial_slack: float = 1.0) -> torch.Tensor:
    """Rows of [N, 3] ``points`` inside the cylinder (closed form)."""
    center = torch.as_tensor(center, dtype=points.dtype, device=points.device)
    axis = torch.as_tensor(axis, dtype=points.dtype, device=points.device)
    rel = points - center[None, :]
    t = (rel.double() @ axis.double()).float()
    radial = _sqrt(_sq3(rel - t[:, None] * axis[None, :]))
    return (t.abs() <= height / 2.0) & (radial <= radius * radial_slack)


def sample_cylinder_surface(center, axis, radius: float, height: float, n: int = 512,
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """n points drawn uniformly on the cylinder's side (for viz/export),
    from ``generator`` (a CPU generator seeded 0 by default), on
    ``center``'s device."""
    center = torch.as_tensor(center, dtype=torch.float32)
    axis = torch.as_tensor(axis, dtype=torch.float32, device=center.device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand((2, n), generator=generator).to(center.device)
    theta = u[0] * (2 * math.pi)
    t = (u[1] - 0.5) * height
    ref = torch.tensor([1.0, 0.0, 0.0] if abs(float(axis[0])) < 0.9 else [0.0, 1.0, 0.0],
                       device=center.device)
    uu = torch.linalg.cross(axis, ref)
    uu = uu / torch.clamp(torch.linalg.vector_norm(uu), min=1e-12)
    vv = torch.linalg.cross(axis, uu)
    return (center[None, :] + t[:, None] * axis[None, :]
            + radius * (torch.cos(theta)[:, None] * uu[None, :]
                        + torch.sin(theta)[:, None] * vv[None, :]))
