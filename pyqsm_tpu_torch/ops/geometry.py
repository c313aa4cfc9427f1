"""Geometric utilities: percentile selection, region masks, the Rodrigues
rotation of the cylinder fit, centres and radii of a cloud, the footprint
tiling and the PCA-oriented bounding box of the contraction clamp
(counterparts of ``pyqsm_tpu/ops/geometry.py:21-176``)."""

from __future__ import annotations

import math

import torch

from pyqsm_tpu_torch.ops.linalg3 import sym_eig3
from pyqsm_tpu_torch.ops.neighbors import _sq3, _sqrt


def masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float,
                      constant_q: bool = False) -> torch.Tensor:
    """Linear-interpolated percentile over live entries — the float32
    arithmetic of ``jnp.nanpercentile`` (weights ``1 - h`` and ``h`` on the
    two neighbouring order statistics), so thresholds agree with the JAX
    package to the bit.

    XLA turns q / 100 into q · f32(0.01) where q reaches the computation at
    run time, but folds it into one correctly rounded f32(q / 100) where q
    is a constant of the trace (a literal, or a default argument of the
    jitted function): ``constant_q`` says which the JAX package's call
    site is (60 · f32(0.01) and f32(60 / 100) differ in the last bit)."""
    v = torch.where(mask, values, float("nan"))
    s, _ = torch.sort(v)  # NaN sorts last
    cnt = mask.sum().to(torch.float32)
    q32 = torch.tensor(q, dtype=torch.float32)
    qq = (q32 / 100.0 if constant_q else q32 * torch.tensor(0.01)).to(values.device)
    pos = qq * (cnt - 1.0)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = torch.clamp(torch.minimum(low, cnt - 1.0), min=0.0).long()
    high = torch.clamp(torch.minimum(high, cnt - 1.0), min=0.0).long()
    # low·lw + high·hw with the second product fused (XLA's FMA), emulated
    # in float64: one product exact, one rounding to float32
    return ((s[low] * lw).double() + s[high].double() * hw.double()).float()


def percentile(values: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated percentile of a whole float32 vector, in the
    arithmetic of ``jnp.percentile`` on it: XLA folds ``q / 100 · (n − 1)``
    (n known when it compiles) into ``q · f32(f32(n − 1) · f32(0.01))``."""
    s, _ = torch.sort(values)
    n = values.shape[0]
    scale = torch.tensor(float(n - 1), dtype=torch.float32) * torch.tensor(0.01)
    pos = (torch.tensor(q, dtype=torch.float32) * scale).to(values.device)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = torch.clamp(low, 0.0, n - 1.0).long()
    high = torch.clamp(high, 0.0, n - 1.0).long()
    # the second product fused, as in masked_percentile
    return ((s[low] * lw).double() + s[high].double() * hw.double()).float()


def percentile_mask(values: torch.Tensor, mask: torch.Tensor,
                    low: float, high: float) -> torch.Tensor:
    """Live rows whose value lies in the [low, high] percentile band."""
    lo = masked_percentile(values, mask, low)
    hi = masked_percentile(values, mask, high)
    return mask & (values >= lo) & (values <= hi)


def crop_mask(points: torch.Tensor, mask: torch.Tensor,
              minx: float = -math.inf, maxx: float = math.inf,
              miny: float = -math.inf, maxy: float = math.inf,
              minz: float | torch.Tensor = -math.inf,
              maxz: float | torch.Tensor = math.inf) -> torch.Tensor:
    """Axis-aligned crop of the live rows (bounds inclusive)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return (mask & (x >= minx) & (x <= maxx) & (y >= miny) & (y <= maxy)
            & (z >= minz) & (z <= maxz))


def zoom_mask(points: torch.Tensor, mask: torch.Tensor, region,
              reverse: bool = False) -> torch.Tensor:
    """Keep (or with ``reverse`` exclude) points inside an AABB region
    ``[[minx, miny(, minz)], [maxx, maxy(, maxz)]]``; 2D regions span all z."""
    region = torch.as_tensor(region, dtype=points.dtype, device=points.device)
    lo, hi = region[0], region[1]
    inside = ((points[:, 0] >= lo[0]) & (points[:, 0] <= hi[0])
              & (points[:, 1] >= lo[1]) & (points[:, 1] <= hi[1]))
    if region.shape[1] > 2:
        inside = inside & (points[:, 2] >= lo[2]) & (points[:, 2] <= hi[2])
    return mask & (~inside if reverse else inside)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| of [..., 3] rows: XLA's fused square sum, correctly rounded root."""
    return _sqrt(_sq3(v))[..., None]


def _mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] elementwise (no TF32 on the card), each
    entry a three-term sum rounded once from float64."""
    return (a.double()[..., :, :, None] * b.double()[..., None, :, :]).sum(-2).float()


def rotation_matrix_from_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation taking direction ``a`` onto ``b`` ([..., 3] each,
    normalised here): ``I + K + K²·(1 − c)/|v|²`` with ``v = a × b``,
    ``c = a·b``; parallel inputs give I and antiparallel ones the 180°
    turn about an axis perpendicular to ``a``."""
    a = a / torch.clamp(_norm3(a), min=1e-12)
    b = b / torch.clamp(_norm3(b), min=1e-12)
    v = torch.linalg.cross(a, b, dim=-1)
    c = (a.double() * b.double()).sum(-1).float()
    s2 = _sq3(v)
    zero = torch.zeros_like(v[..., 0])
    K = torch.stack([torch.stack([zero, -v[..., 2], v[..., 1]], -1),
                     torch.stack([v[..., 2], zero, -v[..., 0]], -1),
                     torch.stack([-v[..., 1], v[..., 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    scale = (1 - c) / torch.clamp(s2, min=1e-20)
    R = eye + K + _mat3(K, K) * scale[..., None, None]
    # antiparallel fallback: 180° about a perpendicular axis
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    perp = torch.where((a[..., 0].abs() < 0.9)[..., None], ex, ey)
    axis = torch.linalg.cross(a, perp, dim=-1)
    axis = axis / torch.clamp(_norm3(axis), min=1e-12)
    r180 = 2.0 * axis[..., :, None] * axis[..., None, :] - eye
    par = torch.where((c > 0)[..., None, None], eye, r180)
    return torch.where((s2 < 1e-16)[..., None, None], par, R)


def get_center(points: torch.Tensor, mask: torch.Tensor, method: str = "centroid") -> torch.Tensor:
    """Centroid, top or bottom centre: the xy centroid with the mean z, or
    the live rows' largest or smallest z."""
    w = mask.to(points.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    cx = (points[:, 0] * w).sum() / n
    cy = (points[:, 1] * w).sum() / n
    if method == "centroid":
        cz = (points[:, 2] * w).sum() / n
    elif method == "top":
        cz = torch.where(mask, points[:, 2], float("-inf")).amax()
    elif method == "bottom":
        cz = torch.where(mask, points[:, 2], float("inf")).amin()
    else:
        raise ValueError(method)
    return torch.stack([cx, cy, cz])


def get_radius(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean xy distance of the live rows from their xy centroid."""
    c = get_center(points, mask, method="centroid")
    d = torch.sqrt((points[:, 0] - c[0]) ** 2 + (points[:, 1] - c[1]) ** 2)
    w = mask.to(points.dtype)
    return (d * w).sum() / torch.clamp(w.sum(), min=1.0)


def generate_grid(lo: tuple[float, float], hi: tuple[float, float], nx: int = 2, ny: int = 3,
                  overlap: float = 1.0 / 7.0) -> list[tuple[tuple[float, float],
                                                            tuple[float, float]]]:
    """Overlapping 2D tiling of the plot footprint (the reference's 2×3
    cells with 1/7 overlap), host-side."""
    x0, y0 = lo
    x1, y1 = hi
    w = (x1 - x0) / nx
    h = (y1 - y0) / ny
    ox, oy = w * overlap, h * overlap
    return [((x0 + i * w - ox, y0 + j * h - oy), (x0 + (i + 1) * w + ox, y0 + (j + 1) * h + oy))
            for i in range(nx) for j in range(ny)]


def obb_axes(points: torch.Tensor, mask: torch.Tensor):
    """PCA-oriented bounding box over [..., N, 3]: (center [..., 3], axes
    [..., 3, 3] rows = axes, half-extents [..., 3])."""
    w = mask.to(points.dtype)[..., None]
    n = torch.clamp(w.sum(dim=-2), min=1.0)  # [..., 1]
    mean = (points * w).sum(dim=-2) / n
    centered = (points - mean[..., None, :]) * w
    cov = centered.transpose(-1, -2) @ centered / n[..., None]
    _, vecs = sym_eig3(cov)
    axes = vecs.transpose(-1, -2)
    proj = centered @ axes.transpose(-1, -2)
    half = torch.where(mask[..., None], proj, 0.0).abs().amax(dim=-2)
    return mean, axes, half


def clamp_to_obb(points: torch.Tensor, center: torch.Tensor, axes: torch.Tensor,
                 half: torch.Tensor) -> torch.Tensor:
    """Clamp [..., N, 3] points into their OBB (contraction stabiliser)."""
    local = (points - center[..., None, :]) @ axes.transpose(-1, -2)
    local = torch.maximum(torch.minimum(local, half[..., None, :]), -half[..., None, :])
    return local @ axes + center[..., None, :]
