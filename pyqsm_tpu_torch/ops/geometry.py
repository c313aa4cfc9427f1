"""Geometric utilities on the main path: percentile selection, region
masks and the PCA-oriented bounding box of the contraction clamp
(counterparts of ``pyqsm_tpu/ops/geometry.py:21-176``)."""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.linalg3 import sym_eig3


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


def percentile_mask(values: torch.Tensor, mask: torch.Tensor,
                    low: float, high: float) -> torch.Tensor:
    """Live rows whose value lies in the [low, high] percentile band."""
    lo = masked_percentile(values, mask, low)
    hi = masked_percentile(values, mask, high)
    return mask & (values >= lo) & (values <= hi)


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
