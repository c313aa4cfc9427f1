"""Projected-area kernels (counterparts of ``pyqsm_tpu/ops/area.py``).

- ``rasterized_area``: the xy projection binned onto a ``grid_n²`` grid by
  a scatter-max, closed morphologically (3×3 dilations, then erosions), and
  its occupied cells counted. On a 0/1 grid a 3×3 ``max_pool2d`` is the
  clipped 3×3 box convolution of the JAX package, and an erosion is one
  minus the dilation of the complement, so the grid is equal cell for cell.
- ``convex_hull_area_2d``: the polygon of the support lines at 256 angles.
- ``width_p95``: the 95th percentile of the pairwise xy distances.
"""

from __future__ import annotations

import logging
import math

import torch
import torch.nn.functional as F

from pyqsm_tpu_torch.ops.geometry import masked_percentile
from pyqsm_tpu_torch.ops.neighbors import _sqrt
from pyqsm_tpu_torch.ops.sampling import _scalar

# rows above which width_p95 subsamples before materialising its [N, N] pairs
_PAIRWISE_CAP = 8192


def rasterized_area(points: torch.Tensor, mask: torch.Tensor, cell: float = 0.05,
                    grid_n: int = 512, close_iters: int = 1) -> torch.Tensor:
    """Occupied-cell area of the xy projection after ``close_iters`` rounds
    of 3×3 closing (≈ alpha-filling with alpha ≈ cell·(2·close_iters+1));
    a 0-dim f32 tensor."""
    xy = points[:, :2]
    finite = mask & torch.isfinite(xy).all(dim=-1)
    safe = torch.where(finite[:, None], xy, 0.0)
    lo = torch.where(finite[:, None], safe, float("inf")).amin(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    ij = torch.floor((safe - lo[None, :]) / _scalar(cell, xy)).to(torch.int32)
    ij = torch.clamp(ij, 0, grid_n - 1)
    flat = ij[:, 0] * grid_n + ij[:, 1]
    dst = torch.where(finite, flat, grid_n * grid_n - 1).long()
    grid = torch.zeros(grid_n * grid_n, dtype=torch.float32, device=xy.device)
    grid.scatter_reduce_(0, dst, finite.to(torch.float32), reduce="amax")
    g = grid.reshape(1, 1, grid_n, grid_n)

    def dilate(x):
        return F.max_pool2d(x, 3, stride=1, padding=1)

    for _ in range(close_iters):
        g = dilate(g)
    for _ in range(close_iters):
        g = 1.0 - dilate(1.0 - g)
    c = _scalar(cell, xy)[0]
    return g.sum() * c * c


def convex_hull_area_2d(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Area of the polygon bounded by the xy projection's support lines at
    256 uniform angles (within 0.5 % of the convex hull for smooth hulls).
    As in the JAX package, masked rows enter as -inf."""
    xy = torch.where(mask[:, None], points[:, :2], float("-inf"))
    m = 256
    dev = xy.device
    theta = torch.arange(m, dtype=torch.float32, device=dev) * (2.0 * math.pi / m)
    dirs = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    h = (xy @ dirs.T).amax(dim=0)  # support function
    dth = torch.tensor(2.0 * math.pi / m, dtype=torch.float32, device=dev)
    h_next = torch.roll(h, -1)
    sin_d = torch.sin(dth)
    vx = (h * torch.sin(theta + dth) - h_next * torch.sin(theta)) / sin_d
    vy = (-h * torch.cos(theta + dth) + h_next * torch.cos(theta)) / sin_d
    vx_n, vy_n = torch.roll(vx, -1), torch.roll(vy, -1)
    return 0.5 * torch.abs((vx * vy_n - vx_n * vy).sum())


def width_p95(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """95th percentile of the pairwise xy distances (each pair once). Above
    8192 rows every ``ceil(N/8192)``-th row is kept first, with a logged
    warning, as in the JAX package. The squared distance is
    ``fma(dy, dy, dx·dx)`` as XLA computes it, emulated in float64."""
    if points.shape[0] > _PAIRWISE_CAP:
        stride = -(-points.shape[0] // _PAIRWISE_CAP)
        logging.getLogger("pyqsm_tpu_torch.calc").warning(
            "width_p95: N=%d exceeds the %d pairwise cap; auto-subsampling every %dth row",
            points.shape[0], _PAIRWISE_CAP, stride)
        points, mask = points[::stride], mask[::stride]
    xy = torch.where(mask[:, None], points[:, :2], float("nan"))
    n = xy.shape[0]
    i, j = torch.triu_indices(n, n, 1, device=xy.device)
    diff = (xy[i] - xy[j]).double()
    d2 = ((diff[:, 0] * diff[:, 0]).float().double() + diff[:, 1] * diff[:, 1]).float()
    vals = _sqrt(d2)
    return masked_percentile(vals, ~torch.isnan(vals), 95.0, constant_q=True)
