"""Canopy metrics and epiphyte segmentation (counterpart of
``pyqsm_tpu/models/canopy.py``):

- ``get_shift``: the per-point shift of one Laplacian-contraction
  iteration (contraction 3, attraction 0.8);
- ``identify_epiphytes``: split at the 65th percentile of the shift's
  magnitude; the high part splits again at the 60th percentile of the
  shift's z — leaves contract downward strongly, epiphytes do not;
- ``width_at_height``: p95 of the pairwise xy distances in the slice at
  breast height;
- ``project_in_slices``: projected area per z-percentile slice;
- ``project_components_in_clusters``: per class, k-means clumps and each
  clump's projected area;
- ``canopy_metrics``: all of it for one tree.

Projected area is ``ops/area.rasterized_area``. The host reads what the
JAX package reads: the slice rows of ``width_at_height``, the percentile
bounds of ``project_in_slices``, and each class's and clump's live count.

Deviation: the clumps' k-means draws its first centres from a
``torch.Generator`` seeded with ``seed`` (``ops/cluster.first_center``),
not from ``jax.random``, so clump areas differ from the JAX package's for
the same seed; given the same draws they agree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.config import SkeletonizeConfig
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from pyqsm_tpu_torch.models.skeleton import extract_skeleton
from pyqsm_tpu_torch.ops.area import rasterized_area, width_p95
from pyqsm_tpu_torch.ops.cluster import kmeans
from pyqsm_tpu_torch.ops.color import split_on_percentile
from pyqsm_tpu_torch.ops.geometry import masked_percentile
from pyqsm_tpu_torch.ops.neighbors import _sq3, _sqrt


def get_shift(points, mask, contraction: float = 3.0, attraction: float = 0.8, iters: int = 1,
              n_neighbors: int = 20,
              device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """Shift of ``iters`` contraction iterations (exactly that many)."""
    cfg = SkeletonizeConfig(init_contraction=contraction, init_attraction=attraction,
                            max_iter=iters, step_wise_contraction_amplification=contraction,
                            n_neighbors=n_neighbors, termination_ratio=0.0)
    res = extract_skeleton(points, mask, cfg, amplify_auto=False, device=device)
    return res.first_shift if iters == 1 else res.total_shift


class EpiphyteSplit(NamedTuple):
    epis: torch.Tensor  # [N] bool
    leaves: torch.Tensor  # [N] bool
    wood: torch.Tensor  # [N] bool (low-contraction remainder)
    c_mag: torch.Tensor  # [N] contraction magnitude


def identify_epiphytes(shift: torch.Tensor, mask: torch.Tensor, cmag_pctile: float | None = None,
                       zshift_pctile: float | None = None) -> EpiphyteSplit:
    """Epiphyte / leaf / wood split of a single-iteration shift [N, 3] at
    the ``cmag_pctile`` (None: 65) and ``zshift_pctile`` (None: 60)
    percentiles. The magnitude is XLA's fused multiply-add chain (``_sq3``)
    and correctly rounded square root, so the splits equal the JAX
    package's. None stands for the JAX package's default argument, which
    its jitted function folds as a constant; a percentile passed in is a
    run-time value there (``masked_percentile``'s ``constant_q``)."""
    c_mag = _sqrt(_sq3(shift))
    highc, lowc = split_on_percentile(c_mag, mask, 65.0 if cmag_pctile is None else cmag_pctile,
                                      constant_q=cmag_pctile is None)
    z = torch.where(highc, shift[:, 2], float("nan"))
    leaves, epis = split_on_percentile(z, highc, 60.0 if zshift_pctile is None else zshift_pctile,
                                       constant_q=zshift_pctile is None)
    return EpiphyteSplit(epis=epis, leaves=leaves, wood=lowc, c_mag=c_mag)


def width_at_height(points: torch.Tensor, mask: torch.Tensor, height: float = 1.37,
                    tolerance: float = 0.1, max_slice_points: int = 2048) -> float:
    """p95 of pairwise xy distances in the slice at ``height`` ± tolerance
    above the cloud base. Above ``max_slice_points`` slice points the rows
    are stride-subsampled on the host first, as in the JAX package (an
    estimate of the slice statistic)."""
    z = points[:, 2]
    zmin = torch.where(mask, z, float("inf")).amin()
    band = mask & (z >= zmin + height - tolerance) & (z <= zmin + height + tolerance)
    rows = np.flatnonzero(band.cpu().numpy())
    if len(rows) < 2:
        return 0.0
    if len(rows) > max_slice_points:
        rows = rows[:: len(rows) // max_slice_points + 1]
    block = points[torch.as_tensor(rows, device=points.device)]
    return float(width_p95(block, torch.ones(block.shape[0], dtype=torch.bool,
                                             device=points.device)))


def project_in_slices(points: torch.Tensor, mask: torch.Tensor,
                      pctiles: tuple[float, ...] = (0, 20, 40, 60, 80, 100), cell: float = 0.05,
                      grid_n: int = 512) -> list[float]:
    """Projected area of each z-percentile slice."""
    z = points[:, 2]
    bounds = [float(masked_percentile(z, mask, p)) for p in pctiles]
    return [float(rasterized_area(points, mask & (z >= lo) & (z <= hi), cell=cell,
                                  grid_n=grid_n))
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def project_components_in_clusters(points: torch.Tensor, class_masks: dict[str, torch.Tensor],
                                   n_clumps: int = 20, cell: float = 0.05, grid_n: int = 512,
                                   seed: int = 0) -> dict[str, dict]:
    """Per class, k-means into up to ``n_clumps`` clumps (one a 10 live
    points) and the projected area of every clump of 3 points or more:
    ``{class: {"areas": [...], "total": float}}``. One CPU generator seeded
    ``seed`` serves the classes in order."""
    out: dict[str, dict] = {}
    generator = torch.Generator().manual_seed(seed)
    for name, m in class_masks.items():
        n_live = int(m.sum())
        if n_live == 0:
            out[name] = {"areas": [], "total": 0.0}
            continue
        k = min(n_clumps, max(n_live // 10, 1))
        _, labels = kmeans(points, m, k, generator)
        areas = []
        for c in range(k):
            clump = m & (labels == c)
            if int(clump.sum()) < 3:
                continue
            areas.append(float(rasterized_area(points, clump, cell=cell, grid_n=grid_n)))
        out[name] = {"areas": areas, "total": float(np.sum(areas))}
    return out


def canopy_metrics(points, mask, shift=None, cell: float = 0.05,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """One tree's canopy metrics, on ``device``: the epiphyte split, each
    class's clump areas, the slice areas and the width at breast height,
    in the JAX package's dict (``classes``, ``slice_areas``,
    ``width_at_bh``, ``counts``). Without ``shift`` one contraction
    iteration (``get_shift``) makes it."""
    dev = resolve_device(device)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    if shift is None:
        shift = get_shift(points, mask, device=dev)
    split = identify_epiphytes(as_tensor(shift, dev, torch.float32), mask)
    class_masks = {"epis": split.epis, "leaves": split.leaves, "wood": split.wood}
    return {
        "classes": project_components_in_clusters(points, class_masks, cell=cell),
        "slice_areas": project_in_slices(points, mask, cell=cell),
        "width_at_bh": width_at_height(points, mask),
        "counts": {k: int(v.sum()) for k, v in class_masks.items()},
    }
