"""Whole-plot pipeline: isolate → per-tree skeleton QSM, optionally with
per-tree canopy metrics (counterpart of
``pyqsm_tpu/models/plot_pipeline.py``).

The plot stays on the device; every kept tree is gathered into one
``[T, cap]`` buffer, its resolution rung found by a batched binary search
over the voxel ladder ``skeleton_voxel·1.3^k``, and all trees are
contracted together.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pyqsm_tpu_torch.config import Config, IsolationConfig
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from pyqsm_tpu_torch.models.canopy import canopy_metrics
from pyqsm_tpu_torch.models.isolation import GrowthResult, build_trees
from pyqsm_tpu_torch.models.skeleton import (extract_skeleton_batch, extract_topology,
                                             skeleton_to_qsm)
from pyqsm_tpu_torch.ops.sampling import (compact_rows_batch, label_segments, rows_for_labels,
                                          voxel_count_batch, voxel_downsample_batch)
from pyqsm_tpu_torch.state import Cylinders


class TreeResult(NamedTuple):
    tree_id: int
    n_points: int
    cylinders: Cylinders
    metrics: dict | None = None  # canopy metrics (``with_metrics``)


class PlotResult(NamedTuple):
    growth: GrowthResult
    trees: list[TreeResult]
    timings: dict | None = None  # per-stage wall seconds (synchronised)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def process_plot(points, mask, cfg: Config | None = None, iso_cfg: IsolationConfig | None = None,
                 skeleton_voxel: float = 0.05, max_skeleton_points: int = 50_000,
                 min_tree_points: int = 500, with_metrics: bool = False,
                 max_trees: int | None = None, mesh=None, progress=None,
                 device: str | torch.device = DEFAULT_DEVICE) -> PlotResult:
    """Isolate every tree and fit a skeleton QSM per tree, on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``max_trees``: keep at most this many trees, the largest first (before
    the ``min_tree_points`` cut, as in the JAX package).
    ``with_metrics``: each tree's ``canopy_metrics`` on its contraction
    batch row, from the contraction's own first-iteration shift, inside
    the topology stage (so its time lands in ``topology_s``).
    ``progress``: optional ``callable(stage, stage_s)`` fired after each
    stage (isolation, ladder, contraction, topology); an exception it
    raises is swallowed — an observer must not end the run.
    ``mesh``: a ``parallel.mesh.Mesh`` — every rank calls with the same
    inputs; the growth runs sharded over the ranks, each rank contracts
    its block of trees, and every rank returns the full result. ``device``
    must name the rank's mesh device; with ``with_metrics`` every rank
    computes every tree's metrics."""
    dev = resolve_device(device, mesh)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    cfg = cfg or Config()
    timings: dict = {}

    def tick(stage: str, t0: float) -> float:
        _sync(dev)
        timings[f"{stage}_s"] = round(time.perf_counter() - t0, 3)
        if progress is not None:
            try:
                progress(stage, timings[f"{stage}_s"])
            except Exception:  # noqa: BLE001 — the observer must not kill the run
                pass
        return time.perf_counter()

    t0 = time.perf_counter()
    growth = build_trees(points, mask, iso_cfg, mesh=mesh, device=dev)
    seg_order, seg_slab, seg_vals, seg_counts, seg_n = label_segments(growth.labels, u_cap=4096)
    n_uniq = int(seg_n)
    t0 = tick("isolation", t0)
    if n_uniq > 4096:
        lab = growth.labels.cpu().numpy()
        uniq, counts = np.unique(lab[lab >= 0], return_counts=True)
    else:
        uniq = seg_vals[:n_uniq].cpu().numpy()
        counts = seg_counts[:n_uniq].cpu().numpy()
    order = np.argsort(-counts)  # same numpy call as the JAX package
    uniq, counts = uniq[order], counts[order]
    if max_trees is not None:
        uniq, counts = uniq[:max_trees], counts[:max_trees]
    kept_ids = [int(t) for t, c in zip(uniq, counts) if c >= min_tree_points]
    kept_counts = [int(c) for c in counts if c >= min_tree_points]
    if not kept_ids:
        return PlotResult(growth, [], timings)
    t_n = len(kept_ids)
    cap_t = -2048 * (-max(kept_counts) // 2048)
    idx_raw = rows_for_labels(seg_order, seg_slab,
                              torch.as_tensor(kept_ids, dtype=torch.int32, device=dev), cap_t)
    tree_m = idx_raw >= 0
    tree_p = torch.where(tree_m[..., None], points[torch.clamp(idx_raw, min=0).long()], 0.0)

    # finest rung whose occupied-voxel count fits the cap (monotone in the
    # rung → per-tree binary search, all trees probed together), bounded by
    # the first rung at a voxel ≥ 0.5
    n_rungs = 1
    while skeleton_voxel * 1.3 ** (n_rungs - 1) < 0.5:
        n_rungs += 1
    lo_r = np.zeros(t_n, np.int32)
    hi_r = np.full(t_n, n_rungs - 1, np.int32)
    while np.any(lo_r < hi_r):
        act = lo_r < hi_r
        mid = (lo_r + hi_r) // 2
        voxels = (skeleton_voxel * 1.3 ** mid).astype(np.float32)
        cnt = voxel_count_batch(tree_p, torch.as_tensor(voxels, device=dev), tree_m).cpu().numpy()
        ok = cnt <= max_skeleton_points
        hi_r = np.where(act & ok, mid, hi_r)
        lo_r = np.where(act & ~ok, mid + 1, lo_r)
    final_v = (skeleton_voxel * 1.3 ** lo_r).astype(np.float32)
    rep_p, rep_m, _ = voxel_downsample_batch(tree_p, torch.as_tensor(final_v, device=dev), tree_m)
    rep_p, rep_m = compact_rows_batch(rep_p, rep_m)
    n_rep = int(rep_m.sum(dim=1).max())
    cap = int(-8192 * (-max(n_rep, 1) // 8192))
    if cap <= cap_t:
        batch_p, batch_m = rep_p[:, :cap], rep_m[:, :cap]
    else:
        batch_p = F.pad(rep_p, (0, 0, 0, cap - cap_t))
        batch_m = F.pad(rep_m, (0, cap - cap_t))
    batch_p, batch_m = batch_p.contiguous(), batch_m.contiguous()
    t0 = tick("ladder", t0)

    skels = extract_skeleton_batch(batch_p, batch_m, cfg.skeletonize, mesh=mesh, device=dev)
    t0 = tick("contraction", t0)

    trees: list[TreeResult] = []
    for i, (tree_id, n_tree) in enumerate(zip(kept_ids, kept_counts)):
        topo = extract_topology(skels.contracted[i], batch_m[i], skels.total_shift[i],
                                cfg.skeletonize.graph_k_n)
        metrics = None
        if with_metrics:
            metrics = canopy_metrics(batch_p[i], batch_m[i], shift=skels.first_shift[i],
                                     device=dev)
        trees.append(TreeResult(tree_id, n_tree, skeleton_to_qsm(topo), metrics))
    tick("topology", t0)
    return PlotResult(growth, trees, timings)
