"""Plot-scale tree isolation (counterpart of
``pyqsm_tpu/models/isolation.py``): trunk-base seeds by DBSCAN on the low
z-slice, then synchronous parallel region growing over a radius graph with
a min-cluster-id claim and per-cycle retirement of clusters whose new
frontier is below ``min_frontier``.

Two claim kernels give bit-identical labels: ``gather`` (each unclaimed row
takes the minimum active frontier id among its neighbors) and ``push``
(frontier rows scatter-min their id along the transposed graph; the
default at ≥ 262 144 rows). The JAX package's opt-in banded claim and its
sharded path are not ported.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from pyqsm_tpu_torch.config import IsolationConfig
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from pyqsm_tpu_torch.ops.cluster import dbscan_from_neighbors
from pyqsm_tpu_torch.ops.geometry import percentile_mask, zoom_mask
from pyqsm_tpu_torch.ops.neighbors import (grid_self_radius_knn, radius_count,
                                           radius_knn)
from pyqsm_tpu_torch.ops.outliers import statistical_outlier_mask
from pyqsm_tpu_torch.ops.sampling import (compact_rows, label_segments, nonzero_rows,
                                          voxel_downsample)
from pyqsm_tpu_torch.ops.sparse import build_transpose_ell, morton_codes

BIG = 2 ** 30


class GrowthResult(NamedTuple):
    labels: torch.Tensor  # [N] i32 tree id per point (-1 unclaimed)
    order: torch.Tensor  # [N] i32 cycle at which each point was claimed (-1)
    cycles_run: int
    active: torch.Tensor  # [cluster_cap] bool activity at exit
    claim: str = "gather"  # claim kernel that ran ("gather" | "push")


def _retire(labels, order, active, newly, cyc, c, min_frontier):
    """Shared tail of a claim cycle: record the claims, retire clusters with
    fewer than ``min_frontier`` new rows, return the next frontier."""
    key = torch.where(newly, torch.clamp(labels, 0, c - 1), c).long()
    new_counts = torch.zeros(c + 1, dtype=torch.int32, device=labels.device).index_add_(
        0, key, newly.to(torch.int32))[:c]
    active = active & (new_counts >= min_frontier)
    frontier = newly & active[torch.clamp(labels, 0, c - 1).long()]
    return labels, order, active, frontier


def region_grow(nbr_idx: torch.Tensor, seed_labels: torch.Tensor, mask: torch.Tensor,
                max_cycles: int = 200, min_frontier: int = 5,
                cluster_cap: int | None = None, kt_max: int = 128) -> GrowthResult:
    """Grow all seed clusters at once until no frontier is left.

    ``PYQSM_CLAIM`` (``auto``/``push``/``gather``) selects the claim as the
    JAX package does: push at ≥ 262 144 rows (or when forced) if the
    transposed graph's in-degree fits ``kt_max``, else gather."""
    n = nbr_idx.shape[0]
    mode = os.environ.get("PYQSM_CLAIM", "auto")
    if mode in ("auto", "push") and cluster_cap is not None and (n >= 262144 or mode == "push"):
        res = _region_grow_push(nbr_idx, seed_labels, mask, max_cycles, min_frontier,
                                int(cluster_cap), kt_max)
        if res is not None:
            return res
    return _region_grow_gather(nbr_idx, seed_labels, mask, max_cycles, min_frontier,
                               cluster_cap)


def _masked_edges(nbr_idx: torch.Tensor, mask: torch.Tensor):
    n = nbr_idx.shape[0]
    return (nbr_idx >= 0) & mask[:, None] & mask[torch.clamp(nbr_idx, 0, n - 1).long()]


def _region_grow_gather(nbr_idx, seed_labels, mask, max_cycles, min_frontier,
                        cluster_cap) -> GrowthResult:
    n = nbr_idx.shape[0]
    dev = nbr_idx.device
    c = n if cluster_cap is None else int(cluster_cap)
    gidx = torch.clamp(nbr_idx, min=0).long()
    edge = _masked_edges(nbr_idx, mask)
    labels = torch.where(mask, seed_labels.to(torch.int32), -1)
    frontier = labels >= 0
    order = torch.where(frontier, 0, -1).to(torch.int32)
    active = torch.ones(c, dtype=torch.bool, device=dev)
    cyc = 0
    while cyc < max_cycles and bool(frontier.any()):
        act_self = active[torch.clamp(labels, 0, c - 1).long()]
        code = torch.where(frontier & act_self & (labels >= 0), labels, BIG)
        cand = torch.where(edge, code[gidx], BIG).amin(dim=1)
        newly = mask & (labels < 0) & (cand < BIG)
        labels = torch.where(newly, cand, labels)
        order = torch.where(newly, cyc + 1, order).to(torch.int32)
        labels, order, active, frontier = _retire(labels, order, active, newly, cyc, c,
                                                  min_frontier)
        cyc += 1
    return GrowthResult(labels, order, cyc, active, "gather")


def _region_grow_push(nbr_idx, seed_labels, mask, max_cycles, min_frontier, cluster_cap,
                      kt_max) -> GrowthResult | None:
    """Frontier-compacted growth: each cycle costs O(frontier·kt) scatter-min
    along the transposed graph plus O(N) elementwise. None when the
    in-degree exceeds ``kt_max`` (the caller then takes the gather claim)."""
    n = nbr_idx.shape[0]
    dev = nbr_idx.device
    c = cluster_cap
    edge = _masked_edges(nbr_idx, mask)
    idx_m = torch.where(edge, nbr_idx, -1)
    indeg = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(edge, nbr_idx, n).reshape(-1).long(),
        torch.ones(edge.numel(), dtype=torch.int32, device=dev))[:n]
    deg_max = int(indeg.max()) if n else 0
    kt = 8
    while kt < deg_max:
        kt *= 2
    if kt > kt_max:
        return None
    t_idx, _, over = build_transpose_ell(idx_m, edge.to(torch.float32), kt=kt)
    if bool(over):
        return None
    labels = torch.where(mask, seed_labels.to(torch.int32), -1)
    frontier = labels >= 0
    order = torch.where(frontier, 0, -1).to(torch.int32)
    active = torch.ones(c, dtype=torch.bool, device=dev)
    nf = int(frontier.sum())
    cyc = 0
    while nf > 0 and cyc < max_cycles:
        f_cap = 1024
        while f_cap < nf:
            f_cap *= 4
        f_rows = nonzero_rows(frontier, f_cap)
        fr = torch.clamp(f_rows, min=0).long()
        lab_f = labels[fr]
        act_f = (f_rows >= 0) & (lab_f >= 0) & active[torch.clamp(lab_f, 0, c - 1).long()]
        tgt = t_idx[fr]  # [f_cap, kt] rows whose lists contain fr
        tgt_ok = act_f[:, None] & (tgt >= 0)
        code_f = torch.where(act_f, lab_f, BIG)
        cand = torch.full((n + 1,), BIG, dtype=torch.int32, device=dev).scatter_reduce_(
            0, torch.where(tgt_ok, tgt, n).reshape(-1).long(),
            code_f[:, None].expand(-1, kt).reshape(-1), "amin")[:n]
        newly = mask & (labels < 0) & (cand < BIG)
        labels = torch.where(newly, cand, labels)
        order = torch.where(newly, cyc + 1, order).to(torch.int32)
        labels, order, active, frontier = _retire(labels, order, active, newly, cyc, c,
                                                  min_frontier)
        nf = int(frontier.sum())
        cyc += 1
    return GrowthResult(labels, order, cyc, active, "push")


def id_trunk_bases(points: torch.Tensor, mask: torch.Tensor, cfg: IsolationConfig | None = None,
                   exclude_regions: list | None = None, coarsen_rows: int = 65536):
    """Trunk-base seed clusters on the low z-slice: ``(seed_labels [N],
    low_mask [N], high_mask [N])``. Above ``coarsen_rows`` slice rows the
    slice is re-voxeled at eps/8 and core counts weigh each
    representative by the rows it stands for."""
    cfg = cfg or IsolationConfig()
    dev = points.device
    z = points[:, 2]
    low = percentile_mask(z, mask, 0.0, cfg.low_pctile)
    high = percentile_mask(z, mask, cfg.low_pctile, 100.0)
    for region in exclude_regions or []:
        low = zoom_mask(points, low, region, reverse=True)
        high = zoom_mask(points, high, region, reverse=True)
    m = int(low.sum())
    cap = 1024
    while cap < m:
        cap *= 2
    bidx = nonzero_rows(low, cap)
    bmask = bidx >= 0
    bpts = points[torch.clamp(bidx, min=0).long()]
    coarsen = cap > coarsen_rows
    if coarsen:
        vpts, vmask, vtrace = voxel_downsample(bpts, float(cfg.base_eps) / 8.0, bmask)
        w_rep = torch.zeros(cap + 1, dtype=torch.float32, device=dev).index_add_(
            0, torch.where(bmask & (vtrace >= 0), vtrace, cap).long(),
            torch.ones(cap, dtype=torch.float32, device=dev))[:cap]
        spts, smask, srows, sweights = compact_rows(vpts, vmask, w_rep)
    else:
        spts, smask, sweights = bpts, bmask, None
    # light outlier clean of the slice, rows kept in place
    smask = statistical_outlier_mask(spts, smask, nb_neighbors=8, std_ratio=3.0)
    counts = radius_count(spts, spts, radius=cfg.base_eps, query_mask=smask,
                          point_mask=smask, weights=sweights)
    core = smask & (counts >= cfg.base_min_points)
    d, i = radius_knn(spts, spts, radius=cfg.base_eps, k=32, query_mask=smask, point_mask=smask)
    blabels = dbscan_from_neighbors(i, d, smask, min_samples=cfg.base_min_points, core=core)
    if coarsen:
        ns = srows.shape[0]
        inv_v = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev).scatter_(
            0, torch.where(smask, srows, cap).long(),
            torch.arange(ns, dtype=torch.int32, device=dev))[:cap]
        crow = inv_v[torch.clamp(vtrace, min=0).long()]
        ok = bmask & (vtrace >= 0) & (crow >= 0)
        blabels = torch.where(ok, blabels[torch.clamp(crow, min=0).long()], -1)
        bmask = ok
    n = points.shape[0]
    dst = torch.where(bmask, bidx, n).long()
    labels = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_(
        0, dst, blabels.to(torch.int32))[:n]
    low = torch.zeros(n + 1, dtype=torch.bool, device=dev).scatter_(0, dst, True)[:n]
    return labels, low, high


def build_trees(points, mask, cfg: IsolationConfig | None = None,
                device: str | torch.device = DEFAULT_DEVICE) -> GrowthResult:
    """Full isolation: voxel representatives at ``max_dist/2`` (Morton-
    ordered) → trunk bases → radius graph (16 neighbors) → region growing
    → labels expanded to every input row. Runs on ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    cfg = cfg or IsolationConfig()
    rep_pts, rep_mask, trace = voxel_downsample(points, cfg.max_dist / 2.0, mask)
    rep_pts, rep_mask, rep_rows = compact_rows(rep_pts, rep_mask)
    mperm = torch.argsort(morton_codes(rep_pts, rep_mask), stable=True)
    rep_pts, rep_mask, rep_rows = rep_pts[mperm], rep_mask[mperm], rep_rows[mperm]
    seed_labels, low, high = id_trunk_bases(rep_pts, rep_mask, cfg)
    search = low | high
    _, nbr_idx = grid_self_radius_knn(rep_pts, radius=cfg.max_dist, k=16, mask=search)
    # compact seed ids to [0, C): the ascending remap keeps the min-id claim
    _, _, seg_vals, _, seg_n = label_segments(seed_labels, u_cap=4096)
    n_seed = int(seg_n)
    if n_seed > 4096:
        uniq = torch.unique(seed_labels[seed_labels >= 0])
        n_seed = uniq.shape[0]
        seg_vals = torch.cat([uniq.to(torch.int32), uniq.new_full((1,), -1).to(torch.int32)])
    ccap = 16
    while ccap < max(n_seed, 1):
        ccap *= 2
    vals_n = seg_vals[:max(n_seed, 1)].contiguous()
    pos = torch.searchsorted(vals_n, seed_labels.contiguous()).to(torch.int32)
    compact = torch.where(seed_labels >= 0, pos, -1)
    res = region_grow(nbr_idx, compact, search, max_cycles=cfg.cycles,
                      min_frontier=cfg.min_frontier, cluster_cap=ccap)
    lut = torch.cat([vals_n, torch.full((1,), -1, dtype=torch.int32, device=dev)])
    labels_rep = torch.where(res.labels >= 0, lut[torch.clamp(res.labels, 0, n_seed).long()], -1)
    n = points.shape[0]
    inv = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_(
        0, torch.where(rep_mask, rep_rows, n).long(),
        torch.arange(rep_rows.shape[0], dtype=torch.int32, device=dev))[:n]
    crow = inv[torch.clamp(trace, min=0).long()]
    ok = mask & (trace >= 0) & (crow >= 0)
    safe = torch.clamp(crow, min=0).long()
    labels_full = torch.where(ok, labels_rep[safe], -1)
    order_full = torch.where(ok, res.order[safe], -1)
    return GrowthResult(labels_full, order_full, res.cycles_run, res.active, res.claim)
