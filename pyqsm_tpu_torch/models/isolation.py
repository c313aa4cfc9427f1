"""Plot-scale tree isolation (counterpart of
``pyqsm_tpu/models/isolation.py``): trunk-base seeds by DBSCAN on the low
z-slice, then synchronous parallel region growing over a radius graph with
a min-cluster-id claim and per-cycle retirement of clusters whose new
frontier is below ``min_frontier``.

Three claims give bit-identical labels: ``gather`` (each unclaimed row
takes the minimum active frontier id among its neighbors), ``push``
(frontier rows scatter-min their id along the transposed graph; the
default at ≥ 262 144 rows) and the opt-in ``band`` (``PYQSM_CLAIM=band``:
the one-hot frontier through the block-banded adjacency, kernel
``csrc/band_matvec_bf16.cu``, plus the exact spill list). The JAX
package's sharded path (``mesh=``) runs in ``parallel/growth.py``.
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
from pyqsm_tpu_torch.ops.band_matvec import BAND_BLOCK, band_apply
from pyqsm_tpu_torch.ops.sparse import (_spill_apply, build_banded, build_transpose_ell,
                                        morton_codes)

BIG = 2 ** 30

# The last band claim's band: rows, cluster cap, resident bytes of the
# window tiles and of the live spill, spill edges. Set by
# ``_region_grow_banded``; read by callers that report the band's size.
LAST_BAND: dict | None = None


class GrowthResult(NamedTuple):
    labels: torch.Tensor  # [N] i32 tree id per point (-1 unclaimed)
    order: torch.Tensor  # [N] i32 cycle at which each point was claimed (-1)
    cycles_run: int
    active: torch.Tensor  # [cluster_cap] bool activity at exit
    claim: str = "gather"  # claim kernel that ran ("gather" | "push" | "band")


def _retire(labels, order, active, newly, c, min_frontier, reduce=None):
    """Shared tail of a claim cycle: retire clusters with fewer than
    ``min_frontier`` new rows, return the next frontier. ``reduce``: sums
    the per-cluster counts over the ranks of a sharded claim."""
    key = torch.where(newly, torch.clamp(labels, 0, c - 1), c).long()
    new_counts = torch.zeros(c + 1, dtype=torch.int32, device=labels.device).index_add_(
        0, key, newly.to(torch.int32))[:c]
    if reduce is not None:
        new_counts = reduce(new_counts)
    active = active & (new_counts >= min_frontier)
    frontier = newly & active[torch.clamp(labels, 0, c - 1).long()]
    return labels, order, active, frontier


def region_grow(nbr_idx: torch.Tensor, seed_labels: torch.Tensor, mask: torch.Tensor,
                max_cycles: int = 200, min_frontier: int = 5, scatter_push: bool = False,
                cluster_cap: int | None = None, active0: torch.Tensor | None = None,
                kt_max: int = 128) -> GrowthResult:
    """Grow all seed clusters at once until no frontier is left.

    ``PYQSM_CLAIM`` (``auto``/``push``/``gather``/``band``) selects the
    claim under the JAX package's conditions (``isolation.py:103-143``):
    - ``band``: the banded claim when ``cluster_cap`` ≤ 128, the row count
      is a multiple of 256 and at least 32 768, the band's bytes fit
      ``PYQSM_BAND_BYTES_BUDGET`` and its spill list does not overflow;
      otherwise gather (never push);
    - ``auto``/``push``: push at ≥ 262 144 rows (or when forced) if the
      transposed graph's in-degree fits ``kt_max``, else gather.
    ``scatter_push`` (in-edges propagate too) runs only on the gather claim.
    ``active0``: [cluster_cap] activity carried in from an earlier chunk."""
    n = nbr_idx.shape[0]
    mode = os.environ.get("PYQSM_CLAIM", "auto")
    use_band = (mode == "band" and not scatter_push and cluster_cap is not None
                and cluster_cap <= 128 and n % BAND_BLOCK == 0 and n >= 32768
                and _band_claim_bytes(n, int(cluster_cap)) <= _band_bytes_budget())
    if use_band:
        b_adj, s_i, s_j, s_w, over = _claim_band(nbr_idx, mask)
        if not bool(over):
            return _region_grow_banded(b_adj, s_i, s_j, s_w, seed_labels, mask, max_cycles,
                                       min_frontier, int(cluster_cap), active0)
        del b_adj, s_i, s_j, s_w
    if (mode in ("auto", "push") and not scatter_push and cluster_cap is not None
            and (n >= 262144 or mode == "push")):
        res = _region_grow_push(nbr_idx, seed_labels, mask, max_cycles, min_frontier,
                                int(cluster_cap), active0, kt_max)
        if res is not None:
            return res
    return _region_grow_gather(nbr_idx, seed_labels, mask, max_cycles, min_frontier,
                               scatter_push, cluster_cap, active0)


def _band_claim_bytes(n: int, cluster_cap: int) -> int:
    """Resident device bytes of the banded claim at ``n`` rows, as the JAX
    package estimates them: the bf16 window tiles (1536 B a row), the
    6n-entry spill triplet and the per-cycle one-hot frontier / proposer
    counts."""
    return n * (1536 + 6 * 10 + 6 * cluster_cap)


def _band_bytes_budget() -> int:
    """Upper bound on the banded claim's device bytes: 8 GiB unless
    ``PYQSM_BAND_BYTES_BUDGET`` says otherwise."""
    return int(os.environ.get("PYQSM_BAND_BYTES_BUDGET", 8 << 30))


def _claim_band(nbr_idx: torch.Tensor, mask: torch.Tensor):
    """Block-banded bf16 adjacency of the masked radius graph (weights 1),
    as one tree of ``build_banded``: ``(b_adj [1, nb, 256, 768], s_i, s_j,
    s_w [1, 6n], overflow)``."""
    n = nbr_idx.shape[0]
    edge = _masked_edges(nbr_idx, mask)
    idx = torch.where(edge, nbr_idx, -1)
    b_adj, s_i, s_j, s_w, over = build_banded(idx[None], edge.to(torch.bfloat16)[None],
                                              spill_cap=6 * n)
    return b_adj, s_i, s_j, s_w, over[0]


def _region_grow_banded(b_adj, s_i, s_j, s_w, seed_labels, mask, max_cycles: int,
                        min_frontier: int, cluster_cap: int,
                        active0: torch.Tensor | None = None) -> GrowthResult:
    """The banded claim, one host-stepped cycle per step (one sync each):
    the bf16 one-hot frontier of active clusters goes through the band
    (``band_apply``: ``band_matvec_bf16`` on the card) and the exact spill;
    each unclaimed row takes the lowest cluster column with a positive
    proposer count — the gather claim's minimum id."""
    global LAST_BAND
    n = seed_labels.shape[0]
    dev = seed_labels.device
    c = int(cluster_cap)
    # the spill is front-packed (dead entries point at row n): apply only
    # its live prefix
    n_spill = int((s_i[0] < n).sum())
    s_i, s_j, s_w = s_i[:, :n_spill], s_j[:, :n_spill], s_w[:, :n_spill]
    LAST_BAND = dict(rows=n, cluster_cap=c, spill_edges=n_spill,
                     band_bytes=b_adj.numel() * b_adj.element_size(),
                     spill_bytes=n_spill * (4 + 4 + s_w.element_size()))
    cids = torch.arange(c, dtype=torch.int32, device=dev)
    labels = torch.where(mask, seed_labels.to(torch.int32), -1)
    frontier = labels >= 0
    order = torch.where(frontier, 0, -1).to(torch.int32)
    active = _initial_activity(active0, c, dev)
    cyc = 0
    while cyc < max_cycles and bool(frontier.any()):
        lab_c = torch.clamp(labels, 0, c - 1)
        prop = frontier & active[lab_c.long()] & (labels >= 0)
        onehot = (prop[:, None] & (lab_c[:, None] == cids[None, :])).to(torch.bfloat16)[None]
        y = band_apply(b_adj, onehot) + _spill_apply(s_i, s_j, s_w, onehot, n, sorted_dst=True)
        cand = torch.where(y[0] > 0, cids, BIG).amin(dim=1)  # lowest set column
        newly = mask & (labels < 0) & (cand < BIG)
        labels = torch.where(newly, cand, labels)
        order = torch.where(newly, cyc + 1, order).to(torch.int32)
        labels, order, active, frontier = _retire(labels, order, active, newly, c,
                                                  min_frontier)
        cyc += 1
    return GrowthResult(labels, order, cyc, active, "band")


def _masked_edges(nbr_idx: torch.Tensor, mask: torch.Tensor):
    n = nbr_idx.shape[0]
    return (nbr_idx >= 0) & mask[:, None] & mask[torch.clamp(nbr_idx, 0, n - 1).long()]


def _region_grow_gather(nbr_idx, seed_labels, mask, max_cycles, min_frontier,
                        scatter_push=False, cluster_cap=None, active0=None) -> GrowthResult:
    n = nbr_idx.shape[0]
    dev = nbr_idx.device
    c = n if cluster_cap is None else int(cluster_cap)
    gidx = torch.clamp(nbr_idx, min=0).long()
    edge = _masked_edges(nbr_idx, mask)
    labels = torch.where(mask, seed_labels.to(torch.int32), -1)
    frontier = labels >= 0
    order = torch.where(frontier, 0, -1).to(torch.int32)
    active = _initial_activity(active0, c, dev)
    cyc = 0
    while cyc < max_cycles and bool(frontier.any()):
        act_self = active[torch.clamp(labels, 0, c - 1).long()]
        code = torch.where(frontier & act_self & (labels >= 0), labels, BIG)
        cand = torch.where(edge, code[gidx], BIG).amin(dim=1)
        if scatter_push:
            # in-edges too: frontier rows push their id at their neighbors
            push_lab = torch.where((frontier & act_self)[:, None] & edge, labels[:, None], BIG)
            tgt = torch.where(edge, gidx, n)
            cand_in = torch.full((n + 1,), BIG, dtype=torch.int32, device=dev).scatter_reduce_(
                0, tgt.reshape(-1), push_lab.reshape(-1).to(torch.int32), "amin")[:n]
            cand = torch.minimum(cand, cand_in)
        newly = mask & (labels < 0) & (cand < BIG)
        labels = torch.where(newly, cand, labels)
        order = torch.where(newly, cyc + 1, order).to(torch.int32)
        labels, order, active, frontier = _retire(labels, order, active, newly, c,
                                                  min_frontier)
        cyc += 1
    return GrowthResult(labels, order, cyc, active, "gather")


def _initial_activity(active0, c: int, dev) -> torch.Tensor:
    if active0 is None:
        return torch.ones(c, dtype=torch.bool, device=dev)
    return torch.as_tensor(active0, device=dev).to(torch.bool)


def _region_grow_push(nbr_idx, seed_labels, mask, max_cycles, min_frontier, cluster_cap,
                      active0=None, kt_max=128) -> GrowthResult | None:
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
    active = _initial_activity(active0, c, dev)
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
        labels, order, active, frontier = _retire(labels, order, active, newly, c,
                                                  min_frontier)
        nf = int(frontier.sum())
        cyc += 1
    return GrowthResult(labels, order, cyc, active, "push")


def id_trunk_bases(points: torch.Tensor, mask: torch.Tensor, cfg: IsolationConfig | None = None,
                   exclude_regions: list | None = None, clean: bool = True,
                   coarsen_rows: int = 65536):
    """Trunk-base seed clusters on the low z-slice: ``(seed_labels [N],
    low_mask [N], high_mask [N])``. Above ``coarsen_rows`` slice rows the
    slice is re-voxeled at eps/8 and core counts weigh each
    representative by the rows it stands for. ``clean``: a light
    statistical outlier clean of the slice first (rows kept in place)."""
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
    if clean:
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


def _observed_growth(nbr_idx, compact, search, cfg, ccap, rep_pts, observer,
                     observe_every) -> GrowthResult:
    """Growth in chunks of ``observe_every`` cycles, each resumed from the
    claimed labels with the previous chunk's activity; the observer sees
    the state after every chunk."""
    labels_c = compact
    order_c = torch.where(labels_c >= 0, 0, -1).to(torch.int32)
    active_c = None
    done = 0
    res = None
    while done < cfg.cycles:
        chunk = min(observe_every, cfg.cycles - done)
        res = region_grow(nbr_idx, labels_c, search, max_cycles=chunk,
                          min_frontier=cfg.min_frontier, cluster_cap=ccap, active0=active_c)
        ran = res.cycles_run
        order_c = torch.where((order_c < 0) & (res.order > 0), done + res.order,
                              order_c).to(torch.int32)
        labels_c, active_c = res.labels, res.active
        done += ran
        observer(done, rep_pts, labels_c, order_c)
        if ran < chunk:  # converged inside the chunk
            break
    return GrowthResult(labels_c, order_c, done, active_c, res.claim)


def build_trees(points, mask, cfg: IsolationConfig | None = None,
                exclude_regions: list | None = None, neighbor_cap: int = 16,
                pre_voxel: float | None = None, observer=None, observe_every: int = 20,
                mesh=None, device: str | torch.device = DEFAULT_DEVICE) -> GrowthResult:
    """Full isolation: voxel representatives at ``pre_voxel`` (default
    ``max_dist/2``; Morton-ordered) → trunk bases (outside
    ``exclude_regions``) → radius graph (``neighbor_cap`` neighbors) →
    region growing → labels expanded to every input row. Runs on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``observer``: optional ``callable(cycle, points, labels, order)`` fired
    every ``observe_every`` cycles with the representatives and their
    current (compacted) labels and claim cycles as torch tensors. Growth
    then runs in chunks with the clusters' activity carried across, as in
    the JAX package (``isolation.py:608-635``).

    ``mesh``: a ``parallel.mesh.Mesh`` — every rank calls with the same
    inputs, the growth runs sharded over the ranks
    (``parallel.growth.region_grow_sharded``) and every rank gets the full
    result; ``device`` must name the rank's mesh device."""
    dev = resolve_device(device, mesh)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    cfg = cfg or IsolationConfig()
    if pre_voxel is None:
        pre_voxel = cfg.max_dist / 2.0
    rep_pts, rep_mask, trace = voxel_downsample(points, pre_voxel, mask)
    rep_pts, rep_mask, rep_rows = compact_rows(rep_pts, rep_mask)
    mperm = torch.argsort(morton_codes(rep_pts, rep_mask), stable=True)
    rep_pts, rep_mask, rep_rows = rep_pts[mperm], rep_mask[mperm], rep_rows[mperm]
    seed_labels, low, high = id_trunk_bases(rep_pts, rep_mask, cfg, exclude_regions)
    search = low | high
    _, nbr_idx = grid_self_radius_knn(rep_pts, radius=cfg.max_dist, k=neighbor_cap,
                                      mask=search, sort=False, need_dists=False)
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
    if mesh is not None:
        from pyqsm_tpu_torch.parallel.growth import region_grow_sharded

        res = region_grow_sharded(nbr_idx, compact, search, mesh, max_cycles=cfg.cycles,
                                  min_frontier=cfg.min_frontier, cluster_cap=ccap)
    elif observer is not None:
        res = _observed_growth(nbr_idx, compact, search, cfg, ccap, rep_pts, observer,
                               observe_every)
    else:
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
