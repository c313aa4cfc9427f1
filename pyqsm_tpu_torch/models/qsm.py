"""Sphere-following QSM generation (counterpart of ``pyqsm_tpu/models/qsm.py``).

The reference's recursive ``sphere_step`` is a worklist of branch fronts:
each front is a fixed-width block of row indices, every step (RANSAC
cylinder fit, ball query, DBSCAN split) is a batched tensor computation,
and the host runs the queue and the fragmentation policy. Three dispatch
forms, as in the JAX package:

- the chain (``_qsm_chain_fused``): one live front a tree climbs up to
  ``chain_steps`` steps with the single-child advance decided on the
  device; the JAX package's ``lax.while_loop`` is a host loop that reads
  one ``alive`` flag a step;
- the wave (``_qsm_wave_fused``): up to ``wave_size`` fronts in one
  dispatch, the earliest slot owning a contested point;
- the forest (``sphere_qsm_forest``): every tree's chain in one batched
  dispatch a round, over ``parallel.mesh`` ranks with ``mesh=`` (a block
  of trees a rank), then the wave walk for the trees that fragmented.

Every device step works on a leading batch axis (trees, or a wave's
fronts) and keeps each row's arithmetic independent of the batch: sums are
rounded once from float64, top-k takes exact (distance, index) keys, and
the block kNN is elementwise, so ``forest([A, B])`` equals ``forest([A])``
and ``forest([B])`` on the card too. The fragmentation policy is host
numpy, as in the JAX package.

Random draws: the walk's draws (each fit's hypotheses, k-means' first
centre) come from ``walk_draws(seed)``, one chain a tree with the JAX
package's round structure: each dispatch splits it into one stream a fit
slot (``chain_steps`` or ``wave_size`` of them, whether those steps run or
not) and one stream for the k-means sweep, which all three k of every
sweep in that dispatch start from. The default streams are CPU
``torch.Generator`` seeds, so the card and the CPU draw alike; torch
cannot reproduce ``jax.random``, so one seed picks other hypotheses than
the JAX package does. The parity tests replace ``walk_draws`` (and the two
draw functions, ``ops/ransac.hypothesis_rows`` and
``ops/cluster.first_center``) with the JAX package's keys.

``SYNCS`` counts the walk's host reads: one ``alive`` flag a chain step and
one readback a dispatch (the DBSCAN rounds' flags are ``ops/cluster``'s).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.config import Config, DBSCANConfig, SphereConfig, StemConfig
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pyqsm_tpu_torch.ops import cluster
from pyqsm_tpu_torch.ops.geometry import crop_mask, percentile_mask
from pyqsm_tpu_torch.ops.neighbors import _fma, _ordered_key, _sq3, _sqrt, knn
from pyqsm_tpu_torch.ops.normals import estimate_normals, filter_by_norm
from pyqsm_tpu_torch.ops.ransac import CylinderFit, fit_cylinder
from pyqsm_tpu_torch.state import Cylinders

SYNCS = 0  # host reads of the walk: chain alive flags and dispatch readbacks
THRESHOLD = 0.04  # circle-inlier band of every walk fit (ref qsm_generation.py:138-179)
N_HYPOTHESES = 512  # RANSAC hypotheses a fit (the JAX package's step kernels' default)
_I64_MAX = torch.iinfo(torch.int64).max


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


class Stream(NamedTuple):
    """One draw stream: every consumer starts a fresh CPU generator from
    its seed, so two consumers of one stream draw alike (the JAX package
    hands one key to several consumers)."""

    seed: int

    def generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed)


class WalkDraws:
    """A tree's chain of draws, from a CPU generator seeded ``seed``."""

    def __init__(self, seed: int):
        self._gen = torch.Generator().manual_seed(int(seed))

    def split(self, n_fits: int) -> tuple[list, object]:
        """One dispatch's streams: ``n_fits`` fit streams and the sweep's."""
        seeds = torch.randint(0, 2 ** 62, (n_fits + 1,), generator=self._gen).tolist()
        return [Stream(s) for s in seeds[:n_fits]], Stream(seeds[-1])


def walk_draws(seed: int) -> WalkDraws:
    """The draw chain a walk starts from ``seed`` (replaceable: the parity
    tests put the JAX package's keys here)."""
    return WalkDraws(seed)


# ---------------------------------------------------------------------------
# stem filter
# ---------------------------------------------------------------------------


def stem_mask(points: torch.Tensor, mask: torch.Tensor,
              cfg: StemConfig | None = None) -> torch.Tensor:
    """Near-vertical-surface filter (ref ``get_stem_pcd``): crop the ground
    +0.5 m, estimate normals, keep rows whose normals lie within
    ``angle_cutoff`` degrees of horizontal."""
    if cfg is None:
        cfg = StemConfig()
    zmin = torch.where(mask, points[:, 2], math.inf).amin()
    m = crop_mask(points, mask, minz=zmin + _f32(0.5).to(points.device))
    normals = estimate_normals(points, m, k=cfg.normals_nn)
    return filter_by_norm(normals, m, angle_cutoff=cfg.angle_cutoff)


# ---------------------------------------------------------------------------
# batched device steps: leading axis B (trees or wave slots), one cloud a row
# ---------------------------------------------------------------------------


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, 3] at rows idx [B, P] (-1 reads row 0)."""
    g = torch.clamp(idx, min=0).long()
    return torch.gather(points, 1, g[..., None].expand(g.shape + (3,)))


def _wsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 sum rounded once from float64 (order-free in practice)."""
    return x.double().sum(dim).float()


def _xy_dist(block: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    dx = block[..., 0] - cx[..., None]
    dy = block[..., 1] - cy[..., None]
    return _sqrt(_fma(dy, dy, dx * dx))


def _scatter_last(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(val)`` per batch row ([B, N] ← [B, P]) with the
    last of duplicate writes winning, as XLA's serial CPU scatter does."""
    b, n = dst.shape
    g = torch.clamp(idx, min=0).long() + torch.arange(b, device=dst.device)[:, None] * n
    pos = torch.arange(idx.shape[1], device=dst.device).expand_as(g)
    last = torch.full((b * n,), -1, dtype=torch.int64, device=dst.device)
    last.scatter_reduce_(0, g.reshape(-1), pos.reshape(-1), "amax")
    last = last.view(b, n)
    hit = last >= 0
    got = torch.gather(val, 1, torch.clamp(last, min=0))
    return torch.where(hit, got, dst)


def _claim(found: torch.Tensor, new_idx: torch.Tensor, new_valid: torch.Tensor) -> torch.Tensor:
    """``found.at[max(idx, 0)].set(valid | found[max(idx, 0)])``."""
    cur = torch.gather(found, 1, torch.clamp(new_idx, min=0).long())
    return _scatter_last(found, new_idx, new_valid | cur)


def _fit_front(points, fidx, fvalid, streams, max_radius, min_radius: float) -> CylinderFit:
    block = _gather_rows(points, fidx)
    return fit_cylinder(block, fvalid, [s.generator() for s in streams], threshold=THRESHOLD,
                        n_hypotheses=N_HYPOTHESES, max_radius=max_radius,
                        min_radius=min_radius)


def _ball_new(points, mask, found, fidx, fvalid, radius_multiplier: float,
              min_radius: float, max_radius: float, last_radius, cap: int):
    """Centroid-ball query excluding claimed rows: ``(new_idx [B, cap],
    new_valid, center [B, 3], radius [B])``, the ``cap`` nearest
    candidates in (distance, row) order."""
    dev = points.device
    block = _gather_rows(points, fidx)
    w = fvalid.to(points.dtype)
    n_f = torch.clamp(w.sum(-1), min=1.0)
    center = _wsum(block * w[..., None], 1) / n_f[:, None]
    mean_d = _wsum(_xy_dist(block, center[:, 0], center[:, 1]) * w, 1) / n_f
    mean_d = torch.maximum(mean_d, last_radius)
    radius = torch.clamp(mean_d * _f32(radius_multiplier).to(dev), min_radius, max_radius)
    d = _sqrt(_sq3(points - center[:, None, :]))  # [B, N]
    cand = mask & ~found & (d <= radius[:, None]) & fvalid.any(-1, keepdim=True)
    key = torch.where(cand, _ordered_key(d), _I64_MAX)
    k = min(cap, key.shape[1])
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    valid = top != _I64_MAX
    new_idx = torch.where(valid, top & 0xFFFFFFFF, -1).to(torch.int32)
    if k < cap:
        new_idx = torch.cat([new_idx, new_idx.new_full((new_idx.shape[0], cap - k), -1)], 1)
        valid = torch.cat([valid, valid.new_zeros((valid.shape[0], cap - k))], 1)
    return new_idx, valid, center, radius


def _block_knn(block: torch.Tensor, valid: torch.Tensor, k: int):
    """``knn(block, block, k)`` within each row of [B, P, 3] (masks both
    sides) as the elementwise form of its ``|q|² + |p|² − 2 q·p`` tiles
    (the dot a fused multiply-add chain) with exact (d², column) top-k:
    the same values as ``ops/neighbors.knn``, no host read, and no GEMM
    whose rounding could follow the batch's size."""
    pts = torch.where(valid[..., None], block, math.inf)
    sq = _sq3(pts)
    sq_p = torch.where(torch.isfinite(sq), sq, math.inf)
    sq_q = torch.where(torch.isfinite(sq), sq, 1e30)
    f = torch.where(torch.isfinite(pts), pts, 0.0)
    q, p = f[:, :, None, :], f[:, None, :, :]
    dot = _fma(q[..., 2], p[..., 2], _fma(q[..., 1], p[..., 1], q[..., 0] * p[..., 0]))
    d2 = (sq_q[:, :, None] + sq_p[:, None, :]) - 2.0 * dot
    kk = min(k, d2.shape[-1])
    col = torch.topk(_ordered_key(d2), kk, dim=-1, largest=False, sorted=True).values & 0xFFFFFFFF
    dd = torch.gather(d2, -1, col)
    idx = torch.where(valid[:, None, :].expand_as(d2).gather(-1, col), col, -1).to(torch.int32)
    if kk < k:
        dd = torch.cat([dd, dd.new_full(dd.shape[:-1] + (k - kk,), math.inf)], -1)
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (k - kk,), -1)], -1)
    dd = torch.where(valid[..., None] & (idx >= 0), dd, math.inf)
    idx = torch.where(valid[..., None], idx, -1)
    return _sqrt(torch.clamp(dd, min=0.0)), idx


def _dbscan_rows(nbr_idx: torch.Tensor, valid: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """``dbscan_from_neighbors`` on each row of a [B, P, k] batch of
    neighbour lists: labels compacted within each row."""
    b, p, _ = nbr_idx.shape
    off = (torch.arange(b, device=nbr_idx.device) * p).to(torch.int32)[:, None, None]
    flat = torch.where(nbr_idx >= 0, nbr_idx + off, -1).reshape(b * p, -1)
    lab = cluster.dbscan_from_neighbors(flat, None, valid.reshape(-1), core=core.reshape(-1))
    # compacted over the whole batch in root order: rows' ids stay in order,
    # so each row's ids are a contiguous run; shift them to start at 0
    lab = lab.view(b, p)
    first = torch.where(lab >= 0, lab, torch.iinfo(torch.int32).max).amin(-1, keepdim=True)
    return torch.where(lab >= 0, lab - first, -1)


def _split_dbscan(points, new_idx, new_valid, eps, min_pts: int, cap_nbrs: int = 32):
    """DBSCAN within each new-points block, density-adaptive as the JAX
    package's: eps grows to 2.5× the block's mean nearest-neighbour
    distance, min_samples shrinks to 15 % of a small block."""
    dev = points.device
    block = _gather_rows(points, new_idx)
    # one neighbour query serves both of the JAX package's (k = 2 and
    # cap_nbrs): the sorted lists' first columns are the k = 2 query's
    d, i = _block_knn(block, new_valid, cap_nbrs)
    nn = torch.where(torch.isfinite(d[..., 1]), d[..., 1], 0.0)
    n_live = torch.clamp(new_valid.sum(-1, dtype=torch.int32), min=1)
    mean_nn = _wsum(torch.where(new_valid, nn, 0.0), 1) / n_live.to(torch.float32)
    eps_eff = torch.maximum(eps, _f32(2.5).to(dev) * mean_nn)
    min_eff = torch.minimum(torch.tensor(min_pts, dtype=torch.int32, device=dev), torch.clamp(
        (_f32(0.15).to(dev) * n_live.to(torch.float32)).to(torch.int32), min=3))
    i = torch.where(d <= eps_eff[:, None, None], i, -1)
    n_nbrs = ((i >= 0) & new_valid[..., None]).sum(-1, dtype=torch.int32)
    core = new_valid & (n_nbrs >= min_eff[:, None])
    return _dbscan_rows(i, new_valid, core)


def _split_kmeans(points, new_idx, new_valid, k: int, stream, score_cap: int = 256):
    block = points[torch.clamp(new_idx, min=0).long()]
    _, labels = cluster.kmeans(block, new_valid, k, stream.generator())
    p = block.shape[0]
    if p > score_cap:
        sub = torch.arange(score_cap, device=block.device) * (p // score_cap)
        score = cluster.silhouette_score(block[sub], labels[sub], new_valid[sub])
    else:
        score = cluster.silhouette_score(block, labels, new_valid)
    return labels, score


def _split_kmeans_sweep(points, new_idx, new_valid, stream):
    """The reference's k-means sweep (k ∈ {2, 3, 4}): every k starts from
    the same stream, as the JAX package gives all three one key."""
    outs = [_split_kmeans(points, new_idx, new_valid, k, stream) for k in (2, 3, 4)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _cluster_xy_radius(points: torch.Tensor, idx: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Mean XY distance from the centroid over the selected block rows."""
    block = points[torch.clamp(idx, min=0).long()]
    w = sel.to(points.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    cx = _wsum(block[:, 0] * w, 0) / n
    cy = _wsum(block[:, 1] * w, 0) / n
    return _wsum(_xy_dist(block, cx, cy) * w, 0) / n


def _chain_step_policy(points, labels, new_idx, new_valid, blocks, last_radius,
                       min_radius: float, max_radius: float, min_contained: int, cap: int):
    """The chain's device-side advance decision: ``(n_usable, child_idx,
    child_valid, child_r)``. The biggest cluster, with noise re-attached
    within branch scale of its centroid, is the child front."""
    dev = points.device
    b = labels.shape[0]
    lab_key = torch.where(new_valid & (labels >= 0), torch.clamp(labels, 0, cap - 1), cap).long()
    counts = torch.zeros((b, cap + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, lab_key, torch.ones_like(lab_key, dtype=torch.int32))[:, :cap]
    n_usable = (counts >= min_contained).sum(-1)
    best_lab = counts.argmax(-1, keepdim=True)
    sel = new_valid & (labels == best_lab)
    w = sel.to(points.dtype)
    n_sel = torch.clamp(w.sum(-1), min=1.0)
    cent = _wsum(blocks * w[..., None], 1) / n_sel[:, None]
    dist_c = _sqrt(_sq3(blocks - cent[:, None, :]))
    near = torch.clamp(_f32(2.2).to(dev) * last_radius, min=0.3)
    sel = sel | (new_valid & (labels < 0) & (dist_c <= near[:, None]))
    w = sel.to(points.dtype)
    n_sel = torch.clamp(w.sum(-1), min=1.0)
    cx = _wsum(blocks[..., 0] * w, 1) / n_sel
    cy = _wsum(blocks[..., 1] * w, 1) / n_sel
    child_r = torch.clamp(_wsum(_xy_dist(blocks, cx, cy) * w, 1) / n_sel, min_radius, max_radius)
    child_r = torch.maximum(child_r, last_radius / 2.0)
    order = torch.sort(torch.where(sel, 0, 1), dim=-1, stable=True).indices
    n_child = sel.sum(-1, keepdim=True)
    child_idx = torch.where(torch.arange(cap, device=dev) < n_child,
                            torch.gather(new_idx, 1, order), -1).to(torch.int32)
    return n_usable, child_idx, child_idx >= 0, child_r


def _qsm_chain_fused(points, mask, found, fidx, fvalid, streams, last_radius, eps,
                     sphere: SphereConfig, min_pts: int, cap: int, chain_steps: int = 4):
    """Advance each row's front ([B] trees, one front each) through up to
    ``chain_steps`` sequential sphere steps. ``streams[b][s]`` is row b's
    fit stream of step s. A row stops when its front fragments (not exactly
    one usable cluster, or too few new points); rows that stopped claim
    nothing more and leave their later ``per`` rows zero. The loop reads
    the rows' ``alive`` flags once a step and ends when none is left.
    Returns ``(found, per, fidx, fvalid, last_radius)``, ``per`` holding
    [B, S, ...] step records."""
    global SYNCS
    dev = points.device
    b, s_n = fidx.shape[0], chain_steps
    f32, i32 = torch.float32, torch.int32
    per = dict(
        fidx=torch.full((b, s_n, cap), -1, dtype=i32, device=dev),
        fvalid=torch.zeros((b, s_n, cap), dtype=torch.bool, device=dev),
        lr=torch.zeros((b, s_n), dtype=f32, device=dev),
        good=torch.zeros((b, s_n), dtype=torch.bool, device=dev),
        advanced=torch.zeros((b, s_n), dtype=torch.bool, device=dev),
        radius=torch.zeros((b, s_n), dtype=f32, device=dev),
        axis=torch.zeros((b, s_n, 3), dtype=f32, device=dev),
        center=torch.zeros((b, s_n, 3), dtype=f32, device=dev),
        height=torch.zeros((b, s_n), dtype=f32, device=dev),
        new_idx=torch.full((b, s_n, cap), -1, dtype=i32, device=dev),
        new_valid=torch.zeros((b, s_n, cap), dtype=torch.bool, device=dev),
        labels=torch.full((b, s_n, cap), -1, dtype=i32, device=dev),
        blocks=torch.zeros((b, s_n, cap, 3), dtype=points.dtype, device=dev),
        child_r=torch.zeros((b, s_n), dtype=f32, device=dev),
    )
    lr = last_radius.to(f32)
    alive = fvalid.any(-1)
    mult = _f32(sphere.radius_multiplier).to(dev)
    bad = _f32(sphere.bad_fit_radius_factor).to(dev)
    for s in range(s_n):
        SYNCS += 1
        if not bool(alive.any()):
            break
        fit = _fit_front(points, fidx, fvalid, [st[s] for st in streams], lr * mult,
                         sphere.min_radius)
        new_idx, new_valid, _, _ = _ball_new(points, mask, found, fidx, fvalid,
                                             sphere.radius_multiplier, sphere.min_radius,
                                             sphere.max_radius, lr, cap)
        new_valid = new_valid & alive[:, None]
        labels = _split_dbscan(points, new_idx, new_valid, eps, min_pts)
        found = _claim(found, new_idx, new_valid)
        blocks = _gather_rows(points, new_idx)
        n_front = fvalid.sum(-1, dtype=i32)
        n_new = new_valid.sum(-1, dtype=i32)
        need = torch.clamp((_f32(0.25).to(dev) * n_front.to(f32)).to(i32),
                           min=sphere.min_contained_points)
        good = fit.ok & (fit.radius < bad * lr) & (fit.n_inliers >= need)
        n_usable, child_idx, child_valid, child_r = _chain_step_policy(
            points, labels, new_idx, new_valid, blocks, lr, sphere.min_radius,
            sphere.max_radius, sphere.min_contained_points, cap)
        advanced = alive & (n_new >= sphere.min_contained_points) & (n_usable == 1)
        rec = dict(fidx=fidx, fvalid=fvalid, lr=lr, good=good & alive, advanced=advanced,
                   radius=fit.radius, axis=fit.axis, center=fit.center, height=fit.height,
                   new_idx=new_idx, new_valid=new_valid, labels=labels, blocks=blocks,
                   child_r=child_r)
        for name, v in rec.items():
            a = alive.view((b,) + (1,) * (v.dim() - 1))
            per[name][:, s] = torch.where(a, v, per[name][:, s])
        a2 = alive[:, None]
        fidx = torch.where(a2, torch.where(advanced[:, None], child_idx, -1), fidx)
        fvalid = torch.where(a2, advanced[:, None] & child_valid, fvalid)
        lr = torch.where(alive, child_r, lr)
        alive = advanced
    return found, per, fidx, fvalid, lr


def _qsm_wave_fused(points, mask, found, fidx, fvalid, streams, last_radius, eps,
                    sphere: SphereConfig, min_pts: int, cap: int):
    """A wave of W fronts on one cloud in one dispatch: batched fit, ball
    and split, the earliest slot owning a point several slots claim.
    Returns ``(found, stats, new_idx, new_valid, labels, blocks)``."""
    dev = points.device
    w_n, n = fidx.shape[0], points.shape[0]
    pts = points[None].expand(w_n, -1, -1)
    msk = mask[None].expand(w_n, -1)
    fnd = found[None].expand(w_n, -1)
    fit = _fit_front(pts, fidx, fvalid, streams, last_radius * _f32(sphere.radius_multiplier).to(dev),
                     sphere.min_radius)
    new_idx, new_valid, _, _ = _ball_new(pts, msk, fnd, fidx, fvalid, sphere.radius_multiplier,
                                         sphere.min_radius, sphere.max_radius, last_radius, cap)
    slot = torch.arange(w_n, device=dev)[:, None].expand_as(new_idx)
    tgt = torch.where(new_valid, new_idx.long(), n)
    owner = torch.full((n + 1,), w_n, dtype=torch.int64, device=dev)
    owner.scatter_reduce_(0, tgt.reshape(-1), slot.reshape(-1), "amin")
    new_valid = new_valid & (owner[torch.clamp(new_idx, min=0).long()] == slot)
    for wi in range(w_n):
        found = _claim(found[None], new_idx[wi:wi + 1], new_valid[wi:wi + 1])[0]
    labels = _split_dbscan(pts, new_idx, new_valid, eps.expand(w_n), min_pts)
    stats = dict(radius=fit.radius, axis=fit.axis, center=fit.center, height=fit.height,
                 ok=fit.ok, n_inliers=fit.n_inliers, n_front=fvalid.sum(-1, dtype=torch.int32))
    blocks = _gather_rows(pts, new_idx)
    return found, stats, new_idx, new_valid, labels, blocks


# ---------------------------------------------------------------------------
# worklist orchestration
# ---------------------------------------------------------------------------


class Front(NamedTuple):
    idx: torch.Tensor  # [P] i32
    valid: torch.Tensor  # [P] bool
    last_radius: float
    branch_order: int
    parent: int  # cylinder id of the parent (-1 root)


class QSMResult(NamedTuple):
    cylinders: Cylinders
    found: torch.Tensor  # [N] bool — rows the walk claimed
    branch_order: torch.Tensor  # [N] i32 per row (-1 unclaimed)
    n_steps: int


def _to_host(tree):
    """One readback of (nested dicts and tuples of) tensors as numpy."""
    global SYNCS
    SYNCS += 1

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return x.cpu().numpy()

    return conv(tree)


def _eps_floor(points: torch.Tensor, mask: torch.Tensor, epsilon: float) -> float:
    """The split's eps floored at 2.5× the mean nearest-neighbour spacing
    of up to 2048 strided live rows (the voxel ladder's coarse clouds
    space points beyond the config eps)."""
    live = np.flatnonzero(mask.cpu().numpy())
    if len(live) == 0:
        return epsilon
    stride = max(len(live) // 2048, 1)
    rows = torch.as_tensor(live[::stride][:2048], device=points.device)
    d2, _ = knn(points[rows], points, 2, point_mask=mask)
    v = d2[:, 1]
    fin = torch.isfinite(v)
    nn_d = float(_wsum(torch.where(fin, v, 0.0), 0) / fin.sum().to(torch.float32))
    if math.isnan(nn_d):
        nn_d = 0.0
    return max(epsilon, 2.5 * nn_d)


def _pad_front_fn(p: int, device):
    def pad_front(idx_arr: np.ndarray):
        k = min(len(idx_arr), p)
        out = np.full(p, -1, np.int32)
        out[:k] = np.asarray(idx_arr[:k], np.int32)
        t = torch.as_tensor(out, device=device)
        return t, t >= 0
    return pad_front


def _seed_state(n: int, seed_idx: torch.Tensor, seed_valid: torch.Tensor):
    """found and branch order after the seed writes (XLA's scatter: the
    last duplicate write wins, so padding rows can overwrite row 0)."""
    found = _scatter_last(torch.zeros((1, n), dtype=torch.bool, device=seed_idx.device),
                          seed_idx[None], seed_valid[None])[0]
    order = _scatter_last(torch.full((1, n), -1, dtype=torch.int32, device=seed_idx.device),
                          seed_idx[None], torch.where(seed_valid, 0, -1).to(torch.int32)[None])[0]
    return found, order


def sphere_following_qsm(points: torch.Tensor, mask: torch.Tensor, seed_idx, seed_valid,
                         initial_radius: float, sphere: SphereConfig | None = None,
                         dbscan_cfg: DBSCANConfig | None = None, block_size: int = 1024,
                         max_steps: int = 512, max_cylinders: int = 2048, seed: int = 0,
                         wave_size: int = 4, chain_steps: int = 24, _resume: dict | None = None,
                         device: str | torch.device = DEFAULT_DEVICE) -> QSMResult:
    """Run the sphere-following walk from a seed front until exhaustion.

    A single live front climbs as a chain (``chain_steps`` steps a dispatch
    at most); several fronts go as waves of ``wave_size`` (padded with dead
    fronts), the earliest front owning contested rows. ``_resume``: the
    state ``sphere_qsm_forest``'s climb hands over (found, branch_order,
    queue, cylinders, order_updates, steps); the seeds are then ignored.
    Inputs may be numpy arrays or tensors; the walk runs on ``device``."""
    dev = resolve_device(device)
    if sphere is None:
        sphere = SphereConfig()
    if dbscan_cfg is None:
        dbscan_cfg = DBSCANConfig()
    points = torch.as_tensor(points, dtype=torch.float32).to(dev)
    mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    n = points.shape[0]
    p = block_size
    draws = walk_draws(seed)
    eps_f = _eps_floor(points, mask, dbscan_cfg.epsilon)
    if eps_f > dbscan_cfg.epsilon:
        dbscan_cfg = dataclasses.replace(dbscan_cfg, epsilon=eps_f)
    eps = torch.tensor([dbscan_cfg.epsilon], dtype=torch.float32, device=dev)
    pad_front = _pad_front_fn(p, dev)

    if _resume is None:
        seed_idx = torch.as_tensor(seed_idx, dtype=torch.int32).to(dev)
        seed_valid = torch.as_tensor(seed_valid, dtype=torch.bool).to(dev)
        if seed_idx.shape[0] != p:
            si, sv = seed_idx.cpu().numpy(), seed_valid.cpu().numpy()
            seed_idx, seed_valid = pad_front(np.where(sv, si, -1)[sv])
        found, branch_order = _seed_state(n, seed_idx, seed_valid)
        queue = [Front(seed_idx, seed_valid, float(initial_radius), 0, -1)]
        cyls: list[dict] = []
        order_updates: list[tuple[np.ndarray, int]] = []
        steps = 0
    else:
        found = _resume["found"].to(dev)
        branch_order = _resume.get("branch_order")
        branch_order = torch.full((n,), -1, dtype=torch.int32, device=dev) \
            if branch_order is None else branch_order.to(dev)
        queue = list(_resume["queue"])
        cyls = list(_resume.get("cylinders", []))
        order_updates = list(_resume.get("order_updates", []))
        steps = int(_resume.get("steps", 0))
    wave_size = max(int(wave_size), 1)
    pts_b, mask_b = points[None], mask[None]

    while queue and steps < max_steps and len(cyls) < max_cylinders:
        if len(queue) == 1 and chain_steps > 1:
            front = queue.pop(0)
            fit_streams, sweep = draws.split(chain_steps)
            found_b, st_d, f_idx, f_valid, f_lr = _qsm_chain_fused(
                pts_b, mask_b, found[None], front.idx[None], front.valid[None], [fit_streams],
                torch.tensor([front.last_radius], dtype=torch.float32, device=dev), eps,
                sphere, dbscan_cfg.min_neighbors, p, chain_steps)
            found = found_b[0]
            st, f_idx_np, f_valid_np, f_lr_np = _to_host((st_d, f_idx[0], f_valid[0], f_lr[0]))
            st = {k: v[0] for k, v in st.items()}
            steps, parent, stopped = _replay_chain(
                st, chain_steps, steps, front.parent, front.branch_order, cyls, order_updates,
                lambda s, parent, good: _process_front_policy(
                    points, sphere, pad_front, queue, order_updates, float(st["lr"][s]),
                    front.branch_order, parent, good, st["labels"][s].copy(), st["new_idx"][s],
                    st["new_valid"][s], st["blocks"][s], sweep))
            if not stopped and f_valid_np.any():
                queue.append(Front(torch.as_tensor(f_idx_np, device=dev),
                                   torch.as_tensor(f_valid_np, device=dev),
                                   float(f_lr_np), front.branch_order, parent))
            continue

        wave = [queue.pop(0) for _ in range(min(wave_size, len(queue)))]
        steps += len(wave)
        dummy = Front(torch.full((p,), -1, dtype=torch.int32, device=dev),
                      torch.zeros(p, dtype=torch.bool, device=dev), 1.0, 0, -1)
        padded = wave + [dummy] * (wave_size - len(wave))
        fit_streams, sweep = draws.split(wave_size)
        found, stats, new_idx_w, new_valid_w, labels_w, blocks_w = _qsm_wave_fused(
            points, mask, found, torch.stack([f.idx for f in padded]),
            torch.stack([f.valid for f in padded]), fit_streams,
            torch.tensor([f.last_radius for f in padded], dtype=torch.float32, device=dev),
            eps, sphere, dbscan_cfg.min_neighbors, p)
        stats_h, labels_np, idx_np_w, nv_np_w, blocks_np = _to_host(
            (stats, labels_w, new_idx_w, new_valid_w, blocks_w))
        for wi, front in enumerate(wave):
            n_front = int(stats_h["n_front"][wi])
            good_fit = (
                bool(stats_h["ok"][wi])
                and float(stats_h["radius"][wi]) < sphere.bad_fit_radius_factor * front.last_radius
                and int(stats_h["n_inliers"][wi]) >= max(sphere.min_contained_points,
                                                         int(0.25 * n_front)))
            if good_fit:
                cyls.append(dict(center=stats_h["center"][wi], axis=stats_h["axis"][wi],
                                 height=float(stats_h["height"][wi]),
                                 radius=float(stats_h["radius"][wi]),
                                 branch_order=front.branch_order, parent=front.parent))
            cyl_id = len(cyls) - 1 if good_fit else front.parent
            _process_front_policy(points, sphere, pad_front, queue, order_updates,
                                  front.last_radius, front.branch_order, cyl_id, good_fit,
                                  labels_np[wi].copy(), idx_np_w[wi], nv_np_w[wi], blocks_np[wi],
                                  sweep)

    bo = branch_order.cpu().numpy().copy()
    for rows, child_order in order_updates:
        bo[rows] = child_order
    return QSMResult(_pack_cylinders(cyls, max_cylinders, dev), found,
                     torch.as_tensor(bo, device=dev), steps)


def _replay_chain(st: dict, chain_steps: int, steps: int, parent: int, order: int,
                  cyls: list, order_updates: list, on_stop):
    """Host bookkeeping of one front's chain records: cylinders of good
    fits, branch-order writes of advanced steps, and the fragmentation
    policy (``on_stop(s, parent, good)``) at the step that stopped.
    Returns ``(steps, parent, stopped)``."""
    for s in range(chain_steps):
        if int(st["fvalid"][s].sum()) == 0:
            return steps, parent, True
        steps += 1
        good = bool(st["good"][s])
        if good:
            cyls.append(dict(center=st["center"][s], axis=st["axis"][s],
                             height=float(st["height"][s]), radius=float(st["radius"][s]),
                             branch_order=order, parent=parent))
            parent = len(cyls) - 1
        if bool(st["advanced"][s]):
            rows = st["new_idx"][s][st["new_valid"][s]]
            if len(rows):
                order_updates.append((rows.copy(), order))
            continue
        on_stop(s, parent, good)
        return steps, parent, True
    return steps, parent, False


def sphere_qsm_forest(points_t, mask_t, seed_idx_t, seed_valid_t, initial_radius_t,
                      sphere: SphereConfig | None = None, dbscan_cfg: DBSCANConfig | None = None,
                      block_size: int = 1024, max_steps: int = 512, max_cylinders: int = 2048,
                      seeds: list[int] | None = None, mesh=None, chain_steps: int = 24,
                      device: str | torch.device = DEFAULT_DEVICE) -> list[QSMResult]:
    """Sphere-following QSM over a forest of T padded clouds [T, Np, 3]:
    every tree's trunk/branch climb advances in one batched chain dispatch
    a round; trees that fragment finish with the per-tree wave walk
    (``sphere_following_qsm(_resume=...)``). Per-tree results do not depend
    on the batch: ``forest([A, B])`` equals ``forest([A]) + forest([B])``
    given the same per-tree ``seeds``.

    ``mesh`` (a ``parallel.mesh.Mesh``): each rank runs the chain of its
    block of trees (``models/skeleton.tree_block``) and the rounds' records
    are gathered to every rank; each rank then finishes the fragmented
    trees of its block and the results are gathered, so every rank returns
    the whole forest, equal to the single-device run."""
    dev = resolve_device(device, mesh)
    if sphere is None:
        sphere = SphereConfig()
    if dbscan_cfg is None:
        dbscan_cfg = DBSCANConfig()
    points_t = torch.as_tensor(points_t, dtype=torch.float32).to(dev)
    mask_t = torch.as_tensor(mask_t, dtype=torch.bool).to(dev)
    seed_idx_t = torch.as_tensor(seed_idx_t, dtype=torch.int32).to(dev)
    seed_valid_t = torch.as_tensor(seed_valid_t, dtype=torch.bool).to(dev)
    t_n, n = points_t.shape[0], points_t.shape[1]
    p = block_size
    if seeds is None:
        seeds = list(range(t_n))
    pw = seed_idx_t.shape[1]
    if pw < p:
        seed_idx_t = torch.cat([seed_idx_t, seed_idx_t.new_full((t_n, p - pw), -1)], 1)
        seed_valid_t = torch.cat([seed_valid_t, seed_valid_t.new_zeros((t_n, p - pw))], 1)
    elif pw > p:
        seed_idx_t, seed_valid_t = seed_idx_t[:, :p], seed_valid_t[:, :p]

    eps_list = [_eps_floor(points_t[i], mask_t[i], dbscan_cfg.epsilon) for i in range(t_n)]
    eps_t = torch.tensor(eps_list, dtype=torch.float32, device=dev)

    found_t = _claim(torch.zeros((t_n, n), dtype=torch.bool, device=dev), seed_idx_t,
                     seed_valid_t)
    order0 = _scatter_last(torch.zeros((t_n, n), dtype=torch.int32, device=dev), seed_idx_t,
                           seed_valid_t.to(torch.int32))
    order0 = torch.where(order0 > 0, 0, -1).to(torch.int32)

    draws = [walk_draws(sd) for sd in seeds]
    climbing = [bool(seed_valid_t[i].any()) for i in range(t_n)]
    queues: list[list[Front]] = [[] for _ in range(t_n)]
    cyls_t: list[list[dict]] = [[] for _ in range(t_n)]
    order_up_t: list[list] = [[] for _ in range(t_n)]
    parents, orders, steps_t = [-1] * t_n, [0] * t_n, [0] * t_n
    sweeps = [None] * t_n
    pads = [_pad_front_fn(p, dev) for _ in range(t_n)]

    fidx_t = seed_idx_t
    fvalid_t = torch.where(torch.tensor(climbing, device=dev)[:, None], seed_valid_t, False)
    lr_t = torch.tensor(np.asarray(initial_radius_t, np.float32), device=dev)

    max_rounds = -(-max_steps // chain_steps) + 1
    for _ in range(max_rounds):
        if not any(climbing):
            break
        fit_streams = []
        for i in range(t_n):
            fs, sweeps[i] = draws[i].split(chain_steps)
            fit_streams.append(fs)
        found_t, st_d, f_idx_d, f_valid_d, f_lr_d = _chain_batch(
            points_t, mask_t, found_t, fidx_t, fvalid_t, fit_streams, lr_t, eps_t, sphere,
            dbscan_cfg.min_neighbors, p, chain_steps, mesh)
        st, f_idx, f_valid, f_lr = _to_host((st_d, f_idx_d, f_valid_d, f_lr_d))
        fidx_host = fidx_t.cpu().numpy().copy()
        fvalid_host = fvalid_t.cpu().numpy().copy()
        lr_host = lr_t.cpu().numpy().copy()
        for i in range(t_n):
            if not climbing[i]:
                continue
            sti = {k: v[i] for k, v in st.items()}
            order = orders[i]
            steps_t[i], parents[i], stopped = _replay_chain(
                sti, chain_steps, steps_t[i], parents[i], order, cyls_t[i], order_up_t[i],
                lambda s, parent, good, i=i, sti=sti, order=order: _process_front_policy(
                    points_t[i], sphere, pads[i], queues[i], order_up_t[i],
                    float(sti["lr"][s]), order, parent, good, sti["labels"][s].copy(),
                    sti["new_idx"][s], sti["new_valid"][s], sti["blocks"][s], sweeps[i]))
            if (not stopped and f_valid[i].any() and steps_t[i] < max_steps
                    and len(cyls_t[i]) < max_cylinders):
                fidx_host[i], fvalid_host[i], lr_host[i] = f_idx[i], f_valid[i], f_lr[i]
            else:
                climbing[i] = False
                fvalid_host[i] = False
        fidx_t = torch.as_tensor(fidx_host, device=dev)
        fvalid_t = torch.as_tensor(fvalid_host, device=dev)
        lr_t = torch.as_tensor(lr_host, device=dev)

    def finish(i: int) -> QSMResult:
        if queues[i] and steps_t[i] < max_steps:
            return sphere_following_qsm(
                points_t[i], mask_t[i], seed_idx_t[i], seed_valid_t[i], float(lr_t[i]),
                sphere=sphere, dbscan_cfg=dbscan_cfg, block_size=p, max_steps=max_steps,
                max_cylinders=max_cylinders, seed=seeds[i], chain_steps=chain_steps,
                device=dev,
                _resume=dict(found=found_t[i], branch_order=order0[i], queue=queues[i],
                             cylinders=cyls_t[i], order_updates=order_up_t[i],
                             steps=steps_t[i]))
        bo = order0[i].cpu().numpy().copy()
        for rows, child_order in order_up_t[i]:
            bo[rows] = child_order
        return QSMResult(_pack_cylinders(cyls_t[i], max_cylinders, dev), found_t[i],
                         torch.as_tensor(bo, device=dev), steps_t[i])

    if mesh is None:
        return [finish(i) for i in range(t_n)]
    return _finish_sharded(finish, t_n, mesh, dev)


def _chain_batch(points_t, mask_t, found_t, fidx_t, fvalid_t, streams, lr_t, eps_t, sphere,
                 min_pts, cap, chain_steps, mesh):
    """One forest round's chain dispatch: all trees on this device, or each
    rank its block of trees with every output gathered in rank order."""
    args = (points_t, mask_t, found_t, fidx_t, fvalid_t)
    if mesh is None:
        return _qsm_chain_fused(*args, streams, lr_t, eps_t, sphere, min_pts, cap, chain_steps)
    from pyqsm_tpu_torch.models.skeleton import tree_block
    from pyqsm_tpu_torch.parallel.mesh import all_gather_rows

    t_n = points_t.shape[0]
    tb = -(-t_n // mesh.size)
    lo = mesh.rank * tb
    dead = [Stream(0)] * chain_steps
    mine = [streams[i] if i < t_n else dead for i in range(lo, lo + tb)]
    blk = [tree_block(x, mesh.size, mesh.rank) for x in args + (lr_t, eps_t)]
    found, per, fidx, fvalid, lr = _qsm_chain_fused(*blk[:5], mine, blk[5], blk[6], sphere,
                                                    min_pts, cap, chain_steps)

    def gather(x):
        return all_gather_rows(x.contiguous(), mesh)[:t_n]

    return (gather(found), {k: gather(v) for k, v in per.items()}, gather(fidx),
            gather(fvalid), gather(lr))


def _finish_sharded(finish, t_n: int, mesh, dev) -> list[QSMResult]:
    """Each rank finishes the trees of its block; every rank gets all."""
    import torch.distributed as dist

    from pyqsm_tpu_torch.parallel.mesh import _to_cpu

    tb = -(-t_n // mesh.size)
    mine = {i: _to_cpu(finish(i)) for i in range(mesh.rank * tb, min(t_n, (mesh.rank + 1) * tb))}
    parts = [None] * mesh.size
    dist.all_gather_object(parts, mine, group=mesh.group)
    out = {}
    for part in parts:
        out.update(part)
    return [QSMResult(Cylinders(*(f.to(dev) for f in out[i].cylinders)), out[i].found.to(dev),
                      out[i].branch_order.to(dev), out[i].n_steps) for i in range(t_n)]


def _process_front_policy(points, sphere, pad_front, queue, order_updates, last_radius,
                          branch_order, cyl_id, good_fit, lab_np, idx_np, nv_np, block_np,
                          sweep):
    """Host fragmentation policy for one front's new points: k-means sweep
    on bad fits, centroid merge, noise re-attach, children enqueued onto
    ``queue``. Shared by the wave path, the chain's stop step and the
    forest's climb."""
    n_new = int(nv_np.sum())
    if n_new < sphere.min_contained_points:
        return
    if not good_fit:
        # bad fit: the reference switches to a k-means sweep (branches
        # likely split) — one batch of work, one readback
        dev = points.device
        sweep_lab, sweep_score = _to_host(_split_kmeans_sweep(
            points, torch.as_tensor(idx_np, device=dev), torch.as_tensor(nv_np, device=dev),
            sweep))
        bi = int(np.argmax(sweep_score))
        if float(sweep_score[bi]) > 0.4:
            lab_np = np.asarray(sweep_lab[bi])
    lab_np = _merge_close_clusters(block_np, lab_np, merge_dist=max(2.2 * last_radius, 0.15))
    usable = [lab for lab in np.unique(lab_np[lab_np >= 0])
              if (lab_np == lab).sum() >= sphere.min_contained_points]
    if not usable:
        # fragmentation fallback: advance with the whole new set as one front
        lab_np = np.where(nv_np, 0, -1)
        usable = [0]
    else:
        # re-attach DBSCAN noise to the nearest usable cluster within
        # branch scale
        noise = nv_np & (lab_np < 0)
        if noise.any():
            cents = np.stack([block_np[lab_np == lab].mean(axis=0) for lab in usable])
            dd = np.linalg.norm(block_np[noise][:, None, :] - cents[None, :, :], axis=-1)
            nearest = np.argmin(dd, axis=1)
            close = dd[np.arange(len(nearest)), nearest] <= max(2.2 * last_radius, 0.3)
            tgt = np.where(close, np.asarray(usable)[nearest], -1)
            lab_np = lab_np.copy()
            lab_np[np.flatnonzero(noise)] = tgt
    for li, lab in enumerate(usable):
        sel = lab_np == lab
        rows = idx_np[sel]
        if len(rows) < sphere.min_contained_points:
            continue
        # mean XY distance from the cluster centroid (ref get_radius)
        cb = block_np[sel]
        cr = float(np.mean(np.hypot(cb[:, 0] - cb[:, 0].mean(), cb[:, 1] - cb[:, 1].mean())))
        cr = min(max(cr, sphere.min_radius), sphere.max_radius)
        cr = max(cr, last_radius / 2.0)
        child_order = branch_order + (1 if li > 0 else 0)
        order_updates.append((rows.copy(), child_order))
        fidx, fvalid = pad_front(rows)
        queue.append(Front(fidx, fvalid, cr, child_order, cyl_id))


def _merge_close_clusters(block: np.ndarray, labels: np.ndarray, merge_dist: float) -> np.ndarray:
    """Union clusters whose centroids are closer than ``merge_dist``."""
    ids = np.unique(labels[labels >= 0])
    if len(ids) <= 1:
        return labels
    cents = np.stack([block[labels == i].mean(axis=0) for i in ids])
    parent = {int(i): int(i) for i in ids}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a in range(len(ids)):
        for b in range(a + 1, len(ids)):
            if np.linalg.norm(cents[a] - cents[b]) < merge_dist:
                ra, rb = find(int(ids[a])), find(int(ids[b]))
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    out = labels.copy()
    for i in ids:
        out[labels == i] = find(int(i))
    return out


def _pack_cylinders(cyls: list[dict], capacity: int, device) -> Cylinders:
    m = len(cyls)
    cap = max(capacity, m, 1)
    center = np.zeros((cap, 3), np.float32)
    axis = np.zeros((cap, 3), np.float32)
    height = np.zeros(cap, np.float32)
    radius = np.zeros(cap, np.float32)
    order = np.zeros(cap, np.int32)
    parent = np.full(cap, -1, np.int32)
    for i, c in enumerate(cyls):
        center[i], axis[i] = c["center"], c["axis"]
        height[i], radius[i] = c["height"], c["radius"]
        order[i], parent[i] = c["branch_order"], c["parent"]
    mask = np.arange(cap) < m
    return Cylinders(*(torch.as_tensor(a, device=device)
                       for a in (center, axis, height, radius, order, parent, mask)))


def generate_qsm(points, mask, cfg: Config | None = None, block_size: int = 1024,
                 max_steps: int = 512, seed: int = 0,
                 device: str | torch.device = DEFAULT_DEVICE) -> QSMResult:
    """Staged single-tree QSM (ref ``find_low_order_branches``): stem
    filter → trunk-base percentile crop and its largest cluster → seed
    front → sphere-following walk."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = Config()
    points = torch.as_tensor(points, dtype=torch.float32).to(dev)
    mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    stem = stem_mask(points, mask, cfg.stem)
    if int(stem.sum()) < cfg.sphere.min_contained_points:
        stem = mask
    low = percentile_mask(points[:, 2], stem, cfg.trunk.lower_pctile, cfg.trunk.upper_pctile)
    _, trunk = cluster.largest_cluster_mask(points, low, eps=cfg.trunk.cluster_eps,
                                            min_samples=cfg.trunk.cluster_nn, neighbor_cap=64)
    rows = np.flatnonzero(trunk.cpu().numpy())
    if len(rows) == 0:
        rows = np.flatnonzero(stem.cpu().numpy())[:block_size]
    seed_idx = np.full(block_size, -1, np.int32)
    seed_idx[:min(len(rows), block_size)] = rows[:block_size]
    seed_t = torch.as_tensor(seed_idx, device=dev)
    init_r = float(_cluster_xy_radius(points, seed_t, seed_t >= 0))
    init_r = min(max(init_r, cfg.sphere.min_radius), cfg.sphere.max_radius)
    return sphere_following_qsm(points, stem, seed_t, seed_t >= 0, init_r, sphere=cfg.sphere,
                                dbscan_cfg=cfg.dbscan, block_size=block_size,
                                max_steps=max_steps, seed=seed, device=dev)
