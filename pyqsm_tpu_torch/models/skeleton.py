"""Laplacian-contraction skeletonization → topology → QSM (counterpart of
``pyqsm_tpu/models/skeleton.py``: the single-tree ``extract_skeleton`` and
``skeletonize``, ``extract_skeleton_batch`` with its two-level path,
``extract_topology``, ``skeleton_to_qsm``).

The batch of trees is a leading axis ``[T, P, ...]``; the outer contraction
loop is host-stepped as in the JAX package (one iteration per step, with
the per-tree termination and stall tests on the host), and between steps
``_banded_guard`` rebuilds any Laplacian whose banded spill overflowed
before it reaches a solve. The single-tree contraction is the same step on
a batch of one tree, with the exact ELL Laplacian rebuilt every iteration
(no Morton order, no band).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.config import SkeletonizeConfig
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from pyqsm_tpu_torch.ops.geometry import clamp_to_obb, obb_axes
from pyqsm_tpu_torch.ops.graph import SimplifiedGraph, boruvka_mst, simplify_degree2
from pyqsm_tpu_torch.ops.laplacian import point_cloud_laplacian
from pyqsm_tpu_torch.ops.neighbors import knn
from pyqsm_tpu_torch.ops.sampling import farthest_point_sampling, voxel_downsample
from pyqsm_tpu_torch.ops.segment import segment_sum
from pyqsm_tpu_torch.ops.sparse import ELLLaplacian, morton_codes, normal_diag, pcg
from pyqsm_tpu_torch.state import Cylinders, Topology

# A tree whose mass ratio improves by less than this fraction in one
# iteration has reached its contraction fixed point (stall detector).
_STALL_FRAC = 0.05


class SkeletonResult(NamedTuple):
    """Batch results carry the leading trees axis; ``extract_skeleton``'s
    have none ([P, 3] and scalars), as in the JAX package."""

    contracted: torch.Tensor  # [T, P, 3]
    total_shift: torch.Tensor  # [T, P, 3]
    first_shift: torch.Tensor  # [T, P, 3] single-iteration shift
    iterations: torch.Tensor  # [T] i32
    volume_ratio: torch.Tensor  # [T]


def set_amplification(n_points: int, termination_ratio: float) -> tuple[float, float]:
    """Point-count tiers for contraction amplification ('auto' policy)."""
    if n_points < 1_000:
        return 0.01, 1.0
    if n_points < 10_000:
        return 0.007, 2.0
    if n_points < 100_000:
        return 0.003, 5.0
    if n_points < 500_000:
        return 0.004, 5.0
    return 0.003, 5.0


def _masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, v, 0.0).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1)


def _contract_init_batch(pts, msk, n_neighbors, moll, c_factor, a_factor, banded=False):
    """Per-tree OBB frames, initial Laplacians and weights."""
    center, axes, half = obb_axes(pts, msk)
    L0 = point_cloud_laplacian(pts, msk, n_neighbors, moll, banded=banded)
    m0 = L0.mass
    m0_mean = _masked_mean(m0, msk)
    wl0 = (c_factor * 1e3 * torch.sqrt(m0_mean))[:, None].expand(-1, pts.shape[1]).contiguous()
    wh0 = torch.full(msk.shape, a_factor, dtype=pts.dtype, device=pts.device)
    return center, axes, half, L0, m0, m0_mean, wl0, wh0


def _select_L(active: torch.Tensor, new: ELLLaplacian, old: ELLLaplacian) -> ELLLaplacian:
    def pick(a, b):
        if a is None:
            return None
        if isinstance(a, bool):  # t_overflow_any: a tree of either may be kept
            return a or b
        return torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return ELLLaplacian(*[pick(a, b) for a, b in zip(new, old)])


def _contract_step_batch(pts, masks, L, wl, wh, shift, first, ratio, it, m0_mean, m0,
                         center, axes, half, n_neighbors, moll, contraction_factor,
                         max_contraction, max_attraction, termination_ratio, cg_iters,
                         cg_tol=3e-4, banded=False, active=None):
    """ONE contraction iteration for a batch of trees (solve + Laplacian
    rebuild), gated per tree by ``active`` (default ``ratio > termination``)."""
    if active is None:
        active = ratio > termination_ratio
    b = (wh * wh)[..., None] * pts
    diag = normal_diag(L, wl, wh)
    new, _ = pcg((L, wl, wh), b, diag, x0=pts, tol=cg_tol, max_iters=cg_iters)
    new = clamp_to_obb(new, center, axes, half)
    new = torch.where((masks & active[:, None])[..., None], new, pts)
    step_shift = (pts - new) * masks[..., None].to(pts.dtype)
    L_new = point_cloud_laplacian(new, masks, n_neighbors, moll, banded=banded)
    m = L_new.mass
    new_ratio = _masked_mean(m, masks) / torch.clamp(m0_mean, min=1e-30)
    wl_n = torch.clamp(wl * contraction_factor, 0.1, max_contraction)
    wh_n = torch.clamp(wh * torch.sqrt(m0 / torch.clamp(m, min=1e-30)), 0.1, max_attraction)
    a1 = active[:, None]
    a2 = active[:, None, None]
    pts_out = torch.where(a2, new, pts)
    step_shift = torch.where(a2, step_shift, 0.0)
    shift = shift + step_shift
    first = torch.where(a2 & (it[:, None, None] == 0), step_shift, first)
    L_out = _select_L(active, L_new, L)
    wl_out = torch.where(a1, wl_n, wl)
    wh_out = torch.where(a1, wh_n, wh)
    ratio_out = torch.where(active, new_ratio, ratio)
    it_out = it + active.to(torch.int32)
    return pts_out, shift, first, L_out, wl_out, wh_out, ratio_out, it_out


def _contract(points, mask, cfg: SkeletonizeConfig, termination, contraction, cg_iters,
              cg_iters_first, wl_scale=None, cg_tol=3e-4) -> SkeletonResult:
    """The single-tree contraction loop: ``_contract_step_batch`` on a
    batch of one tree with the ELL Laplacian. The first solve has its own
    budget; then the loop goes on while the mass ratio is above
    ``termination``, fewer than ``cfg.max_iter`` iterations ran and the
    last one cut the ratio by at least ``_STALL_FRAC`` (so ``max_iter=1``
    runs exactly one). One host read a step."""
    pts, msk = points[None], mask[None]
    center, axes, half, L, m0, m0_mean, wl, wh = _contract_init_batch(
        pts, msk, cfg.n_neighbors, cfg.moll, contraction, cfg.init_attraction)
    if wl_scale is not None:
        wl = wl * wl_scale[None]
    ratio = torch.ones(1, dtype=pts.dtype, device=pts.device)
    it = torch.zeros(1, dtype=torch.int32, device=pts.device)
    active = torch.ones(1, dtype=torch.bool, device=pts.device)
    shift = first = torch.zeros_like(pts)
    budget = 3 * cg_iters if cg_iters_first is None else cg_iters_first
    while True:
        prev = ratio
        pts, shift, first, L, wl, wh, ratio, it = _contract_step_batch(
            pts, msk, L, wl, wh, shift, first, ratio, it, m0_mean, m0, center, axes, half,
            n_neighbors=cfg.n_neighbors, moll=cfg.moll, contraction_factor=contraction,
            max_contraction=cfg.max_contraction, max_attraction=cfg.max_attraction,
            termination_ratio=termination, cg_iters=budget, cg_tol=cg_tol, active=active)
        budget = cg_iters
        go = (ratio > termination) & (it < cfg.max_iter) & (prev - ratio >= _STALL_FRAC * prev)
        if not bool(go):
            break
    return SkeletonResult(pts[0], shift[0], first[0], it[0], ratio[0])


def extract_skeleton(points, mask, cfg: SkeletonizeConfig | None = None,
                     amplify_auto: bool = True, cg_iters: int = 80, trunk_mask=None,
                     cg_iters_first: int | None = None,
                     device: str | torch.device = DEFAULT_DEVICE) -> SkeletonResult:
    """Contract one cloud [N, 3] (mask [N]) onto its skeleton, on ``device``.

    ``amplify_auto``: under ``"auto"`` amplification pick the tier from the
    live count. ``trunk_mask``: semantic weighting — trunk points get their
    Laplacian rows scaled by ``cfg.semantic_weight``. PCG budgets:
    ``cg_iters`` a solve, the first ``cg_iters_first`` (default
    3·``cg_iters``)."""
    dev = resolve_device(device)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    cfg = cfg or SkeletonizeConfig()
    termination, contraction = cfg.termination_ratio, cfg.init_contraction
    if amplify_auto and cfg.step_wise_contraction_amplification == "auto":
        termination, contraction = set_amplification(int(mask.sum()), termination)
    wl_scale = None
    if trunk_mask is not None:
        wl_scale = torch.where(as_tensor(trunk_mask, dev, torch.bool), cfg.semantic_weight, 1.0)
    return _contract(points, mask, cfg, termination, contraction, cg_iters, cg_iters_first,
                     wl_scale)


def _morton_perm_batch(points, masks):
    return torch.argsort(morton_codes(points, masks), dim=1, stable=True)


def _take(a, perm):
    if a.dim() == 3:
        return torch.gather(a, 1, perm[..., None].expand(-1, -1, a.shape[-1]))
    return torch.gather(a, 1, perm)


def _reorder_rebuild_batch(pts, masks, shift, first, wl, wh, m0, n_neighbors, moll):
    """Re-Morton every tree on its current (contracted) positions and
    rebuild the banded Laplacians — restores the band's locality."""
    perm = _morton_perm_batch(pts, masks)
    pts, masks, shift, first = (_take(a, perm) for a in (pts, masks, shift, first))
    wl, wh, m0 = (_take(a, perm) for a in (wl, wh, m0))
    L = point_cloud_laplacian(pts, masks, n_neighbors, moll, banded=True)
    return perm, pts, masks, shift, first, wl, wh, m0, L


def _banded_guard(pts, masks, shift, first, wl, wh, m0, L, cum, banded_now, active,
                  n_neighbors, moll):
    """Host-stepped spill-overflow rescue: a lossy banded L never reaches a
    solve. If a live tree's spill overflowed, re-Morton the batch on current
    positions and rebuild; if that still overflows, drop the batch to the
    exact ELL form. ``cum`` is the composed row permutation (None until a
    re-sort) so the result can be returned in the caller's row order."""
    if not banded_now or not bool((L.s_overflow & active).any()):
        return pts, masks, shift, first, wl, wh, m0, L, cum, banded_now
    if cum is None:
        cum = torch.arange(pts.shape[1], device=pts.device).expand(masks.shape)
    perm, pts, masks, shift, first, wl, wh, m0, L = _reorder_rebuild_batch(
        pts, masks, shift, first, wl, wh, m0, n_neighbors, moll)
    cum = torch.gather(cum, 1, perm)
    if bool((L.s_overflow & active).any()):
        L = point_cloud_laplacian(pts, masks, n_neighbors, moll, banded=False)
        banded_now = False
    return pts, masks, shift, first, wl, wh, m0, L, cum, banded_now


def _unpermute(res: SkeletonResult, perm) -> SkeletonResult:
    if perm is None:
        return res
    inv = torch.argsort(perm, dim=1)
    return SkeletonResult(_take(res.contracted, inv), _take(res.total_shift, inv),
                          _take(res.first_shift, inv), res.iterations, res.volume_ratio)


def _outer_loop(pts, masks, L, wl, wh, shift, first, ratio, it, m0_mean, m0, center, axes,
                half, cfg, contraction, termination, banded, cg_first, cg_rest):
    """Host-stepped outer iterations with the per-tree stall detector and the
    banded guard. ``cg_first`` budgets the first solve; with None every
    solve gets ``cg_rest`` (the polish loop, whose first shift is computed
    before it)."""
    cum = None
    banded_now = banded
    prev_ratio = None
    stalled = np.zeros(pts.shape[0], bool)
    for outer in range(cfg.max_iter):
        r_np = ratio.cpu().numpy()
        if prev_ratio is not None:
            stalled |= (prev_ratio - r_np) < _STALL_FRAC * np.abs(prev_ratio)
        prev_ratio = r_np
        active = (ratio > termination) & torch.as_tensor(~stalled, device=pts.device)
        if not bool(active.any()):
            break
        pts, masks, shift, first, wl, wh, m0, L, cum, banded_now = _banded_guard(
            pts, masks, shift, first, wl, wh, m0, L, cum, banded_now, active,
            cfg.n_neighbors, cfg.moll)
        pts, shift, first, L, wl, wh, ratio, it = _contract_step_batch(
            pts, masks, L, wl, wh, shift, first, ratio, it, m0_mean, m0, center, axes, half,
            n_neighbors=cfg.n_neighbors, moll=cfg.moll, contraction_factor=contraction,
            max_contraction=cfg.max_contraction, max_attraction=cfg.max_attraction,
            termination_ratio=termination,
            cg_iters=cg_first if (outer == 0 and cg_first is not None) else cg_rest,
            banded=banded_now, active=active)
    return _unpermute(SkeletonResult(pts, shift, first, it, ratio), cum)


def extract_skeleton_batch(points, masks, cfg: SkeletonizeConfig | None = None,
                           cg_iters: int = 80, mesh=None, two_level: bool = True,
                           coarse_stride: int = 4, _morton: bool = True,
                           cg_iters_first: int | None = None,
                           cg_iters_polish: int | None = None,
                           device: str | torch.device = DEFAULT_DEVICE) -> SkeletonResult:
    """Contract a batch of trees [T, P, 3] (masks [T, P]) onto their
    skeletons. Rows are Morton-ordered internally (the banded Laplacian
    needs the locality) and returned in the caller's order. Buffers of
    ≥ 8192·``coarse_stride``/2 rows take the two-level (coarse → fine)
    path; ``two_level`` and ``_morton`` are off for the coarse pass's own
    call.

    PCG budgets, as in the JAX package: ``cg_iters`` per solve, the first
    solve ``cg_iters_first`` (default 3·``cg_iters``; on the two-level path
    the coarse pass's first solve), and on the two-level path every
    full-resolution solve ``cg_iters_polish`` (default
    max(``cg_iters``//2, 20)).

    ``mesh``: a ``parallel.mesh.Mesh`` — every rank calls with the same
    batch, contracts its own contiguous block of trees (the batch padded
    with empty trees to a multiple of the rank count) and all-gathers the
    results; ``device`` must name the rank's mesh device. The
    amplification tier is chosen from the whole batch's largest tree, as
    without a mesh."""
    dev = resolve_device(device, mesh)
    points = as_tensor(points, dev, torch.float32)
    masks = as_tensor(masks, dev, torch.bool)
    cfg = cfg or SkeletonizeConfig()
    budgets = dict(cg_iters=cg_iters, coarse_stride=coarse_stride,
                   cg_iters_first=cg_iters_first, cg_iters_polish=cg_iters_polish)
    if mesh is not None:
        return _extract_skeleton_sharded(points, masks, cfg, mesh, two_level, budgets)
    if _morton:
        perm = _morton_perm_batch(points, masks)
        res = extract_skeleton_batch(_take(points, perm), _take(masks, perm), cfg,
                                     two_level=two_level, _morton=False, device=dev, **budgets)
        return _unpermute(res, perm)
    termination = cfg.termination_ratio
    contraction = cfg.init_contraction
    if cfg.step_wise_contraction_amplification == "auto":
        n_max = int(masks.sum(dim=1).max())
        termination, contraction = set_amplification(n_max, termination)
    if two_level and points.shape[1] >= 8192 * coarse_stride // 2:
        return _extract_skeleton_two_level(points, masks, cfg, termination, contraction,
                                           cg_iters, coarse_stride, cg_iters_first,
                                           cg_iters_polish)
    if cg_iters_first is None:
        cg_iters_first = 3 * cg_iters
    banded = points.shape[1] % 256 == 0
    center, axes, half, L, m0, m0_mean, wl, wh = _contract_init_batch(
        points, masks, cfg.n_neighbors, cfg.moll, contraction, cfg.init_attraction,
        banded=banded)
    tb = points.shape[0]
    ratio = torch.where(masks.any(dim=1), 1.0, 0.0).to(points.dtype)
    it = torch.zeros(tb, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(points)
    return _outer_loop(points, masks, L, wl, wh, zero, zero, ratio, it, m0_mean, m0,
                       center, axes, half, cfg, contraction, termination, banded,
                       cg_iters_first, cg_iters)


def batch_amplification(cfg: SkeletonizeConfig, masks: torch.Tensor) -> SkeletonizeConfig:
    """``cfg`` with the amplification tier that the batch ``masks`` [T, P]
    picks under ``"auto"`` fixed in it, so that a block of the batch
    contracts at the whole batch's tier."""
    if cfg.step_wise_contraction_amplification != "auto":
        return cfg
    termination, contraction = set_amplification(int(masks.sum(dim=1).max()),
                                                  cfg.termination_ratio)
    return dataclasses.replace(cfg, termination_ratio=termination, init_contraction=contraction,
                               step_wise_contraction_amplification="fixed")


def tree_block(x: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of a [T, ...] tree batch split over
    ``size`` ranks: ceil(T/size) trees, padded with zeros (empty trees:
    all-False masks converge before their first step)."""
    tb = -(-x.shape[0] // size)
    blk = x[rank * tb:(rank + 1) * tb]
    if blk.shape[0] < tb:
        blk = torch.cat([blk, blk.new_zeros((tb - blk.shape[0],) + tuple(x.shape[1:]))])
    return blk.contiguous()


def _extract_skeleton_sharded(points, masks, cfg, mesh, two_level, budgets) -> SkeletonResult:
    """This rank's block of trees through ``extract_skeleton_batch`` at the
    whole batch's amplification tier, then every block's results gathered
    in rank order: each tree's rows equal the rank's block contracted
    alone on one device."""
    from pyqsm_tpu_torch.parallel.mesh import all_gather_rows

    res = extract_skeleton_batch(tree_block(points, mesh.size, mesh.rank),
                                 tree_block(masks, mesh.size, mesh.rank),
                                 batch_amplification(cfg, masks), two_level=two_level,
                                 device=points.device, **budgets)
    return SkeletonResult(*(all_gather_rows(f.contiguous(), mesh)[:points.shape[0]]
                            for f in res))


def _coarse_transfer(fine_p, fine_m, coarse_p, coarse_m, coarse_shift):
    """Each fine point starts at its nearest coarse point's displacement."""
    _, idx = knn(fine_p, coarse_p, 1, query_mask=fine_m, point_mask=coarse_m)
    disp = _take(coarse_shift, torch.clamp(idx[..., 0], min=0).long())
    return torch.where(fine_m[..., None], fine_p - disp, fine_p)


def _extract_skeleton_two_level(points, masks, cfg, termination, contraction, cg_iters,
                                stride, cg_iters_first, cg_iters_polish):
    """Coarse → fine contraction: the bulk of the motion on a 1/stride
    subsample, then the full cloud starts from the transferred coarse
    displacement and is polished with ``cg_iters_polish`` (default half
    the CG budget); ``first_shift`` is exact (one full-res iteration from
    the original positions)."""
    if cg_iters_polish is None:
        cg_iters_polish = max(cg_iters // 2, 20)
    cfg_fixed = dataclasses.replace(cfg, termination_ratio=termination,
                                    init_contraction=contraction,
                                    step_wise_contraction_amplification="fixed")
    banded = points.shape[1] % 256 == 0
    coarse = extract_skeleton_batch(
        points[:, ::stride].contiguous(), masks[:, ::stride].contiguous(), cfg_fixed,
        cg_iters=cg_iters, two_level=False, _morton=False, cg_iters_first=cg_iters_first,
        device=points.device)
    center, axes, half, L0, m0, m0_mean, wl0, wh0 = _contract_init_batch(
        points, masks, cfg.n_neighbors, cfg.moll, contraction, cfg.init_attraction,
        banded=banded)
    tb = points.shape[0]
    live_tree = masks.any(dim=1)
    ratio0 = torch.where(live_tree, 1.0, 0.0).to(points.dtype)
    it0 = torch.zeros(tb, dtype=torch.int32, device=points.device)
    zero = torch.zeros_like(points)
    # L0 is Morton-ordered on these very positions: an overflow here cannot
    # be fixed by re-sorting, so go straight to the exact ELL form
    first_banded = banded
    if banded and bool((L0.s_overflow & live_tree).any()):
        L0 = point_cloud_laplacian(points, masks, cfg.n_neighbors, cfg.moll, banded=False)
        first_banded = False
    _, _, first, _, _, _, _, _ = _contract_step_batch(
        points, masks, L0, wl0, wh0, zero, zero, ratio0, it0, m0_mean, m0, center, axes,
        half, n_neighbors=cfg.n_neighbors, moll=cfg.moll, contraction_factor=contraction,
        max_contraction=cfg.max_contraction, max_attraction=cfg.max_attraction,
        termination_ratio=termination, cg_iters=cg_iters_polish, banded=first_banded)
    fine_init = _coarse_transfer(points, masks, points[:, ::stride], masks[:, ::stride],
                                 coarse.total_shift)
    k = coarse.iterations.to(points.dtype)
    wl = torch.clamp(wl0 * (contraction ** k)[:, None], 0.1, cfg.max_contraction)
    L = point_cloud_laplacian(fine_init, masks, cfg.n_neighbors, cfg.moll, banded=banded)
    m_cur = L.mass
    wh = torch.clamp(wh0 * torch.sqrt(m0 / torch.clamp(m_cur, min=1e-30)), 0.1,
                     cfg.max_attraction)
    ratio = torch.where(live_tree, _masked_mean(m_cur, masks) / torch.clamp(m0_mean, min=1e-30),
                        0.0)
    shift = torch.where(masks[..., None], points - fine_init, 0.0)
    it = torch.clamp(coarse.iterations, min=1)  # > 0: first_shift stays frozen
    res = _outer_loop(fine_init, masks, L, wl, wh, shift, zero, ratio, it, m0_mean, m0,
                      center, axes, half, cfg, contraction, termination, banded,
                      None, cg_iters_polish)
    return res._replace(first_shift=first)


class TopologyResult(NamedTuple):
    topology: Topology
    graph: SimplifiedGraph
    fps_idx: torch.Tensor  # [S] rows of the contracted cloud chosen as vertices
    vertex_cmag: torch.Tensor  # [S] total contraction magnitude per vertex


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1))


def extract_topology(contracted, mask, total_shift, graph_k_n: int = 15,
                     fps_fraction: float = 0.1, min_fps: int = 15,
                     dedupe_voxel: float = 0.02) -> TopologyResult:
    """FPS → kNN graph → Borůvka MST → degree-2 contraction for one tree.
    FPS picks ``fps_fraction`` (at least ``min_fps``) of the contracted
    points, after deduping them at ``dedupe_voxel`` (0 or None: no dedupe);
    the pick count is padded to a power of two."""
    mask = mask & (_norm3(contracted) > 0.01)  # near-origin artifacts
    sample_mask = mask
    if dedupe_voxel and dedupe_voxel > 0:
        _, rep_mask, _ = voxel_downsample(contracted, dedupe_voxel, mask)
        sample_mask = mask & rep_mask
    n_live = int(sample_mask.sum())
    s_real = min(max(int(n_live * fps_fraction), min_fps), max(n_live, 1))
    s = 16
    while s < s_real:
        s *= 2
    fps_idx = farthest_point_sampling(contracted, s, sample_mask)
    verts = contracted[fps_idx.long()]
    vmask = torch.arange(s, device=contracted.device) < s_real
    d, idx = knn(verts, verts, min(graph_k_n + 1, s), query_mask=vmask, point_mask=vmask)
    d, idx = d[:, 1:].contiguous(), idx[:, 1:].contiguous()
    eu, ev, sel, _ = boruvka_mst(idx, d, vmask)
    graph = simplify_degree2(eu, ev, sel, vmask)
    cmag = _norm3(total_shift)[fps_idx.long()]
    _, nearest = knn(contracted, verts, 1, query_mask=mask, point_mask=vmask)
    topo = Topology(vertices=verts, vertex_mask=vmask,
                    edges=torch.stack([graph.edge_u, graph.edge_v], dim=1),
                    edge_mask=graph.edge_mask,
                    point_to_vertex=torch.where(mask, nearest[:, 0], -1))
    return TopologyResult(topo, graph, fps_idx, cmag)


def _median_midpoint(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: midpoint of the middle order statistics, NaN if any
    entry is NaN."""
    s, _ = torch.sort(v)
    n = v.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(v).any(), float("nan"), med)


def skeleton_to_qsm(topo: TopologyResult) -> Cylinders:
    """Cylinders from the simplified skeleton: radius = mean contraction
    magnitude of each edge's chain members (endpoint mean for direct
    edges); edges shorter than a tenth of the median are pruned."""
    g = topo.graph
    verts = topo.topology.vertices
    s = verts.shape[0]
    dev = verts.device
    cmag = topo.vertex_cmag
    in_chain = g.chain_id >= 0
    key = torch.where(in_chain, g.chain_id, s).long()
    csum = segment_sum(torch.where(in_chain, cmag, 0.0), key, s)
    ccnt = segment_sum(in_chain.to(torch.float32), key, s)
    chain_mean = csum / torch.clamp(ccnt, min=1.0)
    u = torch.clamp(g.edge_u, 0, s - 1).long()
    v = torch.clamp(g.edge_v, 0, s - 1).long()
    endpoint_mean = 0.5 * (cmag[u] + cmag[v])
    radius = torch.where(g.edge_chain >= 0,
                         chain_mean[torch.clamp(g.edge_chain, 0, s - 1).long()], endpoint_mean)
    a, b = verts[u], verts[v]
    height = _norm3(b - a)
    axis = (b - a) / torch.clamp(height, min=1e-12)[:, None]
    center = 0.5 * (a + b)
    med = torch.nan_to_num(_median_midpoint(torch.where(g.edge_mask, height, float("nan"))),
                           nan=0.0)
    m = g.edge_mask & (height > torch.clamp(0.1 * med, min=1e-6))
    ncyl = center.shape[0]
    return Cylinders(center=center, axis=axis, height=height,
                     radius=torch.where(m, radius, 0.0),
                     branch_order=torch.zeros(ncyl, dtype=torch.int32, device=dev),
                     parent=torch.full((ncyl,), -1, dtype=torch.int32, device=dev), mask=m)


def skeletonize(points, mask, cfg: SkeletonizeConfig | None = None,
                device: str | torch.device = DEFAULT_DEVICE):
    """One tree through contract → topology → QSM, on ``device``:
    ``(SkeletonResult, TopologyResult, Cylinders)``."""
    dev = resolve_device(device)
    mask = as_tensor(mask, dev, torch.bool)
    cfg = cfg or SkeletonizeConfig()
    skel = extract_skeleton(points, mask, cfg, device=dev)
    topo = extract_topology(skel.contracted, mask, skel.total_shift, cfg.graph_k_n)
    return skel, topo, skeleton_to_qsm(topo)
