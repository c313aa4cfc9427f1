"""The sharded multi-tree pipeline step (counterpart of
``pyqsm_tpu/parallel/pipeline_step.py``), over a ``("trees", "points")``
mesh: each rank holds a block of trees and a block of each tree's points,
and runs, tree after tree,

1. ring kNN over the ``points`` axis (the neighbour engine),
2. heat-kernel Laplacian weights from those neighbour lists,
3. one Laplacian-contraction step by sharded Jacobi-PCG,
4. a RANSAC circle fit scored by global inlier counts,
5. one min-label propagation round.

``trees`` is data parallelism (independent trees); ``points`` carries the
collectives. The hypothesis draws come from a CPU ``torch.Generator``
(``step_draws``), not JAX's counter-based keys: the tests replay the JAX
package's draws through the step's ``draws`` argument.
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.device import resolve_device
from pyqsm_tpu_torch.ops.neighbors import _sqrt
from pyqsm_tpu_torch.parallel.collective_ops import (label_prop_round, psum_inlier_count,
                                                     ring_knn, sharded_cg)
from pyqsm_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum

AXIS = "points"


def _hyp_local(mesh: Mesh, n_hyp: int) -> int:
    return max(n_hyp // mesh.axis_size(AXIS), 1)


def step_draws(seed: int, mesh: Mesh, mask, n_hyp: int = 64) -> torch.Tensor:
    """This rank's hypothesis draws for a step, [T_local, H_local, 3] local
    rows (H_local = n_hyp / points-axis size), each row drawn with
    probability mask / Σ mask (with replacement), on the CPU. As the JAX
    package folds one key with the ``points`` index for every tree of a
    shard, every tree of a rank draws from the same stream, restarted."""
    m = (mask.detach().cpu() if isinstance(mask, torch.Tensor)
         else torch.as_tensor(mask)).to(torch.float64)
    h = _hyp_local(mesh, n_hyp)
    g = torch.Generator()
    out = []
    for tree in m:
        g.manual_seed(seed * 1_000_003 + mesh.axis_index(AXIS))
        p = tree if bool(tree.sum() > 0) else torch.ones_like(tree)
        out.append(torch.multinomial(p, h * 3, replacement=True, generator=g).reshape(h, 3))
    return torch.stack(out)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in column order, elementwise: the same bits on
    every device and for every number of rows."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis: the ordered sum of squares, correctly
    rounded root (the same bits on every device)."""
    return _sqrt(_row_sum(v * v))


def _tree_step_local(pts: torch.Tensor, mask: torch.Tensor, samples: torch.Tensor, k: int,
                     mesh: Mesh) -> dict:
    # 1. neighbour search over the ring
    safe = torch.where(mask[:, None], pts, 1e6)
    d, idx = ring_knn(safe, safe, mask, k + 1, AXIS, mesh=mesh)
    d, idx = d[:, 1:], idx[:, 1:]
    valid = idx >= 0

    # 2. heat-kernel Laplacian weights and the mass
    dd = torch.where(valid, d, 0.0)
    cnt = torch.clamp(valid.sum(1), min=1)
    mean_d = _row_sum(dd) / cnt
    sigma2 = torch.clamp(mean_d * mean_d, min=1e-12)
    w = torch.where(valid, torch.exp(-(dd * dd) / sigma2[:, None]), 0.0)
    deg = _row_sum(w)
    mass_mean = all_reduce_sum(torch.where(mask, mean_d ** 2, 0.0).sum(), mesh, AXIS) / (
        all_reduce_sum(mask.sum(dtype=torch.int32), mesh, AXIS) + 1e-9)

    # 3. one contraction step (sharded PCG on the normal equations)
    n_local = pts.shape[0]
    wl = torch.full((n_local,), 1.0, device=pts.device) * (
        3.0 * torch.sqrt(torch.clamp(mass_mean, min=1e-12)))
    wh = torch.full((n_local,), 3.0, device=pts.device)
    b = (wh * wh)[:, None] * torch.where(mask[:, None], pts, 0.0)
    contracted = sharded_cg(idx, w, deg, wl, wh, b, AXIS, iters=15, mesh=mesh)
    shift = torch.where(mask[:, None], pts - contracted, 0.0)

    # 4. RANSAC circle on the xy projection: every rank's minimal samples
    # gathered, so the hypotheses (and their global scores) agree
    tri = all_gather_rows(pts[samples.long()][..., :2], mesh, AXIS)  # [H, 3, 2]
    a, bb, c = tri[:, 0], tri[:, 1], tri[:, 2]
    dmat = 2.0 * (a[:, 0] * (bb[:, 1] - c[:, 1]) + bb[:, 0] * (c[:, 1] - a[:, 1])
                  + c[:, 0] * (a[:, 1] - bb[:, 1]))
    dmat = torch.where(dmat.abs() < 1e-12, float("inf"), dmat)
    a2, b2, c2 = _row_sum(a * a), _row_sum(bb * bb), _row_sum(c * c)
    ux = (a2 * (bb[:, 1] - c[:, 1]) + b2 * (c[:, 1] - a[:, 1]) + c2 * (a[:, 1] - bb[:, 1])) / dmat
    uy = (a2 * (c[:, 0] - bb[:, 0]) + b2 * (a[:, 0] - c[:, 0]) + c2 * (bb[:, 0] - a[:, 0])) / dmat
    centers = torch.stack([ux, uy], 1)
    radii = _norm(a - centers)
    resid = (_norm(pts[None, :, :2] - centers[:, None, :]) - radii[:, None]).abs()
    scores = psum_inlier_count(resid, mask, 0.02, AXIS, mesh=mesh)  # [H] global
    best = torch.argmax(torch.where(torch.isfinite(radii), scores, -1))

    # 5. one label-propagation round
    gids = mesh.axis_index(AXIS) * n_local + torch.arange(n_local, dtype=torch.int32,
                                                          device=pts.device)
    labels0 = torch.where(mask, gids, 2 ** 30)
    labels = label_prop_round(labels0, idx, valid & (d <= 0.5), AXIS, mesh=mesh)
    return dict(contracted=contracted, shift_mag=_norm(shift),
                nbr_dist_mean=mean_d, fit_radius=radii[best], fit_center=centers[best],
                labels=labels)


def multi_tree_pipeline_step(mesh: Mesh, k: int = 8, n_hyp: int = 64):
    """The sharded step on a ``tree_points_mesh``. Returns ``step(points,
    mask, draws) -> dict``: each rank passes its [T_local, P_local, 3]
    block (``mesh.shard_tree_batch``), its mask block and its draws
    (``step_draws``), and gets its blocks of ``contracted``, ``shift_mag``,
    ``nbr_dist_mean`` and ``labels`` (global point ids along ``points``)
    and its trees' ``fit_radius`` [T_local] and ``fit_center``
    [T_local, 2], the same on every rank of a ``points`` row. Inputs go to
    the mesh's device (a card, unless the mesh was made on the CPU)."""
    h = _hyp_local(mesh, n_hyp)
    dev = resolve_device(mesh.device)

    def step(points, mask, draws) -> dict:
        pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
        msk = torch.as_tensor(mask, dtype=torch.bool).to(dev)
        smp = torch.as_tensor(draws).to(dev)
        if smp.shape[1:] != (h, 3):
            raise ValueError(f"draws {tuple(smp.shape)}: expected [T_local, {h}, 3]")
        outs = [_tree_step_local(p, m, s, k, mesh) for p, m, s in zip(pts, msk, smp)]
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return step
