"""Collective kernels of the sharded multi-tree step (counterpart of
``pyqsm_tpu/parallel/collective_ops.py``).

The JAX package runs these inside ``shard_map`` with a named axis; here
each rank calls them on its own block with the JAX package's arguments,
the axis name included, and the ``Mesh`` as the keyword ``mesh``; the
collectives act on that axis's row of ranks: a ring of point
shards for kNN (``ring_shift``), ``all_gather_rows`` for the small
per-iteration solution vectors of the contraction CG, and
``all_reduce_sum`` for global reductions (inlier counts, mass means, dot
products).
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.neighbors import _TILE_ELEMS, _dot3, _sq3, _sqrt, smallest_k
from pyqsm_tpu_torch.ops.segment import segment_sum
from pyqsm_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum, ring_shift


def ring_knn(queries: torch.Tensor, points: torch.Tensor, point_mask: torch.Tensor, k: int,
             axis: str, *, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of this rank's [Q, 3] queries against the point set
    sharded over ``axis``: the shards circulate the ring (received from the
    left), and each hop's [Q, P_local] block of ``q² + p² − 2·q·p`` (XLA's
    rounding, elementwise) merges into a running top-k of ``[best, new]``,
    so a tie keeps the earlier hop. Returns ``(sqrt(max(d², 0)), global
    ids)``, ids ``owner·P_local + row``, -1 where d is inf."""
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    nq, p_local = queries.shape[0], points.shape[0]
    dev = queries.device
    q_sq = _sq3(queries)
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    live = torch.ones(1, nq, dtype=torch.bool, device=dev)
    rows = max(1, (_TILE_ELEMS >> 2) // max(p_local, 1))  # float64 temporaries a tile
    pts, mask, owner = points, point_mask, me
    for step in range(n_dev):
        p_sq = _sq3(pts)
        gidx = owner * p_local + torch.arange(p_local, dtype=torch.int32, device=dev)
        for s in range(0, nq, rows):
            e = min(nq, s + rows)
            d2 = (q_sq[s:e, None] + p_sq[None, :]) - 2.0 * _dot3(queries[s:e, None, :],
                                                                 pts[None, :, :])
            d2 = torch.where(mask[None, :], d2, float("inf"))
            cat_d = torch.cat([best_d[s:e], d2], 1)
            cat_i = torch.cat([best_i[s:e], gidx[None, :].expand(e - s, -1)], 1)
            col = smallest_k(cat_d[None], k, live[:, s:e])[0]
            best_d[s:e] = torch.gather(cat_d, 1, col)
            best_i[s:e] = torch.gather(cat_i, 1, col)
        if step < n_dev - 1:
            pts, mask = ring_shift(pts, mesh, axis), ring_shift(mask, mesh, axis)
            owner = (owner - 1) % n_dev
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return _sqrt(torch.clamp(best_d, min=0.0)), best_i


def sharded_laplacian_matvec(x_local: torch.Tensor, nbr_idx: torch.Tensor, w: torch.Tensor,
                             deg: torch.Tensor, axis: str, *, mesh: Mesh) -> torch.Tensor:
    """L x with x sharded over ``axis``: gather the (small) solution
    vector, then this rank's rows ``deg·x − Σ_k w·x[nbr]``."""
    x_full = all_gather_rows(x_local, mesh, axis)  # [P_global, C]
    nbr_x = x_full[torch.clamp(nbr_idx, min=0).long()]
    acc = (torch.where(nbr_idx >= 0, w, 0.0)[..., None] * nbr_x).sum(1)
    return deg[:, None] * x_local - acc


def _scatter_global(vals: torch.Tensor, nbr_idx: torch.Tensor, mesh: Mesh,
                    axis: str) -> torch.Tensor:
    """Σ over every rank's out-edges of ``vals`` [P_local, k, ...] into
    their global destination rows, summed over ``axis``; this rank's block
    of rows."""
    n_local, k = nbr_idx.shape
    n_global = n_local * mesh.axis_size(axis)
    dst = torch.where(nbr_idx >= 0, nbr_idx.long(), n_global).reshape(-1)
    part = segment_sum(vals.reshape((n_local * k,) + tuple(vals.shape[2:])), dst, n_global)
    me = mesh.axis_index(axis)
    return all_reduce_sum(part, mesh, axis)[me * n_local:(me + 1) * n_local]


def sharded_laplacian_rmatvec(y_local: torch.Tensor, nbr_idx: torch.Tensor, w: torch.Tensor,
                              deg: torch.Tensor, axis: str, *, mesh: Mesh) -> torch.Tensor:
    """Exact Lᵀ y with rows sharded over ``axis``: each rank scatters its
    rows' out-edge contributions ``w_ij·y_i`` to global destinations, the
    partial sums are summed over the axis and each rank takes its block
    back (the directed kNN weights stay exact)."""
    wv = torch.where(nbr_idx >= 0, w, 0.0)
    acc = _scatter_global(wv[:, :, None] * y_local[:, None, :], nbr_idx, mesh, axis)
    return deg[:, None] * y_local - acc


def sharded_cg(nbr_idx: torch.Tensor, w: torch.Tensor, deg: torch.Tensor, wl: torch.Tensor,
               wh: torch.Tensor, b_local: torch.Tensor, axis: str, iters: int = 30, *,
               mesh: Mesh) -> torch.Tensor:
    """Jacobi-PCG on the contraction's normal equations ``(Lᵀ·WL²·L +
    WH²) x = b`` with the points sharded over ``axis``: a fixed ``iters``
    iterations, dot products summed over the axis; the Jacobi diagonal
    includes the in-edge term Σ_i (wl_i·w_ij)²."""

    def matvec(x_local):
        y = sharded_laplacian_matvec(x_local, nbr_idx, w, deg, axis, mesh=mesh)
        y = sharded_laplacian_rmatvec((wl * wl)[:, None] * y, nbr_idx, w, deg, axis, mesh=mesh)
        return y + (wh * wh)[:, None] * x_local

    in_sq = _scatter_global((wl[:, None] * torch.where(nbr_idx >= 0, w, 0.0)) ** 2, nbr_idx,
                            mesh, axis)
    minv = 1.0 / torch.clamp((wl * deg) ** 2 + in_sq + wh * wh, min=1e-20)[:, None]

    def psum_dot(a, b):
        return all_reduce_sum((a * b).sum(), mesh, axis)

    x = torch.zeros_like(b_local)
    r = b_local - matvec(x)
    z = minv * r
    p = z
    rz = psum_dot(r, z)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rz / torch.clamp(psum_dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = psum_dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
    return x


def psum_inlier_count(resid_local: torch.Tensor, mask_local: torch.Tensor, threshold: float,
                      axis: str, *, mesh: Mesh) -> torch.Tensor:
    """Global RANSAC inlier count per hypothesis: this rank's count summed
    over ``axis``."""
    inl = (resid_local <= threshold) & mask_local[None, :]
    return all_reduce_sum(inl.sum(1, dtype=torch.int32), mesh, axis)


def label_prop_round(labels_local: torch.Tensor, nbr_idx: torch.Tensor,
                     edge_valid: torch.Tensor, axis: str, *, mesh: Mesh) -> torch.Tensor:
    """One min-label propagation round over labels sharded along ``axis``
    (the sharded DBSCAN/region-growing primitive): gather the labels, take
    each row's minimum over its valid neighbours (2³⁰ = none)."""
    full = all_gather_rows(labels_local, mesh, axis)
    nbr_lab = torch.where(edge_valid, full[torch.clamp(nbr_idx, min=0).long()], 2 ** 30)
    return torch.minimum(labels_local, nbr_lab.amin(1).to(labels_local.dtype))
