"""Host-side validation oracle for the contraction Laplacian (counterpart
of ``pyqsm_tpu/utils/laplacian_oracle.py``, numpy and scipy).

The reference contracts with ``robust_laplacian.point_cloud_laplacian``
(tufted intrinsic DEC) and exact sparse solves. The port, as the JAX
package, uses a kNN heat-kernel Laplacian and Jacobi-PCG; this module is
the measuring stick for that deviation:

- ``tufted_style_laplacian``: per-point PCA tangent plane, local 2D
  Delaunay, the centre's one-ring triangles as a nonmanifold soup, cotan
  weights with intrinsic mollification, lumped barycentric mass (small N
  only; it skips the tufted cover's doubling and intrinsic flips, which
  perturb weights only on nonmanifold fins);
- ``heat_kernel_laplacian_host``: the kNN heat kernel with exact kNN;
- ``contract_exact``: the reference's contraction loop (exact ``spsolve``
  on the normal equations, the shared WL/WH schedule) on any (L, M)
  builder, so a comparison varies only the operator;
- ``chamfer``: symmetric mean nearest-neighbour distance.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from pyqsm_tpu_torch.device import to_numpy


def tufted_style_laplacian(
    points: np.ndarray,
    n_neighbors: int = 20,
    mollify_factor: float = 1e-6,
) -> tuple["object", np.ndarray]:
    """Cotan Laplacian + lumped mass from tangent-plane Delaunay one-rings.

    Returns ``(L_csr, mass)`` with the robust-laplacian sign convention
    (positive semi-definite weak Laplacian: ``L = D - W`` row sums zero).
    O(N · k log k) host work — validation scales only.
    """
    from scipy.sparse import csr_matrix
    from scipy.spatial import Delaunay, cKDTree

    pts = to_numpy(points).astype(np.float64)
    n = len(pts)
    tree = cKDTree(pts)
    _, idx = tree.query(pts, k=min(n_neighbors + 1, n))

    tris: set[tuple[int, int, int]] = set()
    for i in range(n):
        nbrs = idx[i]
        local = pts[nbrs] - pts[i]
        # PCA tangent plane of the neighborhood
        _, _, vt = np.linalg.svd(local, full_matrices=False)
        uv = local @ vt[:2].T
        try:
            dt = Delaunay(uv)
        except Exception:  # degenerate neighborhood (collinear) — skip
            continue
        for simplex in dt.simplices:
            if 0 in simplex:  # one-ring of the center point only
                tri = tuple(sorted(int(nbrs[s]) for s in simplex))
                if len(set(tri)) == 3:
                    tris.add(tri)

    if not tris:
        raise ValueError("no local triangulations succeeded")
    f = np.array(sorted(tris), np.int64)  # [T, 3]

    # intrinsic mollification: pad every edge length by eps
    va, vb, vc = pts[f[:, 0]], pts[f[:, 1]], pts[f[:, 2]]
    la = np.linalg.norm(vb - vc, axis=1)  # opposite corner a
    lb = np.linalg.norm(vc - va, axis=1)
    lc = np.linalg.norm(va - vb, axis=1)
    eps = mollify_factor * np.mean([la.mean(), lb.mean(), lc.mean()])
    la, lb, lc = la + eps, lb + eps, lc + eps

    # intrinsic cotans from (mollified) lengths via the half-angle form
    s = 0.5 * (la + lb + lc)
    area = np.sqrt(np.maximum(s * (s - la) * (s - lb) * (s - lc), 1e-300))
    cot_a = (lb**2 + lc**2 - la**2) / (4.0 * area)  # angle at corner a
    cot_b = (lc**2 + la**2 - lb**2) / (4.0 * area)
    cot_c = (la**2 + lb**2 - lc**2) / (4.0 * area)

    # edge (b, c) gets 0.5 cot(angle at a), etc.
    rows, cols, vals = [], [], []
    for e0, e1, w in ((f[:, 1], f[:, 2], cot_a),
                      (f[:, 2], f[:, 0], cot_b),
                      (f[:, 0], f[:, 1], cot_c)):
        half = 0.5 * w
        rows += [e0, e1, e0, e1]
        cols += [e1, e0, e0, e1]
        vals += [-half, -half, half, half]
    L = csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )

    mass = np.zeros(n)
    third = area / 3.0
    for c in range(3):
        np.add.at(mass, f[:, c], third)
    mass = np.maximum(mass, 1e-12 * max(mass.max(), 1e-30))
    return L, mass


def heat_kernel_laplacian_host(
    points: np.ndarray,
    n_neighbors: int = 20,
    mollify_factor: float = 1e-6,
) -> tuple["object", np.ndarray]:
    """Host copy of the kNN heat-kernel Laplacian (exact kNN), so a
    comparison isolates the operator, not top-k recall or bf16."""
    from scipy.sparse import csr_matrix
    from scipy.spatial import cKDTree

    pts = to_numpy(points).astype(np.float64)
    n = len(pts)
    tree = cKDTree(pts)
    d, idx = tree.query(pts, k=min(n_neighbors + 1, n))
    d, idx = d[:, 1:], idx[:, 1:]
    mean_d = d.mean(axis=1)
    sigma2 = np.maximum(mean_d**2, 1e-12)
    w = np.maximum(np.exp(-(d**2) / sigma2[:, None]), mollify_factor)
    rows = np.repeat(np.arange(n), d.shape[1])
    W = csr_matrix((w.ravel(), (rows, idx.ravel())), shape=(n, n))
    from scipy.sparse import diags

    L = diags(np.asarray(W.sum(axis=1)).ravel()) - W
    mass = np.pi * mean_d**2
    return L, mass


def contract_exact(
    points: np.ndarray,
    builder: Callable[[np.ndarray], tuple["object", np.ndarray]],
    max_iter: int = 20,
    termination_ratio: float = 0.005,
    contraction_factor: float = 2.0,
    attraction_factor: float = 0.5,
    max_contraction: float = 2048.0,
    max_attraction: float = 1024.0,
) -> tuple[np.ndarray, int, float]:
    """Reference contraction loop with EXACT sparse solves
    (``least_squares_sparse``, skeletonize.py:150-180: normal equations of
    A = [WL.L; WH], one spsolve per axis) and the shared weight schedule of
    ``models/skeleton.py::_contract``. Returns (contracted, iters, ratio)."""
    from scipy.sparse import diags
    from scipy.sparse.linalg import spsolve

    pts = to_numpy(points).astype(np.float64)
    L, m = builder(pts)
    m0 = m.copy()
    m0_mean = m0.mean()
    wl = np.full(len(pts), contraction_factor * 1e3 * np.sqrt(m0_mean))
    wh = np.full(len(pts), attraction_factor)

    ratio = 1.0
    it = 0
    while ratio > termination_ratio and it < max_iter:
        WL2 = diags(wl * wl)
        A = L.T @ WL2 @ L + diags(wh * wh)
        b = (wh * wh)[:, None] * pts
        new = np.column_stack([spsolve(A.tocsc(), b[:, c]) for c in range(3)])
        # any NaN row poisons the next builder's cKDTree — stop at the last
        # good contraction (degenerate one-rings can blow up the cotans)
        if np.isnan(new).any():
            break
        pts = new
        L, m = builder(pts)
        ratio = m.mean() / max(m0_mean, 1e-30)
        wl = np.clip(wl * contraction_factor, 0.1, max_contraction)
        wh = np.clip(wh * np.sqrt(m0 / np.maximum(m, 1e-30)), 0.1,
                     max_attraction)
        it += 1
    return pts, it, float(ratio)


def chamfer(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric mean nearest-neighbor distance between two clouds."""
    from scipy.spatial import cKDTree

    a, b = to_numpy(a), to_numpy(b)
    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    return float(0.5 * (da.mean() + db.mean()))
