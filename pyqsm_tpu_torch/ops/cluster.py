"""Clustering (counterpart of ``pyqsm_tpu/ops/cluster.py``): connected
components and DBSCAN over capped neighbor lists by iterated min-label
propagation with pointer jumping (the ``while_loop`` becomes a host loop
that reads one ``changed`` flag per round), cluster sizes, k-means with
its silhouette sweep.

Deviation: k-means' one random draw, its first centre, comes from a
``torch.Generator`` (``first_center``); torch cannot reproduce
``jax.random``, so the same seed picks another first centre than the JAX
package does. Given the same draws the labels are equal.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from pyqsm_tpu_torch.ops.neighbors import _sq3, _sqrt, radius_count, radius_knn
from pyqsm_tpu_torch.ops.segment import segment_sum

BIG = 2 ** 30
_PAIRWISE_CAP = 8192  # rows above which silhouette_score subsamples


def propagate_min_labels(labels: torch.Tensor, nbr_idx: torch.Tensor,
                         edge_valid: torch.Tensor, node_active: torch.Tensor,
                         max_rounds: int = 64) -> torch.Tensor:
    """Min-label diffusion + two pointer jumps per round until no label
    changes. ``labels`` start as unique ids (row index) on active nodes and
    ``BIG`` elsewhere."""
    n = labels.shape[0]
    gidx = torch.clamp(nbr_idx, min=0).long()
    for _ in range(max_rounds):
        nbr_lab = torch.where(edge_valid, labels[gidx], BIG)
        best = torch.minimum(nbr_lab.amin(dim=1), labels)
        new = torch.where(node_active, best, labels)
        safe = torch.clamp(new, 0, n - 1).long()
        jumped = torch.where(new < BIG, torch.minimum(new, labels[safe]), new)
        safe2 = torch.clamp(jumped, 0, n - 1).long()
        jumped = torch.where(jumped < BIG, torch.minimum(jumped, labels[safe2]), jumped)
        changed = bool((jumped != labels).any())
        labels = jumped
        if not changed:
            break
    return labels


def connected_components(nbr_idx: torch.Tensor, edge_valid: torch.Tensor,
                         node_mask: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
    """Component labels (min row index per component); dead nodes -1."""
    n = nbr_idx.shape[0]
    init = torch.where(node_mask, torch.arange(n, dtype=torch.int32, device=nbr_idx.device), BIG)
    lab = propagate_min_labels(init, nbr_idx, edge_valid, node_mask, max_rounds)
    return torch.where(node_mask, lab, -1)


def compact_labels(labels: torch.Tensor) -> torch.Tensor:
    """Renumber nonnegative labels to 0..C-1 in order of root row; keep -1."""
    n = labels.shape[0]
    is_root = (labels == torch.arange(n, device=labels.device)) & (labels >= 0)
    new_id = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    safe = torch.clamp(labels, 0, n - 1).long()
    return torch.where(labels >= 0, new_id[safe], -1)


def dbscan_from_neighbors(nbr_idx: torch.Tensor, nbr_dist: torch.Tensor,
                          mask: torch.Tensor, min_samples: int = 10,
                          neighbor_cap: int = 0, max_rounds: int = 64,
                          core: torch.Tensor | None = None) -> torch.Tensor:
    """DBSCAN from eps-neighbor lists: core-core components by min row id,
    border points adopt their min core-neighbor label, noise -1; labels
    compacted to 0..C-1. ``core`` (exact counts) overrides the list-based
    core test. ``neighbor_cap`` is unused; it keeps the JAX package's
    positional order."""
    del nbr_dist, neighbor_cap
    n = nbr_idx.shape[0]
    valid = (nbr_idx >= 0) & mask[:, None]
    if core is None:
        core = mask & (valid.sum(dim=1) >= min_samples)
    gidx = torch.clamp(nbr_idx, min=0).long()
    nbr_is_core = core[gidx] & valid
    edge_cc = nbr_is_core & core[:, None]
    init = torch.where(core, torch.arange(n, dtype=torch.int32, device=nbr_idx.device), BIG)
    lab = propagate_min_labels(init, nbr_idx, edge_cc, core, max_rounds)
    border = torch.where(nbr_is_core, lab[gidx], BIG).amin(dim=1)
    lab = torch.where(core, lab, border)
    lab = torch.where(mask & (lab < BIG), lab, -1)
    return compact_labels(lab)


def dbscan(points: torch.Tensor, mask: torch.Tensor, eps: float = 0.1, min_samples: int = 10,
           neighbor_cap: int = 32, max_rounds: int = 64) -> torch.Tensor:
    """DBSCAN over 3D points from brute-force neighbour lists: the core test
    is exact (``radius_count``), so ``min_samples`` may exceed
    ``neighbor_cap``; the capped lists carry connectivity only."""
    counts = radius_count(points, points, eps, query_mask=mask, point_mask=mask)
    core = mask & (counts >= min_samples)
    d, i = radius_knn(points, points, eps, neighbor_cap, query_mask=mask, point_mask=mask)
    return dbscan_from_neighbors(i, d, mask, min_samples=min_samples, max_rounds=max_rounds,
                                 core=core)


def cluster_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Size of each cluster id: an [N] i32 array indexed by label."""
    n = labels.shape[0]
    safe = torch.where(labels >= 0, labels, n - 1).long()
    return torch.zeros(n, dtype=torch.int32, device=labels.device).index_add_(
        0, safe, (labels >= 0).to(torch.int32))


def top_clusters(labels: torch.Tensor, top: int = 1) -> torch.Tensor:
    """Ids of the ``top`` largest clusters, largest first, equal sizes in
    ascending id (``lax.top_k``'s order, by a stable sort); -1 padded."""
    sizes = cluster_sizes(labels)
    ids = torch.sort(sizes, descending=True, stable=True).indices[:top]
    return torch.where(sizes[ids] > 0, ids.to(torch.int32), -1)


def largest_cluster_mask(points: torch.Tensor, mask: torch.Tensor, eps: float,
                         min_samples: int, neighbor_cap: int = 32):
    """DBSCAN and keep only the largest cluster: ``(labels, refined mask)``."""
    labels = dbscan(points, mask, eps, min_samples, neighbor_cap)
    return labels, mask & (labels == top_clusters(labels, 1)[0])


# ---------------------------------------------------------------------------
# k-means (Lloyd) + silhouette sweep
# ---------------------------------------------------------------------------


def first_center(mask: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Row of k-means' first centre: a live row drawn uniformly, from one
    uniform number of ``generator`` (a CPU ``torch.Generator``, so the card
    and the CPU draw alike). The JAX package draws it with
    ``jax.random.choice(key, n, p=mask/Σmask)``, which torch cannot
    reproduce: every random draw of k-means goes through this one function,
    and the parity tests replace it with the JAX package's draws."""
    u = torch.rand((), generator=generator, dtype=torch.float64).to(mask.device)
    live = torch.cumsum(mask.to(torch.int64), 0)
    n_live = live[-1]
    r = torch.minimum(torch.floor(u * n_live).to(torch.int64), torch.clamp(n_live - 1, min=0))
    return torch.clamp(torch.searchsorted(live, r + 1), max=mask.shape[0] - 1)


def _default_generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def kmeans(points: torch.Tensor, mask: torch.Tensor, k: int,
           generator: torch.Generator | None = None, iters: int = 25):
    """Lloyd k-means with farthest-point seeding after one random first
    centre (``first_center``; ``generator`` defaults to a CPU generator
    seeded 0). Returns ``(centers [k, 3], labels [N] i32)``, dead rows -1;
    equal distances go to the lower centre index, as ``jnp.argmin`` and
    ``jnp.argmax`` rank them. Squared distances are XLA's fused
    multiply-add chain (``_sq3``); the per-cluster sums are rounded once
    from float64."""
    pts = torch.where(mask[:, None], points, 0.0)
    live = mask.to(points.dtype)
    def row(i):  # a row picked on the device, read without a host sync
        return torch.index_select(pts, 0, i.reshape(1))[0]

    centers = torch.zeros((k, 3), dtype=points.dtype, device=points.device)
    centers[0] = row(first_center(mask, _default_generator(generator)))
    min_d2 = torch.where(mask, float("inf"), float("-inf"))
    for c in range(1, k):
        d2 = _sq3(pts - centers[c - 1][None, :])
        min_d2 = torch.minimum(min_d2, torch.where(mask, d2, float("-inf")))
        centers[c] = row(torch.argmax(min_d2))
    for _ in range(iters):
        lab = torch.argmin(_sq3(pts[:, None, :] - centers[None, :, :]), dim=1)
        onehot = F.one_hot(lab, k).to(points.dtype) * live[:, None]
        sums = (onehot.double().T @ pts.double()).to(points.dtype)
        cnts = onehot.sum(dim=0)
        centers = torch.where(cnts[:, None] > 0, sums / torch.clamp(cnts, min=1)[:, None],
                              centers)
    lab = torch.argmin(_sq3(pts[:, None, :] - centers[None, :, :]), dim=1)
    return centers, torch.where(mask, lab.to(torch.int32), -1)


def silhouette_score(points: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Mean silhouette coefficient over the full pairwise matrix. Above
    ``_PAIRWISE_CAP`` rows every ``ceil(N/cap)``-th row is kept first, with
    a logged warning, as in the JAX package. The mean distance to each
    cluster is a segment sum over the label (the JAX package's ``d @
    one_hot`` of width N)."""
    if points.shape[0] > _PAIRWISE_CAP:
        stride = -(-points.shape[0] // _PAIRWISE_CAP)
        logging.getLogger("pyqsm_tpu_torch.calc").warning(
            "silhouette_score: N=%d exceeds the %d pairwise cap; auto-subsampling every %dth "
            "row", points.shape[0], _PAIRWISE_CAP, stride)
        points, labels, mask = points[::stride], labels[::stride], mask[::stride]
    n = points.shape[0]
    pts = torch.where(mask[:, None], points, float("inf"))
    live = mask & (labels >= 0)
    d2 = torch.nan_to_num(_sq3(pts[:, None, :] - pts[None, :, :]), nan=0.0, posinf=float("inf"))
    d = _sqrt(torch.clamp(d2, min=0.0))
    pair = live[:, None] & live[None, :]
    same = (labels[:, None] == labels[None, :]) & pair
    same_n = same & ~torch.eye(n, dtype=torch.bool, device=d.device)
    a_cnt = same_n.sum(dim=1)
    a = torch.where(same_n, d, 0.0).sum(dim=1) / torch.clamp(a_cnt, min=1)
    lab_safe = torch.where(live, labels, n - 1).long()
    dsum = segment_sum(torch.where(pair, d, 0.0).T, lab_safe, n).T  # [N, n labels]
    cnts = segment_sum(live.to(d.dtype), lab_safe, n)
    mean_to = dsum / torch.clamp(cnts[None, :], min=1)
    own = F.one_hot(lab_safe, n).bool()
    b = torch.where(own | (cnts == 0)[None, :], float("inf"), mean_to).amin(dim=1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    valid = live & (a_cnt > 0) & torch.isfinite(b)
    s = torch.where(valid, s, 0.0)
    return s.sum() / torch.clamp(valid.sum(), min=1)


def kmeans_sweep(points: torch.Tensor, mask: torch.Tensor, generator: torch.Generator | None,
                 k_range: tuple[int, ...], min_silhouette: float = 0.4, iters: int = 25):
    """Try each k of ``k_range`` and keep the best silhouette; below
    ``min_silhouette`` fall back to the smallest k, fitted anew. Returns
    ``(centers, labels, chosen_k, score)``. Each fit draws its first centre
    from ``generator`` in turn (the JAX package splits its key once a
    fit)."""
    generator = _default_generator(generator)
    best = None
    for k in k_range:
        centers, labels = kmeans(points, mask, k, generator, iters=iters)
        score = float(silhouette_score(points, labels, mask))
        if best is None or score > best[3]:
            best = (centers, labels, k, score)
    if best[3] < min_silhouette:
        k0 = k_range[0]
        centers, labels = kmeans(points, mask, k0, generator, iters=iters)
        return centers, labels, k0, best[3]
    return best
