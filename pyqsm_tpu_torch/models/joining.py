"""Plot-scale cluster joining (counterpart of ``pyqsm_tpu/models/joining.py``):
merge per-tree clusters across scans. Adjacency is one grid radius pass over
the whole subsampled cloud and one scatter-min over label-pair keys; the
approvals are explicit policies (accept every adjacent pair, with an audit
list), and the union-find, renumbering and ratings run on the host, as in
the JAX package.

``SYNCS`` counts the host reads of this module's functions (and of the
queries they call), the reads the JAX package makes at the same places.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import input_device
from pyqsm_tpu_torch.ops.neighbors import grid_self_radius_knn
from pyqsm_tpu_torch.ops.sampling import compact_rows, uniform_downsample

SYNCS = 0


def _host(a) -> np.ndarray:
    """numpy of ``a``; a card tensor's read is counted in ``SYNCS``."""
    global SYNCS
    if isinstance(a, torch.Tensor):
        SYNCS += int(a.is_cuda)
        return a.cpu().numpy()
    return np.asarray(a)


class Adjacency(NamedTuple):
    min_dist: torch.Tensor  # [L, L] min pairwise distance between labels
    adjacent: torch.Tensor  # [L, L] bool (min_dist <= threshold)
    labels: torch.Tensor  # [L] i32 label ids present


def _label_pair_min(d: torch.Tensor, idx: torch.Tensor, labels: torch.Tensor,
                    n_labels: int) -> torch.Tensor:
    """Min edge distance per (label_i, label_j) pair: one scatter-min over
    flattened pair keys (key L² is the drop slot). Edges within one label
    are ignored."""
    li = labels[:, None]
    lj = torch.where(idx >= 0, labels[torch.clamp(idx, min=0).long()], -1)
    valid = (idx >= 0) & (li >= 0) & (lj >= 0) & (li != lj)
    drop = n_labels * n_labels
    key = torch.where(valid, li.long() * n_labels + lj, drop)
    dv = torch.where(valid, d, float("inf"))
    dmin = torch.full((drop + 1,), float("inf"), device=d.device).scatter_reduce(
        0, key.reshape(-1), dv.reshape(-1), reduce="amin")
    return dmin[:drop].reshape(n_labels, n_labels)


def label_adjacency(points, labels, mask, threshold: float = 0.35, subsample_every: int = 10,
                    max_labels: int = 256, neighbor_cap: int = 64,
                    device=None) -> Adjacency:
    """Pairwise min distance between labelled clusters on every
    ``subsample_every``-th live labelled point: one grid radius pass and one
    scatter-min. Exact for pairs within ``threshold`` as long as no point
    has more than ``neighbor_cap`` subsampled neighbours inside the
    threshold ball; farther pairs report inf. Runs on ``device``, else on
    the points' device when they are a tensor, else on the card."""
    global SYNCS
    dev = input_device(points, device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev).to(torch.int32)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    sub = uniform_downsample(mask & (labels >= 0), subsample_every)
    lab_np = _host(torch.where(sub, labels, -1))
    present = np.unique(lab_np[lab_np >= 0])[:max_labels]
    n_lab = len(present)
    if n_lab == 0:
        z = torch.zeros((0, 0), device=dev)
        return Adjacency(z, z.to(torch.bool), torch.zeros(0, dtype=torch.int32, device=dev))
    in_present = np.isin(lab_np, present)
    compact = np.where(in_present, np.searchsorted(present, np.where(in_present, lab_np, 0)),
                       -1).astype(np.int32)
    compact_t = torch.as_tensor(compact, device=dev)
    pts_c, m_c, _, lab_c = compact_rows(points, compact_t >= 0, compact_t)
    lab_c = torch.where(m_c, lab_c, -1)
    d, idx = grid_self_radius_knn(pts_c, radius=threshold, k=neighbor_cap, mask=m_c,
                                  sort=False, max_bucket=128)
    if dev.type == "cuda":
        SYNCS += 3  # compact_rows' live count, the query's occupancy and cell count
    dmat = _host(_label_pair_min(d, idx, lab_c, n_lab))
    dmat = np.minimum(dmat, dmat.T)
    np.fill_diagonal(dmat, 0.0)
    adj = (dmat <= threshold) & ~np.eye(n_lab, dtype=bool)
    return Adjacency(torch.as_tensor(dmat, device=dev), torch.as_tensor(adj, device=dev),
                     torch.as_tensor(present.astype(np.int32), device=dev))


def auto_join_policy(adj: Adjacency, max_dist: float | None = None) -> list[tuple[int, int]]:
    """Default approval policy: accept every adjacent pair (optionally with
    a tighter distance). Returns the audit list of approved (label, label)
    joins."""
    a, d, labels = _host(adj.adjacent), _host(adj.min_dist), _host(adj.labels)
    out = []
    for i in range(len(labels)):
        for j in range(i + 1, len(labels)):
            if a[i, j] and (max_dist is None or d[i, j] <= max_dist):
                out.append((int(labels[i]), int(labels[j])))
    return out


def join_clusters(labels, joins: list[tuple[int, int]], device=None) -> torch.Tensor:
    """Apply approved joins: union-find over label ids (the smaller id is
    the root), relabel to the root, then renumber the ids densely to
    0..C-1 (host numpy). Returns i32 on ``device``, else on the labels'
    device when they are a tensor, else on the card."""
    dev = input_device(labels, device)
    lab_np = _host(labels)
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in joins:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    out = lab_np.copy()
    for lid in np.unique(lab_np[lab_np >= 0]):
        out[lab_np == lid] = find(int(lid))
    uniq = np.unique(out[out >= 0])
    dense = out.copy()
    for i, u in enumerate(uniq):
        dense[out == u] = i
    return torch.as_tensor(dense.astype(np.int32), device=dev)


class Ratings(NamedTuple):
    """Cluster quality ratings (good / bad / small) as a typed artifact."""

    labels: torch.Tensor  # [L]
    rating: dict[int, str]  # label -> 'g' | 'b' | 's'


def rate_clusters(points, labels, mask, rater: Callable[[int, np.ndarray], str] | None = None,
                  min_points: int = 100, min_height: float = 2.0, device=None) -> Ratings:
    """Rate each cluster with a pluggable rater (default: 'g'ood if it has
    ``min_points`` points and spans ``min_height`` in z, 's'mall below
    ``min_points``, else 'b'ad), on the host."""
    dev = input_device(points, device)
    lab_np, pts, m = _host(labels), _host(points), _host(mask)
    out: dict[int, str] = {}
    present = np.unique(lab_np[(lab_np >= 0) & m])
    for lid in present:
        cluster = pts[(lab_np == lid) & m]
        if rater is not None:
            out[int(lid)] = rater(int(lid), cluster)
        elif len(cluster) < min_points:
            out[int(lid)] = "s"
        elif np.ptp(cluster[:, 2]) >= min_height:
            out[int(lid)] = "g"
        else:
            out[int(lid)] = "b"
    return Ratings(torch.as_tensor(present.astype(np.int32), device=dev), out)


def merge_labeled_scans(points_list: list, labels_list: list, masks_list: list,
                        threshold: float = 0.35, device=None):
    """Combine labelled scans into one cloud with globally joined labels:
    offset each scan's label ids past the previous scan's, concatenate,
    compute the adjacency and accept every adjacent pair. Returns
    ``(points, labels, mask)`` on ``device``, else on the first scan's
    device when it is a tensor, else on the card."""
    dev = input_device(points_list[0], device)
    offset = 0
    pts_all, lab_all, mask_all = [], [], []
    for pts, lab, m in zip(points_list, labels_list, masks_list):
        lab = _host(lab).copy()
        live = lab >= 0
        lab[live] += offset
        if live.any():
            offset = lab[live].max() + 1
        pts_all.append(_host(pts))
        lab_all.append(lab)
        mask_all.append(_host(m))
    points = torch.as_tensor(np.concatenate(pts_all).astype(np.float32), device=dev)
    labels = torch.as_tensor(np.concatenate(lab_all).astype(np.int32), device=dev)
    mask = torch.as_tensor(np.concatenate(mask_all).astype(bool), device=dev)
    adj = label_adjacency(points, labels, mask, threshold=threshold)
    joins = auto_join_policy(adj)
    return points, join_clusters(labels, joins), mask
