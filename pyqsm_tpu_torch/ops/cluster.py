"""Connected components and DBSCAN over capped neighbor lists
(counterparts of ``pyqsm_tpu/ops/cluster.py:29-126``): iterated min-label
propagation with pointer jumping; the ``while_loop`` becomes a host loop
that reads one ``changed`` flag per round."""

from __future__ import annotations

import torch

BIG = 2 ** 30


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
                          max_rounds: int = 64,
                          core: torch.Tensor | None = None) -> torch.Tensor:
    """DBSCAN from eps-neighbor lists: core-core components by min row id,
    border points adopt their min core-neighbor label, noise -1; labels
    compacted to 0..C-1. ``core`` (exact counts) overrides the list-based
    core test."""
    del nbr_dist
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
