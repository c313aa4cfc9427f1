"""Sharded plot-scale region growing (counterpart of
``pyqsm_tpu/parallel/growth.py``).

The radius graph's rows split over the ranks in contiguous blocks; every
growth cycle all-gathers the int32 claim codes (``all_gather_rows``) and
sums the clusters' new-row counts and the any-frontier test over the ranks
(``all_reduce_sum``). The claims are the single-device ones — the same
min-id tie-break and per-cycle retirement — so the sharded and
single-device results are equal bit for bit:

- ``_grow_local``: each rank's rows take the minimum active frontier id
  among their neighbours (the gather claim);
- ``_grow_local_banded`` (``PYQSM_CLAIM=band``, under the JAX package's
  conditions): each rank applies its own rows' block band to the one-hot
  codes of its rows plus one halo block on each side,
  ``band_apply(prepadded=True)`` — on the card the halo form of
  ``csrc/band_matvec_bf16.cu`` — plus its exact spill list.

Both are host loops with one sync per cycle.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from pyqsm_tpu_torch.device import as_tensor
from pyqsm_tpu_torch.models.isolation import (BIG, GrowthResult, _band_bytes_budget,
                                              _band_claim_bytes, _retire)
from pyqsm_tpu_torch.ops.band_matvec import BAND_BLOCK, band_apply
from pyqsm_tpu_torch.ops.segment import segment_sum
from pyqsm_tpu_torch.ops.sparse import build_banded_window
from pyqsm_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum

# This rank's band of the last sharded band claim: local rows, cluster cap,
# spill edges, resident bytes of its window tiles and live spill. Set by
# ``_grow_local_banded``; read by callers that report the band's size.
LAST_BAND: dict | None = None


def _any_frontier(frontier: torch.Tensor, mesh: Mesh) -> bool:
    return int(all_reduce_sum(frontier.sum(dtype=torch.int32).reshape(1), mesh)[0]) > 0


def _init_state(seed_labels, mask, c: int):
    labels = torch.where(mask, seed_labels.to(torch.int32), -1)
    frontier = labels >= 0
    order = torch.where(frontier, 0, -1).to(torch.int32)
    return labels, frontier, order, torch.ones(c, dtype=torch.bool, device=labels.device)


def _grow_local(nbr_idx, seed_labels, mask, mesh: Mesh, max_cycles: int, min_frontier: int,
                cluster_cap: int):
    """The gather claim on this rank's rows: ``nbr_idx`` [N_local, k] holds
    GLOBAL neighbour indices (-1 padded). Returns ``(labels, order,
    cycles, active)`` for the local rows."""
    c = cluster_cap
    gidx = torch.clamp(nbr_idx, min=0).long()
    mask_full = all_gather_rows(mask, mesh)
    edge = (nbr_idx >= 0) & mask[:, None] & mask_full[gidx]
    labels, frontier, order, active = _init_state(seed_labels, mask, c)
    cyc = 0
    while cyc < max_cycles and _any_frontier(frontier, mesh):
        act_self = active[torch.clamp(labels, 0, c - 1).long()]
        code = torch.where(frontier & act_self & (labels >= 0), labels, BIG)
        code_full = all_gather_rows(code, mesh)  # [N] int32
        cand = torch.where(edge, code_full[gidx], BIG).amin(dim=1)
        newly = mask & (labels < 0) & (cand < BIG)
        labels = torch.where(newly, cand, labels)
        order = torch.where(newly, cyc + 1, order).to(torch.int32)
        labels, order, active, frontier = _retire(labels, order, active, newly, c, min_frontier,
                                                  lambda v: all_reduce_sum(v, mesh))
        cyc += 1
    return labels, order, cyc, active


def _grow_local_banded(b_w, s_i, s_j, s_w, seed_labels, mask, mesh: Mesh, max_cycles: int,
                       min_frontier: int, cluster_cap: int):
    """The banded claim on this rank's rows: ``b_w`` [nb_local, 256, 768]
    bf16 in-window adjacency of this shard, ``s_i``/``s_j``/``s_w`` its
    spill (LOCAL rows, GLOBAL columns). Each cycle builds the one-hot
    codes of this rank's rows ± one halo block from the gathered codes and
    applies the band to them in its halo form. Claims are bit-identical to
    ``_grow_local`` (same edge set, same min-id tie-break)."""
    global LAST_BAND
    bs = BAND_BLOCK
    n_local = seed_labels.shape[0]
    dev = seed_labels.device
    c = int(cluster_cap)
    cids = torch.arange(c, dtype=torch.int32, device=dev)
    start = mesh.rank * n_local
    # the spill is front-packed (dead entries point at row n_local): apply
    # only its live prefix
    n_spill = int((s_i < n_local).sum())
    s_i, s_j, s_w = s_i[:n_spill].long(), s_j[:n_spill].long(), s_w[:n_spill].float()
    LAST_BAND = dict(rows=n_local, cluster_cap=c, spill_edges=n_spill,
                     band_bytes=b_w.numel() * b_w.element_size(),
                     spill_bytes=n_spill * (4 + 4 + 2))
    b_w = b_w[None]
    halo = torch.full((bs,), BIG, dtype=torch.int32, device=dev)
    labels, frontier, order, active = _init_state(seed_labels, mask, c)
    cyc = 0
    while cyc < max_cycles and _any_frontier(frontier, mesh):
        act_self = active[torch.clamp(labels, 0, c - 1).long()]
        code = torch.where(frontier & act_self & (labels >= 0), labels, BIG)
        code_full = all_gather_rows(code, mesh)  # [N] int32
        win = torch.cat([halo, code_full, halo])[start:start + n_local + 2 * bs]
        onehot = (win[:, None] == cids[None, :]).to(torch.bfloat16)[None]
        y = band_apply(b_w, onehot, prepadded=True)[0]  # [n_local, c] f32
        sj_code = code_full[torch.clamp(s_j, 0, code_full.shape[0] - 1)]
        contrib = (sj_code[:, None] == cids[None, :]).float() * s_w[:, None]
        y = y + segment_sum(contrib, s_i, n_local, sorted_index=True)
        cand = torch.where(y > 0, cids, BIG).amin(dim=1)  # lowest set column
        newly = mask & (labels < 0) & (cand < BIG)
        labels = torch.where(newly, cand, labels)
        order = torch.where(newly, cyc + 1, order).to(torch.int32)
        labels, order, active, frontier = _retire(labels, order, active, newly, c, min_frontier,
                                                  lambda v: all_reduce_sum(v, mesh))
        cyc += 1
    return labels, order, cyc, active


def _claim_band_shards(nbr_idx: torch.Tensor, mask: torch.Tensor, mesh: Mesh):
    """This rank's block-banded bf16 adjacency of the masked radius graph
    (weights 1): ``(b_w, s_i, s_j, s_w, overflow)``, the overflow summed
    over the ranks so that every rank takes the same claim."""
    n = nbr_idx.shape[0]
    n_local = n // mesh.size
    start = mesh.rank * n_local
    rows = slice(start, start + n_local)
    nl = nbr_idx[rows]
    edge = (nl >= 0) & mask[rows][:, None] & mask[torch.clamp(nl, 0, n - 1).long()]
    b_w, s_i, s_j, s_w, over = build_banded_window(
        torch.where(edge, nl, -1), edge.to(torch.bfloat16), start, 6 * n_local)
    over_any = all_reduce_sum(over.to(torch.int32).reshape(1), mesh)
    return b_w, s_i, s_j, s_w, bool(over_any[0] > 0)


def region_grow_sharded(nbr_idx, seed_labels, mask, mesh: Mesh, max_cycles: int = 200,
                        min_frontier: int = 5, cluster_cap: int = 1024) -> GrowthResult:
    """``region_grow`` over the mesh's ranks (all axes flattened): every
    rank calls it with the same full inputs and gets the full result.

    Pads N to a multiple of the rank count and grows each rank's block of
    rows. Under ``PYQSM_CLAIM=band``, with ``cluster_cap`` ≤ 128, block
    rows a multiple of 256, N ≥ 32 768 and the band's bytes within
    ``PYQSM_BAND_BYTES_BUDGET``, the claim runs block-banded per rank
    (rows spatially ordered by the caller — ``build_trees`` Morton-orders
    them); a spill overflow on any rank, or any other case, takes the
    gather claim. ``claim`` says which ran."""
    dev = mesh.device
    nbr_idx = as_tensor(nbr_idx, dev, torch.int32)
    seed_labels = as_tensor(seed_labels, dev, torch.int32)
    mask = as_tensor(mask, dev, torch.bool)
    size, rank = mesh.size, mesh.rank
    n = nbr_idx.shape[0]
    pad = (-n) % size
    if pad:
        nbr_idx = F.pad(nbr_idx, (0, 0, 0, pad), value=-1)
        seed_labels = F.pad(seed_labels, (0, pad), value=-1)
        mask = F.pad(mask, (0, pad), value=False)
    n_local = nbr_idx.shape[0] // size
    rows = slice(rank * n_local, (rank + 1) * n_local)
    kw = dict(max_cycles=max_cycles, min_frontier=min_frontier, cluster_cap=cluster_cap)
    use_band = (os.environ.get("PYQSM_CLAIM") == "band" and cluster_cap <= 128
                and n_local % BAND_BLOCK == 0 and nbr_idx.shape[0] >= 32768
                and _band_claim_bytes(n_local, cluster_cap) <= _band_bytes_budget())
    if use_band:
        b_w, s_i, s_j, s_w, over = _claim_band_shards(nbr_idx, mask, mesh)
        use_band = not over
    if use_band:
        labels, order, cyc, active = _grow_local_banded(
            b_w, s_i, s_j, s_w, seed_labels[rows], mask[rows], mesh, **kw)
    else:
        labels, order, cyc, active = _grow_local(
            nbr_idx[rows], seed_labels[rows], mask[rows], mesh, **kw)
    labels = all_gather_rows(labels, mesh)[:n]
    order = all_gather_rows(order, mesh)[:n]
    return GrowthResult(labels, order, cyc, active, "band" if use_band else "gather")
