"""Borůvka MST + degree-2 chain contraction (counterparts of
``pyqsm_tpu/ops/graph.py``). Segment minima become ``scatter_reduce_``
with ``amin``; the ``while_loop``s become host loops on a changed flag."""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 2 ** 30


def _pointer_jump(parent: torch.Tensor, rounds: int = 32) -> torch.Tensor:
    """Collapse a parent forest (parent[i] <= i) to roots."""
    for _ in range(rounds):
        p2 = parent[parent.long()]
        changed = bool((p2 != parent).any())
        parent = p2
        if not changed:
            break
    return parent


def _scatter_min(size: int, fill, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, index.long(), src, "amin")


def boruvka_mst(nbr_idx: torch.Tensor, nbr_dist: torch.Tensor, node_mask: torch.Tensor,
                max_rounds: int = 32):
    """MST (forest) over the symmetric closure of a kNN graph: ``(edge_u
    [E], edge_v [E], selected [E] bool, comp [N])`` with E = N·k; ties on
    weight go to the lowest edge index."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    e = n * k
    u = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    v = nbr_idx.reshape(-1)
    w = nbr_dist.reshape(-1)
    ul, vl = u.long(), torch.clamp(v, min=0).long()
    edge_live = (v >= 0) & node_mask[ul] & node_mask[vl]
    v = torch.clamp(v, min=0)
    w = torch.where(edge_live, w, float("inf"))
    eidx = torch.arange(e, dtype=torch.int32, device=dev)
    comp = torch.where(node_mask, torch.arange(n, dtype=torch.int32, device=dev), BIG)
    selected = torch.zeros(e, dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        cu, cv = comp[ul], comp[vl]
        active = edge_live & (cu != cv)
        if not bool(active.any()):
            break
        wa = torch.where(active, w, float("inf"))
        cu_s = torch.where(active, cu, n)
        cv_s = torch.where(active, cv, n)
        minw = _scatter_min(n + 1, float("inf"), cu_s, wa)
        minw = minw.scatter_reduce_(0, cv_s.long(), wa, "amin")
        is_min_u = active & (wa == minw[cu_s.long()])
        is_min_v = active & (wa == minw[cv_s.long()])
        mine = _scatter_min(n + 1, BIG, torch.where(is_min_u, cu_s, n), eidx)
        mine = mine.scatter_reduce_(0, torch.where(is_min_v, cv_s, n).long(), eidx, "amin")
        chosen = (is_min_u & (eidx == mine[cu_s.long()])) | (is_min_v & (eidx == mine[cv_s.long()]))
        selected = selected | chosen
        a = torch.where(chosen, torch.minimum(cu, cv), 0)
        b = torch.where(chosen, torch.maximum(cu, cv), 0)
        parent = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev)])
        parent = parent.scatter_reduce_(0, torch.where(chosen, b, n).long(), a, "amin")[:n]
        parent = _pointer_jump(parent)
        comp = torch.where(node_mask, parent[torch.clamp(comp, 0, n - 1).long()], comp)
    return u, v, selected, comp


def _edge_cc(n: int, eu: torch.Tensor, ev: torch.Tensor, edge_mask: torch.Tensor,
             node_active: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
    """Connected components over an edge list restricted to active nodes."""
    dev = eu.device
    lab = torch.where(node_active, torch.arange(n, dtype=torch.int32, device=dev), BIG)
    eul, evl = torch.clamp(eu, 0, n - 1).long(), torch.clamp(ev, 0, n - 1).long()
    use = edge_mask & node_active[eul] & node_active[evl]
    us = torch.where(use, eu, n).long()
    vs = torch.where(use, ev, n).long()
    for _ in range(max_rounds):
        m = torch.where(use, torch.minimum(lab[eul], lab[evl]), BIG)
        new = torch.cat([lab, lab.new_full((1,), BIG)])
        new = new.scatter_reduce_(0, us, m, "amin").scatter_reduce_(0, vs, m, "amin")[:n]
        safe = torch.clamp(new, 0, n - 1).long()
        jumped = torch.where(new < BIG, torch.minimum(new, new[safe]), new)
        changed = bool((jumped != lab).any())
        lab = jumped
        if not changed:
            break
    return lab


class SimplifiedGraph(NamedTuple):
    edge_u: torch.Tensor  # [M] i32 junction endpoints
    edge_v: torch.Tensor  # [M]
    edge_mask: torch.Tensor  # [M]
    edge_chain: torch.Tensor  # [M] i32 chain id (-1 = direct edge)
    chain_id: torch.Tensor  # [N] i32 per vertex (-1 for junctions/dead)
    degree: torch.Tensor  # [N]
    is_junction: torch.Tensor  # [N] bool


def simplify_degree2(eu: torch.Tensor, ev: torch.Tensor, edge_mask: torch.Tensor,
                     node_mask: torch.Tensor) -> SimplifiedGraph:
    """Contract all maximal chains of degree-2 vertices into single edges."""
    n = node_mask.shape[0]
    dev = eu.device
    us = torch.where(edge_mask, eu, n).long()
    vs = torch.where(edge_mask, ev, n).long()
    deg = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    one = torch.ones_like(us, dtype=torch.int32)
    deg = deg.index_add_(0, us, one).index_add_(0, vs, one)[:n]
    live = node_mask & (deg > 0)
    is_j = live & (deg != 2)
    is_c = live & (deg == 2)
    eul, evl = torch.clamp(eu, 0, n - 1).long(), torch.clamp(ev, 0, n - 1).long()
    interior = edge_mask & is_c[eul] & is_c[evl]
    chain = _edge_cc(n, eu, ev, interior, is_c)
    chain_id = torch.where(is_c, chain, -1)
    u_j, v_j = is_j[eul], is_j[evl]
    attach = edge_mask & (u_j ^ v_j)
    j_node = torch.where(u_j, eu, ev)
    c_node = torch.where(u_j, ev, eu)
    c_chain = torch.where(attach, chain_id[torch.clamp(c_node, 0, n - 1).long()], -1)
    key = torch.where(attach & (c_chain >= 0), c_chain, n).long()
    jmin = torch.full((n + 1,), BIG, dtype=torch.int32, device=dev).scatter_reduce_(
        0, key, torch.where(attach, j_node, BIG).to(torch.int32), "amin")
    jmax = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, key, torch.where(attach, j_node, -1).to(torch.int32), "amax")
    chain_exists = (jmin[:n] < BIG) & (jmax[:n] >= 0)
    ce_u = torch.where(chain_exists, jmin[:n], 0)
    ce_v = torch.where(chain_exists, jmax[:n], 0)
    direct = edge_mask & u_j & v_j
    out_u = torch.cat([ce_u, torch.where(direct, eu, 0).to(torch.int32)])
    out_v = torch.cat([ce_v, torch.where(direct, ev, 0).to(torch.int32)])
    out_m = torch.cat([chain_exists, direct])
    out_c = torch.cat([torch.where(chain_exists, torch.arange(n, dtype=torch.int32, device=dev), -1),
                       torch.full((eu.shape[0],), -1, dtype=torch.int32, device=dev)])
    return SimplifiedGraph(out_u, out_v, out_m, out_c, chain_id, deg, is_j)
