"""Sparse linear algebra of the contraction: ELL and block-banded graph
operators plus Jacobi-preconditioned CG (counterparts of
``pyqsm_tpu/ops/sparse.py:74-468``).

Every ``ELLLaplacian`` field carries a leading TREES axis ``[T, ...]`` —
the written-out form of the JAX package's ``vmap`` over trees. The banded
applies (``band_apply`` and, without a Wᵀ band, ``band_apply_t``) send a
CUDA tensor to the hand-written kernels in ``ops/band_matvec.py`` and a CPU
tensor to their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyqsm_tpu_torch.ops.band_matvec import BAND_BLOCK, band_apply, band_apply_t
from pyqsm_tpu_torch.ops.segment import segment_sum


class ELLLaplacian(NamedTuple):
    """Graph Laplacian L = D − W for a batch of trees. Row i of tree t:
    L_ii = deg[t, i], L_ij = −w[t, i, slot] for j = nbr_idx[t, i, slot].

    It carries one of two matvec forms. ELL: ``t_idx``/``t_w``/
    ``t_overflow``, the transpose ELL (Lᵀ gathers; a tree whose in-degree
    overflowed ``kt`` takes the exact scatter). Banded (rows Morton-ordered):
    ``b_w``/``b_w_t`` window tiles ``[T, nb, 256, 768]`` of W and Wᵀ plus
    the exact spill list sorted by row (``s_*``) and by column (``st_*``).
    When ``s_overflow`` is set for a tree its banded form is LOSSY; the
    matvecs do not branch on it — host-stepped callers rebuild first."""

    nbr_idx: torch.Tensor  # [T, N, k] i32, -1 padded
    w: torch.Tensor  # [T, N, k] f32, 0 on padding
    deg: torch.Tensor  # [T, N]
    mass: torch.Tensor  # [T, N]
    t_idx: torch.Tensor | None = None  # [T, N, kt] i32
    t_w: torch.Tensor | None = None  # [T, N, kt]
    t_overflow: torch.Tensor | None = None  # [T] bool
    b_w: torch.Tensor | None = None  # [T, nb, BS, 3·BS]
    s_i: torch.Tensor | None = None  # [T, R] i32 spill rows (N = dead), ascending
    s_j: torch.Tensor | None = None  # [T, R] i32 spill cols
    s_w: torch.Tensor | None = None  # [T, R]
    s_overflow: torch.Tensor | None = None  # [T] bool
    st_i: torch.Tensor | None = None  # [T, R] spill re-sorted by col
    st_j: torch.Tensor | None = None  # [T, R] cols ascending
    st_w: torch.Tensor | None = None  # [T, R]
    b_w_t: torch.Tensor | None = None  # [T, nb, BS, 3·BS] banded Wᵀ


def morton_codes(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes over the masked bbox of [..., N, 3] points;
    dead rows get INT32_MAX."""
    finite = mask & torch.isfinite(points).all(dim=-1)
    safe = torch.where(finite[..., None], points, 0.0)
    lo = torch.where(finite[..., None], safe, float("inf")).amin(dim=-2)
    hi = torch.where(finite[..., None], safe, float("-inf")).amax(dim=-2)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    scale = 1024.0 / torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((safe - lo[..., None, :]) * scale[..., None, :], 0, 1023).to(torch.int32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    return torch.where(finite, code, 2 ** 31 - 1)


def build_banded(nbr_idx: torch.Tensor, w: torch.Tensor, spill_cap: int, start: int = 0):
    """Block-banded form of [T, N, k] ELL weights: ``(b_w, s_i, s_j, s_w,
    overflow)``. Out-of-window edges go to the spill list, front-packed in
    row-major edge order (so ``s_i`` ascends). ``start``: the rows are
    global rows ``[start, start + N)`` and ``nbr_idx`` holds global
    columns (a shard; see ``build_banded_window``)."""
    t, n, k = nbr_idx.shape
    bs = BAND_BLOCK
    nb = n // bs
    if nb * bs != n:
        raise ValueError("row count must be a multiple of BAND_BLOCK")
    dev = nbr_idx.device
    row = torch.arange(n, device=dev)[:, None]
    blk = row // bs
    cpos = nbr_idx.long() - start - (blk - 1) * bs
    valid = nbr_idx >= 0
    in_win = valid & (cpos >= 0) & (cpos < 3 * bs)
    m = nb * bs * 3 * bs
    flat = torch.where(in_win, (torch.clamp(blk, max=nb - 1) * bs + row % bs) * (3 * bs) + cpos, m)
    flat = flat + torch.arange(t, device=dev)[:, None, None] * (m + 1)
    # every live tile slot takes exactly one edge (neighbour lists hold no
    # column twice) and the spare slot m only zeros, so the atomic adds give
    # the same bits in any order
    b_w = torch.zeros(t * (m + 1), dtype=w.dtype, device=dev).index_add_(
        0, flat.reshape(-1), torch.where(in_win, w, 0.0).reshape(-1))
    b_w = b_w.reshape(t, m + 1)[:, :m].reshape(t, nb, bs, 3 * bs).contiguous()

    flat_s = (valid & ~in_win).reshape(t, n * k)
    pos = torch.cumsum(flat_s.to(torch.int64), dim=1) - 1
    dst = torch.where(flat_s & (pos < spill_cap), pos, spill_cap)
    src_rows = (torch.arange(n * k, device=dev) // k).to(torch.int32).expand(t, -1)
    s_i = torch.full((t, spill_cap + 1), n, dtype=torch.int32, device=dev).scatter_(
        1, dst, src_rows)[:, :spill_cap]
    s_j = torch.zeros((t, spill_cap + 1), dtype=torch.int32, device=dev).scatter_(
        1, dst, nbr_idx.reshape(t, -1))[:, :spill_cap]
    s_w = torch.zeros((t, spill_cap + 1), dtype=w.dtype, device=dev).scatter_(
        1, dst, w.reshape(t, -1))[:, :spill_cap]
    overflow = flat_s.sum(dim=1) > spill_cap
    return b_w, s_i, s_j, s_w, overflow


def build_banded_window(nbr_idx: torch.Tensor, w: torch.Tensor, start: int, spill_cap: int):
    """``build_banded`` for a SHARD (``pyqsm_tpu/ops/sparse.py:144-185``):
    [n_local, k] rows are the local slice ``[start, start + n_local)`` of
    a globally ordered array and ``nbr_idx`` carries GLOBAL columns.
    In-window edges land in the local ±1-block band, applied against the
    caller's window with one halo block on each side
    (``band_apply(prepadded=True)``); the spill keeps global columns
    (``s_j``) with LOCAL rows (``s_i``). Returns ``(b_w [nb, 256, 768],
    s_i, s_j, s_w [spill_cap], overflow)``."""
    b_w, s_i, s_j, s_w, over = build_banded(nbr_idx[None], w[None], spill_cap, start=start)
    return b_w[0], s_i[0], s_j[0], s_w[0], over[0]


def band_transpose(b_w: torch.Tensor) -> torch.Tensor:
    """Banded form of Wᵀ from that of W ([T, nb, BS, 3·BS]):
    ``b_w_t[c, q, u·bs+v] = b_w[c-1+u, v, (2-u)·bs+q]``."""
    bs = b_w.shape[2]
    s0 = b_w[..., 2 * bs:].transpose(-1, -2)
    s1 = b_w[..., bs:2 * bs].transpose(-1, -2)
    s2 = b_w[..., :bs].transpose(-1, -2)
    zero = torch.zeros_like(s1[:, :1])
    t0 = torch.cat([zero, s0[:, :-1]], dim=1)
    t2 = torch.cat([s2[:, 1:], zero], dim=1)
    return torch.cat([t0, s1, t2], dim=3).contiguous()


def _spill_apply(s_i, s_j, s_w, x, n, transpose=False, sorted_dst=False):
    """Exact spill list applied to x [T, N, C] (a deterministic segment sum).

    ``sorted_dst`` is the JAX signature's promise that the destinations
    ascend (the row-sorted spill forward, the column-sorted one
    transposed); here it selects ``segment_sum``'s sorted path. bf16
    weights and x (the banded claim's 0/1 spill and one-hot frontier) are
    accumulated in float32, where the JAX package sums in bf16: every term
    is 0 or 1, so the float32 sums are exact integer counts, and a bf16 sum
    of nonnegative terms is positive exactly when they are — the claim,
    which reads only ``> 0``, is unchanged."""
    c = x.shape[-1]
    src = (s_i if transpose else s_j).long()
    dst = (s_j if transpose else s_i).long()
    xs = torch.gather(x, 1, torch.clamp(src, 0, n - 1)[..., None].expand(-1, -1, c))
    acc = torch.promote_types(x.dtype, torch.float32)
    contrib = s_w.to(acc)[..., None] * xs.to(acc)
    return segment_sum(contrib, dst, n, sorted_index=sorted_dst)


def sort_spill_transpose(s_i, s_j, s_w, n: int):
    """Spill list re-sorted (stably) by column; dead entries last."""
    key = torch.where(s_i >= n, n, s_j)
    order = torch.argsort(key, dim=1, stable=True)
    return (torch.gather(s_i, 1, order), torch.gather(key, 1, order),
            torch.gather(s_w, 1, order))


def build_transpose_ell(nbr_idx: torch.Tensor, w: torch.Tensor, kt: int):
    """ELL rows of Wᵀ for [..., N, k] lists: each row's in-edge sources and
    weights in source order, ``(t_idx, t_w, overflow)`` with ``overflow``
    per leading batch entry when an in-degree exceeds ``kt``."""
    squeeze = nbr_idx.dim() == 2
    if squeeze:
        nbr_idx, w = nbr_idx[None], w[None]
    t, n, k = nbr_idx.shape
    dev = nbr_idx.device
    off = torch.arange(t, device=dev)[:, None] * (n + 1)
    src = (torch.arange(n * k, device=dev) // k).expand(t, -1)
    dst = torch.where(nbr_idx >= 0, nbr_idx.long(), n).reshape(t, -1) + off
    wf = torch.where(nbr_idx >= 0, w, 0.0).reshape(t, -1)
    order = torch.argsort(dst.reshape(-1), stable=True)
    sd = dst.reshape(-1)[order]
    ss = src.reshape(-1)[order]
    sw = wf.reshape(-1)[order]
    rows = (torch.arange(n, device=dev)[None, :] + off).reshape(-1)
    starts = torch.searchsorted(sd, rows, right=False)
    ends = torch.searchsorted(sd, rows, right=True)
    overflow = ((ends - starts) > kt).reshape(t, n).any(dim=1)
    take = starts[:, None] + torch.arange(kt, device=dev)[None, :]
    valid = take < ends[:, None]
    safe = torch.clamp(take, max=sd.shape[0] - 1)
    t_idx = torch.where(valid, ss[safe], -1).to(torch.int32).reshape(t, n, kt)
    t_w = torch.where(valid, sw[safe], 0.0).reshape(t, n, kt)
    if squeeze:
        return t_idx[0], t_w[0], overflow[0]
    return t_idx, t_w, overflow


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [T, N, C] at rows idx [T, N, k] (clamped at 0) -> [T, N, k, C]."""
    t, n, k = idx.shape
    c = x.shape[-1]
    g = torch.clamp(idx, min=0).long().reshape(t, n * k, 1).expand(-1, -1, c)
    return torch.gather(x, 1, g).reshape(t, n, k, c)


def _matvec_ell(L: ELLLaplacian, x: torch.Tensor) -> torch.Tensor:
    acc = torch.einsum("tnk,tnkc->tnc", L.w, _gather_rows(x, L.nbr_idx))
    return L.deg[..., None] * x - acc


def laplacian_matvec(L: ELLLaplacian, x: torch.Tensor) -> torch.Tensor:
    """L @ x for x [T, N, C]; banded + spill when the band is built."""
    if L.b_w is None:
        return _matvec_ell(L, x)
    n = x.shape[1]
    acc = band_apply(L.b_w, x) + _spill_apply(L.s_i, L.s_j, L.s_w, x, n, sorted_dst=True)
    return L.deg[..., None] * x - acc


def _rmatvec_scatter(L: ELLLaplacian, x: torch.Tensor) -> torch.Tensor:
    """Exact Lᵀ @ x by scatter (any in-degree)."""
    t, n, k = L.nbr_idx.shape
    c = x.shape[-1]
    contrib = L.w[..., None] * x[:, :, None, :]
    dst = torch.where(L.nbr_idx >= 0, L.nbr_idx.long(), n)
    out = segment_sum(contrib.reshape(t, n * k, c), dst.reshape(t, n * k), n)
    return L.deg[..., None] * x - out


def laplacian_rmatvec(L: ELLLaplacian, x: torch.Tensor) -> torch.Tensor:
    """Lᵀ @ x, in the JAX package's order of preference
    (``pyqsm_tpu/ops/sparse.py:362-387``): banded (the Wᵀ band through the forward
    kernel, or the forward tiles through the transpose kernel when no Wᵀ
    band was built; the column-sorted spill, or the row-sorted one) →
    transpose-ELL gather (trees whose in-degree overflowed take the exact
    scatter) → exact scatter."""
    n = x.shape[1]
    if L.b_w is not None:
        if L.st_j is not None:
            acc_s = _spill_apply(L.st_i, L.st_j, L.st_w, x, n, transpose=True, sorted_dst=True)
        else:
            acc_s = _spill_apply(L.s_i, L.s_j, L.s_w, x, n, transpose=True)
        acc_b = band_apply(L.b_w_t, x) if L.b_w_t is not None else band_apply_t(L.b_w, x)
        return L.deg[..., None] * x - (acc_b + acc_s)
    if L.t_idx is None:
        return _rmatvec_scatter(L, x)
    gathered = L.deg[..., None] * x - torch.einsum(
        "tnk,tnkc->tnc", L.t_w, _gather_rows(x, L.t_idx))
    if L.t_overflow is None or not bool(L.t_overflow.any()):
        return gathered
    return torch.where(L.t_overflow[:, None, None], _rmatvec_scatter(L, x), gathered)


def normal_matvec(L: ELLLaplacian, wl: torch.Tensor, wh: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(Lᵀ·WL²·L + WH²) @ x — the contraction normal-equation operator."""
    y = laplacian_matvec(L, x)
    y = (wl * wl)[..., None] * y
    y = laplacian_rmatvec(L, y)
    return y + (wh * wh)[..., None] * x


def normal_diag(L: ELLLaplacian, wl: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Exact diagonal of the normal operator (Jacobi preconditioner)."""
    t, n, k = L.nbr_idx.shape
    sq = (wl[..., None] * L.w) ** 2
    dst = torch.where(L.nbr_idx >= 0, L.nbr_idx.long(), n)
    scat = segment_sum(sq.reshape(t, n * k), dst.reshape(t, n * k), n)
    return (wl * L.deg) ** 2 + scat + wh * wh


# PCG reads its any-tree-active flag from the device every this many steps
_CHECK_EVERY = 8


def pcg(matvec_operands: tuple, b: torch.Tensor, diag: torch.Tensor,
        x0: torch.Tensor | None = None, tol: float = 1e-6, max_iters: int = 200):
    """Jacobi-preconditioned CG on the normal equations, batched over trees:
    b [T, N, C]. Each tree stops at its own residual ratio ``tol`` or at
    ``max_iters`` (its state is then frozen — the JAX package's vmapped
    ``while_loop``). The host reads the any-active flag every
    ``_CHECK_EVERY`` iterations; the frozen masking keeps extra iterations
    exact no-ops. Returns ``(x, residual ratio [T])``."""
    L, wl, wh = matvec_operands
    x = torch.zeros_like(b) if x0 is None else x0
    minv = (1.0 / torch.clamp(diag, min=1e-20))[..., None]

    def mv(v):
        return normal_matvec(L, wl, wh, v)

    def tsum(v):
        return v.reshape(v.shape[0], -1).sum(dim=1)

    r = b - mv(x)
    z = minv * r
    p = z
    rz = tsum(r * z)
    b_norm = torch.clamp(torch.sqrt(tsum(b * b)), min=1e-30)
    tiny = 1e-30
    for it in range(max_iters):
        active = torch.sqrt(tsum(r * r)) / b_norm > tol
        if it % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        Ap = mv(p)
        denom = tsum(p * Ap)
        alpha = rz / torch.where(denom.abs() < tiny, tiny, denom)
        a3 = active[:, None, None]
        x = torch.where(a3, x + alpha[:, None, None] * p, x)
        r_new = r - alpha[:, None, None] * Ap
        z = minv * r_new
        rz_new = tsum(r_new * z)
        beta = rz_new / torch.where(rz.abs() < tiny, tiny, rz)
        p = torch.where(a3, z + beta[:, None, None] * p, p)
        r = torch.where(a3, r_new, r)
        rz = torch.where(active, rz_new, rz)
    return x, torch.sqrt(tsum(r * r)) / b_norm
