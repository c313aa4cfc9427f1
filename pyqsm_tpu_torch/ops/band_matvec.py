"""Block-banded matvec and its transpose: the hand-written CUDA kernels,
their plain PyTorch versions and their launch counters.

- ``band_apply`` (y = W x) replaces ``pyqsm_tpu/ops/pallas_kernels.py:183``
  ``band_matvec_pallas``: float32 weights with C = 3 (the contraction's
  Laplacian; kernel ``csrc/band_matvec.cu``) and bf16 weights with
  C = cluster_cap in {16, 32, 64, 128} (the banded region-grow claim;
  kernel ``csrc/band_matvec_bf16.cu``), the latter also in its halo
  (``prepadded``) form, where x carries one halo block on each side (the
  sharded claim's window). All return float32. No caller of the JAX
  package passes ``prepadded`` with float32 weights, and the float32
  kernel has no halo form: it raises.
- ``band_apply_t`` (y = Wᵀ x from the forward tiles) replaces
  ``pallas_kernels.py:227`` ``band_matvec_t_pallas``; kernel
  ``csrc/band_matvec_t.cu``.

Each sends a CUDA tensor to its kernel (or raises) and a CPU tensor to the
plain version. The kernels are built by ``ops/cuda_build.py``.
"""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.cuda_build import I, P, CudaLib

BAND_BLOCK = 256  # rows per band block; window = 3 blocks

# Launches of each CUDA kernel, counted by its ``*_cuda`` wrapper (the only
# place that launches it). Reset and read by callers that want to prove a
# path ran through the kernel.
LAUNCHES = 0  # band_matvec
LAUNCHES_T = 0  # band_matvec_t
LAUNCHES_BF16 = 0  # band_matvec_bf16
LAUNCHES_BF16_HALO = 0  # band_matvec_bf16, halo (prepadded) form

LIB = CudaLib("band_matvec.cu", {"band_matvec_f32_c3": ([P, P, P, I, I, P], I)})
LIB_T = CudaLib("band_matvec_t.cu", {"band_matvec_t_f32_c3": ([P, P, P, I, I, P], I)})
LIB_BF16 = CudaLib("band_matvec_bf16.cu", {"band_matvec_bf16": ([P, P, P, I, I, I, P], I),
                                            "band_matvec_bf16_halo": ([P, P, P, I, I, I, P], I)})

# x widths the bf16 kernel takes: the powers of two that ``build_trees``'
# cluster cap can take, up to the claim dispatch's cap of 128
BF16_WIDTHS = (16, 32, 64, 128)


def _windows(x: torch.Tensor, nb: int, prepadded: bool = False) -> torch.Tensor:
    """x [T, nb·BS, C] -> the concatenated blocks b-1, b, b+1 of every
    output block, zero past the ends: [T, nb, 3·BS, C]. ``prepadded``: x is
    [T, (nb+2)·BS, C] with one halo block on each side, and block b's
    window is its padded rows [b·BS, b·BS + 3·BS) — no zero fill."""
    t, _, c = x.shape
    if prepadded:
        xb = x.reshape(t, nb + 2, BAND_BLOCK, c)
        return torch.cat([xb[:, :-2], xb[:, 1:-1], xb[:, 2:]], dim=2)
    xb = x.reshape(t, nb, BAND_BLOCK, c)
    zero = torch.zeros_like(xb[:, :1])
    prev = torch.cat([zero, xb[:, :-1]], dim=1)
    nxt = torch.cat([xb[:, 1:], zero], dim=1)
    return torch.cat([prev, xb, nxt], dim=2)


def band_matvec_plain(b_w: torch.Tensor, x: torch.Tensor, prepadded: bool = False) -> torch.Tensor:
    """Plain version: y[t, i] = Σ_j W_ij x_j as the window einsum of the
    JAX package's ``_band_apply`` (``sparse.py:215-239``), ``prepadded`` as
    there. W and x are upcast to float32 first — the einsum's
    ``preferred_element_type=float32`` — so bf16 0/1 inputs give exact
    integer counts."""
    t, nb, bs, _ = b_w.shape
    y = torch.einsum("tbrc,tbcd->tbrd", b_w.float(), _windows(x.float(), nb, prepadded))
    return y.reshape(t, nb * bs, x.shape[-1])


def _check_band(b_w: torch.Tensor, x: torch.Tensor, what: str, bf16: bool = False,
                prepadded: bool = False) -> tuple[int, int]:
    """Validate kernel inputs; returns (trees, nb). The kernels take exactly
    these forms — float32 W and x with C = 3 (``bf16=False``), bf16 W and x
    with C in ``BF16_WIDTHS`` (``bf16=True``), the latter with x
    [T, (nb+2)·256, C] when ``prepadded`` — and raise on anything else."""
    if b_w.dim() != 4 or b_w.shape[2:] != (BAND_BLOCK, 3 * BAND_BLOCK):
        raise ValueError(f"b_w must be [T, nb, {BAND_BLOCK}, {3 * BAND_BLOCK}], got {tuple(b_w.shape)}")
    t, nb = b_w.shape[:2]
    dtype = torch.bfloat16 if bf16 else torch.float32
    if b_w.dtype != dtype or x.dtype != dtype:
        raise TypeError(f"{what} kernel takes {dtype} weights and x, got {b_w.dtype} and {x.dtype}")
    if prepadded and not bf16:
        raise ValueError(f"{what} kernel has no halo (prepadded) form")
    widths = BF16_WIDTHS if bf16 else (3,)
    rows = (nb + 2 if prepadded else nb) * BAND_BLOCK
    if x.dim() != 3 or x.shape[:2] != (t, rows) or x.shape[2] not in widths:
        raise ValueError(f"x must be [{t}, {rows}, C] with C in {widths}, "
                         f"got {tuple(x.shape)}")
    if not (b_w.is_cuda and x.is_cuda and b_w.device == x.device):
        raise ValueError(f"{what} kernel needs b_w and x on one CUDA device")
    if not (b_w.is_contiguous() and x.is_contiguous()) or b_w.data_ptr() % 16 or \
            x.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs contiguous, 16-byte aligned inputs")
    return t, nb


def _launch(lib: CudaLib, fn: str, b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    t, nb = _check_band(b_w, x, fn)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib.load(), fn)(b_w.data_ptr(), x.data_ptr(), y.data_ptr(), t, nb, stream)
    lib.check(rc, fn)
    return y


def band_matvec_cuda(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The forward kernel: b_w [T, nb, 256, 768] f32, x [T, nb·256, 3] f32,
    both contiguous on one CUDA device. Raises on anything else."""
    global LAUNCHES
    y = _launch(LIB, "band_matvec_f32_c3", b_w, x)
    LAUNCHES += 1
    return y


def band_matvec_bf16_cuda(b_w: torch.Tensor, x: torch.Tensor,
                          prepadded: bool = False) -> torch.Tensor:
    """The bf16 tensor-core kernel: b_w [T, nb, 256, 768] bf16, x
    [T, nb·256, C] bf16 with C in {16, 32, 64, 128} — or, ``prepadded``,
    x [T, (nb+2)·256, C] with one halo block on each side — both
    contiguous on one CUDA device; returns float32 [T, nb·256, C]. Raises
    on anything else."""
    global LAUNCHES_BF16, LAUNCHES_BF16_HALO
    fn = "band_matvec_bf16_halo" if prepadded else "band_matvec_bf16"
    t, nb = _check_band(b_w, x, fn, bf16=True, prepadded=prepadded)
    y = torch.empty((t, nb * BAND_BLOCK, x.shape[2]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(LIB_BF16.load(), fn)(b_w.data_ptr(), x.data_ptr(), y.data_ptr(), t, nb,
                                          x.shape[2], stream)
    LIB_BF16.check(rc, fn)
    if prepadded:
        LAUNCHES_BF16_HALO += 1
    else:
        LAUNCHES_BF16 += 1
    return y


def band_matvec_t_plain(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the transpose: y[t, j] = Σ_i W_ij x_i read from the
    forward tiles, as the JAX package's ``_band_apply_t`` einsum
    (``sparse.py:242-256``): each tile's rows contract against its own x
    block, and the first/last column thirds land on the previous/next
    block."""
    t, nb, bs, _ = b_w.shape
    c = x.shape[-1]
    xb = x.reshape(t, nb, bs, c).float()
    contrib = torch.einsum("tbrc,tbrd->tbcd", b_w.float(), xb)  # [T, nb, 3·BS, C]
    t0, t1, t2 = contrib.split(bs, dim=2)
    zero = torch.zeros_like(t1[:, :1])
    acc = t1 + torch.cat([t0[:, 1:], zero], dim=1) + torch.cat([zero, t2[:, :-1]], dim=1)
    return acc.reshape(t, nb * bs, c)


def band_matvec_t_cuda(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The transpose kernel: the same inputs as ``band_matvec_cuda``;
    returns Wᵀ x. Raises on anything else."""
    global LAUNCHES_T
    y = _launch(LIB_T, "band_matvec_t_f32_c3", b_w, x)
    LAUNCHES_T += 1
    return y


def band_apply(b_w: torch.Tensor, x: torch.Tensor, prepadded: bool = False) -> torch.Tensor:
    """Σ_j W_ij x_j for block-banded W, in float32 (the JAX package's
    ``_band_apply`` signature; ``prepadded``: x carries one halo block on
    each side instead of implicit zeros): for a CUDA tensor the kernel of
    W's dtype (bf16 → ``band_matvec_bf16``, else ``band_matvec``, which
    raises on anything but float32 without a halo), for a CPU tensor the
    plain version."""
    if x.is_cuda:
        if b_w.dtype == torch.bfloat16:
            return band_matvec_bf16_cuda(b_w, x.contiguous(), prepadded)
        if prepadded:
            _check_band(b_w, x, "band_matvec", prepadded=True)
        return band_matvec_cuda(b_w, x.contiguous())
    if x.device.type == "cpu":
        return band_matvec_plain(b_w, x, prepadded)
    raise ValueError(f"band_apply: unsupported device {x.device}")


def band_apply_t(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_i W_ij x_i from the forward tiles of block-banded W: the kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return band_matvec_t_cuda(b_w, x.contiguous())
    if x.device.type == "cpu":
        return band_matvec_t_plain(b_w, x)
    raise ValueError(f"band_apply_t: unsupported device {x.device}")
