"""Block-banded matvec: the hand-written CUDA kernel, its plain PyTorch
version, its launch counter and its loader.

Replaces ``pyqsm_tpu/ops/pallas_kernels.py:183`` ``band_matvec_pallas``.
``band_apply`` is the one entry the port calls: a CUDA tensor goes to the
kernel (or the call raises), a CPU tensor to the plain version.

The kernel (``csrc/band_matvec.cu``) has a plain C interface: it is built
with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` beside this
package (git-ignored) and loaded with ``ctypes`` — seconds, where a source
that includes PyTorch's headers takes minutes to build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

BAND_BLOCK = 256  # rows per band block; window = 3 blocks

# Launches of the CUDA kernel by ``band_matvec_cuda`` (the only place that
# launches it). Reset and read by callers that want to prove the path ran.
LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "band_matvec.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
BUILD_LOG = ""  # nvcc/ptxas output of the build this process loaded


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the band_matvec kernel is built from "
                       "csrc/band_matvec.cu with the CUDA toolkit's nvcc")


def build() -> Path:
    """Compile the kernel (cached by source and flags) and return the .so.
    Raises with nvcc's output when the build fails."""
    global BUILD_LOG
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libband_matvec_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.band_matvec_f32_c3.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.band_matvec_f32_c3.restype = ctypes.c_int
        lib.band_matvec_error_string.argtypes = [ctypes.c_int]
        lib.band_matvec_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _windows(x: torch.Tensor, nb: int) -> torch.Tensor:
    """x [T, nb·BS, C] -> the concatenated blocks b-1, b, b+1 of every
    output block, zero past the ends: [T, nb, 3·BS, C]."""
    t, _, c = x.shape
    xb = x.reshape(t, nb, BAND_BLOCK, c)
    zero = torch.zeros_like(xb[:, :1])
    prev = torch.cat([zero, xb[:, :-1]], dim=1)
    nxt = torch.cat([xb[:, 1:], zero], dim=1)
    return torch.cat([prev, xb, nxt], dim=2)


def band_matvec_plain(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y[t, i] = Σ_j W_ij x_j as the window einsum of the
    JAX package's ``_band_apply`` (``sparse.py:227-239``), in float32."""
    t, nb, bs, _ = b_w.shape
    y = torch.einsum("tbrc,tbcd->tbrd", b_w, _windows(x, nb).to(b_w.dtype))
    return y.reshape(t, nb * bs, x.shape[-1]).to(torch.float32)


def band_matvec_cuda(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: b_w [T, nb, 256, 768] f32, x [T, nb·256, 3] f32,
    both contiguous on one CUDA device. Raises on anything else."""
    global LAUNCHES
    if b_w.dim() != 4 or b_w.shape[2:] != (BAND_BLOCK, 3 * BAND_BLOCK):
        raise ValueError(f"b_w must be [T, nb, {BAND_BLOCK}, {3 * BAND_BLOCK}], got {tuple(b_w.shape)}")
    t, nb = b_w.shape[:2]
    if x.shape != (t, nb * BAND_BLOCK, 3):
        raise ValueError(f"x must be [{t}, {nb * BAND_BLOCK}, 3], got {tuple(x.shape)}")
    if b_w.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("band_matvec kernel takes float32 weights and x (bf16 is not ported)")
    if not (b_w.is_cuda and x.is_cuda and b_w.device == x.device):
        raise ValueError("band_matvec kernel needs b_w and x on one CUDA device")
    if not (b_w.is_contiguous() and x.is_contiguous()) or b_w.data_ptr() % 16:
        raise ValueError("band_matvec kernel needs contiguous, 16-byte aligned inputs")
    lib = _load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.band_matvec_f32_c3(b_w.data_ptr(), x.data_ptr(), y.data_ptr(), t, nb, stream)
    if rc != 0:
        raise RuntimeError(f"band_matvec launch failed: {lib.band_matvec_error_string(rc).decode()}")
    LAUNCHES += 1
    return y


def band_apply(b_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_j W_ij x_j for block-banded W: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.is_cuda:
        return band_matvec_cuda(b_w, x.contiguous())
    if x.device.type == "cpu":
        return band_matvec_plain(b_w, x)
    raise ValueError(f"band_apply: unsupported device {x.device}")
