"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` beside this
package (git-ignored, cached by source and flags) and loaded with
``ctypes`` — seconds per source, where a source that includes PyTorch's
headers takes minutes. Every ``CudaLib`` registers itself in ``REGISTRY``;
the first ``load`` of any of them builds every registered source that is
not built yet, one ``nvcc`` each, all started at once (``build_all``), so
a cold start costs the slowest build, not their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

REGISTRY: list["CudaLib"] = []  # every kernel library the port declares


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from csrc/*.cu "
                       "with the CUDA toolkit's nvcc")


class CudaLib:
    """One kernel source, its C functions' signatures and its loaded library.

    ``functions`` maps a C function name to ``(argtypes, restype)``; every
    library also exports ``<stem>_error_string(int)``."""

    def __init__(self, source: str, functions: dict, extra_flags: tuple[str, ...] = ()):
        self.source = CSRC / source
        self.functions = functions
        self.flags = NVCC_FLAGS + list(extra_flags)
        self.log = ""  # nvcc/ptxas output of the build this process made
        self._lib = None
        REGISTRY.append(self)

    def target(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{tag.hexdigest()[:16]}.so"

    def _start(self):
        """Start nvcc unless the library is built; returns (proc, tmp) or None."""
        if self.target().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *self.flags, "-o", tmp, str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish(self, started) -> Path:
        out = self.target()
        if started is None:
            return out
        proc, tmp = started
        try:
            self.log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                                   f"{self.log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def build(self) -> Path:
        """Compile (cached) and return the .so; raises with nvcc's output."""
        return self._finish(self._start())

    def load(self):
        if self._lib is None:
            if not self.target().exists():
                build_all()  # this source together with every other unbuilt one
            lib = ctypes.CDLL(str(self.build()))
            for name, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            err = getattr(lib, f"{self.source.stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise when a launch returned a CUDA error code."""
        if rc != 0:
            msg = getattr(self.load(), f"{self.source.stem}_error_string")(rc).decode()
            raise RuntimeError(f"{what} launch failed: {msg}")


def build_all(libs=None) -> list[Path]:
    """Build every library (default: ``REGISTRY``) at once, one nvcc process
    each, and return the paths; raises on the first failed build after all
    have ended."""
    libs = REGISTRY if libs is None else list(libs)
    started = [lib._start() for lib in libs]
    errors, paths = [], []
    for lib, s in zip(libs, started):
        try:
            paths.append(lib._finish(s))
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


P = ctypes.c_void_p
I = ctypes.c_int
