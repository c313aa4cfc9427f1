"""ctypes bindings to the port's C++ ingestion library
(``csrc/pointio.cpp``; counterpart of ``pyqsm_tpu/io/native.py``).

The library is built with ``g++`` at first use into ``_build/`` beside the
package (git-ignored; the file name is a hash of the source and the flags,
written atomically) and loaded with ``ctypes``. Every entry point keeps
the numpy path, the plain version the native one is held against; when
the build fails a warning is logged and the numpy path serves.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger("pyqsm_tpu_torch.io")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pointio.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: ctypes.CDLL | None = None
_build_failed = False


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpointio_{tag}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _get_lib() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
        dp = ctypes.POINTER(ctypes.c_double)
        lp = ctypes.POINTER(ctypes.c_int64)
        lib.parse_xyz.restype = ctypes.c_int64
        lib.parse_xyz.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, dp,
                                  ctypes.c_int64]
        lib.count_rows.restype = ctypes.c_int64
        lib.count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.voxel_accumulate.restype = ctypes.c_int64
        lib.voxel_accumulate.argtypes = [dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                                         ctypes.c_double, ctypes.c_double, lp, dp, lp,
                                         ctypes.c_int64]
        _lib = lib
    except Exception as e:  # noqa: BLE001 — any build or load fault: the numpy path serves
        log.warning("native pointio unavailable (%s); using the numpy path", e)
        _build_failed = True
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _parse_numpy(data: bytes, n_cols: int) -> np.ndarray:
    rows = [ln.split()[:n_cols] for ln in data.decode("ascii", "replace").splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]
    rows = [r for r in rows if len(r) == n_cols]
    return np.asarray(rows, dtype=np.float64)


def parse_text_points(data: bytes, n_cols: int) -> np.ndarray:
    """Whitespace text → [rows, n_cols] float64: the native parser, or the
    numpy path (``_parse_numpy``) when it is unavailable."""
    lib = _get_lib()
    if lib is None:
        return _parse_numpy(data, n_cols)
    max_rows = lib.count_rows(data, len(data))
    out = np.empty((max(max_rows, 1), n_cols), np.float64)
    n = lib.parse_xyz(data, len(data), n_cols,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows)
    return out[:n]


class StreamingVoxelizer:
    """Streaming voxel accumulator for out-of-core ingestion: feed point
    batches, get voxel centroids at the end; the raw scan never lives in
    memory whole. An open-addressing table of packed 21-bit cell keys, sums
    and counts (float64 on the host)."""

    def __init__(self, voxel: float, origin=(0.0, 0.0, 0.0), table_size: int = 1 << 22):
        self.voxel = voxel
        self.origin = origin
        self.table_size = table_size
        self.keys = np.full(table_size, np.iinfo(np.int64).min, np.int64)
        self.sums = np.zeros((table_size, 3), np.float64)
        self.counts = np.zeros(table_size, np.int64)
        self._lib = _get_lib()  # None: the numpy path

    def add(self, points: np.ndarray) -> None:
        pts = np.ascontiguousarray(points, np.float64)
        if self._lib is not None:
            self._lib.voxel_accumulate(
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts),
                self.voxel, *self.origin,
                self.keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.sums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                self.counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.table_size)
            return
        c = np.floor((pts - np.asarray(self.origin)) / self.voxel).astype(np.int64)
        key = ((c[:, 0] & 0x1FFFFF) << 42) | ((c[:, 1] & 0x1FFFFF) << 21) | (c[:, 2] & 0x1FFFFF)
        order = np.argsort(key)
        key_s = key[order]
        pts_s = pts[order]
        uniq, start = np.unique(key_s, return_index=True)
        sums = np.add.reduceat(pts_s, start, axis=0)
        cnts = np.diff(np.append(start, len(pts_s)))
        h = (uniq.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) % np.uint64(self.table_size)
        for k, s, n, slot0 in zip(uniq, sums, cnts, h.astype(np.int64)):
            slot = int(slot0)
            while True:
                if self.keys[slot] == np.iinfo(np.int64).min:
                    self.keys[slot] = k
                    break
                if self.keys[slot] == k:
                    break
                slot = (slot + 1) % self.table_size
            self.sums[slot] += s
            self.counts[slot] += n

    def centroids(self) -> np.ndarray:
        occ = self.counts > 0
        return (self.sums[occ] / self.counts[occ][:, None]).astype(np.float32)


def read_xyz_stream(path: str | Path, batch_bytes: int = 64 << 20, n_cols: int = 3,
                    voxel: float | None = None):
    """Stream a text scan in byte batches (rows never split across
    batches). Yields [B, n_cols] float64 arrays; with ``voxel`` set, yields
    the voxel centroids once at the end instead."""
    vox = StreamingVoxelizer(voxel) if voxel else None
    with open(path, "rb") as f:
        carry = b""
        while True:
            chunk = f.read(batch_bytes)
            if not chunk:
                break
            chunk = carry + chunk
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                carry = chunk
                continue
            carry, body = chunk[last_nl + 1:], chunk[: last_nl + 1]
            arr = parse_text_points(body, n_cols)
            if vox is not None:
                vox.add(arr[:, :3])
            else:
                yield arr
        if carry.strip():
            arr = parse_text_points(carry, n_cols)
            if vox is not None:
                vox.add(arr[:, :3])
            else:
                yield arr
    if vox is not None:
        yield vox.centroids()
