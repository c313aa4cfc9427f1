"""Point-cloud file IO (the port's own copy of ``pyqsm_tpu/io/readers.py``;
numpy only, no tensors).

First-party readers/writers for LAS (1.2–1.4, point formats 0–3 and 6–8),
PCD (ASCII + binary), PLY (ASCII + binary_little_endian), whitespace
XYZ/PTS text, and NPZ — the formats the reference handles through laspy /
Open3D / plyfile (``utils/io.py:64-119``, ``scripts/read_in_by_parts.py``).
LAS color normalisation matches the reference's ``colors/65280``
(``utils/io.py:95``). A file written by either package reads back the
same in the other.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_LAS_COLOR_SCALE = 65280.0  # utils/io.py:95


class CloudData(dict):
    """Plain dict of numpy arrays: points [N,3] f64/f32 (+ colors,
    intensity, classification, gps_time when present)."""

    @property
    def points(self) -> np.ndarray:
        return self["points"]


# ---------------------------------------------------------------------------
# LAS
# ---------------------------------------------------------------------------

_LAS_BASE_FIELDS_0 = [
    ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
    ("intensity", "<u2"), ("flags", "u1"), ("classification", "u1"),
    ("scan_angle", "i1"), ("user_data", "u1"), ("point_source", "<u2"),
]
_LAS_BASE_FIELDS_6 = [
    ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
    ("intensity", "<u2"), ("returns", "u1"), ("flags", "u1"),
    ("classification", "u1"), ("user_data", "u1"),
    ("scan_angle", "<i2"), ("point_source", "<u2"), ("gps_time", "<f8"),
]


def _las_dtype(fmt: int) -> np.dtype:
    if fmt in (0, 1, 2, 3):
        fields = list(_LAS_BASE_FIELDS_0)
        if fmt in (1, 3):
            fields.append(("gps_time", "<f8"))
        if fmt in (2, 3):
            fields += [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
        return np.dtype(fields)
    if fmt in (6, 7, 8):
        fields = list(_LAS_BASE_FIELDS_6)
        if fmt in (7, 8):
            fields += [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
        if fmt == 8:
            fields.append(("nir", "<u2"))
        return np.dtype(fields)
    raise ValueError(f"unsupported LAS point format {fmt}")


def read_las(path: str | Path) -> CloudData:
    raw = Path(path).read_bytes()
    if raw[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS file")
    ver_major, ver_minor = raw[24], raw[25]
    offset_to_points = struct.unpack_from("<I", raw, 96)[0]
    fmt = raw[104] & 0x3F  # mask compression bit (LAZ unsupported)
    if raw[104] & 0x80:
        raise ValueError(f"{path}: LAZ compression not supported")
    record_len = struct.unpack_from("<H", raw, 105)[0]
    n_points = struct.unpack_from("<I", raw, 107)[0]
    if ver_minor >= 4 and n_points == 0:
        n_points = struct.unpack_from("<Q", raw, 247)[0]
    sx, sy, sz = struct.unpack_from("<3d", raw, 131)
    ox, oy, oz = struct.unpack_from("<3d", raw, 155)

    dt = _las_dtype(fmt)
    base = np.frombuffer(
        raw, dtype=np.uint8, count=n_points * record_len, offset=offset_to_points
    ).reshape(n_points, record_len)
    rec = base[:, : dt.itemsize].copy().view(dt).reshape(n_points)

    pts = np.stack(
        [rec["x"] * sx + ox, rec["y"] * sy + oy, rec["z"] * sz + oz], axis=1
    ).astype(np.float64)
    out = CloudData(points=pts, intensity=rec["intensity"].astype(np.float32),
                    classification=rec["classification"].astype(np.int32))
    if "red" in dt.names:
        out["colors"] = np.stack(
            [rec["red"], rec["green"], rec["blue"]], axis=1
        ).astype(np.float32) / _LAS_COLOR_SCALE
    if "gps_time" in dt.names:
        out["gps_time"] = rec["gps_time"].astype(np.float64)
    return out


def write_las(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None,
              intensity: np.ndarray | None = None,
              classification: np.ndarray | None = None) -> None:
    """Minimal LAS 1.2, point format 2 (xyz + intensity + RGB)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    lo = points.min(0) if n else np.zeros(3)
    hi = points.max(0) if n else np.zeros(3)
    scale = np.maximum((hi - lo) / (2**31 - 2), 1e-8)
    header_size = 227
    fmt = 2
    dt = _las_dtype(fmt)
    rec = np.zeros(n, dtype=dt)
    q = np.round((points - lo) / scale).astype(np.int64)
    rec["x"], rec["y"], rec["z"] = q[:, 0], q[:, 1], q[:, 2]
    if intensity is not None:
        rec["intensity"] = np.clip(np.asarray(intensity), 0, 65535).astype(np.uint16)
    if classification is not None:
        rec["classification"] = np.asarray(classification).astype(np.uint8)
    if colors is not None:
        c = np.clip(np.asarray(colors) * _LAS_COLOR_SCALE, 0, 65535).astype(np.uint16)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, header_size)
    header[104] = fmt
    struct.pack_into("<H", header, 105, dt.itemsize)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale)
    struct.pack_into("<3d", header, 155, *lo)
    struct.pack_into("<2d", header, 179, hi[0], lo[0])
    struct.pack_into("<2d", header, 195, hi[1], lo[1])
    struct.pack_into("<2d", header, 211, hi[2], lo[2])
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

_PCD_TYPE = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "u1", ("U", 2): "<u2",
             ("U", 4): "<u4", ("I", 1): "i1", ("I", 2): "<i2", ("I", 4): "<i4"}


def read_pcd(path: str | Path) -> CloudData:
    raw = Path(path).read_bytes()
    lines = []
    pos = 0
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("ascii", "replace").strip()
        pos = eol + 1
        if line and not line.startswith("#"):
            lines.append(line)
        if line.startswith("DATA"):
            break
    hdr = {l.split()[0]: l.split()[1:] for l in lines}
    fields = hdr["FIELDS"]
    sizes = list(map(int, hdr["SIZE"]))
    types = hdr["TYPE"]
    counts = list(map(int, hdr.get("COUNT", ["1"] * len(fields))))
    n = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0]
    dt = np.dtype([
        (f if c == 1 else f, _PCD_TYPE[(t, s)], (c,) if c > 1 else ())
        for f, s, t, c in zip(fields, sizes, types, counts)
    ])
    if mode == "ascii":
        arr = np.loadtxt(
            [l for l in raw[pos:].decode("ascii", "replace").splitlines() if l.strip()],
            dtype=np.float64,
        ).reshape(n, -1)
        cols = {}
        i = 0
        for f, c in zip(fields, counts):
            cols[f] = arr[:, i] if c == 1 else arr[:, i:i + c]
            i += c
    elif mode == "binary":
        rec = np.frombuffer(raw, dtype=dt, count=n, offset=pos)
        cols = {f: rec[f] for f in fields}
    else:
        raise ValueError(f"PCD DATA mode {mode} unsupported")
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float64)
    out = CloudData(points=pts)
    if "rgb" in cols:  # packed float rgb
        packed = np.asarray(cols["rgb"], np.float32).view(np.uint32)
        out["colors"] = np.stack(
            [(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], axis=1
        ).astype(np.float32) / 255.0
    if "intensity" in cols:
        out["intensity"] = np.asarray(cols["intensity"], np.float32)
    return out


def write_pcd(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Binary PCD with xyz (+ packed rgb)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    fields, sizes, types, counts = ["x", "y", "z"], [4, 4, 4], ["F", "F", "F"], [1, 1, 1]
    if colors is not None:
        fields.append("rgb"); sizes.append(4); types.append("F"); counts.append(1)
    hdr = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\nSIZE {' '.join(map(str, sizes))}\n"
        f"TYPE {' '.join(types)}\nCOUNT {' '.join(map(str, counts))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    dt = np.dtype([(f, "<f4") for f in fields])
    rec = np.zeros(n, dtype=dt)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        c = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint32)
        packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        rec["rgb"] = packed.view(np.float32)
    with open(path, "wb") as f:
        f.write(hdr.encode("ascii"))
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPE = {"float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
             "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
             "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
             "uint": "<u4", "uint32": "<u4"}


def read_ply(path: str | Path) -> CloudData:
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    n = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for l in header:
        t = l.split()
        if not t:
            continue
        if t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n = int(t[2])
        elif t[0] == "property" and in_vertex:
            props.append((t[2], _PLY_TYPE[t[1]]))
    dt = np.dtype(props)
    if fmt == "ascii":
        body = raw[end:].decode("ascii").splitlines()[:n]
        arr = np.loadtxt(body, dtype=np.float64).reshape(n, len(props))
        cols = {p[0]: arr[:, i] for i, p in enumerate(props)}
    elif fmt == "binary_little_endian":
        rec = np.frombuffer(raw, dtype=dt, count=n, offset=end)
        cols = {p[0]: rec[p[0]] for p in props}
    else:
        raise ValueError(f"PLY format {fmt} unsupported")
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float64)
    out = CloudData(points=pts)
    if "red" in cols:
        scale = 255.0 if dt["red"].kind == "u" and dt["red"].itemsize == 1 else 65535.0
        out["colors"] = np.stack(
            [cols["red"], cols["green"], cols["blue"]], axis=1
        ).astype(np.float32) / scale
    return out


def write_ply(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    points = np.asarray(points, np.float32)
    n = len(points)
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines.append("end_header")
    rec = np.zeros(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        c = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# text XYZ / PTS + NPZ + dispatch
# ---------------------------------------------------------------------------


def read_xyz(path: str | Path, max_rows: int | None = None) -> CloudData:
    """Whitespace text: x y z [intensity [r g b]] (the .pts/.xyz scans of
    ``scripts/read_in_by_parts.py``)."""
    arr = np.loadtxt(path, dtype=np.float64, max_rows=max_rows, ndmin=2)
    out = CloudData(points=arr[:, :3])
    if arr.shape[1] >= 4:
        out["intensity"] = arr[:, 3].astype(np.float32)
    if arr.shape[1] >= 7:
        c = arr[:, 4:7].astype(np.float32)
        out["colors"] = c / 255.0 if c.max() > 1.0 else c
    return out


def write_xyz(path: str | Path, points: np.ndarray,
              intensity: np.ndarray | None = None) -> None:
    cols = [np.asarray(points, np.float64)]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float64)[:, None])
    np.savetxt(path, np.concatenate(cols, axis=1), fmt="%.6f")


def read_npz(path: str | Path) -> CloudData:
    """NPZ with a 'points'/'pts' array + optional attribute arrays (the
    reference's per-feature NPZ caches, ``utils/io.py:112-119``)."""
    data = np.load(path, allow_pickle=False)
    keys = set(data.keys())
    pts_key = "points" if "points" in keys else ("pts" if "pts" in keys else None)
    if pts_key is None:
        raise ValueError(f"{path}: no points/pts array")
    out = CloudData(points=np.asarray(data[pts_key]))
    for k in keys - {pts_key}:
        out[k] = np.asarray(data[k])
    return out


def write_npz(path: str | Path, points: np.ndarray, **attrs: np.ndarray) -> None:
    np.savez_compressed(path, points=np.asarray(points),
                        **{k: np.asarray(v) for k, v in attrs.items() if v is not None})


_READERS = {
    ".las": read_las, ".pcd": read_pcd, ".ply": read_ply,
    ".xyz": read_xyz, ".pts": read_xyz, ".txt": read_xyz, ".npz": read_npz,
}


def read_point_cloud(path: str | Path) -> CloudData:
    """Extension-dispatched reader (the capability of Open3D
    ``read_point_cloud`` as used throughout the reference)."""
    suffix = Path(path).suffix.lower()
    if suffix not in _READERS:
        raise ValueError(f"unsupported point-cloud format: {suffix}")
    return _READERS[suffix](path)
