"""Artifact serialization — no pickles (counterpart of
``pyqsm_tpu/io/artifacts.py``): scene clouds and cylinder lists as NPZ
(the reference's cylinder-dict field names), metric dicts as JSON, and a
plain-text table formatter standing in for PrettyTable. Tensors cross to
numpy here; loads put them on ``device`` (the card by default). The files
are the JAX package's: either package reads what the other wrote.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device, to_numpy
from pyqsm_tpu_torch.state import Cylinders, PointCloud


def save_artifact(path: str | Path, cloud: PointCloud) -> None:
    arrs = {"points": to_numpy(cloud.points), "mask": to_numpy(cloud.mask)}
    for name in ("colors", "intensity", "normals", "labels", "tree_id", "shift"):
        v = getattr(cloud, name)
        if v is not None:
            arrs[name] = to_numpy(v)
    np.savez_compressed(path, **arrs)


def load_artifact(path: str | Path, device: str | torch.device = DEFAULT_DEVICE) -> PointCloud:
    dev = resolve_device(device)
    data = np.load(path)
    return PointCloud(**{k: torch.as_tensor(data[k], device=dev) for k in data.keys()})


def save_cylinders(path: str | Path, cyls: Cylinders) -> None:
    np.savez_compressed(path, **{f: to_numpy(getattr(cyls, f)) for f in Cylinders._fields})


def load_cylinders(path: str | Path, device: str | torch.device = DEFAULT_DEVICE) -> Cylinders:
    dev = resolve_device(device)
    d = np.load(path)
    return Cylinders(**{k: torch.as_tensor(d[k], device=dev) for k in d.keys()})


def save_metrics(path: str | Path, metrics: dict) -> None:
    Path(path).write_text(json.dumps(_jsonify(metrics), indent=2))


def load_metrics(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())


def _jsonify(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return to_numpy(obj).tolist()
    return obj


def format_table(rows: list[dict], columns: list[str] | None = None) -> str:
    """Aligned plain-text table (PrettyTable stand-in for results reporting,
    ``scripts/result_related/get_projection_results.py:63-90``)."""
    if not rows:
        return "(empty)"
    if columns is None:
        columns = list(rows[0].keys())
    cells = [[_fmt(r.get(c, "")) for c in columns] for r in rows]
    widths = [max(len(c), max(len(row[i]) for row in cells)) for i, c in enumerate(columns)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "| " + " | ".join(c.ljust(w) for c, w in zip(columns, widths)) + " |", sep]
    for row in cells:
        out.append("| " + " | ".join(v.ljust(w) for v, w in zip(row, widths)) + " |")
    out.append(sep)
    return "\n".join(out)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)
