"""Batch pipeline driver (counterpart of ``pyqsm_tpu/pipeline/driver.py``):
seed-keyed file discovery, declarative per-file-type loading, a batch
runner that collects each seed's errors, and staged work with NPZ
checkpoints and ``start=`` resume. Whole pytree snapshots go through
``torch.save``/``torch.load``.

The NPZ checkpoints hold every array or tensor of the state as numpy, under
the JAX package's names (``<workdir>/<seed>_<stage>.npz``), so either
package resumes from the other's.
"""

from __future__ import annotations

import logging
import re
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from pyqsm_tpu_torch.io.readers import read_point_cloud

log = logging.getLogger("pyqsm_tpu_torch.pipeline")


def get_files_by_seed(
    folders: list[str | Path],
    seed_pattern: str = r"(\d+)",
    extensions: tuple[str, ...] = (".las", ".pcd", ".ply", ".npz", ".xyz", ".pts"),
) -> dict[str, list[Path]]:
    """Group files by the seed id captured by ``seed_pattern`` in the file
    name (folders in order, files sorted by name)."""
    out: dict[str, list[Path]] = {}
    pat = re.compile(seed_pattern)
    for folder in folders:
        folder = Path(folder)
        if not folder.exists():
            continue
        for f in sorted(folder.iterdir()):
            if f.suffix.lower() not in extensions:
                continue
            m = pat.search(f.name)
            if m:
                out.setdefault(m.group(1), []).append(f)
    return out


def load_seed_data(
    files: list[Path],
    loaders: dict[str, Callable[[Path], Any]] | None = None,
) -> dict[str, Any]:
    """Per-file-type loading: ``loaders`` maps a file-name substring to a
    loader; a file no key matches is read with ``read_point_cloud`` and
    keyed by its stem."""
    out: dict[str, Any] = {}
    for f in files:
        loaded = None
        name = None
        if loaders:
            for key, fn in loaders.items():
                if key in f.name:
                    loaded = fn(f)
                    name = key
                    break
        if loaded is None:
            loaded = read_point_cloud(f)
            name = f.stem
        out[name] = loaded
    return out


def loop_over_files(
    func: Callable[[str, dict], Any],
    folders: list[str | Path],
    seed_pattern: str = r"(\d+)",
    loaders: dict[str, Callable] | None = None,
    skip_seeds: tuple[str, ...] = (),
    n_workers: int = 1,
) -> tuple[dict[str, Any], dict[str, str]]:
    """Run ``func(seed, data)`` for every discovered seed, collecting each
    seed's error (type, message and traceback) instead of stopping. With
    ``n_workers`` > 1 the seeds run on that many threads."""
    by_seed = get_files_by_seed(folders, seed_pattern)
    results: dict[str, Any] = {}
    errors: dict[str, str] = {}

    def run(seed: str) -> None:
        if seed in skip_seeds:
            return
        try:
            data = load_seed_data(by_seed[seed], loaders)
            results[seed] = func(seed, data)
        except Exception as e:  # noqa: BLE001 — per-seed isolation is the point
            errors[seed] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            log.error("seed %s failed: %s", seed, e)

    if n_workers > 1:
        with ThreadPoolExecutor(n_workers) as pool:
            list(pool.map(run, by_seed))
    else:
        for seed in by_seed:
            run(seed)
    return results, errors


def _to_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class StagedPipeline:
    """Named stages with NPZ checkpoints and ``start=`` resume.

    Each stage is ``fn(state: dict) -> dict``. After each stage every array
    or tensor of the state is saved, as numpy, to
    ``<workdir>/<seed>_<stage>.npz``. ``run(start=...)`` loads the
    checkpoint of the stage before ``start`` (numpy arrays) and continues
    from there.
    """

    def __init__(self, workdir: str | Path, seed: str = "default") -> None:
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.seed = seed
        self.stages: list[tuple[str, Callable[[dict], dict]]] = []

    def add_stage(self, name: str, fn: Callable[[dict], dict]) -> "StagedPipeline":
        self.stages.append((name, fn))
        return self

    def _path(self, stage: str) -> Path:
        return self.workdir / f"{self.seed}_{stage}.npz"

    def run(self, state: dict | None = None, start: str | None = None) -> dict:
        names = [n for n, _ in self.stages]
        begin = 0
        if start is not None:
            if start not in names:
                raise ValueError(f"unknown stage {start!r}; have {names}")
            begin = names.index(start)
            if begin > 0:
                prev = self._path(names[begin - 1])
                if not prev.exists():
                    raise FileNotFoundError(
                        f"cannot resume at {start!r}: missing checkpoint {prev}")
                state = dict(np.load(prev))
                log.info("resumed from %s", prev)
        if state is None:
            state = {}
        for name, fn in self.stages[begin:]:
            log.info("stage %s", name)
            state = fn(state)
            arrays = {k: _to_numpy(v) for k, v in state.items()
                      if isinstance(v, (np.ndarray, torch.Tensor))}
            np.savez_compressed(self._path(name), **arrays)
        return state


_NDARRAY = "__ndarray__"


def _pack(tree):
    if isinstance(tree, np.ndarray):
        return {_NDARRAY: torch.from_numpy(np.ascontiguousarray(tree))}
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pack(v) for v in tree)
    return tree


def _unpack(tree, template=None):
    if isinstance(tree, dict) and set(tree) == {_NDARRAY}:
        return tree[_NDARRAY].numpy()
    if isinstance(tree, dict):
        return {k: _unpack(v, None if template is None else template[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        tmpl = [None] * len(tree) if template is None else template
        return type(tree)(_unpack(v, t) for v, t in zip(tree, tmpl))
    if isinstance(tree, torch.Tensor) and isinstance(template, torch.Tensor):
        return tree.to(template.device)
    return tree


def save_checkpoint(path: str | Path, pytree: Any) -> None:
    """Save a pytree (dicts, lists and tuples of tensors, numpy arrays and
    Python scalars) with ``torch.save``; tensors keep their devices."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_pack(pytree), path)


def load_checkpoint(path: str | Path, template: Any | None = None) -> Any:
    """Load a ``save_checkpoint`` pytree (``weights_only``: tensors,
    containers and scalars only). Tensors come back on the devices they
    were saved from, or with ``template`` (a pytree of the same structure)
    on its tensors' devices; numpy arrays come back as numpy."""
    tree = torch.load(Path(path), map_location="cpu" if template is not None else None,
                      weights_only=True)
    return _unpack(tree, template)
