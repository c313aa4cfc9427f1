"""Typed configuration system of the PyTorch port.

Mirrors the original pyQSM project's TOML schema (section/key names from
its ``pyqsm_config.toml``) so existing config files load
unchanged, but replaces the reference's import-time global-dict pattern
(``pyQSM/set_config.py:21-44``) with frozen dataclasses that are explicit
function arguments (the PyTorch port keeps its own copy of the JAX
package's schema so that it never imports that package).

Env-var compatibility: ``PY_QSM_CONFIG`` selects the TOML file, as in
``set_config.py:16``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

log = logging.getLogger("pyqsm_tpu_torch")

_CONFIG_ENV_VAR = "PY_QSM_CONFIG"


@dataclass(frozen=True)
class IOConfig:
    """``[io]`` — pyqsm_config.toml:27-29."""

    data_root: str = "data/"
    super_user: bool = False


@dataclass(frozen=True)
class InitialCleanConfig:
    """``[initial_clean]`` — pyqsm_config.toml:34-38.

    Voxel downsample + iterated statistical outlier removal; the reference
    escalates neighbors x2 and shrinks ratio /1.5 per iteration
    (point_cloud_processing.py:117-121).
    """

    voxel_size: float = 0.04
    neighbors: int = 2
    ratio: float = 4.0
    iters: int = 3


@dataclass(frozen=True)
class StemConfig:
    """``[stem]`` — pyqsm_config.toml:40-49."""

    normals_radius: float = 0.1
    normals_nn: int = 30
    normals_smoothing_nn: int = 50
    angle_cutoff: float = 10.0
    stem_voxel_size: float = 0.0  # reference uses '' for disabled
    post_id_stat_down: bool = False
    stem_neighbors: int = 10
    stem_ratio: float = 2.0
    stem_iters: int = 3


@dataclass(frozen=True)
class TrunkConfig:
    """``[trunk]`` — pyqsm_config.toml:51-61."""

    num_lowest: int = 2000
    trunk_neighbors: int = 10
    trunk_ratio: float = 0.25
    cluster_eps: float = 0.8
    cluster_nn: int = 10
    lower_pctile: float = 3.0
    upper_pctile: float = 10.0


@dataclass(frozen=True)
class SkeletonizeConfig:
    """``[skeletonize]`` — pyqsm_config.toml:63-79.

    Laplacian contraction parameters. ``step_wise_contraction_amplification``
    'auto' selects tiered amplification by point count, as in
    skeletonize.py:182-223.
    """

    moll: float = 1e-6
    n_neighbors: int = 20
    max_iter: int = 20
    semantic_weight: float = 10.0
    init_contraction: float = 3.0
    init_attraction: float = 3.0
    max_contraction: float = 2048.0
    max_attraction: float = 1024.0
    termination_ratio: float = 0.003
    step_wise_contraction_amplification: str | float = "auto"
    graph_k_n: int = 15


@dataclass(frozen=True)
class DBSCANConfig:
    """``[dbscan]`` — pyqsm_config.toml:81-83."""

    epsilon: float = 0.1
    min_neighbors: int = 10


@dataclass(frozen=True)
class SphereConfig:
    """``[sphere]`` — pyqsm_config.toml:85-91 (sphere-following QSM step)."""

    min_radius: float = 0.01
    max_radius: float = 1.5
    radius_multiplier: float = 1.75
    dist: float = 0.07
    bad_fit_radius_factor: float = 2.5
    min_contained_points: int = 8


@dataclass(frozen=True)
class IsolationConfig:
    """Region-growing defaults (tree_isolation.py:67-70,250 — not in TOML
    in the reference; exposed here as a proper section)."""

    k: int = 200
    max_dist: float = 0.1
    cycles: int = 150
    min_frontier: int = 5
    base_eps: float = 1.0
    base_min_points: int = 300
    low_pctile: float = 3.0


@dataclass(frozen=True)
class RaycastConfig:
    """Ray-engine defaults (viz/ray_casting.py:45-47 pinhole 640x480)."""

    width_px: int = 640
    height_px: int = 480
    fov_deg: float = 90.0


@dataclass(frozen=True)
class Config:
    """Top-level config bundling every section."""

    io: IOConfig = field(default_factory=IOConfig)
    initial_clean: InitialCleanConfig = field(default_factory=InitialCleanConfig)
    stem: StemConfig = field(default_factory=StemConfig)
    trunk: TrunkConfig = field(default_factory=TrunkConfig)
    skeletonize: SkeletonizeConfig = field(default_factory=SkeletonizeConfig)
    dbscan: DBSCANConfig = field(default_factory=DBSCANConfig)
    sphere: SphereConfig = field(default_factory=SphereConfig)
    isolation: IsolationConfig = field(default_factory=IsolationConfig)
    raycast: RaycastConfig = field(default_factory=RaycastConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


_SECTION_TYPES = {
    "io": IOConfig,
    "initial_clean": InitialCleanConfig,
    "stem": StemConfig,
    "trunk": TrunkConfig,
    "skeletonize": SkeletonizeConfig,
    "dbscan": DBSCANConfig,
    "sphere": SphereConfig,
    "isolation": IsolationConfig,
    "raycast": RaycastConfig,
}


def _coerce(cls: type, raw: dict[str, Any]) -> Any:
    """Build a section dataclass from raw TOML, tolerating the reference's
    quirks (e.g. ``stem_voxel_size = ''`` meaning disabled)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for key, value in raw.items():
        f = fields.get(key)
        if f is None:
            log.debug("config: ignoring unknown key %s.%s", cls.__name__, key)
            continue
        if value == "" and f.type in ("float", "int"):
            value = 0
        if f.type == "float" and isinstance(value, (int, float)):
            value = float(value)
        kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str | Path | None = None) -> Config:
    """Load a TOML config file; path defaults to ``$PY_QSM_CONFIG``.

    With no path and no env var, returns defaults (which mirror the
    reference's shipped ``pyqsm_config.toml``).
    """
    if path is None:
        path = os.environ.get(_CONFIG_ENV_VAR)
    if path is None:
        return Config()
    raw = tomllib.loads(Path(path).read_text())
    sections = {
        name: _coerce(cls, raw[name]) for name, cls in _SECTION_TYPES.items() if name in raw
    }
    return Config(**sections)
