"""Columnar scene state as tensor containers.

Counterparts of the JAX package's pytrees (``PointCloud``, ``Cylinders``,
``Topology``, ``SceneState``): fixed-capacity padded tensors with a
validity mask. Selection is a mask update, not a copy; rows stay in place,
so indices into the parent stay valid. Leading batch axes are allowed on
every field (the batched contraction carries a trees axis in front).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _pad_to(x, capacity: int, dtype: torch.dtype, device, fill: float = 0.0) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    n = t.shape[0]
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    out = torch.full((capacity,) + tuple(t.shape[1:]), fill, dtype=dtype, device=device)
    out[:n] = t.to(device=device, dtype=dtype)
    return out


class PointCloud(NamedTuple):
    """Fixed-capacity padded point cloud: positions, colors, intensity,
    normals, labels (cluster/tree ids, -1 unassigned), tree ids and the
    contraction shift, as in the JAX package."""

    points: torch.Tensor  # [N, 3] f32
    mask: torch.Tensor  # [N] bool — live rows
    colors: torch.Tensor | None = None  # [N, 3] f32 in [0, 1]
    intensity: torch.Tensor | None = None  # [N] f32
    normals: torch.Tensor | None = None  # [N, 3] f32
    labels: torch.Tensor | None = None  # [N] i32 (-1 = unassigned)
    tree_id: torch.Tensor | None = None  # [N] i32
    shift: torch.Tensor | None = None  # [N, 3] f32 contraction displacement

    @staticmethod
    def create(points, capacity: int | None = None, colors=None, intensity=None, normals=None,
               labels=None, device: str | torch.device = DEFAULT_DEVICE) -> "PointCloud":
        """Pad the given rows to ``capacity`` (default: their count) on
        ``device``; padding rows are dead (labels -1)."""
        dev = resolve_device(device)
        n = points.shape[0]
        if capacity is None:
            capacity = n

        def pad(v, dtype, fill=0.0):
            return None if v is None else _pad_to(v, capacity, dtype, dev, fill)

        return PointCloud(points=pad(points, torch.float32),
                          mask=torch.arange(capacity, device=dev) < n,
                          colors=pad(colors, torch.float32),
                          intensity=pad(intensity, torch.float32),
                          normals=pad(normals, torch.float32),
                          labels=pad(labels, torch.int32, -1))

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Number of live points."""
        return self.mask.sum(dtype=torch.int32)

    def select(self, keep: torch.Tensor) -> "PointCloud":
        """Keep only the live rows where ``keep`` is True (rows stay in place)."""
        return self._replace(mask=self.mask & keep)

    def with_(self, **kw) -> "PointCloud":
        return self._replace(**kw)

    def masked_points(self, fill: float = math.inf) -> torch.Tensor:
        """Points with dead rows set to ``fill`` (keeps them out of
        min-distance reductions)."""
        return torch.where(self.mask[:, None], self.points, fill)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The live rows of every field as host numpy arrays."""
        mask = self.mask.cpu().numpy()
        return {f: getattr(self, f).cpu().numpy()[mask] for f in self._fields
                if f != "mask" and getattr(self, f) is not None}

    def compact(self) -> "PointCloud":
        """Drop dead rows (new, smaller capacity), on the same device."""
        arrs = self.to_numpy()
        dev = self.points.device
        pc = PointCloud.create(arrs.pop("points"), device=dev)
        return pc._replace(**{k: torch.as_tensor(v, device=dev) for k, v in arrs.items()})


class Cylinders(NamedTuple):
    """Fitted cylinders — the QSM output (center, axis, height, radius as in
    the reference's cylinder dict, plus branch-order/parent bookkeeping)."""

    center: torch.Tensor  # [M, 3]
    axis: torch.Tensor  # [M, 3] unit
    height: torch.Tensor  # [M]
    radius: torch.Tensor  # [M]
    branch_order: torch.Tensor  # [M] i32
    parent: torch.Tensor  # [M] i32 (-1 = root)
    mask: torch.Tensor  # [M] bool

    @property
    def capacity(self) -> int:
        return self.center.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def volume(self) -> torch.Tensor:
        """Total woody volume of the live cylinders."""
        v = math.pi * self.radius ** 2 * self.height
        return torch.where(self.mask, v, 0.0).sum()


class Topology(NamedTuple):
    """Skeleton topology: FPS'd vertices + MST edges + point->vertex map."""

    vertices: torch.Tensor  # [V, 3]
    vertex_mask: torch.Tensor  # [V] bool
    edges: torch.Tensor  # [E, 2] i32 indices into vertices
    edge_mask: torch.Tensor  # [E] bool
    point_to_vertex: torch.Tensor  # [N] i32


class SceneState(NamedTuple):
    """A plot scene: the cloud plus a pipeline step counter."""

    cloud: PointCloud
    step: torch.Tensor | None = None  # scalar i32

    def with_(self, **kw) -> "SceneState":
        return self._replace(**kw)


def concatenate(clouds: list[PointCloud]) -> PointCloud:
    """Concatenate clouds (capacities add); a field absent from any cloud is
    absent from the result."""
    fields = {}
    for name in PointCloud._fields:
        vals = [getattr(c, name) for c in clouds]
        fields[name] = None if any(v is None for v in vals) else torch.cat(vals, dim=0)
    return PointCloud(**fields)
