"""Columnar scene state as tensor containers.

Counterparts of the JAX package's pytrees (``PointCloud``, ``Cylinders``,
``Topology``): fixed-capacity padded tensors with a validity mask. Leading
batch axes are allowed on every field (the batched contraction carries a
trees axis in front).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointCloud(NamedTuple):
    points: torch.Tensor  # [N, 3] f32
    mask: torch.Tensor  # [N] bool — live rows
    colors: torch.Tensor | None = None  # [N, 3] f32 in [0, 1]
    intensity: torch.Tensor | None = None  # [N] f32
    normals: torch.Tensor | None = None  # [N, 3] f32
    labels: torch.Tensor | None = None  # [N] i32 (-1 = unassigned)
    tree_id: torch.Tensor | None = None  # [N] i32
    shift: torch.Tensor | None = None  # [N, 3] f32 contraction displacement


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

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)


class Topology(NamedTuple):
    """Skeleton topology: FPS'd vertices + MST edges + point->vertex map."""

    vertices: torch.Tensor  # [V, 3]
    vertex_mask: torch.Tensor  # [V] bool
    edges: torch.Tensor  # [E, 2] i32 indices into vertices
    edge_mask: torch.Tensor  # [E] bool
    point_to_vertex: torch.Tensor  # [N] i32
