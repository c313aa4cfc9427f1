"""Triangle meshes for the ray engine (counterpart of
``pyqsm_tpu/ops/mesh.py:29-132, 330-349``): the ``TriMesh`` container, the
parametric cylinder and sphere meshes the QSM occupancy and exposure casts
consume, merging, and the manifold/area audit.

Constructors build on the host in numpy, as the JAX package does, and hand
the result to ``device``. The scipy routes (canopy Delaunay, alpha complex,
surface clusters, hole filling) and ``map_density`` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class TriMesh(NamedTuple):
    vertices: torch.Tensor  # [V, 3] f32
    triangles: torch.Tensor  # [T, 3] i32 (-1 rows padding)

    def n_triangles(self) -> int:
        return int((self.triangles[:, 0] >= 0).sum())

    def to(self, device) -> "TriMesh":
        return TriMesh(self.vertices.to(device), self.triangles.to(device))


def _mesh(vertices: np.ndarray, triangles: np.ndarray, device) -> TriMesh:
    dev = resolve_device(device)
    return TriMesh(torch.as_tensor(np.asarray(vertices, np.float32), device=dev),
                   torch.as_tensor(np.asarray(triangles, np.int32), device=dev))


def empty_mesh(device=DEFAULT_DEVICE) -> TriMesh:
    """The empty scene: three zero vertices and one padding row."""
    return _mesh(np.zeros((3, 3)), np.full((1, 3), -1), device)


def cylinder_mesh(center, axis, radius: float, height: float, segments: int = 16,
                  capped: bool = True, device=DEFAULT_DEVICE) -> TriMesh:
    """Parametric cylinder (the reference's ``create_cylinder`` + translate
    and rotate)."""
    center = np.asarray(center, np.float32)
    axis = np.asarray(axis, np.float32)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    ref = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1, 0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    theta = np.arange(segments) * (2 * np.pi / segments)
    ring = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * v
    verts = [center - axis * (height / 2) + radius * ring,
             center + axis * (height / 2) + radius * ring]
    tris = []
    for i in range(segments):
        j = (i + 1) % segments
        tris.append([i, j, segments + i])
        tris.append([j, segments + j, segments + i])
    if capped:
        nv = 2 * segments
        verts.append((center - axis * (height / 2))[None, :])
        verts.append((center + axis * (height / 2))[None, :])
        for i in range(segments):
            j = (i + 1) % segments
            tris.append([nv, j, i])
            tris.append([nv + 1, segments + i, segments + j])
    return _mesh(np.concatenate(verts), np.asarray(tris), device)


def sphere_mesh(center, radius: float, n_lat: int = 8, n_lon: int = 16,
                device=DEFAULT_DEVICE) -> TriMesh:
    """UV sphere (the reference's ``create_sphere``)."""
    center = np.asarray(center, np.float32)
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.arange(n_lon) * (2 * np.pi / n_lon)
    verts = [center + radius * np.array([0, 0, 1.0])]
    for la in lats[1:-1]:
        for lo in lons:
            verts.append(center + radius * np.array(
                [np.sin(la) * np.cos(lo), np.sin(la) * np.sin(lo), np.cos(la)]))
    verts.append(center + radius * np.array([0, 0, -1.0]))
    tris = [[0, 1 + j, 1 + (j + 1) % n_lon] for j in range(n_lon)]
    for i in range(n_lat - 2):
        base = 1 + i * n_lon
        nxt = base + n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            tris.append([base + j, nxt + j, base + j2])
            tris.append([base + j2, nxt + j, nxt + j2])
    last = len(verts) - 1
    base = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        tris.append([last, base + (j + 1) % n_lon, base + j])
    return _mesh(np.asarray(verts), np.asarray(tris), device)


def merge_meshes(meshes: list[TriMesh]) -> TriMesh:
    """Concatenate meshes with index offsetting (padding rows dropped), on
    the first mesh's device."""
    verts, tris = [], []
    off = 0
    for m in meshes:
        v = m.vertices.cpu().numpy()
        t = m.triangles.cpu().numpy()
        verts.append(v)
        tris.append(t[t[:, 0] >= 0] + off)
        off += len(v)
    return _mesh(np.concatenate(verts), np.concatenate(tris), meshes[0].vertices.device)


def qsm_mesh(cylinders, segments: int = 12, device=DEFAULT_DEVICE) -> TriMesh:
    """Triangle mesh of a whole QSM (one cylinder per masked row with a
    positive radius and height) from the port's ``Cylinders``."""
    mask = cylinders.mask.cpu().numpy()
    centers = cylinders.center.cpu().numpy()
    axes = cylinders.axis.cpu().numpy()
    radii = cylinders.radius.cpu().numpy()
    heights = cylinders.height.cpu().numpy()
    meshes = [cylinder_mesh(centers[i], axes[i], float(radii[i]), float(heights[i]),
                            segments=segments, device="cpu")
              for i in np.flatnonzero(mask) if radii[i] > 0 and heights[i] > 0]
    if not meshes:
        return empty_mesh(device)
    return merge_meshes(meshes).to(resolve_device(device))


def mesh_properties(mesh: TriMesh) -> dict:
    """Manifold/watertight/area audit (the reference's ``check_properties``).
    Host-side, as in the JAX package."""
    tris = mesh.triangles.cpu().numpy()
    tris = tris[tris[:, 0] >= 0]
    verts = mesh.vertices.cpu().numpy()
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    _, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    v = verts[tris]
    areas = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1)
    return {
        "n_vertices": len(verts),
        "n_triangles": len(tris),
        "edge_manifold": bool((counts <= 2).all()),
        "watertight": bool((counts == 2).all()),
        "surface_area": float(areas.sum()),
    }
