"""Triangle meshes for the ray engine (counterpart of
``pyqsm_tpu/ops/mesh.py``): the ``TriMesh`` container, the parametric
cylinder and sphere meshes the QSM occupancy and exposure casts consume,
merging, the canopy surface (2.5D Delaunay) and the 3D alpha complex,
surface clusters, hole filling, per-vertex point density with trimming,
and the manifold/area audit.

Constructors build on the host in numpy and scipy, as the JAX package
does, and hand the result to ``device``; ``map_density`` counts on the
mesh's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyqsm_tpu_torch.device import (DEFAULT_DEVICE, as_tensor, input_device, resolve_device,
                                     to_numpy)


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


def canopy_surface_mesh(points, mask=None, max_edge: float | None = None,
                        device=DEFAULT_DEVICE) -> TriMesh:
    """2.5D canopy surface: Delaunay over the xy footprint, triangles
    whose longest edge exceeds ``max_edge`` dropped (host scipy)."""
    from scipy.spatial import Delaunay

    pts = to_numpy(points)
    if mask is not None:
        pts = pts[to_numpy(mask)]
    if len(pts) < 3:
        return empty_mesh(device)
    simplices = Delaunay(pts[:, :2]).simplices
    if max_edge is not None:
        v = pts[simplices]
        e = np.stack([np.linalg.norm(v[:, 0] - v[:, 1], axis=1),
                      np.linalg.norm(v[:, 1] - v[:, 2], axis=1),
                      np.linalg.norm(v[:, 0] - v[:, 2], axis=1)], axis=1).max(1)
        simplices = simplices[e <= max_edge]
    return _mesh(pts, simplices, device)


def alpha_complex_mesh(points, alpha: float, mask=None, device=DEFAULT_DEVICE) -> TriMesh:
    """Boundary of the 3D alpha complex: Delaunay tetrahedra with
    circumradius ≤ ``alpha`` (float64); boundary faces are those of exactly
    one kept tetrahedron, in ``np.unique`` order (host scipy)."""
    from scipy.spatial import Delaunay

    pts = to_numpy(points).astype(np.float64)
    if mask is not None:
        pts = pts[to_numpy(mask)]
    if len(pts) < 4:
        return empty_mesh(device)
    simp = Delaunay(pts).simplices
    a, b, c, d = (pts[simp[:, i]] for i in range(4))
    ba, ca, da = b - a, c - a, d - a
    det = np.einsum("ij,ij->i", ba, np.cross(ca, da))
    det = np.where(np.abs(det) < 1e-20, 1e-20, det)
    o = (np.einsum("ij,ij->i", ba, ba)[:, None] * np.cross(ca, da)
         + np.einsum("ij,ij->i", ca, ca)[:, None] * np.cross(da, ba)
         + np.einsum("ij,ij->i", da, da)[:, None] * np.cross(ba, ca)) / (2.0 * det[:, None])
    keep = simp[np.linalg.norm(o, axis=1) <= alpha]
    faces = np.concatenate([keep[:, [0, 1, 2]], keep[:, [0, 1, 3]], keep[:, [0, 2, 3]],
                            keep[:, [1, 2, 3]]])
    _, idx, counts = np.unique(np.sort(faces, axis=1), axis=0, return_index=True,
                               return_counts=True)
    return _mesh(pts, faces[idx[counts == 1]], device)


def surface_clusters(mesh: TriMesh, min_triangles: int = 1) -> tuple[np.ndarray, TriMesh]:
    """Triangles sharing an edge form one surface component (host
    union-find over edge keys, in triangle order). Returns (labels per
    triangle row, -1 on padding; the mesh without components smaller than
    ``min_triangles``, on the mesh's device)."""
    tris = to_numpy(mesh.triangles)
    idx = np.flatnonzero(tris[:, 0] >= 0)
    t = tris[idx]
    parent = np.arange(len(t))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    edge_owner: dict[tuple[int, int], int] = {}
    for ti, tri in enumerate(t):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[0], tri[2])):
            key = (int(min(a, b)), int(max(a, b)))
            if key in edge_owner:
                ra, rb = find(edge_owner[key]), find(ti)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
            else:
                edge_owner[key] = ti
    roots = np.array([find(i) for i in range(len(t))])
    _, labels, counts = np.unique(roots, return_inverse=True, return_counts=True)
    keep = counts[labels] >= min_triangles
    out = np.full(len(tris), -1, np.int64)
    out[idx] = labels
    return out, TriMesh(mesh.vertices, torch.as_tensor(t[keep].astype(np.int32),
                                                       device=mesh.triangles.device))


def fill_holes(mesh: TriMesh, max_loop: int = 256) -> TriMesh:
    """Close boundary loops by centroid fans (the hole-filling half of the
    reference's mesh repair): boundary edges (used once) chain into loops,
    and each loop of up to ``max_loop`` edges gets a fan from its
    centroid; unchainable boundaries stay open. Loops are taken in the
    iteration order of the set of boundary edges, so new vertices and
    triangles come out in the JAX package's order."""
    v = to_numpy(mesh.vertices)
    t = to_numpy(mesh.triangles)
    t = t[t[:, 0] >= 0]
    edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    uniq, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    boundary = uniq[counts == 1]
    if len(boundary) == 0:
        return mesh
    nxt: dict[int, list[int]] = {}
    for a, b in boundary:
        nxt.setdefault(int(a), []).append(int(b))
        nxt.setdefault(int(b), []).append(int(a))
    unused = {tuple(e) for e in boundary}
    new_verts: list[np.ndarray] = []
    new_tris: list[list[int]] = []
    nv = len(v)
    while unused:
        a0, b0 = next(iter(unused))
        loop = [a0, b0]
        unused.discard((a0, b0))
        ok = True
        while loop[-1] != loop[0]:
            cur, prev = loop[-1], loop[-2]
            cands = [c for c in nxt.get(cur, [])
                     if c != prev and (tuple(sorted((cur, c))) in unused or c == loop[0])]
            if not cands or len(loop) > max_loop:
                ok = False
                break
            c = cands[0]
            unused.discard(tuple(sorted((cur, c))))
            loop.append(c)
        if not ok or len(loop) < 4:  # a closed loop repeats its head
            continue
        ring = loop[:-1]
        ci = nv + len(new_verts)
        new_verts.append(v[ring].mean(0).astype(np.float32))
        for i in range(len(ring)):
            new_tris.append([ring[i], ring[(i + 1) % len(ring)], ci])
    if not new_tris:
        return mesh
    return _mesh(np.concatenate([v, np.stack(new_verts)]),
                 np.concatenate([t, np.asarray(new_tris, np.int32)]), mesh.vertices.device)


def map_density(mesh: TriMesh, points, mask=None, radius: float = 0.2,
                density_threshold_pctile: float = 0.0, device=None):
    """Per-vertex point density, its plasma colours, and the mesh trimmed
    of triangles touching a vertex below the ``density_threshold_pctile``
    percentile of density (0 keeps every triangle). Density is the number
    of live points within ``radius`` of a vertex. Returns ``(density [V]
    f32, colours [V, 3], mesh)`` on ``device`` (default: that of a tensor
    mesh, else the card)."""
    from pyqsm_tpu_torch.ops.geometry import percentile
    from pyqsm_tpu_torch.ops.neighbors import radius_count
    from pyqsm_tpu_torch.utils.viz import color_continuous_map

    dev = input_device(mesh.vertices, device)
    verts = as_tensor(mesh.vertices, dev, torch.float32)
    tris = as_tensor(mesh.triangles, dev, torch.int32)
    points = as_tensor(points, dev, torch.float32)
    mask = (torch.ones(points.shape[0], dtype=torch.bool, device=dev) if mask is None
            else as_tensor(mask, dev, torch.bool))
    dens = radius_count(verts, points, radius=radius, point_mask=mask).to(torch.float32)
    colors = torch.as_tensor(color_continuous_map(dens), device=dev)
    if density_threshold_pctile <= 0.0:
        return dens, colors, TriMesh(verts, tris)
    thr = percentile(dens, density_threshold_pctile)
    keep_v = dens >= thr
    tri_keep = (tris[:, 0] >= 0) & keep_v[torch.clamp(tris, min=0).long()].all(dim=1)
    return dens, colors, TriMesh(verts, torch.where(tri_keep[:, None], tris, -1))


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
