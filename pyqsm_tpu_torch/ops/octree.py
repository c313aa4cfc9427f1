"""Octree tiling (counterpart of ``pyqsm_tpu/ops/octree.py``, host numpy).

The reference shards big clouds through an Open3D octree with an
early-stop traversal (stop descending below 250 points; each leaf is a
processing tile) and ancestor-path lookups. The voxel grid does the
compute; the tiling stays for host-side work partitioning.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pyqsm_tpu_torch.device import to_numpy


@dataclass
class OctreeNode:
    center: np.ndarray
    half: float
    depth: int
    indices: np.ndarray  # point rows in this node
    children: list["OctreeNode"] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children


def build_octree(points, max_depth: int = 6, stop_below: int = 250) -> OctreeNode:
    """Build with the reference's early-stop policy: a node with fewer than
    ``stop_below`` points stays a leaf. Children in octant order
    (4·[x > cx] + 2·[y > cy] + [z > cz]), empty octants skipped."""
    pts = to_numpy(points)
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2
    half = float(np.max(hi - lo) / 2) + 1e-6
    root = OctreeNode(center, half, 0, np.arange(len(pts)))

    def split(node: OctreeNode) -> None:
        if node.depth >= max_depth or len(node.indices) < stop_below:
            return
        p = pts[node.indices]
        octant = ((p[:, 0] > node.center[0]).astype(int) * 4
                  + (p[:, 1] > node.center[1]).astype(int) * 2
                  + (p[:, 2] > node.center[2]).astype(int))
        for o in range(8):
            sel = node.indices[octant == o]
            if len(sel) == 0:
                continue
            off = np.array([(o >> 2 & 1) * 2 - 1, (o >> 1 & 1) * 2 - 1,
                            (o & 1) * 2 - 1]) * (node.half / 2)
            child = OctreeNode(node.center + off, node.half / 2, node.depth + 1, sel)
            node.children.append(child)
            split(child)

    split(root)
    return root


def leaves(root: OctreeNode) -> list[OctreeNode]:
    """All leaf tiles, in depth-first order from the last child."""
    out: list[OctreeNode] = []
    stack = [root]
    while stack:
        n = stack.pop()
        if n.is_leaf:
            out.append(n)
        else:
            stack.extend(n.children)
    return out


def containing_path(root: OctreeNode, point) -> list[OctreeNode]:
    """Ancestor chain of the leaf containing ``point``."""
    path = [root]
    node = root
    p = to_numpy(point)
    while not node.is_leaf:
        nxt = None
        for c in node.children:
            if np.all(np.abs(p - c.center) <= c.half + 1e-9):
                nxt = c
                break
        if nxt is None:
            break
        path.append(nxt)
        node = nxt
    return path
