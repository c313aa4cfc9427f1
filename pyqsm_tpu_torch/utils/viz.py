"""Visualisation and observability utilities (counterpart of
``pyqsm_tpu/utils/viz.py``): continuous colour maps of per-point scalars,
coloured-cloud export to PLY, stepwise NPZ dumps (the TensorBoard-3D
replacement), matplotlib scatter snapshots and rotating GIFs, and
nearest-neighbour distance histograms.

``plasma`` (the only map the package asks for) is looked up from the table
in ``_plasma`` as matplotlib's ``ListedColormap`` does, so colouring needs
no matplotlib; any other map, the snapshots and the GIFs import matplotlib
(and imageio) where they are called.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pyqsm_tpu_torch.device import as_tensor, input_device, to_numpy


def _plasma_lut() -> np.ndarray:
    from pyqsm_tpu_torch.utils._plasma import PLASMA_RGB

    return np.array([float(v) for v in PLASMA_RGB.split()]).reshape(256, 3)


def color_continuous_map(values, cmap: str = "plasma") -> np.ndarray:
    """RGB [N, 3] float32 of a scalar per point, scaled to its finite
    range: index ``int(t·256)`` (t in [0, 1], 1 → 255) of the map's 256
    entries; NaN is black."""
    v = to_numpy(values).astype(np.float64)
    finite = np.isfinite(v)
    lo = v[finite].min() if finite.any() else 0.0
    hi = v[finite].max() if finite.any() else 1.0
    t = np.clip((v - lo) / max(hi - lo, 1e-12), 0, 1)
    if cmap != "plasma":
        import matplotlib

        return matplotlib.colormaps[cmap](t)[:, :3].astype(np.float32)
    x = t * 256
    x[x == 256] = 255
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = np.clip(x.astype(int), 0, 255)
    return np.where(bad[:, None], 0.0, _plasma_lut()[idx]).astype(np.float32)


def export_colored_cloud(path: str | Path, points, values=None, colors=None,
                         mask=None) -> None:
    """Write a PLY coloured by a scalar (or given RGB) for external
    viewing."""
    from pyqsm_tpu_torch.io.readers import write_ply

    pts = to_numpy(points)
    if mask is not None:
        m = to_numpy(mask)
        pts = pts[m]
        if values is not None:
            values = to_numpy(values)[m]
        if colors is not None:
            colors = to_numpy(colors)[m]
    if colors is None and values is not None:
        colors = color_continuous_map(values)
    write_ply(path, pts, colors=None if colors is None else to_numpy(colors))


class StepLogger:
    """Stepwise cloud dumps: one NPZ per logged step under ``logdir/name``,
    with labels and scalars attached."""

    def __init__(self, logdir: str | Path, name: str = "run") -> None:
        self.dir = Path(logdir) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.steps: list[int] = []

    def log(self, step: int, points, mask=None, **scalars) -> Path:
        arrays = {"points": to_numpy(points)}
        if mask is not None:
            arrays["mask"] = to_numpy(mask)
        for k, v in scalars.items():
            arrays[k] = to_numpy(v)
        path = self.dir / f"step_{step:06d}.npz"
        np.savez_compressed(path, **arrays)
        self.steps.append(step)
        return path


def scatter_snapshot(path: str | Path, points, values=None, mask=None,
                     elev: float = 20.0, azim: float = -60.0, s: float = 0.5) -> None:
    """Matplotlib 3D scatter PNG (headless)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = to_numpy(points)
    if values is not None:
        values = to_numpy(values)
    if mask is not None:
        m = to_numpy(mask)
        pts = pts[m]
        if values is not None:
            values = values[m]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=values, s=s, cmap="plasma")
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((np.ptp(pts[:, 0]) + 1e-6, np.ptp(pts[:, 1]) + 1e-6,
                       np.ptp(pts[:, 2]) + 1e-6))
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def rotating_compare_gif(path: str | Path, points_a, points_b, values_a=None, values_b=None,
                         steps: int = 36, on_frames: int = 3, off_frames: int = 3,
                         point_size: float = 0.5, fps: int = 8, figsize: float = 6.0) -> Path:
    """Rotating before/after GIF: the camera orbits while frames alternate
    between the two clouds every on/off cycle (matplotlib + imageio)."""
    import imageio.v2 as imageio
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a, b = to_numpy(points_a), to_numpy(points_b)
    values_a = None if values_a is None else to_numpy(values_a)
    values_b = None if values_b is None else to_numpy(values_b)
    both = np.concatenate([a, b])
    center = both.mean(0)
    span = np.ptp(both, axis=0).max() / 2 + 1e-6
    frames = []
    cycle = on_frames + off_frames
    for i in range(steps):
        use_a = (i % cycle) < on_frames
        pts = a if use_a else b
        fig = plt.figure(figsize=(figsize, figsize))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=values_a if use_a else values_b,
                   s=point_size, cmap="plasma")
        ax.view_init(elev=20, azim=i * 360.0 / steps)
        for setl, c in ((ax.set_xlim, 0), (ax.set_ylim, 1), (ax.set_zlim, 2)):
            setl(center[c] - span, center[c] + span)
        ax.set_axis_off()
        fig.canvas.draw()
        w, h = fig.canvas.get_width_height()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        frames.append(buf.reshape(h, w, 4)[..., :3].copy())
        plt.close(fig)
    path = Path(path)
    imageio.mimsave(path, frames, fps=fps, loop=0)
    return path


def nn_distance_histogram(points, mask=None, k: int = 2, bins: int = 50, device=None):
    """Nearest-neighbour distance histogram, ``(counts, edges)``; the kNN
    runs on ``device`` (default: that of a tensor ``points``, else the
    card)."""
    from pyqsm_tpu_torch.ops.neighbors import knn

    dev = input_device(points, device)
    pts = as_tensor(points, dev, torch.float32)
    m = (torch.ones(pts.shape[0], dtype=torch.bool, device=dev) if mask is None
         else as_tensor(mask, dev, torch.bool))
    d, _ = knn(pts, pts, k, query_mask=m, point_mask=m)
    nn = to_numpy(d[:, 1])
    return np.histogram(nn[np.isfinite(nn)], bins=bins)
