"""TensorBoard 3D event emission (counterpart of
``pyqsm_tpu/utils/tbevents.py``): point clouds and triangle meshes as
summaries of the standard TensorBoard mesh plugin, which a stock
``tensorboard --logdir`` opens.

- ``TBMeshWriter``: clouds (coloured by labels or a scalar) and meshes, a
  step each;
- ``growth_observer(writer)``: a ``models.isolation.build_trees(observer=)``
  callback that streams the claimed-label state each observed chunk;
- ``steplog_to_tb``: ``utils.viz.StepLogger`` NPZ directories replayed
  into an event file.

TensorFlow and tensorboard are imported where a writer needs them; without
them constructing a writer raises ``ImportError``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pyqsm_tpu_torch.device import to_numpy
from pyqsm_tpu_torch.utils.viz import color_continuous_map


def _tf():
    try:
        import tensorflow as tf  # noqa: PLC0415
    except Exception as e:  # noqa: BLE001
        raise ImportError(
            "TensorBoard 3D emission needs the optional tensorflow "
            "dependency (pip install tensorflow tensorboard)") from e
    return tf


def _mesh_summary():
    from tensorboard.plugins.mesh import summary_v2  # noqa: PLC0415

    return summary_v2


def _label_colors(labels: np.ndarray) -> np.ndarray:
    """Distinct uint8 colors per label id; unassigned (<0) = gray."""
    import matplotlib  # noqa: PLC0415

    lab = to_numpy(labels)
    cmap = matplotlib.colormaps["tab20"]
    rgb = (np.asarray(cmap(np.mod(lab, 20) / 19.0))[:, :3] * 255)
    rgb[lab < 0] = 128
    return rgb.astype(np.uint8)


class TBMeshWriter:
    """Mesh-plugin summary writer for point clouds and triangle meshes.

    Clouds above ``max_points`` are strided-subsampled per step (TB renders
    in the browser; the reference downsamples before emitting for the same
    reason, ``tree_isolation.py:156-163``)."""

    def __init__(self, logdir: str | Path, max_points: int = 200_000) -> None:
        tf = _tf()
        self.logdir = str(logdir)
        self.max_points = max_points
        self._writer = tf.summary.create_file_writer(self.logdir)

    def _prep(self, points, mask, colors):
        pts = to_numpy(points).astype(np.float32)
        if mask is not None:
            m = to_numpy(mask)
            pts = pts[m]
            if colors is not None:
                colors = to_numpy(colors)[m]
        if len(pts) > self.max_points:
            stride = -(-len(pts) // self.max_points)
            pts = pts[::stride]
            if colors is not None:
                colors = colors[::stride]
        return pts, colors

    def log_cloud(self, tag: str, points, step: int, mask=None,
                  labels=None, values=None, colors=None) -> None:
        """Point cloud at ``step``; color by ``labels`` (categorical),
        ``values`` (plasma), or explicit uint8 ``colors``."""
        tf = _tf()
        if labels is not None:
            colors = _label_colors(labels)
        elif values is not None:
            colors = (color_continuous_map(values) * 255
                      ).astype(np.uint8)
        pts, colors = self._prep(points, mask, colors)
        if len(pts) == 0:
            return
        with self._writer.as_default():
            _mesh_summary().mesh(
                tag,
                vertices=tf.constant(pts[None], tf.float32),
                colors=None if colors is None else tf.constant(
                    colors[None], tf.uint8),
                faces=None,
                step=step,
            )

    def log_mesh(self, tag: str, vertices, triangles, step: int,
                 colors=None) -> None:
        """Triangle mesh at ``step`` (padding rows with id -1 dropped)."""
        tf = _tf()
        v = to_numpy(vertices).astype(np.float32)
        t = to_numpy(triangles).astype(np.int32)
        t = t[t[:, 0] >= 0]
        with self._writer.as_default():
            _mesh_summary().mesh(
                tag,
                vertices=tf.constant(v[None], tf.float32),
                faces=tf.constant(t[None], tf.int32),
                colors=None if colors is None else tf.constant(
                    to_numpy(colors).astype(np.uint8)[None], tf.uint8),
                step=step,
            )

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        tf = _tf()
        with self._writer.as_default():
            tf.summary.scalar(tag, value, step=step)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def growth_observer(writer: TBMeshWriter, tag: str = "growth",
                    scalars: bool = True):
    """Observer for ``models.isolation.build_trees(observer=)``: streams the
    label state after each observed chunk as a mesh-plugin cloud, plus
    claimed/assigned-count scalars (the reference's in-loop TB emission,
    ``tree_isolation.py:163-179``)."""

    def observe(step: int, points, labels, order) -> None:  # noqa: ARG001
        lab = to_numpy(labels)
        writer.log_cloud(tag, to_numpy(points), step=step,
                         mask=lab >= -10**9,  # keep all rows; labels color
                         labels=lab)
        if scalars:
            writer.log_scalar(f"{tag}/assigned", float((lab >= 0).sum()),
                              step=step)
            writer.log_scalar(f"{tag}/clusters",
                              float(len(np.unique(lab[lab >= 0]))), step=step)
        writer.flush()

    return observe


def steplog_to_tb(steplog_dir: str | Path, logdir: str | Path,
                  tag: str = "steps", max_points: int = 200_000) -> int:
    """Convert a ``utils.viz.StepLogger`` NPZ directory into TB mesh events.
    Returns the number of steps written. Scalar arrays of per-point size
    named ``labels`` color categorically; other 1-D float arrays of matching
    size color continuously (first one wins)."""
    src = Path(steplog_dir)
    writer = TBMeshWriter(logdir, max_points=max_points)
    n = 0
    for f in sorted(src.glob("step_*.npz")):
        step = int(f.stem.split("_")[1])
        data = np.load(f)
        pts = data["points"]
        mask = data["mask"] if "mask" in data else None
        labels = data["labels"] if "labels" in data else None
        values = None
        if labels is None:
            for k in data.files:
                arr = data[k]
                if (k not in ("points", "mask") and arr.ndim == 1
                        and len(arr) == len(pts)):
                    values = arr
                    break
        writer.log_cloud(tag, pts, step=step, mask=mask, labels=labels,
                         values=values)
        n += 1
    writer.flush()
    writer.close()
    return n
