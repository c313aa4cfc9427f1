"""File IO of the port: point-cloud readers/writers (numpy) and artifacts."""

from pyqsm_tpu_torch.io.artifacts import (
    format_table, load_artifact, load_cylinders, load_metrics, save_artifact, save_cylinders,
    save_metrics,
)
from pyqsm_tpu_torch.io.readers import (
    read_las, read_npz, read_pcd, read_ply, read_point_cloud, read_xyz, write_las, write_npz,
    write_pcd, write_ply, write_xyz,
)

__all__ = [
    "read_point_cloud", "read_las", "read_pcd", "read_ply", "read_xyz", "read_npz",
    "write_npz", "write_pcd", "write_ply", "write_las", "write_xyz", "save_artifact",
    "load_artifact", "save_cylinders", "load_cylinders", "save_metrics", "load_metrics",
    "format_table",
]
