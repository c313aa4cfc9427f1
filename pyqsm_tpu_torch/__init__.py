"""PyTorch/CUDA port of pyqsm-tpu.

Mirrors the JAX package's layout (``config``, ``state``, ``ops/``,
``models/``) with plain functions on torch tensors. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``:

- ``models.plot_pipeline.process_plot`` (isolate → contract → QSM, with
  per-tree canopy metrics under ``with_metrics=True``);
- ``models.skeleton``: ``extract_skeleton`` and ``skeletonize`` (one
  tree), ``extract_skeleton_batch``;
- ``models.canopy.canopy_metrics`` (one tree);
- ``models.raycast``: ``cast_scene``, ``sun_exposure``, ``sun_sweep``,
  ``raycast_to_pcd``, ``sparse_cast_with_intersections``, ``mri_slices``;
- ``models.qsm``: ``generate_qsm``, ``sphere_following_qsm``,
  ``sphere_qsm_forest`` (the sphere-following QSM);
- ``pipeline.cli``: the console commands' ``main`` functions
  (``python -m pyqsm_tpu_torch.pipeline.cli`` isolates trees), on
  ``io.readers`` and ``io.artifacts``; ``pipeline.driver``, the batch
  driver;
- ``ops``: among the building blocks, the grid index and its queries
  (``neighbors``), the scipy meshes and ``map_density`` (``mesh``), the
  octree, ``outliers.clean_cloud``;
- ``parallel.multi_tree_pipeline_step``, the sharded multi-tree step, on
  ``parallel.collective_ops``; ``utils``: colouring and snapshots
  (``viz``), TensorBoard events (``tbevents``), the Laplacian oracle.

Four hand-written CUDA kernels (``csrc/``) replace the JAX package's
Pallas kernels: ``band_matvec``, ``band_matvec_t`` and ``band_matvec_bf16``
(``ops/band_matvec.py``: the contraction's banded Laplacian applies and the
banded region-grow claim, the latter also in the sharded claim's halo
form) and ``mt_raycast`` (``ops/mt_raycast.py``, the fused closest-hit
cast). Each is built with ``nvcc`` at first use on the card
(``ops/cuda_build.py``) and has a plain PyTorch version that CPU tensors
take. ``parallel/`` runs the main path sharded over ``torch.distributed``
ranks (``mesh=``).
"""

from pyqsm_tpu_torch.config import Config, IsolationConfig, SkeletonizeConfig, load_config
from pyqsm_tpu_torch.device import resolve_device
from pyqsm_tpu_torch.state import Cylinders, PointCloud, SceneState, Topology

__version__ = "0.1.0"

__all__ = [
    "Config", "IsolationConfig", "SkeletonizeConfig", "load_config",
    "resolve_device", "Cylinders", "PointCloud", "SceneState", "Topology", "__version__",
]
