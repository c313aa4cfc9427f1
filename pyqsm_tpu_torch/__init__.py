"""PyTorch/CUDA port of pyqsm-tpu.

Mirrors the JAX package's layout (``config``, ``state``, ``ops/``,
``models/``) with plain functions on torch tensors. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``:

- ``models.plot_pipeline.process_plot`` (isolate → contract → QSM);
- ``models.raycast``: ``cast_scene``, ``sun_exposure``, ``sun_sweep``,
  ``raycast_to_pcd``, ``sparse_cast_with_intersections``, ``mri_slices``.

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

__all__ = [
    "Config", "IsolationConfig", "SkeletonizeConfig", "load_config",
    "resolve_device", "Cylinders", "PointCloud", "SceneState", "Topology",
]
