"""PyTorch/CUDA port of pyqsm-tpu.

Mirrors the JAX package's layout (``config``, ``state``, ``ops/``,
``models/``) with plain functions on torch tensors. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the one hand-written
kernel on the main path (``ops/band_matvec.py`` + ``csrc/band_matvec.cu``)
is built with ``nvcc`` at first use on the card.
"""

from pyqsm_tpu_torch.config import Config, IsolationConfig, SkeletonizeConfig, load_config
from pyqsm_tpu_torch.device import resolve_device
from pyqsm_tpu_torch.state import Cylinders, PointCloud, Topology

__all__ = [
    "Config", "IsolationConfig", "SkeletonizeConfig", "load_config",
    "resolve_device", "Cylinders", "PointCloud", "Topology",
]
