"""Tensor ops of the PyTorch port (counterparts of ``pyqsm_tpu/ops``).

The package imports ``neighbors``, ``sampling``, ``outliers`` and
``normals``, as the JAX package's does; importing them builds no kernel
(kernels build at their first launch, ``ops/cuda_build.py``).
"""

from pyqsm_tpu_torch.ops import neighbors, normals, outliers, sampling  # noqa: F401
