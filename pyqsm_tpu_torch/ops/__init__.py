"""Tensor ops of the PyTorch port (counterparts of ``pyqsm_tpu/ops``)."""
