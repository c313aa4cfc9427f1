"""Models of the PyTorch port (counterparts of ``pyqsm_tpu/models``)."""
