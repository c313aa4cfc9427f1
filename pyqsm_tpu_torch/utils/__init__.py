"""Utilities of the port: logging, stage timing and the viewer export."""

from pyqsm_tpu_torch.utils.logging import get_logger, setup_logging
from pyqsm_tpu_torch.utils.timing import Timer, stage_timer

__all__ = ["get_logger", "setup_logging", "Timer", "stage_timer"]
