"""Logging bootstrap (counterpart of ``pyqsm_tpu/utils/logging.py``): stdlib
logging with the framework's root logger and its two named children
(``calc`` DEBUG, ``viz`` INFO), console and an optional file."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

ROOT = "pyqsm_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)-7s %(name)s %(funcName)s:%(lineno)d | %(message)s"
_configured = False


def setup_logging(
    level: int = logging.INFO,
    log_file: str | Path | None = "pyqsm_tpu_torch.log",
    calc_level: int = logging.DEBUG,
    viz_level: int = logging.INFO,
) -> None:
    """Configure the framework loggers (idempotent)."""
    global _configured
    if _configured:
        return
    root = logging.getLogger(ROOT)
    root.setLevel(level)
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(console)
    if log_file is not None:
        try:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(fh)
        except OSError:
            pass
    logging.getLogger(f"{ROOT}.calc").setLevel(calc_level)
    logging.getLogger(f"{ROOT}.viz").setLevel(viz_level)
    _configured = True


def get_logger(name: str = ROOT) -> logging.Logger:
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
