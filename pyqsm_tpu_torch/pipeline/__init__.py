"""Pipeline of the port: the batch driver (``driver``) and the console
commands (``cli``)."""

from pyqsm_tpu_torch.pipeline.driver import (
    StagedPipeline, get_files_by_seed, load_checkpoint, loop_over_files, save_checkpoint,
)

__all__ = [
    "StagedPipeline", "get_files_by_seed", "loop_over_files",
    "save_checkpoint", "load_checkpoint",
]
