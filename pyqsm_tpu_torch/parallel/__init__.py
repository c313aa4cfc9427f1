"""Multi-process paths on ``torch.distributed`` (counterpart of
``pyqsm_tpu/parallel/``): process meshes with their axis subgroups,
collectives and a rank launcher (``mesh``), the collective kernels
(``collective_ops``) and the sharded multi-tree step (``pipeline_step``),
the sharded region growing (``growth``) and the sharded ray casts
(``raycast``)."""

from pyqsm_tpu_torch.parallel.mesh import (Mesh, all_gather_rows, all_reduce_sum, launch,
                                           make_mesh, ring_shift, shard_tree_batch,
                                           tree_points_mesh)
from pyqsm_tpu_torch.parallel.pipeline_step import multi_tree_pipeline_step, step_draws
from pyqsm_tpu_torch.parallel.raycast import sharded_cast_rays

__all__ = ["Mesh", "all_gather_rows", "all_reduce_sum", "launch", "make_mesh",
           "multi_tree_pipeline_step", "ring_shift", "sharded_cast_rays", "shard_tree_batch",
           "step_draws", "tree_points_mesh"]
