"""Multi-process paths on ``torch.distributed`` (counterpart of
``pyqsm_tpu/parallel/``): process meshes, their two collectives and a rank
launcher (``mesh``), the sharded region growing (``growth``) and the
sharded ray casts (``raycast``). The JAX package's ``collective_ops`` and
``pipeline_step`` are not ported yet."""

from pyqsm_tpu_torch.parallel.mesh import (Mesh, all_gather_rows, all_reduce_sum, launch,
                                           make_mesh, shard_tree_batch, tree_points_mesh)
from pyqsm_tpu_torch.parallel.raycast import sharded_cast_rays

__all__ = ["Mesh", "all_gather_rows", "all_reduce_sum", "launch", "make_mesh",
           "sharded_cast_rays", "shard_tree_batch", "tree_points_mesh"]
