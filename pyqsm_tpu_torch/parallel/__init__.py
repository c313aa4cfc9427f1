"""Multi-process paths on ``torch.distributed`` (counterpart of
``pyqsm_tpu/parallel/``): process meshes, their two collectives and a rank
launcher (``mesh``), and the sharded region growing (``growth``). The
JAX package's ``collective_ops``, ``pipeline_step`` and ``raycast`` are
not ported yet."""

from pyqsm_tpu_torch.parallel.mesh import (Mesh, all_gather_rows, all_reduce_sum, launch,
                                           make_mesh, shard_tree_batch, tree_points_mesh)

__all__ = ["Mesh", "all_gather_rows", "all_reduce_sum", "launch", "make_mesh",
           "shard_tree_batch", "tree_points_mesh"]
