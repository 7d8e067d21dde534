"""Data parallelism and point sharding over ``torch.distributed``
(counterpart of ``mm3d_tpu/parallel``): the mesh and its collectives
(``mesh``), the point-sharding context (``point_shard``), point-sharded
FPS (``sharded_fps``), ball query, kNN and SA / FP tails
(``sharded_group``), the data-parallel step's pieces (``data_parallel``),
the per-thread stack both contexts live on (``context``) and a launcher of
ranks as processes (``launch``). Imports torch only."""

from mm3d_tpu_torch.parallel.mesh import (Mesh, batch_slice, init_parallel,
                                          make_mesh, replicate)
from mm3d_tpu_torch.parallel.point_shard import point_shard
from mm3d_tpu_torch.parallel.sharded_fps import sharded_fps
from mm3d_tpu_torch.parallel.sharded_group import (sharded_ball_query,
                                                   sharded_fp,
                                                   sharded_idx_group_max,
                                                   sharded_knn_point,
                                                   sharded_sa_group_max)

__all__ = ["Mesh", "make_mesh", "init_parallel", "batch_slice", "replicate",
           "point_shard",
           "sharded_fps", "sharded_ball_query", "sharded_sa_group_max",
           "sharded_knn_point", "sharded_idx_group_max", "sharded_fp"]
