"""Point-sharding context (counterpart of
``mm3d_tpu/parallel/point_shard.py``)::

    from mm3d_tpu_torch import parallel
    with parallel.point_shard(mesh, min_points=2048):
        log_probs, _ = model(points)

Inside the context, eval-mode PointNet++ blocks whose input cloud has at
least ``min_points`` points split the cloud's points over the mesh's
``data`` axis: ``SetAbstraction`` and ``SetAbstractionMsg`` run
``sharded_fps`` and the SA tail of ``sharded_group``, and
``FeaturePropagation`` runs ``sharded_fp`` (the gates are the JAX
module's, in ``models/pointnet2.py``). Every rank runs the same forward on
the same (replicated) inputs; a sharded block works on its rank's tile and
ends in a collective, so its output is again the same on every rank.
Later blocks work on the S << N centroids and stay replicated.

The decision is read when a block runs, per thread
(``parallel.context``). The point axis is split over the mesh's ``data``
axis, the only one with more than one rank (``make_mesh`` takes
``model_parallel`` 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mm3d_tpu_torch.parallel.context import ContextStack
from mm3d_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class PointShardCtx:
    mesh: Mesh
    min_points: int = 2048


_CONTEXT = ContextStack()


def point_shard(mesh: Mesh, axis: str = DATA_AXIS, min_points: int = 2048):
    """Shard the point axis of big-N eval blocks run inside, over the
    mesh's ``axis``; raises ValueError for an axis other than ``data``."""
    if axis != DATA_AXIS:
        raise ValueError(f"point_shard: the point axis splits over the "
                         f"{DATA_AXIS!r} axis, not {axis!r}")
    return _CONTEXT.push(PointShardCtx(mesh, min_points))


def current() -> Optional[PointShardCtx]:
    return _CONTEXT.current()
