"""Data parallelism: the same step as one process, over ranks (counterpart
of the JAX package's mesh-aware ``Trainer``, ``training/loop.py:141-155``,
where XLA partitions one global program).

A data-parallel step computes the single-process step's function on the
same global batch:

* every rank reads the whole global batch and draws the augmentations over
  it, as one process does, then runs the model on its rows
  (``mesh.batch_slice``);
* inside the model (``data_parallel`` context) the random draws are the
  global batch's, sliced to the rank's rows (``Dropout``, the FPS start),
  and train-mode BN normalises with the global batch's statistics: its sums
  are all-reduced in the forward and the two batch sums of its backward
  are too, as a synchronised BN does (``models/layers.py``);
* the model's outputs are gathered back into the global batch
  (``gather_rows``), so the loss and the metrics are the single-process
  ones on every rank; the gather's backward hands each rank its rows of
  the loss's gradient;
* each rank's parameter gradients are then its rows' share of the global
  batch's gradient, and ``sync_gradients`` sums them with one all-reduce
  (explicit, in place of ``DistributedDataParallel``), so every rank's
  optimizer takes the same update.

``data_parallel_size`` is JAX's rule: the largest divisor of the batch that
is at most the world size; ``make_data_mesh`` puts the first that many
ranks in a process group and leaves the rest idle.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from mm3d_tpu_torch.parallel.context import ContextStack
from mm3d_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce,
                                          batch_slice, make_mesh)


@dataclasses.dataclass(frozen=True)
class DataParallelCtx:
    mesh: Mesh
    global_batch: int

    @property
    def rows(self) -> slice:
        return batch_slice(self.mesh, self.global_batch)


_CONTEXT = ContextStack()


def data_parallel(mesh: Mesh, global_batch: int):
    """Run a model on this rank's rows of a ``global_batch``-row batch:
    its BN statistics and random draws are the global batch's."""
    return _CONTEXT.push(DataParallelCtx(mesh, global_batch))


def current() -> Optional[DataParallelCtx]:
    return _CONTEXT.current()


def draw_rows(draw, shape, ctx: Optional[DataParallelCtx]) -> torch.Tensor:
    """``draw(shape)``, or under ``ctx`` the draw of the global batch's
    shape cut to this rank's rows (the single-process draws, sliced)."""
    if ctx is None:
        return draw(shape)
    return draw((ctx.global_batch,) + tuple(shape[1:]))[ctx.rows]


class _GatherRows(torch.autograd.Function):
    """All ranks' rows in rank order; the backward keeps this rank's rows
    of the (same on every rank) cotangent."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.rows = batch_slice(mesh, t.shape[0] * mesh.world_size)
        return all_gather(t, mesh).reshape((-1,) + tuple(t.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[world * b, ...] from every rank's [b, ...], differentiable."""
    return _GatherRows.apply(t, mesh)


def sync_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum the parameters' ``.grad`` over the ranks in place, one
    all-reduce a dtype (each rank holds its rows' share)."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def data_parallel_size(batch_size: int, world_size: int) -> int:
    """The largest divisor of the batch that is at most the world size
    (``loop.py:141-148`` of the JAX package: batch 12 on 8 ranks uses 6)."""
    return max(d for d in range(1, min(batch_size, world_size) + 1)
               if batch_size % d == 0)


def make_data_mesh(batch_size: int) -> Optional[Mesh]:
    """The data-parallel mesh of an initialised world for this batch: the
    first ``data_parallel_size`` ranks, in a group of their own when that
    is not the whole world. Every rank must call it (``new_group`` is
    collective); an idle rank gets None."""
    world = dist.get_world_size()
    dp = data_parallel_size(batch_size, world)
    group = None
    if dp < world:
        group = dist.new_group(list(range(dp)))
    if dist.get_rank() >= dp:
        return None
    return make_mesh(group)
