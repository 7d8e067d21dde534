"""Process group, data layout and collectives (counterpart of
``mm3d_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over devices and lets XLA
insert the collectives. Here a ``Mesh`` is a ``torch.distributed`` process
group, one process a rank, with the same two axes: ``data`` carries data
parallelism (each rank takes its rows of a global batch) and point
sharding (each rank takes its tile of a cloud's points); ``model`` is
reserved, as in the JAX package, and must be 1 today.

A ``Mesh`` whose ``group`` is None is one process with no process group:
world size 1, and every collective below returns its input. That is what
``make_mesh`` gives when no group is initialised, so the paths that consult
a mesh run unchanged without one.

The collectives are built from ``all_reduce`` and ``broadcast``, the two
that PyTorch's table of backends lists for ``gloo`` on CUDA tensors (the
backend that lets several ranks share one card): ``all_gather`` here is an
all-reduce (sum) of a zero buffer in which each rank fills its own slot.
Adding zeros is exact, so the result is bit for bit the gathered values
(up to the sign of a zero), on every backend and PyTorch version (torch
2.13 deprecates ``all_gather_into_tensor``). ``collectives()`` counts the
calls made, the way the kernel wrappers count their launches.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_CALLS = {"all_reduce": 0, "broadcast": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) layout over a process group.

    ``group`` is the process group (None: one process, no collectives),
    ``rank`` this process's rank in it, ``data_parallel`` x
    ``model_parallel`` its size."""
    group: Optional[Any]
    rank: int
    data_parallel: int
    model_parallel: int = 1

    @property
    def world_size(self) -> int:
        return self.data_parallel * self.model_parallel

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {DATA_AXIS: self.data_parallel, MODEL_AXIS: self.model_parallel}


def init_parallel(backend: str, rank: int, world_size: int,
                  init_method: str, timeout: float = 120.0) -> "Mesh":
    """Initialise the default process group and return its mesh.

    The caller names the backend: ``nccl`` for ranks on cards of their own,
    ``gloo`` on the CPU or for ranks that share one card (NCCL takes one
    rank a card). ``init_method`` is a ``tcp://host:port`` or
    ``file://path`` rendezvous, or ``env://`` under ``torchrun``; a
    collective that waits longer than ``timeout`` seconds raises."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return make_mesh()


def make_mesh(group=None, data_parallel: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """The mesh of ``group`` (default: the whole initialised world; with no
    process group, one process). Raises when ``data_parallel x
    model_parallel`` is not the group's size, as the JAX function does."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("make_mesh: a group was given but no process "
                         "group is initialised")
    else:
        n, rank = 1, 0
    if data_parallel is None:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} != {n} ranks")
    if model_parallel != 1:
        raise ValueError("the model axis is reserved: model_parallel must "
                         "be 1")
    return Mesh(group, rank, data_parallel, model_parallel)


def batch_slice(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch (the counterpart of
    ``batch_sharding`` / ``shard_batch``): contiguous, rank order."""
    n = mesh.shape[DATA_AXIS]
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not divide over "
                         f"{n} data-parallel ranks")
    b = batch_size // n
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def collectives() -> int:
    """Collective calls made by this process so far."""
    return sum(_CALLS.values())


def reset_collectives() -> None:
    for k in _CALLS:
        _CALLS[k] = 0


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``op`` ('sum', 'max' or 'min') of ``t`` over the mesh's
    ranks."""
    if mesh.group is None:
        return t
    w = _copy(t)
    _CALLS["all_reduce"] += 1
    dist.all_reduce(w, op=_OPS[op], group=mesh.group)
    return w


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[world, *t.shape]: every rank's ``t`` in rank order, bit for bit. An
    all-reduce (sum) of a zero buffer in which each rank fills its slot
    (see the module's docstring)."""
    if mesh.group is None:
        return t[None]
    buf = t.new_zeros((mesh.world_size,) + tuple(t.shape))
    buf[mesh.rank] = t
    _CALLS["all_reduce"] += 1
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def _src(mesh: Mesh) -> int:
    """The global rank of the mesh's rank 0."""
    if mesh.group is dist.group.WORLD:
        return 0
    return dist.get_global_rank(mesh.group, 0)


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A new tensor: rank 0's ``t`` on every rank."""
    if mesh.group is None:
        return t
    w = _copy(t)
    _CALLS["broadcast"] += 1
    dist.broadcast(w, src=_src(mesh), group=mesh.group)
    return w


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable ``obj`` on every rank (a restored train state)."""
    if mesh.group is None:
        return obj
    box = [obj]
    _CALLS["broadcast"] += 1
    dist.broadcast_object_list(box, src=_src(mesh), group=mesh.group)
    return box[0]


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite ``tensors`` (a module's parameters and buffers) with rank
    0's values, in place: one broadcast a dtype (the counterpart of
    ``replicated_sharding``)."""
    if mesh.group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = broadcast(torch.cat([t.reshape(-1) for t in ts]), mesh)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
