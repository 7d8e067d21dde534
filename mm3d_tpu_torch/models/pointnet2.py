"""PointNet++ blocks and models (counterpart of
``mm3d_tpu/models/pointnet2.py``).

The branches of ``SetAbstraction`` that ``fusion_cls``, ``fusion_sem_seg``
and the PointNet++ classifiers, part-seg and sem-seg models serve and train:

* group_all (``pointnet2.py:142-163``): dense SharedMLP + max; in bf16
  training the stack computes in f32 (the group_all guard, ``:142-154``);
* fused (``:232-259``), eval only: the BN-folded SA tail in one kernel,
  ``ops.fused_sa`` over the ball query or, for a kNN block, ``ops.knn_point``
  then ``ops.fused_sa_idx`` over its indices (bf16 serving, or any dtype
  under impl 'cuda');
* unfused (``:273-300``): the FPS kernel, the ball-query kernel or
  ``knn_point``, then the gather (whose backward is the gather-backward
  kernel), the MLP and max. Training always takes it; bf16 training
  recentres in f32 from the f32 inputs captured before the cast
  (``:170-178,278-292``).

The last two are the scale tail ``_scale_tail``, which ``SetAbstractionMsg``
(``:303-413``, project-first) runs once a scale after one shared FPS.

``FeaturePropagation`` (``:416-513``), the FP decoder block of the dense
trunk, project-first:

* fused (``:479-496``), eval (``_want_fused_fp``): BN folds to an affine map,
  so 3-NN, inverse-distance interpolation, the dense-side term and relu run
  as one kernel (``ops.fused_fp``), in every dtype;
* unfused (``:497-509``): the three_nn kernel, the inverse-distance
  weights, the three_interpolate kernel (whose backward is the
  gather-backward kernel), skip, bias, BN, relu. Training takes it;
* M == 1 broadcasts the single sparse row.

Models: ``PointNet2ClsSSG`` (``:519-554``) is BASELINE config 2
(``pointnet2_cls_ssg``) and, with ``knn=True``, the kNN variant
``pointnet2_cls_knn``; ``PointNet2ClsMSG`` (``:557-589``) its multi-scale
twin; ``PointNet2PartSegMSG`` (``:636-675``) is config 3
(``pointnet2_part_seg_msg``) and ``PointNet2PartSegSSG`` (``:595-633``) its
SSG twin; ``PointNet2SemSeg`` (``:681-721``) and ``PointNet2SemSegMSG``
(``:724-760``) segment 9-dim indoor blocks through four SA and four FP
blocks.

Point sharding (``parallel.point_shard``): under the context, an eval
``SetAbstraction`` (``:180-230``), ``SetAbstractionMsg`` (``:319-331``,
``:356-368``) or ``FeaturePropagation`` (``:470-478``) whose cloud passes
the JAX gates (``_point_shard``) splits its points over the ranks:
``sharded_fps``, then the folded SA tail of ``parallel.sharded_group`` (one
a scale), or ``sharded_fp`` for the FP tail; a data-parallel train step
draws the FPS start of the global batch (``_fps_start``).

The lineage's group-then-MLP form, ``project_first=False`` (the default is
True, and no model sets it, in JAX either): ``SetAbstraction``
(``:142-163``: ``sample_and_group``, the whole ``mlp``, max),
``SetAbstractionMsg`` (``:401-411``: one ``mlp_{i}`` a scale, with no dtype)
and ``FeaturePropagation`` (``:442-454``: interpolate the sparse features,
put the skip features first, the whole ``mlp``). They run the FPS, ball
query, three_nn and three_interpolate kernels and, in training, the gather
backward, never a fused kernel, and never shard; each class docstring lists
the JAX quirks kept.

``MM3D_BF16_DEBUG`` (``_dbg_dtype``, ``:30-36``): a comma list of components
a bf16 model computes in f32; unset or empty it changes nothing. Flax reads
it each time a module is traced; the port reads the model-level components
(``sa``, ``sa1``-``sa4``, ``fp``, ``head`` of ``PointNet2ClsSSG`` and
``PointNet2SemSeg``, ``:531-553,691-720``) when the model is built, and the
block-level ones (``sa_bn``, ``sa_rest``, ``sa_h`` of the project-first
``SetAbstraction``, ``:207-211,292``) at each forward, through the layers'
call-time ``f32`` flags. A forced ``sa`` takes a bf16 classifier's SA
blocks off the fused SA kernel; a forced ``sa_bn`` gives the fused kernel
f32 operands, so it runs its f32 form, as JAX's does.

Train or eval is the module's ``training`` flag. The dtype casts sit where
the JAX module puts them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from mm3d_tpu_torch import ops
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.parallel import data_parallel
from mm3d_tpu_torch.parallel.point_shard import current as point_shard_ctx
from mm3d_tpu_torch.parallel import sharded_group as sg
from mm3d_tpu_torch.parallel.sharded_fps import sharded_fps
from mm3d_tpu_torch.models.layers import (BatchNorm, Dense, Dropout,
                                          SharedMLP, guarded_train_dtype,
                                          lecun_normal_, log_softmax_head)


def _dbg_dtype(component: str, dtype):
    """bf16 numerics bisection knob (debug only), ``pointnet2.py:30-36``:
    ``MM3D_BF16_DEBUG`` is a comma list of components forced back to f32
    (e.g. "sa" or "head"; exact names, so "sa" does not force "sa1"). Unset
    or empty, it returns ``dtype`` unchanged."""
    dbg = os.environ.get("MM3D_BF16_DEBUG", "")
    return None if dbg and component in dbg.split(",") else dtype


def _want_fused_sa(train: bool, mlp, dtype) -> bool:
    """Take the fused SA kernel (eval only, 3-layer MLP)?

    bf16 serving always does; fp32 keeps the unfused path unless the mode
    is explicitly 'cuda' (tests / forced kernels), as in the JAX package."""
    if train or len(mlp) != 3:
        return False
    if dtype == torch.bfloat16:
        return True
    return dispatch.get_impl() == "cuda"


def _want_fused_sa_idx(train: bool, mlp, dtype, knn: bool,
                       nsample: int) -> bool:
    """Take the given-index fused SA kernel (kNN serving)?

    The JAX gates: eval only, a 3-layer MLP, a kNN block, K <= 128 (the
    kernel's contract), bf16 serving or impl 'cuda'. The JAX package's
    fourth gate, N <= 16*K in auto mode (``pointnet2.py:68-72``), is
    dropped on purpose: it came from the TPU kernel's [R, N] one-hot
    selection, whose cost grows with N, and the port's kernel gathers rows,
    whose cost does not. So bf16 serving takes the kernel at SA1 (N/K = 32)
    as well as at SA2: a routing difference, not a numeric one."""
    return knn and nsample <= 128 and _want_fused_sa(train, mlp, dtype)


def _want_fused_fp(train: bool) -> bool:
    """Take the fused FP-tail kernel? Eval only, in every dtype, as in the
    JAX package."""
    return not train


def _fps_start(train: bool, xyz: torch.Tensor,
               generator: Optional[torch.Generator]):
    """Lineage-parity random-start FPS seed (``pointnet2.py:90-102``).

    In training, with a generator (``TrainConfig.fps_random_start``), each
    cloud starts FPS at a random index; otherwise at index 0. In a
    data-parallel step the draw is the global batch's, cut to this rank's
    rows."""
    if train and generator is not None:
        return data_parallel.draw_rows(lambda shape: torch.randint(
            0, xyz.shape[1], shape, generator=generator, device=xyz.device,
            dtype=torch.int32), (xyz.shape[0],), data_parallel.current())
    return 0


def _point_shard(train: bool, n_points: int, mlps,
                 knn_nsample: Optional[int] = None):
    """The point-shard context a block runs under, or None: the JAX gates
    (``pointnet2.py:183-193,324-328,474-476``). A block shards in eval, with
    3-layer MLPs (``mlps``: each SA scale's widths; none for an FP block),
    at least ``min_points`` points and a point count that divides by the
    mesh axis; a kNN block (``knn_nsample`` its K) also needs every tile to
    hold K points."""
    ps = point_shard_ctx()
    if ps is None or train:
        return None
    n = ps.mesh.world_size
    if (all(len(m) == 3 for m in mlps) and n_points >= ps.min_points
            and n_points % n == 0
            and (knn_nsample is None or n_points // n >= knn_nsample)):
        return ps
    return None


def _fps(xyz: torch.Tensor, npoint: int, train: bool, generator, ps):
    """The block's centroids: ``sharded_fps`` under a point-shard context
    (eval only, so from index 0), else the FPS kernel."""
    if ps is not None:
        return sharded_fps(xyz, npoint, ps.mesh)
    return ops.farthest_point_sample(xyz, npoint,
                                     _fps_start(train, xyz, generator))


def _concat_points(xyz: torch.Tensor, feats: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """[xyz, feats] promoted like ``jnp.concatenate`` (f32 xyz with bf16
    features gives f32), or xyz alone."""
    if feats is None:
        return xyz
    ct = torch.promote_types(xyz.dtype, feats.dtype)
    return torch.cat([xyz.to(ct), feats.to(ct)], dim=-1)


def _scale_tail(xyz: torch.Tensor, new_xyz: torch.Tensor, cat: torch.Tensor,
                kernel: torch.Tensor, bias: torch.Tensor, bn: BatchNorm,
                rest: Optional[SharedMLP], radius: Optional[float],
                nsample: int, mlp: Sequence[int], dtype, dt, train: bool,
                bn_momentum: float, knn: bool = False,
                ps=None, dbg: bool = False) -> torch.Tensor:
    """One grouping scale of a project-first SA block -> [B,S,C_last]:
    the tail ``SetAbstraction`` runs once and ``SetAbstractionMsg`` once a
    scale (``pointnet2.py:232-300,338-392``).

    ``cat`` [B,N,3+D], ``kernel`` [3+D,C1] and ``bias`` are the f32
    originals; ``dtype`` is the block's dtype, ``dt`` its compute dtype
    after the bf16 training guard. Eval with a 3-layer MLP takes the fused
    kernel (``_want_fused_sa``, or ``_want_fused_sa_idx`` for a kNN block):
    BN folds to an affine map, so neighbour selection, gather, MLP and max
    run as one launch with no [B,S,K,C] tensor (a kNN block selects first,
    in PyTorch, as JAX does in XLA). Otherwise the ball-query kernel or
    ``knn_point``, the gather (whose backward is the gather-backward
    kernel), BN, relu, the rest of the MLP and the max; bf16 training
    recentres in f32 from the f32 originals (``gathered - cterm`` cancels
    two O(1) terms, and in bf16 that leaves ~5 bits of the local
    geometry). Under a point-shard context ``ps`` (``_point_shard``) the
    same folded tail runs over the ranks' tiles of the points
    (``sharded_group``, ``pointnet2.py:202-230``).

    ``dbg`` (``SetAbstraction`` only: JAX's ``SetAbstractionMsg`` has no
    such components) applies ``MM3D_BF16_DEBUG``'s ``sa_bn``, ``sa_rest``
    and ``sa_h`` (``pointnet2.py:207-211,292``), read at this call: BN, the
    rest of the MLP or the recentred rows of bf16 training in f32. A forced
    ``sa_bn`` folds BN in f32, so ``pre * A`` promotes and the fused kernel
    runs its f32 form, as ``fused_sa_pallas`` keys its form on pre's dtype."""
    bn_f32 = dt is None or (dbg and _dbg_dtype("sa_bn", dt) is None)
    rest_f32 = dt is None or (dbg and _dbg_dtype("sa_rest", dt) is None)
    cat32, kernel32, bias32 = cat, kernel, bias
    if dt is not None:
        cat, kernel, bias = cat.to(dt), kernel.to(dt), bias.to(dt)
    if ps is not None or (_want_fused_sa_idx(train, mlp, dtype, knn, nsample)
                          if knn else _want_fused_sa(train, mlp, dtype)):
        pre = torch.matmul(cat, kernel)  # [B,N,C1]
        cterm = torch.matmul(new_xyz.to(pre.dtype), kernel[:3])
        A, C = bn.fold(bn_f32)
        (w1, b1), (w2, b2) = rest.fold(rest_f32)
        pre, cbias = pre * A, (bias - cterm) * A + C
        if ps is not None and knn:
            idx = sg.sharded_knn_point(nsample, xyz, new_xyz, ps.mesh)
            return sg.sharded_idx_group_max(idx, pre, cbias, w1, b1, w2, b2,
                                            ps.mesh)
        if ps is not None:
            return sg.sharded_sa_group_max(radius, nsample, xyz, new_xyz,
                                           pre, cbias, w1, b1, w2, b2,
                                           ps.mesh)
        if knn:
            idx = ops.knn_point(nsample, xyz, new_xyz)
            return ops.fused_sa_idx(nsample, idx, pre, cbias, w1, b1, w2, b2)
        return ops.fused_sa(radius, nsample, xyz, new_xyz, pre, cbias, w1,
                            b1, w2, b2)

    if knn:
        idx = ops.knn_point(nsample, xyz, new_xyz)
    else:
        idx = ops.query_ball_point(radius, nsample, xyz, new_xyz)
    if dt is not None and train:
        pre32 = torch.matmul(cat32.float(), kernel32.float())
        ct32 = torch.matmul(new_xyz.float(), kernel32[:3].float())
        gathered = ops.index_points(pre32, idx)  # [B,S,K,C1] f32
        h_dt = (_dbg_dtype("sa_h", dt) if dbg else dt) or torch.float32
        h = (gathered - ct32[:, :, None, :] + bias32.float()).to(h_dt)
    else:
        pre = torch.matmul(cat, kernel)  # [B,N,C1]
        cterm = torch.matmul(new_xyz.to(pre.dtype), kernel[:3])
        gathered = ops.index_points(pre, idx)  # [B,S,K,C1]
        h = gathered - cterm[:, :, None, :] + bias
    h = torch.relu(bn(h, momentum=bn_momentum, f32=bn_f32))
    if rest is not None:
        h = rest(h, bn_momentum, f32=rest_f32)
    return h.amax(dim=2)


class SetAbstraction(nn.Module):
    """Single-scale grouping SA block, project-first form by default.

    ``in_channels`` counts the feature channels besides xyz (0 for raw
    points). Parameters follow the flax tree: ``proj_kernel`` [3+D, C1],
    ``proj_bias``, ``proj_bn`` and ``mlp_rest``; group_all blocks, and
    ``project_first=False`` ones, hold one ``mlp`` over [3+D].
    ``f32_train_guard`` computes the block in f32 during bf16 training
    (serving stays bf16), as the JAX attribute does. ``knn`` groups the
    ``nsample`` nearest points instead of the ball query (``radius`` is then
    unused).

    ``project_first=False`` is the lineage's group-then-MLP form
    (``pointnet2.py:142-163``): ``sample_and_group`` (FPS, the ball query,
    the gathers), the whole MLP over [B,S,K,3+D] and the max, with JAX's
    quirks kept: the MLP computes in the block's dtype (``f32_train_guard``
    has no effect; only group_all has the bf16-training guard), ``knn`` is
    ignored (always the ball query), the FPS start is ``_fps_start``'s, and
    the block never shards under a point-shard context nor takes a fused
    kernel."""

    def __init__(self, npoint: Optional[int] = None,
                 radius: Optional[float] = None,
                 nsample: Optional[int] = None, in_channels: int = 0,
                 mlp: Sequence[int] = (), group_all: bool = False,
                 dtype=None, f32_train_guard: bool = False,
                 knn: bool = False, project_first: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.knn = knn
        self.mlp_widths = tuple(mlp)
        self.group_all = group_all
        self.project_first = project_first
        self.dtype = dtype
        self.f32_train_guard = f32_train_guard
        c_in = 3 + in_channels
        if group_all or not project_first:
            self.mlp = SharedMLP(c_in, self.mlp_widths, dtype=dtype)
            return
        c1 = self.mlp_widths[0]
        self.proj_kernel = nn.Parameter(torch.empty(c_in, c1))
        self.proj_bias = nn.Parameter(torch.zeros(c1))
        self.proj_bn = BatchNorm(c1, dtype=dtype)
        self.mlp_rest = (SharedMLP(c1, self.mlp_widths[1:], dtype=dtype)
                         if len(self.mlp_widths) > 1 else None)
        self.init_(None)

    def init_(self, g):
        if self.group_all or not self.project_first:
            return
        lecun_normal_(self.proj_kernel, self.proj_kernel.shape[0], g)
        with torch.no_grad():
            self.proj_bias.zero_()

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                bn_momentum: float = 0.1,
                fps_generator: Optional[torch.Generator] = None):
        """xyz [B,N,3] f32, feats [B,N,D] or None -> (new_xyz, [B,S,C'])."""
        train = self.training
        if self.group_all:
            # bf16 training computes this global-feature stack in f32
            # (the measured guard of pointnet2.py:142-154)
            f32 = self.dtype is None or (train
                                         and self.dtype == torch.bfloat16)
            new_xyz, grouped = ops.sample_and_group_all(xyz, feats)
            return new_xyz, self.mlp(grouped, bn_momentum, f32=f32).amax(dim=2)
        if not self.project_first:
            new_xyz, grouped = ops.sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, feats,
                fps_start_idx=_fps_start(train, xyz, fps_generator))
            return new_xyz, self.mlp(grouped, bn_momentum).amax(dim=2)

        dt = guarded_train_dtype(self.dtype, train, self.f32_train_guard)
        ps = _point_shard(train, xyz.shape[1], (self.mlp_widths,),
                          self.nsample if self.knn else None)
        fps_idx = _fps(xyz, self.npoint, train, fps_generator, ps)
        new_xyz = ops.index_points(xyz, fps_idx)
        out = _scale_tail(
            xyz, new_xyz, _concat_points(xyz, feats), self.proj_kernel,
            self.proj_bias, self.proj_bn, self.mlp_rest, self.radius,
            self.nsample, self.mlp_widths, self.dtype, dt, train,
            bn_momentum, self.knn, ps, dbg=True)
        return new_xyz, out


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping SA block, project-first form
    (``pointnet2.py:303-413``): one FPS shared by the scales, then for each
    scale ``i`` its own ball query (``radius_list[i]``, ``nsample_list[i]``)
    and MLP ``mlp_list[i]``, the scales' maxima concatenated.

    Parameters follow the flax tree: ``proj_kernel_{i}`` [3+D, C1_i],
    ``proj_bias_{i}``, ``proj_bn_{i}`` and ``mlp_rest_{i}``. Each scale runs
    the tail of ``SetAbstraction`` (``_scale_tail``): the fused SA kernel,
    one launch a scale, in bf16 serving; in training the ball query, the
    gather, BN and the rest of the MLP, recentred in f32 under bf16
    training. ``f32_train_guard`` and ``fps_generator`` as there.

    ``project_first=False`` (``pointnet2.py:401-411``) holds one ``mlp_{i}``
    a scale over [3+D]: after the FPS, each scale's ball query, the gathered
    [xyz - centroid, features] rows (f32 xyz with bf16 features promotes to
    f32) and its whole MLP with no dtype, so the scales compute in f32 even
    in a bf16 block, as JAX's ``SharedMLP(mlp, name=f"mlp_{i}")`` does; it
    never shards nor takes a fused kernel."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int],
                 mlp_list: Sequence[Sequence[int]], in_channels: int = 0,
                 dtype=None, f32_train_guard: bool = False,
                 project_first: bool = True):
        super().__init__()
        self.npoint = npoint
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.mlp_list = tuple(tuple(m) for m in mlp_list)
        self.dtype = dtype
        self.f32_train_guard = f32_train_guard
        self.project_first = project_first
        c_in = 3 + in_channels
        if not project_first:
            for i, mlp in enumerate(self.mlp_list):
                self.add_module(f"mlp_{i}", SharedMLP(c_in, mlp))
            return
        for i, mlp in enumerate(self.mlp_list):
            c1 = mlp[0]
            self.register_parameter(f"proj_kernel_{i}",
                                    nn.Parameter(torch.empty(c_in, c1)))
            self.register_parameter(f"proj_bias_{i}",
                                    nn.Parameter(torch.zeros(c1)))
            self.add_module(f"proj_bn_{i}", BatchNorm(c1, dtype=dtype))
            self.add_module(f"mlp_rest_{i}",
                            SharedMLP(c1, mlp[1:], dtype=dtype)
                            if len(mlp) > 1 else None)
        self.init_(None)

    def init_(self, g):
        if not self.project_first:
            return
        for i in range(len(self.mlp_list)):
            k = getattr(self, f"proj_kernel_{i}")
            lecun_normal_(k, k.shape[0], g)
            with torch.no_grad():
                getattr(self, f"proj_bias_{i}").zero_()

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                bn_momentum: float = 0.1,
                fps_generator: Optional[torch.Generator] = None):
        """xyz [B,N,3] f32, feats [B,N,D] or None -> (new_xyz [B,S,3],
        [B,S,sum of the scales' last widths])."""
        train = self.training
        if not self.project_first:
            fps_idx = _fps(xyz, self.npoint, train, fps_generator, None)
            new_xyz = ops.index_points(xyz, fps_idx)
            outs = []
            for i, (radius, nsample) in enumerate(zip(self.radius_list,
                                                      self.nsample_list)):
                idx = ops.query_ball_point(radius, nsample, xyz, new_xyz)
                grouped = ops.index_points(xyz, idx) - new_xyz[:, :, None, :]
                if feats is not None:
                    grouped = _concat_points(grouped,
                                             ops.index_points(feats, idx))
                outs.append(getattr(self, f"mlp_{i}")(
                    grouped, bn_momentum).amax(dim=2))
            return new_xyz, torch.cat(outs, dim=-1)
        dt = guarded_train_dtype(self.dtype, train, self.f32_train_guard)
        ps = _point_shard(train, xyz.shape[1], self.mlp_list)
        fps_idx = _fps(xyz, self.npoint, train, fps_generator, ps)
        new_xyz = ops.index_points(xyz, fps_idx)
        cat = _concat_points(xyz, feats)
        outs = [_scale_tail(
            xyz, new_xyz, cat, getattr(self, f"proj_kernel_{i}"),
            getattr(self, f"proj_bias_{i}"), getattr(self, f"proj_bn_{i}"),
            getattr(self, f"mlp_rest_{i}"), radius, nsample, mlp, self.dtype,
            dt, train, bn_momentum, ps=ps)
            for i, (radius, nsample, mlp) in enumerate(zip(
                self.radius_list, self.nsample_list, self.mlp_list))]
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """FP decoder block: 3-NN inverse-distance upsample + skip + MLP.

    Project-first (the default): the interpolation is linear, so the first
    layer runs on the M sparse points, ``interp(f2 @ W_f2) + f1 @ W_skip +
    b``. ``skip_channels`` counts the dense-side features (0 for none),
    ``sparse_channels`` the sparse-side ones. Parameters follow the flax
    tree: ``proj_kernel`` [skip + sparse, C1] with rows [skip; interpolated],
    ``proj_bias``, ``proj_bn`` and ``mlp_rest``. With no dtype the sparse
    features are promoted with the kernel (a bf16 ``feats2`` under a forced
    ``fp`` of ``MM3D_BF16_DEBUG`` gives f32), as ``feats2 @ k`` does in JAX.

    ``project_first=False`` (``pointnet2.py:442-454``) holds one ``mlp``
    over [skip + sparse]: the sparse features interpolated (M == 1
    broadcasts them; else the three_nn kernel, the inverse-distance weights
    and the three_interpolate kernel), the skip features cast to their dtype
    and put first, then the whole MLP in the block's dtype; no fused kernel,
    no point sharding. JAX interpolates with ``_three_interpolate_jax``,
    whose bf16 features times f32 weights promote to f32, so the port
    interpolates ``feats2`` promoted to f32: JAX's products and its f32
    result (a bf16 kernel call would round the weights and the result to
    bf16); autograd casts the gradient back."""

    def __init__(self, skip_channels: int, sparse_channels: int,
                 mlp: Sequence[int], dtype=None, project_first: bool = True):
        super().__init__()
        self.mlp_widths = tuple(mlp)
        self.dtype = dtype
        self.project_first = project_first
        if not project_first:
            self.mlp = SharedMLP(skip_channels + sparse_channels,
                                 self.mlp_widths, dtype=dtype)
            return
        c1 = self.mlp_widths[0]
        self.proj_kernel = nn.Parameter(
            torch.empty(skip_channels + sparse_channels, c1))
        self.proj_bias = nn.Parameter(torch.zeros(c1))
        self.proj_bn = BatchNorm(c1, dtype=dtype)
        self.mlp_rest = (SharedMLP(c1, self.mlp_widths[1:], dtype=dtype)
                         if len(self.mlp_widths) > 1 else None)
        self.init_(None)

    def init_(self, g):
        if not self.project_first:
            return
        lecun_normal_(self.proj_kernel, self.proj_kernel.shape[0], g)
        with torch.no_grad():
            self.proj_bias.zero_()

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                feats1: Optional[torch.Tensor], feats2: torch.Tensor,
                bn_momentum: float = 0.1) -> torch.Tensor:
        """xyz1 [B,N,3] dense targets, xyz2 [B,M,3] sparse sources (f32),
        feats1 [B,N,D1] or None, feats2 [B,M,D2] -> [B,N,C_last]."""
        B, N, _ = xyz1.shape
        M = xyz2.shape[1]
        if not self.project_first:
            if M == 1:
                h = feats2.expand(B, N, feats2.shape[-1])
            else:
                dists, idx = ops.three_nn(xyz1, xyz2)
                weight = ops.interpolation_weights(dists)
                h = ops.three_interpolate(
                    feats2.to(torch.promote_types(feats2.dtype,
                                                  weight.dtype)),
                    idx, weight)
            if feats1 is not None:
                h = torch.cat([feats1.to(h.dtype), h], dim=-1)
            return self.mlp(h, bn_momentum)
        c1 = self.mlp_widths[0]
        c2 = feats2.shape[-1]
        k2, bias = self.proj_kernel, self.proj_bias
        if self.dtype is not None:
            feats2, k2 = feats2.to(self.dtype), k2.to(self.dtype)
            bias = bias.to(self.dtype)
        else:
            feats2 = feats2.to(torch.promote_types(feats2.dtype, k2.dtype))
        # rows of W0: [skip channels; interpolated channels]
        k_skip, k_interp = k2[:-c2], k2[-c2:]
        pre = torch.matmul(feats2, k_interp)  # [B,M,C1], on the sparse set
        ps = _point_shard(self.training, N, ()) if M > 1 else None
        if ps is not None or (_want_fused_fp(self.training) and M > 1):
            # eval: BN's per-channel scale commutes with the interpolation,
            # so the kernel sees pre*A and the folded dense-side term
            A, C = self.proj_bn.fold()
            skip_t = bias.to(pre.dtype).expand(B, N, c1)
            if feats1 is not None:
                skip_t = torch.matmul(feats1.to(pre.dtype), k_skip) + skip_t
            if ps is not None:  # the dense rows split over the ranks
                h = sg.sharded_fp(xyz1, xyz2, pre * A, skip_t * A + C,
                                  ps.mesh)
            else:
                h = ops.fused_fp(xyz1, xyz2, pre * A, skip_t * A + C)
        else:
            if M == 1:
                h = pre.expand(B, N, c1)
            else:
                dists, idx = ops.three_nn(xyz1, xyz2)
                weight = ops.interpolation_weights(dists)
                h = ops.three_interpolate(pre, idx, weight.to(pre.dtype))
            if feats1 is not None:
                h = h + torch.matmul(feats1.to(pre.dtype), k_skip)
            h = h + bias
            h = torch.relu(self.proj_bn(h, momentum=bn_momentum))
        if self.mlp_rest is not None:
            h = self.mlp_rest(h, bn_momentum)
        return h


# --------------------------------------------------------------- cls models


def classification_head(model: nn.Module, h: torch.Tensor,
                        bn_momentum: float, deterministic: bool,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """The lineage's FC head on ``model.fc1, bn1, drop1, fc2, bn2, drop2,
    fc3``: two Dense + BN + relu + dropout layers and the class layer, then
    the f32 log-softmax."""
    h = torch.relu(model.bn1(model.fc1(h), momentum=bn_momentum))
    h = model.drop1(h, deterministic, generator)
    h = torch.relu(model.bn2(model.fc2(h), momentum=bn_momentum))
    h = model.drop2(h, deterministic, generator)
    return log_softmax_head(model.fc3(h).float())


class PointNet2ClsSSG(nn.Module):
    """Config 2 (BASELINE.json:8): PointNet++ SSG classification; with
    ``knn=True`` the kNN-grouping variant (``pointnet2_cls_knn``).

    ``MM3D_BF16_DEBUG``'s ``sa``, ``sa3`` and ``head`` (``pointnet2.py:
    531-553``) are read when the model is built: they fix its blocks'
    dtypes (flax reads them each time the module is traced)."""

    def __init__(self, num_class: int = 40, normal_channel: bool = False,
                 knn: bool = False, dtype=None):
        super().__init__()
        self.normal_channel = normal_channel
        sa_dt, hd_dt = _dbg_dtype("sa", dtype), _dbg_dtype("head", dtype)
        self.sa1 = SetAbstraction(512, 0.2, 32, 3 if normal_channel else 0,
                                  (64, 64, 128), dtype=sa_dt, knn=knn)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, (128, 128, 256),
                                  dtype=sa_dt, knn=knn)
        self.sa3 = SetAbstraction(in_channels=256, mlp=(256, 512, 1024),
                                  group_all=True,
                                  dtype=_dbg_dtype("sa3", sa_dt))
        self.fc1 = Dense(1024, 512, hd_dt)
        self.bn1 = BatchNorm(512, dtype=hd_dt)
        self.drop1 = Dropout(0.4)
        self.fc2 = Dense(512, 256, hd_dt)
        self.bn2 = BatchNorm(256, dtype=hd_dt)
        self.drop2 = Dropout(0.4)
        self.fc3 = Dense(256, num_class, hd_dt)

    def forward(self, points, bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,3(+3)] f32 -> (log_probs [B,num_class] f32,
        {"trans_feat": None}). Dropout runs unless ``deterministic``
        (default: not training); its masks come from ``generator``.
        ``fps_generator`` turns on the random FPS start in training."""
        det = (not self.training) if deterministic is None else deterministic
        xyz = points[..., :3]
        feats = points[..., 3:6] if self.normal_channel else None
        xyz, f = self.sa1(xyz, feats, bn_momentum, fps_generator)
        xyz, f = self.sa2(xyz, f, bn_momentum, fps_generator)
        _, f = self.sa3(xyz, f, bn_momentum)
        return (classification_head(self, f[:, 0], bn_momentum, det,
                                    generator), {"trans_feat": None})


class PointNet2ClsMSG(nn.Module):
    """``pointnet2_cls_msg`` (``pointnet2.py:557-589``): PointNet++
    multi-scale classification, two ``SetAbstractionMsg`` blocks of three
    scales each, the group_all sa3 and the lineage's FC head (dropout 0.4,
    then 0.5)."""

    def __init__(self, num_class: int = 40, normal_channel: bool = False,
                 dtype=None):
        super().__init__()
        self.normal_channel = normal_channel
        self.sa1 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (16, 32, 128),
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
            3 if normal_channel else 0, dtype=dtype)
        self.sa2 = SetAbstractionMsg(
            128, (0.2, 0.4, 0.8), (32, 64, 128),
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)), 320,
            dtype=dtype)
        self.sa3 = SetAbstraction(in_channels=640, mlp=(256, 512, 1024),
                                  group_all=True, dtype=dtype)
        self.fc1 = Dense(1024, 512, dtype)
        self.bn1 = BatchNorm(512, dtype=dtype)
        self.drop1 = Dropout(0.4)
        self.fc2 = Dense(512, 256, dtype)
        self.bn2 = BatchNorm(256, dtype=dtype)
        self.drop2 = Dropout(0.5)
        self.fc3 = Dense(256, num_class, dtype)

    # the same forward: sa1, sa2, the group_all sa3, the head
    forward = PointNet2ClsSSG.forward


# ----------------------------------------------------------- part-seg models


class _PartSeg(nn.Module):
    """The part-segmentation trunk both PointNet++ part-seg models share
    (``pointnet2.py:595-675``): sa1, sa2 (``SetAbstraction`` or
    ``SetAbstractionMsg``), the group_all sa3, the FP decoder fp3, fp2 and
    fp1, whose dense-side skip is [one-hot category, xyz, points], then the
    per-point head ``head_mlp`` (128), dropout 0.5 (``drop``) and
    ``head_out``, and the f32 log-softmax.

    fp3 interpolates from sa3's single point, so it broadcasts that row
    (``FeaturePropagation``'s M == 1 branch: no 3-NN, no fused tail). With
    ``normal_channel`` the points carry normals, [B,N,6], and sa1 groups all
    six channels as features, as the JAX models do."""

    def __init__(self, sa1: nn.Module, sa2: nn.Module, c1: int, c2: int,
                 fp1_mlp: Sequence[int], num_part: int, num_category: int,
                 normal_channel: bool, dtype):
        super().__init__()
        self.num_part, self.num_category = num_part, num_category
        self.normal_channel = normal_channel
        self.dtype = dtype
        self.sa1, self.sa2 = sa1, sa2
        self.sa3 = SetAbstraction(in_channels=c2, mlp=(256, 512, 1024),
                                  group_all=True, dtype=dtype)
        self.fp3 = FeaturePropagation(c2, 1024, (256, 256), dtype=dtype)
        self.fp2 = FeaturePropagation(c1, 256, (256, 128), dtype=dtype)
        skip = num_category + 3 + (6 if normal_channel else 3)
        self.fp1 = FeaturePropagation(skip, 128, fp1_mlp, dtype=dtype)
        self.head_mlp = SharedMLP(fp1_mlp[-1], (128,), dtype=dtype)
        self.drop = Dropout(0.5)
        self.head_out = Dense(128, num_part, dtype)

    def forward(self, points: torch.Tensor, cls_label_onehot: torch.Tensor,
                bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,3(+3)] f32, cls_label_onehot [B,num_category] ->
        (log_probs [B,N,num_part] f32, {"trans_feat": None}). Dropout runs
        unless ``deterministic`` (default: not training); its masks come
        from ``generator``. ``fps_generator`` turns on the random FPS start
        in training."""
        det = (not self.training) if deterministic is None else deterministic
        B, N, _ = points.shape
        l0_xyz = points[..., :3]
        l0_feats = points if self.normal_channel else None
        l1_xyz, l1_f = self.sa1(l0_xyz, l0_feats, bn_momentum, fps_generator)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f, bn_momentum, fps_generator)
        l3_xyz, l3_f = self.sa3(l2_xyz, l2_f, bn_momentum)
        l2_f = self.fp3(l2_xyz, l3_xyz, l2_f, l3_f, bn_momentum)
        l1_f = self.fp2(l1_xyz, l2_xyz, l1_f, l2_f, bn_momentum)
        # the one-hot in the points' dtype, concatenated in it (f32), as in
        # the JAX models; fp1 casts the skip to its compute dtype
        cls_tiled = cls_label_onehot[:, None, :].to(points.dtype).expand(
            B, N, self.num_category)
        l0_skip = torch.cat([cls_tiled, l0_xyz, points], dim=-1)
        l0_f = self.fp1(l0_xyz, l1_xyz, l0_skip, l1_f, bn_momentum)
        h = self.head_mlp(l0_f, bn_momentum)
        h = self.drop(h, det, generator)
        h = self.head_out(h)
        return log_softmax_head(h.float()), {"trans_feat": None}


class PointNet2PartSegSSG(_PartSeg):
    """``pointnet2_part_seg_ssg``: the SSG encoder (``pointnet2.py:595-633``)
    with the part-seg decoder and head."""

    def __init__(self, num_part: int = 50, num_category: int = 16,
                 normal_channel: bool = False, dtype=None):
        d = 6 if normal_channel else 0
        super().__init__(
            SetAbstraction(512, 0.2, 32, d, (64, 64, 128), dtype=dtype),
            SetAbstraction(128, 0.4, 64, 128, (128, 128, 256), dtype=dtype),
            128, 256, (128, 128, 128), num_part, num_category,
            normal_channel, dtype)


class PointNet2PartSegMSG(_PartSeg):
    """Config 3 (BASELINE.json:9), ``pointnet2_part_seg_msg``: the MSG
    encoder (``pointnet2.py:636-675``), three scales at sa1 and two at sa2,
    with the part-seg decoder and head."""

    def __init__(self, num_part: int = 50, num_category: int = 16,
                 normal_channel: bool = False, dtype=None):
        d = 6 if normal_channel else 0
        super().__init__(
            SetAbstractionMsg(512, (0.1, 0.2, 0.4), (32, 64, 128),
                              ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
                              d, dtype=dtype),
            SetAbstractionMsg(128, (0.4, 0.8), (64, 128),
                              ((128, 128, 256), (128, 196, 256)), 320,
                              dtype=dtype),
            320, 512, (128, 128), num_part, num_category, normal_channel,
            dtype)


# ------------------------------------------------------------ semseg models


class _SemSeg(nn.Module):
    """The trunk both PointNet++ semantic-segmentation models share
    (``pointnet2.py:681-760``): four SA blocks over 9-dim block features
    (1024, 256, 64 and 16 centroids; sa1 in f32 during bf16 training), four
    FP blocks back to the input points (FP1 with no dense-side skip), then
    the per-point head ``head_mlp`` (128), dropout 0.5 (``drop``) and
    ``head_out``, and the f32 log-softmax. ``widths`` are the SA blocks'
    output channels; each FP block's skip and sparse channels follow from
    them. ``fp_dtype`` and ``head_dtype`` are the FP blocks' and the head's
    dtypes (``dtype`` but under ``MM3D_BF16_DEBUG``)."""

    def __init__(self, sa1, sa2, sa3, sa4, widths, num_class: int, dtype,
                 fp_dtype, head_dtype):
        super().__init__()
        self.dtype = dtype
        self.sa1, self.sa2, self.sa3, self.sa4 = sa1, sa2, sa3, sa4
        w1, w2, w3, w4 = widths
        self.fp4 = FeaturePropagation(w3, w4, (256, 256), dtype=fp_dtype)
        self.fp3 = FeaturePropagation(w2, 256, (256, 256), dtype=fp_dtype)
        self.fp2 = FeaturePropagation(w1, 256, (256, 128), dtype=fp_dtype)
        self.fp1 = FeaturePropagation(0, 128, (128, 128, 128),
                                      dtype=fp_dtype)
        self.head_mlp = SharedMLP(128, (128,), dtype=head_dtype)
        self.drop = Dropout(0.5)
        self.head_out = Dense(128, num_class, head_dtype)

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,9] f32 -> (log_probs [B,N,num_class] f32,
        {"trans_feat": None}). Dropout, ``generator`` and ``fps_generator``
        as in ``PointNet2ClsSSG.forward``."""
        det = (not self.training) if deterministic is None else deterministic
        l0_xyz = points[..., :3]
        l1_xyz, l1_f = self.sa1(l0_xyz, points, bn_momentum, fps_generator)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f, bn_momentum, fps_generator)
        l3_xyz, l3_f = self.sa3(l2_xyz, l2_f, bn_momentum, fps_generator)
        l4_xyz, l4_f = self.sa4(l3_xyz, l3_f, bn_momentum, fps_generator)
        l3_f = self.fp4(l3_xyz, l4_xyz, l3_f, l4_f, bn_momentum)
        l2_f = self.fp3(l2_xyz, l3_xyz, l2_f, l3_f, bn_momentum)
        l1_f = self.fp2(l1_xyz, l2_xyz, l1_f, l2_f, bn_momentum)
        l0_f = self.fp1(l0_xyz, l1_xyz, None, l1_f, bn_momentum)
        h = self.head_mlp(l0_f, bn_momentum)
        h = self.head_out(self.drop(h, det, generator))
        return log_softmax_head(h.float()), {"trans_feat": None}


class PointNet2SemSeg(_SemSeg):
    """``pointnet2_sem_seg``: the SSG trunk (``pointnet2.py:681-721``).

    ``MM3D_BF16_DEBUG``'s ``sa``, ``sa1``-``sa4``, ``fp`` and ``head``
    (``pointnet2.py:691-720``) are read when the model is built, as in
    ``PointNet2ClsSSG``."""

    def __init__(self, num_class: int = 13, dtype=None):
        sa_dt = _dbg_dtype("sa", dtype)

        def sa(i):
            return _dbg_dtype(f"sa{i}", sa_dt)

        super().__init__(
            SetAbstraction(1024, 0.1, 32, 9, (32, 32, 64), dtype=sa(1),
                           f32_train_guard=True),
            SetAbstraction(256, 0.2, 32, 64, (64, 64, 128), dtype=sa(2)),
            SetAbstraction(64, 0.4, 32, 128, (128, 128, 256), dtype=sa(3)),
            SetAbstraction(16, 0.8, 32, 256, (256, 256, 512), dtype=sa(4)),
            (64, 128, 256, 512), num_class, dtype, _dbg_dtype("fp", dtype),
            _dbg_dtype("head", dtype))


class PointNet2SemSegMSG(_SemSeg):
    """``pointnet2_sem_seg_msg``: the MSG trunk (``pointnet2.py:724-760``),
    two scales a block."""

    def __init__(self, num_class: int = 13, dtype=None):
        super().__init__(
            SetAbstractionMsg(1024, (0.05, 0.1), (16, 32),
                              ((16, 16, 32), (32, 32, 64)), 9, dtype=dtype,
                              f32_train_guard=True),
            SetAbstractionMsg(256, (0.1, 0.2), (16, 32),
                              ((64, 64, 128), (64, 96, 128)), 96,
                              dtype=dtype),
            SetAbstractionMsg(64, (0.2, 0.4), (16, 32),
                              ((128, 196, 256), (128, 196, 256)), 256,
                              dtype=dtype),
            SetAbstractionMsg(16, (0.4, 0.8), (16, 32),
                              ((256, 256, 512), (256, 384, 512)), 512,
                              dtype=dtype),
            (96, 256, 512, 1024), num_class, dtype, dtype, dtype)
