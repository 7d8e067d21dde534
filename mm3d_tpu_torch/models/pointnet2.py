"""PointNet++ set abstraction (counterpart of ``mm3d_tpu/models/pointnet2.py``).

The branches of ``SetAbstraction`` that ``fusion_cls`` serves and trains:

* group_all (``pointnet2.py:142-163``): dense SharedMLP + max; in bf16
  training the stack computes in f32 (the group_all guard, ``:142-154``);
* fused (``:232-243``), eval only: the BN-folded SA tail in one kernel
  (``ops.fused_sa``; bf16 serving, or any dtype under impl 'cuda');
* unfused (``:273-300``): FPS and ball-query kernels, then the gather (whose
  backward is the gather-backward kernel), the MLP and max. Training always
  takes it; bf16 training recentres in f32 from the f32 inputs captured
  before the cast (``:170-178,278-292``).

Train or eval is the module's ``training`` flag. The dtype casts sit where
the JAX module puts them. Still to be ported in later slices: the
point-shard branch (``:183-230``), kNN grouping (``:245-259``) and the
``MM3D_BF16_DEBUG`` knob (``:30-36``); ``SetAbstractionMsg`` and
``FeaturePropagation`` come with the FP-block slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mm3d_tpu_torch import ops
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.models.layers import (BatchNorm, SharedMLP,
                                          guarded_train_dtype, lecun_normal_)


def _want_fused_sa(train: bool, mlp, dtype) -> bool:
    """Take the fused SA kernel (eval only, 3-layer MLP)?

    bf16 serving always does; fp32 keeps the unfused path unless the mode
    is explicitly 'cuda' (tests / forced kernels), as in the JAX package."""
    if train or len(mlp) != 3:
        return False
    if dtype == torch.bfloat16:
        return True
    return dispatch.get_impl() == "cuda"


def _fps_start(train: bool, xyz: torch.Tensor,
               generator: Optional[torch.Generator]):
    """Lineage-parity random-start FPS seed (``pointnet2.py:90-102``).

    In training, with a generator (``TrainConfig.fps_random_start``), each
    cloud starts FPS at a random index; otherwise at index 0."""
    if train and generator is not None:
        return torch.randint(0, xyz.shape[1], (xyz.shape[0],),
                             generator=generator, device=xyz.device,
                             dtype=torch.int32)
    return 0


class SetAbstraction(nn.Module):
    """Single-scale grouping SA block, project-first form.

    ``in_channels`` counts the feature channels besides xyz (0 for raw
    points). Parameters follow the flax tree: ``proj_kernel`` [3+D, C1],
    ``proj_bias``, ``proj_bn`` and ``mlp_rest``; group_all blocks hold one
    ``mlp``. ``f32_train_guard`` computes the block in f32 during bf16
    training (serving stays bf16), as the JAX attribute does."""

    def __init__(self, npoint: Optional[int] = None,
                 radius: Optional[float] = None,
                 nsample: Optional[int] = None, in_channels: int = 0,
                 mlp: Sequence[int] = (), group_all: bool = False,
                 dtype=None, f32_train_guard: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_widths = tuple(mlp)
        self.group_all = group_all
        self.dtype = dtype
        self.f32_train_guard = f32_train_guard
        c_in = 3 + in_channels
        if group_all:
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
        if self.group_all:
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

        dt = guarded_train_dtype(self.dtype, train, self.f32_train_guard)
        if feats is None:
            cat = xyz
        else:
            ct = torch.promote_types(xyz.dtype, feats.dtype)
            cat = torch.cat([xyz.to(ct), feats.to(ct)], dim=-1)
        kernel, bias = self.proj_kernel, self.proj_bias
        # f32 originals, captured before the bf16 cast: the bf16-train
        # recentering below starts from them (pointnet2.py:170-178)
        cat32, kernel32, bias32 = cat, kernel, bias
        if dt is not None:
            cat, kernel, bias = cat.to(dt), kernel.to(dt), bias.to(dt)
        fps_idx = ops.farthest_point_sample(
            xyz, self.npoint, _fps_start(train, xyz, fps_generator))
        new_xyz = ops.index_points(xyz, fps_idx)

        if _want_fused_sa(train, self.mlp_widths, self.dtype):
            # eval: BN folds to an affine map, so ball query + gather +
            # MLP + max run as one kernel with no [B,S,K,C] tensor
            pre = torch.matmul(cat, kernel)  # [B,N,C1]
            cterm = torch.matmul(new_xyz.to(pre.dtype), kernel[:3])
            A, C = self.proj_bn.fold()
            (w1, b1), (w2, b2) = self.mlp_rest.fold()
            out = ops.fused_sa(self.radius, self.nsample, xyz, new_xyz,
                               pre * A, (bias - cterm) * A + C, w1, b1, w2,
                               b2)
            return new_xyz, out

        idx = ops.query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        if dt is not None and train:
            # bf16 training: `gathered - cterm` cancels two O(1) terms, and
            # in bf16 that leaves ~5 bits of the local geometry; recentre in
            # f32 and cast after (pointnet2.py:278-292)
            pre32 = torch.matmul(cat32.float(), kernel32.float())
            ct32 = torch.matmul(new_xyz.float(), kernel32[:3].float())
            gathered = ops.index_points(pre32, idx)  # [B,S,K,C1] f32
            h = (gathered - ct32[:, :, None, :] + bias32.float()).to(dt)
        else:
            pre = torch.matmul(cat, kernel)  # [B,N,C1]
            cterm = torch.matmul(new_xyz.to(pre.dtype), kernel[:3])
            gathered = ops.index_points(pre, idx)  # [B,S,K,C1]
            h = gathered - cterm[:, :, None, :] + bias
        f32 = dt is None
        h = torch.relu(self.proj_bn(h, momentum=bn_momentum, f32=f32))
        if self.mlp_rest is not None:
            h = self.mlp_rest(h, bn_momentum, f32=f32)
        return new_xyz, h.amax(dim=2)
