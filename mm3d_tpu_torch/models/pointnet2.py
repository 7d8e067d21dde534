"""PointNet++ blocks (counterpart of ``mm3d_tpu/models/pointnet2.py``).

The branches of ``SetAbstraction`` that ``fusion_cls`` serves and trains:

* group_all (``pointnet2.py:142-163``): dense SharedMLP + max; in bf16
  training the stack computes in f32 (the group_all guard, ``:142-154``);
* fused (``:232-243``), eval only: the BN-folded SA tail in one kernel
  (``ops.fused_sa``; bf16 serving, or any dtype under impl 'cuda');
* unfused (``:273-300``): FPS and ball-query kernels, then the gather (whose
  backward is the gather-backward kernel), the MLP and max. Training always
  takes it; bf16 training recentres in f32 from the f32 inputs captured
  before the cast (``:170-178,278-292``).

``FeaturePropagation`` (``:416-513``), the FP decoder block of the dense
trunk, project-first:

* fused (``:479-496``), eval (``_want_fused_fp``): BN folds to an affine map,
  so 3-NN, inverse-distance interpolation, the dense-side term and relu run
  as one kernel (``ops.fused_fp``), in every dtype;
* unfused (``:497-509``): the three_nn kernel, the inverse-distance
  weights, the three_interpolate kernel (whose backward is the
  gather-backward kernel), skip, bias, BN, relu. Training takes it;
* M == 1 broadcasts the single sparse row.

Train or eval is the module's ``training`` flag. The dtype casts sit where
the JAX module puts them. Still to be ported in later slices: the
point-shard branches (``:183-230``, ``:470-478``), kNN grouping
(``:245-259``), the ``MM3D_BF16_DEBUG`` knob (``:30-36``),
``project_first=False`` and ``SetAbstractionMsg``.
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


def _want_fused_fp(train: bool) -> bool:
    """Take the fused FP-tail kernel? Eval only, in every dtype, as in the
    JAX package."""
    return not train


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


class FeaturePropagation(nn.Module):
    """FP decoder block: 3-NN inverse-distance upsample + skip + MLP.

    Project-first: the interpolation is linear, so the first layer runs on
    the M sparse points, ``interp(f2 @ W_f2) + f1 @ W_skip + b``.
    ``skip_channels`` counts the dense-side features (0 for none),
    ``sparse_channels`` the sparse-side ones. Parameters follow the flax
    tree: ``proj_kernel`` [skip + sparse, C1] with rows [skip; interpolated],
    ``proj_bias``, ``proj_bn`` and ``mlp_rest``."""

    def __init__(self, skip_channels: int, sparse_channels: int,
                 mlp: Sequence[int], dtype=None):
        super().__init__()
        self.mlp_widths = tuple(mlp)
        self.dtype = dtype
        c1 = self.mlp_widths[0]
        self.proj_kernel = nn.Parameter(
            torch.empty(skip_channels + sparse_channels, c1))
        self.proj_bias = nn.Parameter(torch.zeros(c1))
        self.proj_bn = BatchNorm(c1, dtype=dtype)
        self.mlp_rest = (SharedMLP(c1, self.mlp_widths[1:], dtype=dtype)
                         if len(self.mlp_widths) > 1 else None)
        self.init_(None)

    def init_(self, g):
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
        c1 = self.mlp_widths[0]
        c2 = feats2.shape[-1]
        k2, bias = self.proj_kernel, self.proj_bias
        if self.dtype is not None:
            feats2, k2 = feats2.to(self.dtype), k2.to(self.dtype)
            bias = bias.to(self.dtype)
        # rows of W0: [skip channels; interpolated channels]
        k_skip, k_interp = k2[:-c2], k2[-c2:]
        pre = torch.matmul(feats2, k_interp)  # [B,M,C1], on the sparse set
        if _want_fused_fp(self.training) and M > 1:
            # eval: BN's per-channel scale commutes with the interpolation,
            # so the kernel sees pre*A and the folded dense-side term
            A, C = self.proj_bn.fold()
            skip_t = bias.to(pre.dtype).expand(B, N, c1)
            if feats1 is not None:
                skip_t = torch.matmul(feats1.to(pre.dtype), k_skip) + skip_t
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
