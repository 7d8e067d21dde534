"""PointNet++ set abstraction (counterpart of ``mm3d_tpu/models/pointnet2.py``).

This slice carries the eval-mode branches of ``SetAbstraction`` that the
``fusion_cls`` serving path runs:

* group_all (``pointnet2.py:142-163``): dense SharedMLP + max;
* fused (``:232-243``): the BN-folded SA tail in one kernel
  (``ops.fused_sa``; bf16 serving, or any dtype under impl 'cuda');
* unfused (``:273-300``): FPS and ball-query kernels, then a PyTorch gather,
  the folded-free MLP and max (fp32 serving).

The dtype casts sit where the JAX module puts them. Still to be ported in
later slices: the point-shard branch (``:183-230``), kNN grouping
(``:245-259``), every train-mode branch (with its f32 recentering and guard)
and the ``MM3D_BF16_DEBUG`` knob (``:30-36``); ``SetAbstractionMsg`` and
``FeaturePropagation`` come with the FP-block slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mm3d_tpu_torch import ops
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.models.layers import BatchNorm, SharedMLP, lecun_normal_


def _want_fused_sa(train: bool, mlp, dtype) -> bool:
    """Take the fused SA kernel (eval only, 3-layer MLP)?

    bf16 serving always does; fp32 keeps the unfused path unless the mode
    is explicitly 'cuda' (tests / forced kernels), as in the JAX package."""
    if train or len(mlp) != 3:
        return False
    if dtype == torch.bfloat16:
        return True
    return dispatch.get_impl() == "cuda"


class SetAbstraction(nn.Module):
    """Single-scale grouping SA block, project-first form (eval mode).

    ``in_channels`` counts the feature channels besides xyz (0 for raw
    points). Parameters follow the flax tree: ``proj_kernel`` [3+D, C1],
    ``proj_bias``, ``proj_bn`` and ``mlp_rest``; group_all blocks hold one
    ``mlp``."""

    def __init__(self, npoint: Optional[int] = None,
                 radius: Optional[float] = None,
                 nsample: Optional[int] = None, in_channels: int = 0,
                 mlp: Sequence[int] = (), group_all: bool = False,
                 dtype=None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_widths = tuple(mlp)
        self.group_all = group_all
        self.dtype = dtype
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

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
        """xyz [B,N,3] f32, feats [B,N,D] or None -> (new_xyz, [B,S,C'])."""
        if self.training:
            raise NotImplementedError(
                "SetAbstraction is eval-only in this port; call .eval()")
        if self.group_all:
            new_xyz, grouped = ops.sample_and_group_all(xyz, feats)
            return new_xyz, self.mlp(grouped).amax(dim=2)

        dt = self.dtype
        if feats is None:
            cat = xyz
        else:
            ct = torch.promote_types(xyz.dtype, feats.dtype)
            cat = torch.cat([xyz.to(ct), feats.to(ct)], dim=-1)
        kernel, bias = self.proj_kernel, self.proj_bias
        if dt is not None:
            cat, kernel, bias = cat.to(dt), kernel.to(dt), bias.to(dt)
        pre = torch.matmul(cat, kernel)  # [B,N,C1]
        fps_idx = ops.farthest_point_sample(xyz, self.npoint)
        new_xyz = ops.index_points(xyz, fps_idx)
        cterm = torch.matmul(new_xyz.to(pre.dtype), kernel[:3])

        if _want_fused_sa(False, self.mlp_widths, dt):
            # eval: BN folds to an affine map, so ball query + gather +
            # MLP + max run as one kernel with no [B,S,K,C] tensor
            A, C = self.proj_bn.fold()
            (w1, b1), (w2, b2) = self.mlp_rest.fold()
            out = ops.fused_sa(self.radius, self.nsample, xyz, new_xyz,
                               pre * A, (bias - cterm) * A + C, w1, b1, w2,
                               b2)
            return new_xyz, out

        idx = ops.query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        gathered = ops.index_points(pre, idx)  # [B,S,K,C1]
        h = gathered - cterm[:, :, None, :] + bias
        h = torch.relu(self.proj_bn(h))
        if self.mlp_rest is not None:
            h = self.mlp_rest(h)
        return new_xyz, h.amax(dim=2)
