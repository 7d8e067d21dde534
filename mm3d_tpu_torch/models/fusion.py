"""Multimodal point+image fusion (counterpart of ``mm3d_tpu/models/fusion.py``).

This slice carries ``FusionCls`` with the 'concat' head (config 4), in eval
and train mode. The attention head, the dense trunk and ``FusionSemSeg``
come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mm3d_tpu_torch.models.image import ImageEncoder
from mm3d_tpu_torch.models.layers import (BatchNorm, Dense, Dropout,
                                          log_softmax_head)
from mm3d_tpu_torch.models.pointnet2 import SetAbstraction


class PointTrunkCls(nn.Module):
    """PointNet++ SSG trunk -> [B, 1024] global feature."""

    def __init__(self, in_channels: int = 0, dtype=None):
        super().__init__()
        self.sa1 = SetAbstraction(512, 0.2, 32, in_channels, (64, 64, 128),
                                  dtype=dtype)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, (128, 128, 256),
                                  dtype=dtype)
        self.sa3 = SetAbstraction(in_channels=256, mlp=(256, 512, 1024),
                                  group_all=True, dtype=dtype)

    def forward(self, xyz, feats=None, bn_momentum: float = 0.1,
                fps_generator: Optional[torch.Generator] = None):
        xyz, f = self.sa1(xyz, feats, bn_momentum, fps_generator)
        xyz, f = self.sa2(xyz, f, bn_momentum, fps_generator)
        _, f = self.sa3(xyz, f, bn_momentum)
        return f[:, 0]


class FusionCls(nn.Module):
    """Config 4: image + point late-fusion classification."""

    def __init__(self, num_class: int = 40, fusion: str = "concat",
                 normal_channel: bool = False, dtype=None):
        super().__init__()
        if fusion != "concat":
            raise NotImplementedError(
                f"fusion={fusion!r}: only 'concat' is ported so far")
        self.num_class = num_class
        self.normal_channel = normal_channel
        self.dtype = dtype
        self.point_trunk = PointTrunkCls(3 if normal_channel else 0, dtype)
        self.image_trunk = ImageEncoder(dtype=dtype)
        self.fc1 = Dense(1024 + 512, 512, dtype)
        self.bn1 = BatchNorm(512, dtype=dtype)
        self.drop1 = Dropout(0.4)
        self.fc2 = Dense(512, 256, dtype)
        self.bn2 = BatchNorm(256, dtype=dtype)
        self.drop2 = Dropout(0.4)
        self.fc3 = Dense(256, num_class, dtype)

    def forward(self, points, image, K=None, R=None, t=None,
                bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,3(+3)] f32, image [B,H,W,3] NHWC -> (log_probs, aux).

        K, R and t (camera) are accepted for the common fusion signature and
        unused by late fusion. Dropout runs unless ``deterministic`` (default:
        not training); its masks come from ``generator``. ``fps_generator``
        turns on the random FPS start in training."""
        det = (not self.training) if deterministic is None else deterministic
        xyz = points[..., :3]
        feats = points[..., 3:6] if self.normal_channel else None
        pf = self.point_trunk(xyz, feats, bn_momentum, fps_generator)
        _, imgf = self.image_trunk(image.to(self.dtype or image.dtype),
                                   bn_momentum)
        h = torch.cat([pf, imgf], dim=-1)
        h = torch.relu(self.bn1(self.fc1(h), momentum=bn_momentum))
        h = self.drop1(h, det, generator)
        h = torch.relu(self.bn2(self.fc2(h), momentum=bn_momentum))
        h = self.drop2(h, det, generator)
        h = self.fc3(h)
        return log_softmax_head(h.float()), {"trans_feat": None}
