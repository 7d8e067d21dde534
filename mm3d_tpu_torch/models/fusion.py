"""Multimodal point+image fusion (counterpart of ``mm3d_tpu/models/fusion.py``).

Late fusion for classification (``FusionCls``, config 4: global point
feature with the global image feature) and per-point fusion for
segmentation (``FusionSemSeg``, config 5: dense point features with pixel
features projected and bilinearly sampled from the CNN's stride-4 map), each
with the 'concat' and 'attention' heads. Both serve and train.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mm3d_tpu_torch.models.image import ImageEncoder
from mm3d_tpu_torch.models.layers import (BatchNorm, Dense, Dropout,
                                          SharedMLP, log_softmax_head)
from mm3d_tpu_torch.models.pointnet2 import (FeaturePropagation,
                                             SetAbstraction)
from mm3d_tpu_torch.ops import projection


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


class PointTrunkDense(nn.Module):
    """SA x2 down + FP x2 up -> [B, N, 128] per-point features.

    ``in_channels`` counts the per-point features (9 for S3DIS-style
    blocks); sa1 keeps the bf16-train f32 guard of the JAX trunk."""

    def __init__(self, in_channels: int = 9, dtype=None):
        super().__init__()
        self.sa1 = SetAbstraction(256, 0.2, 32, in_channels, (64, 64, 128),
                                  dtype=dtype, f32_train_guard=True)
        self.sa2 = SetAbstraction(64, 0.4, 64, 128, (128, 128, 256),
                                  dtype=dtype)
        self.fp2 = FeaturePropagation(128, 256, (256, 128), dtype=dtype)
        self.fp1 = FeaturePropagation(in_channels, 128, (128, 128),
                                      dtype=dtype)

    def forward(self, xyz, feats=None, bn_momentum: float = 0.1,
                fps_generator: Optional[torch.Generator] = None):
        l1_xyz, l1_f = self.sa1(xyz, feats, bn_momentum, fps_generator)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f, bn_momentum, fps_generator)
        l1_f = self.fp2(l1_xyz, l2_xyz, l1_f, l2_f, bn_momentum)
        return self.fp1(xyz, l1_xyz, feats, l1_f, bn_momentum)


class AttentionFusion(nn.Module):
    """Learned softmax gate over modalities projected to a common width:
    ``proj_i`` Dense to ``features``, ``score_i`` Dense(1) of its tanh."""

    def __init__(self, in_features: Sequence[int], features: int = 256,
                 dtype=None):
        super().__init__()
        self.n = len(in_features)
        for i, c in enumerate(in_features):
            self.add_module(f"proj_{i}", Dense(c, features, dtype))
            self.add_module(f"score_{i}", Dense(features, 1, dtype))

    def forward(self, feats: Sequence[torch.Tensor]):
        projected = [getattr(self, f"proj_{i}")(f) for i, f in enumerate(feats)]
        scores = [getattr(self, f"score_{i}")(torch.tanh(p))
                  for i, p in enumerate(projected)]
        alpha = torch.softmax(torch.cat(scores, dim=-1), dim=-1)
        stacked = torch.stack(projected, dim=-1)  # [..., F, M]
        return (stacked * alpha[..., None, :]).sum(dim=-1), alpha


class FusionCls(nn.Module):
    """Config 4: image + point late-fusion classification."""

    def __init__(self, num_class: int = 40, fusion: str = "concat",
                 normal_channel: bool = False, dtype=None):
        super().__init__()
        if fusion not in ("concat", "attention"):
            raise ValueError(f"fusion={fusion!r}: 'concat' or 'attention'")
        self.num_class = num_class
        self.fusion = fusion
        self.normal_channel = normal_channel
        self.dtype = dtype
        self.point_trunk = PointTrunkCls(3 if normal_channel else 0, dtype)
        self.image_trunk = ImageEncoder(dtype=dtype)
        if fusion == "attention":
            self.fuse = AttentionFusion((1024, 512), 256, dtype)
        self.fc1 = Dense(256 if fusion == "attention" else 1024 + 512, 512,
                         dtype)
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
        aux = {"trans_feat": None}
        if self.fusion == "attention":
            h, aux["fusion_alpha"] = self.fuse([pf, imgf])
        else:
            h = torch.cat([pf, imgf], dim=-1)
        h = torch.relu(self.bn1(self.fc1(h), momentum=bn_momentum))
        h = self.drop1(h, det, generator)
        h = torch.relu(self.bn2(self.fc2(h), momentum=bn_momentum))
        h = self.drop2(h, det, generator)
        h = self.fc3(h)
        return log_softmax_head(h.float()), aux


class FusionSemSeg(nn.Module):
    """Config 5: per-point semantic segmentation with point<->pixel fusion.

    Points project into the image; pixel features are bilinearly sampled
    from the CNN's stride-4 map and fused per point with the dense trunk's
    features ('concat' or 'attention'), then a shared-MLP head predicts
    per-point classes."""

    def __init__(self, num_class: int = 13, fusion: str = "concat",
                 image_stride: int = 4, in_channels: int = 9, dtype=None):
        super().__init__()
        if fusion not in ("concat", "attention"):
            raise ValueError(f"fusion={fusion!r}: 'concat' or 'attention'")
        self.num_class = num_class
        self.fusion = fusion
        self.image_stride = image_stride
        self.dtype = dtype
        self.point_trunk = PointTrunkDense(in_channels, dtype)
        self.image_trunk = ImageEncoder(include_global=False, dtype=dtype)
        c_img = self.image_trunk.stage_features[-1]
        if fusion == "attention":
            self.fuse = AttentionFusion((128, c_img), 128, dtype)
        self.head_mlp = SharedMLP(128 if fusion == "attention"
                                  else 128 + c_img, (128,), dtype=dtype)
        self.drop = Dropout(0.5)
        self.head_out = Dense(128, num_class, dtype)

    def forward(self, points, image, K, R, t, bn_momentum: float = 0.1,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None):
        """points [B,N,9] f32 (block xyz first), image [B,H,W,3] NHWC, camera
        K [B,3,3], R [B,3,3], t [B,3] -> (log_probs [B,N,num_class], aux with
        ``proj_valid`` [B,N])."""
        det = (not self.training) if deterministic is None else deterministic
        xyz = points[..., :3]
        pf = self.point_trunk(xyz, points, bn_momentum, fps_generator)
        fmap, _ = self.image_trunk(image.to(self.dtype or image.dtype),
                                   bn_momentum)
        H, W = image.shape[1], image.shape[2]
        # image_stride must match the encoder's actual downsampling: a
        # mismatch scales uv by the wrong factor with no shape error
        if H // self.image_stride != fmap.shape[1]:
            raise ValueError(
                f"image_stride={self.image_stride} disagrees with the "
                f"encoder: image H={H} -> fmap H={fmap.shape[1]} "
                f"(expected {H // self.image_stride})")
        pixf, valid = projection.sample_image_features(
            fmap, xyz, K, R, t, (H, W), stride=self.image_stride)
        aux = {"trans_feat": None, "proj_valid": valid}
        if self.fusion == "attention":
            fused, aux["fusion_alpha"] = self.fuse([pf, pixf])
        else:
            fused = torch.cat([pf, pixf], dim=-1)
        h = self.head_mlp(fused, bn_momentum)
        h = self.drop(h, det, generator)
        h = self.head_out(h)
        return log_softmax_head(h.float()), aux
