"""2D image branch (counterpart of ``mm3d_tpu/models/image.py``).

The module boundary is NHWC as in the JAX package. Inside, the NHWC input
is viewed as NCHW without a copy; its strides are channels-last, which is
the layout the card's convolutions prefer. Flax ``padding="SAME"`` pads
asymmetrically at stride 2 (low 0, high 1 for even sizes), so ``Conv`` pads
explicitly with flax's formula instead of torch's symmetric ``padding=``.
BatchNorm normalises axis 1 of the NCHW view; in training its statistics
reduce over (0, 2, 3) and their shift anchor is ``x[0, :, 0, 0]``, the JAX
package's ``x[0, 0, 0, :]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mm3d_tpu_torch.models.layers import BatchNorm, Dense, lecun_normal_


def _same_pads(size: int, k: int, s: int):
    """flax SAME: total = max((ceil(size/s)-1)*s + k - size, 0), lo = total//2."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free 2D convolution with flax SAME padding, on NCHW tensors.

    ``kernel`` is OIHW (the flax HWIO kernel transposed on import)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 dtype=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.kernel = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.init_(None)

    def init_(self, g):
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        ph = _same_pads(x.shape[2], self.k, self.stride)
        pw = _same_pads(x.shape[3], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, stride=self.stride)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=None):
        super().__init__()
        self.conv1 = Conv(in_ch, features, 3, stride, dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, 3, 1, dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.proj = None
        if in_ch != features or stride != 1:
            self.proj = Conv(in_ch, features, 1, stride, dtype)
            self.bn_proj = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1
                ) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), True, bn_momentum))
        y = self.bn2(self.conv2(y), True, bn_momentum)
        r = x
        if self.proj is not None:
            r = self.bn_proj(self.proj(x), True, bn_momentum)
        return torch.relu(y + r)


class ImageEncoder(nn.Module):
    """Residual CNN: NHWC image -> (feature map [B,H/4,W/4,C], global [B,512])."""

    def __init__(self, stage_features: Sequence[int] = (32, 64, 128),
                 blocks_per_stage: int = 2, global_features: int = 512,
                 in_channels: int = 3, include_global: bool = True,
                 dtype=None):
        super().__init__()
        self.stage_features = tuple(stage_features)
        self.blocks_per_stage = blocks_per_stage
        self.include_global = include_global
        c = self.stage_features[0]
        self.stem = Conv(in_channels, c, 3, 1, dtype)
        self.stem_bn = BatchNorm(c, dtype=dtype)
        for s, f in enumerate(self.stage_features):
            for b in range(blocks_per_stage):
                stride = 2 if (s > 0 and b == 0) else 1
                self.add_module(f"s{s}b{b}", BasicBlock(c, f, stride, dtype))
                c = f
        if include_global:
            self.fc_glob = Dense(c, global_features, dtype)

    def forward(self, img: torch.Tensor, bn_momentum: float = 0.1):
        x = img.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last strides
        x = torch.relu(self.stem_bn(self.stem(x), True, bn_momentum))
        for s in range(len(self.stage_features)):
            for b in range(self.blocks_per_stage):
                x = getattr(self, f"s{s}b{b}")(x, bn_momentum)
        fmap = x.permute(0, 2, 3, 1)  # stride 4 wrt the input, NHWC
        if not self.include_global:
            return fmap, None
        gap = x.mean(dim=(2, 3))
        return fmap, torch.relu(self.fc_glob(gap))
