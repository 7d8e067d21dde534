"""Point -> pixel projection and bilinear feature sampling (counterpart of
``mm3d_tpu/ops/projection.py``).

Each point projects through its cloud's camera (K [R|t]) into the image and
picks up the CNN's feature map by bilinear sampling. ``bilinear_sample`` is
the wrapper of the hand-written kernel ``csrc/bilinear.cu`` and
``bilinear_sample_torch`` its plain twin (both live in ``cuda_kernels``).
Semantics: zero outside the image, pixel-centre convention u in [0, W-1].
"""

from __future__ import annotations

from typing import Tuple

import torch

from mm3d_tpu_torch.ops.cuda_kernels import (bilinear_sample,
                                             bilinear_sample_torch)

__all__ = ["project_points", "bilinear_sample", "bilinear_sample_torch",
           "sample_image_features"]


def project_points(xyz: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                   t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> (uv [B,N,2] pixel coordinates, depth [B,N]).

    xyz [B,N,3], K [B,3,3] intrinsics, R [B,3,3] world->camera rotation,
    t [B,3]. The rotation is written as elementwise products summed left to
    right, not a matmul: the JAX package pins it to full f32 precision, and
    a TF32 product would move uv."""
    Rb = R[:, None]  # [B,1,3,3]
    cam = [xyz[..., 0] * Rb[..., i, 0] + xyz[..., 1] * Rb[..., i, 1]
           + xyz[..., 2] * Rb[..., i, 2] + t[:, None, i] for i in range(3)]
    z = cam[2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = K[:, None, 0, 0] * cam[0] / safe_z + K[:, None, 0, 2]
    v = K[:, None, 1, 1] * cam[1] / safe_z + K[:, None, 1, 2]
    return torch.stack([u, v], dim=-1), z


def sample_image_features(feat: torch.Tensor, xyz: torch.Tensor,
                          K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                          image_hw: Tuple[int, int], stride: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project points and sample per-point pixel features.

    ``feat`` [B,Hf,Wf,C] may be downsampled by ``stride`` from the image the
    intrinsics describe; map coordinates are uv / stride (not the
    align-corners rescale), as in the JAX package, whose trained weights
    assume it. Returns (pixel features [B,N,C] zeroed where not valid,
    valid [B,N] bool: in front of the camera and inside the frame)."""
    uv, depth = project_points(xyz, K, R, t)
    H, W = image_hw
    valid = ((depth > 0) & (uv[..., 0] >= 0) & (uv[..., 0] <= W - 1)
             & (uv[..., 1] >= 0) & (uv[..., 1] <= H - 1))
    sampled = bilinear_sample(feat, uv / float(stride))
    return sampled * valid[..., None].to(feat.dtype), valid
