"""Point-cloud augmentation on the device (counterpart of
``mm3d_tpu/data/augment.py``, the ``classification``, ``partseg``,
``fusion_cls`` and ``fusion_semseg`` pipelines).

Each op is split in two: a *draw* (generator -> the op's random tensors, on
the batch's device) and an *apply* (batch + those tensors -> the augmented
batch, no randomness). The JAX package draws with ``jax.random`` keys; the
port draws with an explicit ``torch.Generator``. The two give different
numbers from the same seed, so the tests feed the JAX op's own draws to the
apply functions and require equal results.

Semantics as in the JAX package (the provider.py op set); a batch is
``[B, N, C]`` with xyz in channels 0:3:

* ``random_point_dropout`` -- per cloud, ratio U(0, max); dropped points are
  replaced by the first point (the shape stays);
* ``random_scale_point_cloud`` -- per-cloud scale U(0.8, 1.25) on xyz;
* ``shift_point_cloud`` -- per-cloud translation U(-0.1, 0.1) on xyz;
* ``rotate_point_cloud_z`` -- per-cloud rotation about Z by U(0, 2 pi), xyz
  only (the semseg convention);
* ``rotate_point_cloud_z_with_calib`` -- the same rotation, and the camera
  extrinsics rewritten R' = R rot^T, so R' (rot x) = R x and the
  point -> pixel projection does not move (``augment.py:159-170``).

The rotations are written as elementwise products summed left to right, not
matmuls: the JAX package pins them to full f32 precision
(``augment.py:68-71,169``), and a TF32 product would move the points.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def _with_xyz(batch: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    return torch.cat([xyz, batch[..., 3:]], dim=-1)


# ------------------------------------------------------------ draws


def draw_random_point_dropout(generator, batch: torch.Tensor,
                              max_dropout_ratio: float = 0.875
                              ) -> torch.Tensor:
    """The drop mask [B,N] bool: U(0,1) <= ratio, ratio = U(0,1) * max."""
    B, N = batch.shape[:2]
    ratio = torch.rand((B, 1), generator=generator,
                       device=batch.device) * max_dropout_ratio
    return torch.rand((B, N), generator=generator, device=batch.device) <= ratio


def draw_random_scale(generator, batch: torch.Tensor, scale_low: float = 0.8,
                      scale_high: float = 1.25) -> torch.Tensor:
    """Per-cloud scales [B,1,1]."""
    return _uniform(generator, (batch.shape[0], 1, 1), scale_low, scale_high,
                    batch.device)


def draw_shift(generator, batch: torch.Tensor,
               shift_range: float = 0.1) -> torch.Tensor:
    """Per-cloud shifts [B,1,3]."""
    return _uniform(generator, (batch.shape[0], 1, 3), -shift_range,
                    shift_range, batch.device)


def draw_rotation(generator, batch: torch.Tensor) -> torch.Tensor:
    """Per-cloud angles [B], U(0, 2 pi)."""
    u = torch.rand((batch.shape[0],), generator=generator,
                   device=batch.device)
    return u * 2.0 * math.pi


# ------------------------------------------------------------ applies


def random_point_dropout(batch: torch.Tensor,
                         drop: torch.Tensor) -> torch.Tensor:
    """Replace the points where ``drop`` [B,N] is set by the first point."""
    return torch.where(drop[..., None], batch[:, :1, :], batch)


def random_scale_point_cloud(batch: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    return _with_xyz(batch, batch[..., :3] * scale)


def shift_point_cloud(batch: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    return _with_xyz(batch, batch[..., :3] + shift)


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    """Rotations about Z, [B] -> [B,3,3] (``augment.py:48-54``)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _rotate(xyz: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """xyz [B,N,3] -> [B,N,3], out[d] = (x rot[d,0] + y rot[d,1])
    + z rot[d,2] (the einsum "bnc,bdc->bnd" of ``_apply_rot``)."""
    r = rot[:, None]  # [B,1,3,3]
    return torch.stack([xyz[..., 0] * r[..., d, 0] + xyz[..., 1] * r[..., d, 1]
                        + xyz[..., 2] * r[..., d, 2] for d in range(3)], -1)


def rotate_point_cloud_z(batch: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Rotate xyz (channels 0:3) of each cloud about Z by ``angle`` [B]."""
    return _with_xyz(batch, _rotate(batch[..., :3], _rot_z(angle)))


def rotate_point_cloud_z_with_calib(batch: torch.Tensor, R: torch.Tensor,
                                    angle: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rotate_point_cloud_z`` and R' = R rot^T (R [B,3,3]): the camera
    frame coordinates R' (rot x) = R x do not move."""
    rot = _rot_z(angle)
    # R'[i,k] = sum_j R[i,j] rot[k,j]: each row of R rotated like a point
    return rotate_point_cloud_z(batch, angle), _rotate(R, rot)


# --------------------------------------------------------------- pipelines

_CLS_TRAIN = ("random_point_dropout", "random_scale_point_cloud",
              "shift_point_cloud")
# part segmentation (``augment.py:177``): no point dropout
_PARTSEG_TRAIN = ("random_scale_point_cloud", "shift_point_cloud")
# indoor semantic segmentation (``augment.py:178``): a rotation about Z
_SEMSEG_TRAIN = ("rotate_point_cloud_z",)

# name -> (draw, apply)
_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    "random_point_dropout": (draw_random_point_dropout, random_point_dropout),
    "random_scale_point_cloud": (draw_random_scale,
                                 random_scale_point_cloud),
    "shift_point_cloud": (draw_shift, shift_point_cloud),
    "rotate_point_cloud_z": (draw_rotation, rotate_point_cloud_z),
}

# augmentations that also rewrite the camera extrinsics:
# name -> (draw, apply(batch, R, draws) -> (batch, R))
_CALIB_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    "rotate_point_cloud_z_with_calib": (draw_rotation,
                                        rotate_point_cloud_z_with_calib),
}

TASK_PIPELINES = {
    "classification": _CLS_TRAIN,
    "partseg": _PARTSEG_TRAIN,
    # late fusion: the image branch never sees point coordinates, so the
    # point-only cls pipeline is safe as it is
    "fusion_cls": _CLS_TRAIN,
    "semseg": _SEMSEG_TRAIN,
    # projective fusion: the semseg rotation must compensate the extrinsics
    "fusion_semseg": ("rotate_point_cloud_z_with_calib",),
}


def _apply(generator, batch: torch.Tensor, name: str) -> torch.Tensor:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"augmentation {name!r} is not ported yet; the port has "
            f"{sorted(_REGISTRY) + sorted(_CALIB_REGISTRY)}")
    draw, apply = _REGISTRY[name]
    return apply(batch, draw(generator, batch))


def augment_batch(generator: torch.Generator, batch: torch.Tensor,
                  names: Sequence[str]) -> torch.Tensor:
    """Apply a named augmentation sequence to point clouds without a camera
    (``augment.py:209-215``); a calib-aware name raises."""
    for name in names:
        if name in _CALIB_REGISTRY:
            raise ValueError(f"{name} needs calib: use augment_fusion_batch")
        batch = _apply(generator, batch, name)
    return batch


def augment_fusion_batch(generator: torch.Generator, batch: torch.Tensor,
                         R: torch.Tensor, names: Sequence[str]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a named augmentation sequence; returns (points, R). The
    calib-aware entries also rewrite R; the others pass it through."""
    for name in names:
        if name in _CALIB_REGISTRY:
            draw, apply = _CALIB_REGISTRY[name]
            batch, R = apply(batch, R, draw(generator, batch))
            continue
        batch = _apply(generator, batch, name)
    return batch, R
