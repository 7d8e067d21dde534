"""Point-cloud augmentation on the device (counterpart of
``mm3d_tpu/data/augment.py``: every op of its registry, ``pc_normalize``,
the calib-aware rotation, the task pipelines and the numpy twins
``host_np``).

Each op is split in two: a *draw* (generator -> the op's random tensors, on
the batch's device) and an *apply* (batch + those tensors -> the augmented
batch, no randomness). The JAX package draws with ``jax.random`` keys; the
port draws with an explicit ``torch.Generator``. The two give different
numbers from the same seed, so the tests feed the JAX op's own draws to the
apply functions and require equal results.

Semantics as in the JAX package (the provider.py op set); a batch is
``[B, N, C]`` with xyz in channels 0:3 and, where a model takes them,
normals in 3:6:

* ``rotate_point_cloud`` -- per-cloud rotation about Y by U(0, 2 pi), xyz
  only (``rotate_normals=True`` turns channels 3:6 with the same matrix,
  as the vote steps do);
* ``rotate_perturbation_point_cloud`` -- R = Rz Ry Rx with angles
  clip(0.06 N(0,1), +-0.18), per cloud;
* ``jitter_point_cloud`` -- clipped gaussian noise clip(0.01 N(0,1),
  +-0.05) on each xyz coordinate;
* ``shuffle_points`` -- ONE permutation of the point axis for the whole
  batch, the lineage's provider.shuffle_points;
* ``pc_normalize`` -- centre each cloud's xyz on its centroid and scale it
  into the unit sphere (no draw; the JAX registry has no entry for it, the
  port's takes it by name too);
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

import numpy as np
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


def draw_rotate_perturbation(generator, batch: torch.Tensor,
                             angle_sigma: float = 0.06,
                             angle_clip: float = 0.18) -> torch.Tensor:
    """Per-cloud Euler angles [B,3] (x, y, z), clip(sigma N(0,1), +-clip)."""
    n = torch.randn((batch.shape[0], 3), generator=generator,
                    device=batch.device)
    return torch.clamp(angle_sigma * n, -angle_clip, angle_clip)


def draw_jitter(generator, batch: torch.Tensor, sigma: float = 0.01,
                clip: float = 0.05) -> torch.Tensor:
    """Per-point noise [B,N,3], clip(sigma N(0,1), +-clip)."""
    n = torch.randn(batch.shape[:-1] + (3,), generator=generator,
                    device=batch.device)
    return torch.clamp(sigma * n, -clip, clip)


def draw_shuffle(generator, batch: torch.Tensor) -> torch.Tensor:
    """One permutation [N] of the point axis, shared by the batch."""
    return torch.randperm(batch.shape[1], generator=generator,
                          device=batch.device)


def _no_draw(generator, batch: torch.Tensor) -> None:
    return None


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


def _rot_matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot_x(angle: torch.Tensor) -> torch.Tensor:
    """Rotations about X, [B] -> [B,3,3] (``augment.py:57-63``)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rot_matrix([[o, z, z], [z, c, -s], [z, s, c]])


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotations about Y, [B] -> [B,3,3] (``augment.py:39-45``)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rot_matrix([[c, z, s], [z, o, z], [-s, z, c]])


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    """Rotations about Z, [B] -> [B,3,3] (``augment.py:48-54``)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rot_matrix([[c, -s, z], [s, c, z], [z, z, o]])


def _rotate(xyz: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """xyz [B,N,3] -> [B,N,3], out[d] = (x rot[d,0] + y rot[d,1])
    + z rot[d,2] (the einsum "bnc,bdc->bnd" of ``_apply_rot``)."""
    r = rot[:, None]  # [B,1,3,3]
    return torch.stack([xyz[..., 0] * r[..., d, 0] + xyz[..., 1] * r[..., d, 1]
                        + xyz[..., 2] * r[..., d, 2] for d in range(3)], -1)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for [B,3,3] as ordered elementwise products, no TF32: row n
    of _rotate(b^T, a) is a times column n of b."""
    return _rotate(b.transpose(-1, -2), a).transpose(-1, -2)


def _apply_rot(batch: torch.Tensor, rot: torch.Tensor,
               rotate_normals: bool) -> torch.Tensor:
    """Rotate xyz by ``rot`` [B,3,3] and, with ``rotate_normals`` and at
    least 6 channels, the normals in 3:6 too (``augment.py:66-78``)."""
    parts = [_rotate(batch[..., :3], rot)]
    if rotate_normals and batch.shape[-1] >= 6:
        parts += [_rotate(batch[..., 3:6], rot), batch[..., 6:]]
    else:
        parts += [batch[..., 3:]]
    return torch.cat(parts, dim=-1)


def rotate_point_cloud(batch: torch.Tensor, angle: torch.Tensor,
                       rotate_normals: bool = False) -> torch.Tensor:
    """Rotate each cloud about Y by ``angle`` [B]."""
    return _apply_rot(batch, _rot_y(angle), rotate_normals)


def rotate_point_cloud_z(batch: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Rotate xyz (channels 0:3) of each cloud about Z by ``angle`` [B]."""
    return _with_xyz(batch, _rotate(batch[..., :3], _rot_z(angle)))


def rotate_perturbation_point_cloud(batch: torch.Tensor,
                                    angles: torch.Tensor,
                                    rotate_normals: bool = False
                                    ) -> torch.Tensor:
    """Rotate each cloud by Rz Ry Rx of its Euler ``angles`` [B,3]."""
    rot = _matmul3(_matmul3(_rot_z(angles[:, 2]), _rot_y(angles[:, 1])),
                   _rot_x(angles[:, 0]))
    return _apply_rot(batch, rot, rotate_normals)


def jitter_point_cloud(batch: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    return _with_xyz(batch, batch[..., :3] + noise)


def shuffle_points(batch: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder the points of every cloud by the one permutation ``perm``."""
    return batch[:, perm, :]


def pc_normalize(batch: torch.Tensor) -> torch.Tensor:
    """Centre each cloud's xyz on its centroid and divide by the largest
    distance from it (``augment.py:147-154``)."""
    xyz = batch[..., :3]
    xyz = xyz - xyz.mean(dim=-2, keepdim=True)
    m = torch.linalg.norm(xyz, dim=-1, keepdim=True).amax(dim=-2,
                                                          keepdim=True)
    return _with_xyz(batch, xyz / m)


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
    "rotate_point_cloud": (draw_rotation, rotate_point_cloud),
    "rotate_perturbation_point_cloud": (draw_rotate_perturbation,
                                        rotate_perturbation_point_cloud),
    "jitter_point_cloud": (draw_jitter, jitter_point_cloud),
    "shuffle_points": (draw_shuffle, shuffle_points),
    "pc_normalize": (_no_draw, lambda batch, _: pc_normalize(batch)),
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
        raise KeyError(f"unknown augmentation {name!r}; the registry has "
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


# --------------------------------------------------------- numpy (host) twin


class host_np:
    """Numpy twins of the augmentations (``augment.py:232-296`` of the JAX
    package, the same code): same math, numpy RNG (``rng`` a
    ``np.random.RandomState``, default the global one), for host-side
    pipelines. Their draws are numpy's, not a generator's."""

    @staticmethod
    def pc_normalize(pc: np.ndarray) -> np.ndarray:
        centroid = np.mean(pc[..., :3], axis=-2, keepdims=True)
        xyz = pc[..., :3] - centroid
        m = np.max(np.linalg.norm(xyz, axis=-1, keepdims=True), axis=-2,
                   keepdims=True)
        return np.concatenate([xyz / m, pc[..., 3:]], axis=-1)

    @staticmethod
    def rotate_point_cloud(batch, rng=None):
        rng = rng or np.random
        out = batch.copy()
        for k in range(batch.shape[0]):
            a = rng.uniform() * 2 * np.pi
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            out[k, :, :3] = batch[k, :, :3] @ rot
        return out

    @staticmethod
    def jitter_point_cloud(batch, sigma=0.01, clip=0.05, rng=None):
        rng = rng or np.random
        noise = np.clip(sigma * rng.randn(*batch[..., :3].shape), -clip, clip)
        out = batch.copy()
        out[..., :3] += noise.astype(batch.dtype)
        return out

    @staticmethod
    def shift_point_cloud(batch, shift_range=0.1, rng=None):
        rng = rng or np.random
        shifts = rng.uniform(-shift_range, shift_range,
                             (batch.shape[0], 3)).astype(batch.dtype)
        out = batch.copy()
        out[..., :3] += shifts[:, None, :]
        return out

    @staticmethod
    def random_scale_point_cloud(batch, scale_low=0.8, scale_high=1.25,
                                 rng=None):
        rng = rng or np.random
        scales = rng.uniform(scale_low, scale_high,
                             batch.shape[0]).astype(batch.dtype)
        out = batch.copy()
        out[..., :3] *= scales[:, None, None]
        return out

    @staticmethod
    def random_point_dropout(batch, max_dropout_ratio=0.875, rng=None):
        rng = rng or np.random
        out = batch.copy()
        for b in range(batch.shape[0]):
            ratio = rng.uniform() * max_dropout_ratio
            drop = np.where(rng.uniform(size=batch.shape[1]) <= ratio)[0]
            if len(drop) > 0:
                out[b, drop, :] = out[b, 0, :]
        return out
