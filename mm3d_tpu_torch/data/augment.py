"""Point-cloud augmentation on the device (counterpart of
``mm3d_tpu/data/augment.py``, the ``fusion_cls`` pipeline).

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
* ``shift_point_cloud`` -- per-cloud translation U(-0.1, 0.1) on xyz.
"""

from __future__ import annotations

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


# --------------------------------------------------------------- pipelines

_CLS_TRAIN = ("random_point_dropout", "random_scale_point_cloud",
              "shift_point_cloud")

# name -> (draw, apply)
_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    "random_point_dropout": (draw_random_point_dropout, random_point_dropout),
    "random_scale_point_cloud": (draw_random_scale,
                                 random_scale_point_cloud),
    "shift_point_cloud": (draw_shift, shift_point_cloud),
}

# late fusion: the image branch never sees point coordinates, so the
# point-only cls pipeline is safe as it is
TASK_PIPELINES = {"fusion_cls": _CLS_TRAIN}


def augment_fusion_batch(generator: torch.Generator, batch: torch.Tensor,
                         R: torch.Tensor, names: Sequence[str]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a named augmentation sequence; returns (points, R).

    The extrinsics R pass through: no op of this slice moves the camera
    (the calib-aware rotation of fusion_semseg comes with that slice)."""
    for name in names:
        if name not in _REGISTRY:
            raise NotImplementedError(
                f"augmentation {name!r} is not ported yet; this slice has "
                f"{sorted(_REGISTRY)}")
        draw, apply = _REGISTRY[name]
        batch = apply(batch, draw(generator, batch))
    return batch, R
