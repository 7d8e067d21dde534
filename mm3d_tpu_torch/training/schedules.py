"""Epoch-level schedules of the lineage's training recipes.

Counterpart of ``mm3d_tpu/training/schedules.py``: StepLR (lr *
gamma^(epoch // step_size), clamped) and the BN-momentum anneal (momentum =
m0 * 0.5^(epoch // step), floored). Plain floats computed on the host per
epoch.
"""

from __future__ import annotations


def step_lr(base_lr: float, epoch: int, step_size: int = 20,
            gamma: float = 0.7, min_lr: float = 1e-5) -> float:
    return max(base_lr * (gamma ** (epoch // step_size)), min_lr)


def bn_momentum_schedule(epoch: int, initial: float = 0.1,
                         step_size: int = 20, gamma: float = 0.5,
                         floor: float = 0.01) -> float:
    return max(initial * (gamma ** (epoch // step_size)), floor)
