"""Optimizer construction (counterpart of ``mm3d_tpu/training/state.py``).

The JAX package keeps the learning rate out of its optax chain and scales
the updates by an lr passed into each step. Here the optimizer is a
``torch.optim`` instance and ``set_lr`` writes the step's lr into its
parameter groups before the step (``state.py:74-79``). The train state is
the model's parameters and BN buffers plus the optimizer's state.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam",
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """'adam' is torch Adam with coupled L2 (``weight_decay`` added to the
    gradient), the same as optax ``add_decayed_weights`` + ``scale_by_adam``;
    'sgd' is SGD with momentum 0.9, no dampening. The decay covers every
    parameter, BN scale and bias included, as optax does; BN running
    statistics are buffers and get none. The lr is set per step."""
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9,
                               dampening=0.0, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
