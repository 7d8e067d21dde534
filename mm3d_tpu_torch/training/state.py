"""Optimizer construction (counterpart of ``mm3d_tpu/training/state.py``).

The JAX package keeps the learning rate out of its optax chain and scales
the updates by an lr passed into each step. Here the optimizer is a
``torch.optim`` instance and ``set_lr`` writes the step's lr into its
parameter groups before the step (``state.py:74-79``). The train state is
the model's parameters and BN buffers, the optimizer's state, the step and
the generators' states (``make_train_state``), what a checkpoint holds.
"""

from __future__ import annotations

from typing import Iterable, Optional

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


# ------------------------------------------------------------ train state


def generator_state(generator: torch.Generator) -> dict:
    """A generator's state and its device type."""
    return {"device": generator.device.type, "state": generator.get_state()}


def set_generator_state(generator: torch.Generator, saved: dict) -> None:
    """Restore ``generator_state``'s result. A state restores only into a
    generator of the device type it came from: a CPU generator's state and
    a CUDA generator's are different things."""
    if saved["device"] != generator.device.type:
        raise ValueError(
            f"a {saved['device']} generator's state cannot be restored into "
            f"a {generator.device.type} generator")
    generator.set_state(saved["state"].cpu())


def make_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     step: int, generator: torch.Generator,
                     fps_generator: Optional[torch.Generator] = None) -> dict:
    """What a checkpoint holds, the counterpart of the JAX ``TrainState``:
    the model's ``state_dict`` (f32 master parameters and BN buffers), the
    optimizer's, the global step and the states of the run's generators
    (augmentation and dropout draws; the FPS starts or None). The JAX
    package folds a fresh key per epoch, while the port's generator runs on
    across epochs, so a resumed run draws what an uninterrupted one would
    only with the generators' states restored."""
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "step": int(step), "generator": generator_state(generator),
            "fps_generator": (None if fps_generator is None
                              else generator_state(fps_generator))}


def load_train_state(state: dict, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     generator: torch.Generator,
                     fps_generator: Optional[torch.Generator] = None) -> int:
    """Restore ``make_train_state``'s result in place and return its step.
    The model's and the optimizer's tensors are copied onto the devices of
    the model's; the generators' states must come from generators of the
    same device types."""
    if (state["fps_generator"] is None) != (fps_generator is None):
        raise ValueError("the checkpoint and the run disagree on "
                         "fps_random_start (an FPS generator's state)")
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    set_generator_state(generator, state["generator"])
    if fps_generator is not None:
        set_generator_state(fps_generator, state["fps_generator"])
    return int(state["step"])
