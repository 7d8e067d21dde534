"""Train, BN-refresh and eval steps (counterpart of
``mm3d_tpu/training/steps.py``) for the ``fusion_cls`` and ``fusion_semseg``
tasks.

PyTorch runs eagerly, so a step is a plain function over the model and
optimizer, which it updates in place; it returns device tensors and does
not synchronise. The two tasks differ in the target: ``batch["label"]`` [B]
for ``fusion_cls``, ``batch["seg"]`` [B,N] for ``fusion_semseg``, whose
metrics count points. The other tasks of the JAX package (classification,
partseg, semseg) come with the slices that port their models.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.training.state import set_lr
from mm3d_tpu_torch.utils import metrics as M

TASKS = ("fusion_cls", "fusion_semseg")
_LATER = {"classification": "the PointNet++ classification slice",
          "partseg": "the FP-block slice",
          "semseg": "the FP-block slice"}


def _check_task(task: str) -> None:
    if task not in TASKS:
        where = _LATER.get(task)
        raise NotImplementedError(
            f"task {task!r} is not ported yet" +
            (f"; it comes with {where}" if where else ""))


def _model_args(batch, points, R):
    return (points, batch["image"], batch["K"], R, batch["t"])


def _target(batch, task: str) -> torch.Tensor:
    return batch["label"] if task == "fusion_cls" else batch["seg"]


def make_train_step(model: torch.nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, task: str,
                    augment_names: Sequence[str] = (),
                    class_weights: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    fps_generator: Optional[torch.Generator] = None,
                    deterministic: Optional[bool] = None) -> Callable:
    """Returns step(batch, lr, bn_momentum) -> {loss, accuracy}
    (accuracy per cloud, or per point for ``fusion_semseg``).

    One step: augment (draws from ``generator``), forward in train mode,
    ``loss_fn``, backward, optimizer step at ``lr``. The loss and accuracy
    are those of the forward, before the update. ``deterministic`` is
    passed to the model (None: dropout on, as in training). After the step
    each parameter's ``.grad`` holds the gradient it was updated with."""
    _check_task(task)
    names = tuple(augment_names)

    def step(batch, lr: float, bn_momentum: float):
        model.train()
        points, R = batch["points"], batch["R"]
        if names:
            points, R = aug.augment_fusion_batch(generator, points, R, names)
        target = _target(batch, task)
        optimizer.zero_grad(set_to_none=True)
        log_probs, aux = model(*_model_args(batch, points, R),
                               bn_momentum=bn_momentum,
                               deterministic=deterministic,
                               generator=generator,
                               fps_generator=fps_generator)
        loss = loss_fn(log_probs, target, aux, weight=class_weights)
        loss.backward()
        set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": loss.detach(),
                "accuracy": M.accuracy(log_probs.detach(), target)}

    return step


def make_bn_refresh_step(model: torch.nn.Module, task: str,
                         augment_names: Sequence[str] = (),
                         generator: Optional[torch.Generator] = None
                         ) -> Callable:
    """Returns step(batch): a forward-only train-mode pass at momentum 0.5
    that moves only the BN running statistics (no gradient, parameters and
    optimizer untouched). The Trainer runs a few before each eval in bf16
    mixed precision, where the running statistics otherwise lag the
    activations (``steps.py:109-147`` of the JAX package)."""
    _check_task(task)
    names = tuple(augment_names)

    @torch.no_grad()
    def step(batch):
        model.train()
        points, R = batch["points"], batch["R"]
        if names:
            points, R = aug.augment_fusion_batch(generator, points, R, names)
        model(*_model_args(batch, points, R), bn_momentum=0.5,
              generator=generator)

    return step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable, task: str,
                   num_classes: int,
                   class_weights: Optional[torch.Tensor] = None) -> Callable:
    """Returns step(batch, valid=None) -> {loss, correct, count, cm}.

    ``valid`` is an optional [B] bool row mask: full-test-set eval pads the
    final batch with wrap-duplicates, which count nowhere, the loss
    included. For ``fusion_semseg`` every point of a valid row counts:
    ``count`` is valid rows x N and the confusion matrix is weighted per
    row (``steps.py:184-196`` of the JAX package)."""
    _check_task(task)

    @torch.no_grad()
    def step(batch, valid: Optional[torch.Tensor] = None):
        model.eval()
        points = batch["points"]
        target = _target(batch, task)
        B = points.shape[0]
        vm = (torch.ones(B, dtype=torch.int32, device=points.device)
              if valid is None else valid.to(torch.int32))
        wm = vm.reshape((B,) + (1,) * (target.dim() - 1))
        log_probs, aux = model(*_model_args(batch, points, batch["R"]))
        pred = torch.argmax(log_probs, -1)
        hit = (pred == target).to(torch.int32) * wm
        return {"loss": loss_fn(log_probs, target, aux, weight=class_weights,
                                row_mask=vm),
                "correct": hit.sum(),
                "count": vm.sum() * (target.numel() // max(B, 1)),
                "cm": M.confusion_matrix(pred, target, num_classes,
                                         weights=wm)}

    return step
