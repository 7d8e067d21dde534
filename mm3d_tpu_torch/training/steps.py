"""Train, BN-refresh and eval steps (counterpart of
``mm3d_tpu/training/steps.py``) for the ``classification``, ``partseg``,
``semseg``, ``fusion_cls`` and ``fusion_semseg`` tasks.

PyTorch runs eagerly, so a step is a plain function over the model and
optimizer, which it updates in place; it returns device tensors and does
not synchronise. The tasks differ in the inputs and the target:
``classification`` and ``semseg`` take ``batch["points"]`` alone, with the
point-only augmentations; ``partseg`` takes the points and the one-hot of
``batch["cat"]`` in the points' dtype, with the point-only augmentations;
the fusion tasks take the points, the image and the camera (K, R, t), with
the calib-aware augmentations. The target is ``batch["label"]`` [B] for
``classification`` and ``fusion_cls``, ``batch["seg"]`` [B,N] for
``partseg``, ``semseg`` and ``fusion_semseg``, whose metrics count points.
The vote steps (``make_vote_*_step``) ensemble eval forwards over rotated
or reordered copies of a batch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.parallel import data_parallel as dpar
from mm3d_tpu_torch.parallel.point_shard import current as point_shard_ctx
from mm3d_tpu_torch.parallel.mesh import Mesh, batch_slice
from mm3d_tpu_torch.training.state import set_lr
from mm3d_tpu_torch.utils import metrics as M

TASKS = ("classification", "partseg", "semseg", "fusion_cls",
         "fusion_semseg")
# the tasks whose batches carry no camera
_POINT_TASKS = ("classification", "partseg", "semseg")


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; the tasks are {TASKS}")


def _augmented(batch, task: str, names, generator):
    """(points, R) of the batch after the named augmentations; R is None
    for the point-only tasks, which have no camera."""
    points, R = batch["points"], batch.get("R")
    if names:
        if task in _POINT_TASKS:
            points = aug.augment_batch(generator, points, names)
        else:
            points, R = aug.augment_fusion_batch(generator, points, R, names)
    return points, R


def _model_args(batch, task: str, points, R, num_category: int):
    if task in ("classification", "semseg"):
        return (points,)
    if task == "partseg":
        onehot = torch.nn.functional.one_hot(batch["cat"].long(),
                                             num_category)
        return (points, onehot.to(points.dtype))
    return (points, batch["image"], batch["K"], R, batch["t"])


def _target(batch, task: str) -> torch.Tensor:
    return (batch["seg"] if task in ("partseg", "semseg", "fusion_semseg")
            else batch["label"])


def _forward(model: torch.nn.Module, mesh: Optional[Mesh], args,
             gather: bool = True, **kw):
    """``model(*args, **kw)``; with a data-parallel ``mesh``, the model runs
    on this rank's rows of the batch ``args`` (``parallel.data_parallel``)
    and, with ``gather``, its tensor outputs are gathered back into the
    global batch, differentiably."""
    if mesh is None:
        return model(*args, **kw)
    B = args[0].shape[0]
    rows = batch_slice(mesh, B)
    with dpar.data_parallel(mesh, B):
        out, aux = model(*(a[rows] for a in args), **kw)
    if not gather:
        return out, aux
    aux = {k: dpar.gather_rows(v, mesh) if isinstance(v, torch.Tensor)
           else v for k, v in (aux or {}).items()}
    return dpar.gather_rows(out, mesh), aux


def make_train_step(model: torch.nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, task: str,
                    augment_names: Sequence[str] = (),
                    class_weights: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    fps_generator: Optional[torch.Generator] = None,
                    deterministic: Optional[bool] = None,
                    num_category: int = 16,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns step(batch, lr, bn_momentum) -> {loss, accuracy}
    (accuracy per cloud, or per point for ``partseg``, ``semseg`` and
    ``fusion_semseg``).

    One step: augment (draws from ``generator``), forward in train mode,
    ``loss_fn``, backward, optimizer step at ``lr``. The loss and accuracy
    are those of the forward, before the update. ``deterministic`` is
    passed to the model (None: dropout on, as in training). After the step
    each parameter's ``.grad`` holds the gradient it was updated with.

    With a data-parallel ``mesh`` every rank passes the same global batch
    and the step is the single-process step on it: augmented whole, the
    forward on this rank's rows with the global batch's BN statistics and
    draws, the loss on the gathered outputs, the gradients summed over the
    ranks (``parallel.data_parallel``)."""
    _check_task(task)
    names = tuple(augment_names)

    def step(batch, lr: float, bn_momentum: float):
        model.train()
        points, R = _augmented(batch, task, names, generator)
        target = _target(batch, task)
        optimizer.zero_grad(set_to_none=True)
        log_probs, aux = _forward(
            model, mesh, _model_args(batch, task, points, R, num_category),
            bn_momentum=bn_momentum, deterministic=deterministic,
            generator=generator, fps_generator=fps_generator)
        loss = loss_fn(log_probs, target, aux, weight=class_weights)
        loss.backward()
        if mesh is not None:
            dpar.sync_gradients(model.parameters(), mesh)
        set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": loss.detach(),
                "accuracy": M.accuracy(log_probs.detach(), target)}

    return step


def make_bn_refresh_step(model: torch.nn.Module, task: str,
                         augment_names: Sequence[str] = (),
                         generator: Optional[torch.Generator] = None,
                         num_category: int = 16,
                         mesh: Optional[Mesh] = None) -> Callable:
    """Returns step(batch): a forward-only train-mode pass at momentum 0.5
    that moves only the BN running statistics (no gradient, parameters and
    optimizer untouched). The Trainer runs a few before each eval in bf16
    mixed precision, where the running statistics otherwise lag the
    activations (``steps.py:109-147`` of the JAX package). With a
    data-parallel ``mesh``, as the train step: the global batch's
    statistics and draws."""
    _check_task(task)
    names = tuple(augment_names)

    @torch.no_grad()
    def step(batch):
        model.train()
        points, R = _augmented(batch, task, names, generator)
        _forward(model, mesh, _model_args(batch, task, points, R,
                                          num_category),
                 gather=False, bn_momentum=0.5, generator=generator)

    return step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable, task: str,
                   num_classes: int,
                   class_weights: Optional[torch.Tensor] = None,
                   num_category: int = 16,
                   part_start: Optional[torch.Tensor] = None,
                   part_count: Optional[torch.Tensor] = None,
                   max_parts: int = 6,
                   mesh: Optional[Mesh] = None) -> Callable:
    """Returns step(batch, valid=None) -> {loss, correct, count, cm}, or for
    ``partseg`` {loss, correct, count, ious, cats, valid}.

    ``valid`` is an optional [B] bool row mask: full-test-set eval pads the
    final batch with wrap-duplicates, which count nowhere, the loss
    included. For ``partseg``, ``semseg`` and ``fusion_semseg`` every point
    of a valid row counts: ``count`` is valid rows x N. The confusion matrix
    is weighted per row (``steps.py:184-196`` of the JAX package).
    ``partseg`` predicts each point's part among its category's
    (``part_start`` / ``part_count`` [num_category], indexed by the
    batch's ``cat``) and returns each shape's mean part IoU (``ious`` [B]),
    its category and the row mask, which ``utils.metrics
    .partseg_metrics_host`` reduces (``steps.py:207-222``).

    With a data-parallel ``mesh`` every rank passes the same global batch,
    runs the model on its rows and gathers the outputs, so the metrics
    count every rank's valid rows and are the same on every rank. Under a
    point-shard context the ranks split the points instead, each running
    the whole batch."""
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
        rows_mesh = None if point_shard_ctx() is not None else mesh
        log_probs, aux = _forward(model, rows_mesh, _model_args(
            batch, task, points, batch.get("R"), num_category))
        loss = loss_fn(log_probs, target, aux, weight=class_weights,
                       row_mask=vm)
        count = vm.sum() * (target.numel() // max(B, 1))
        if task == "partseg":
            cat = batch["cat"].long()
            ps, pc = part_start[cat], part_count[cat]
            pred = M.masked_part_argmax(log_probs, ps, pc)
            return {"loss": loss,
                    "correct": ((pred == target).to(torch.int32) * wm).sum(),
                    "count": count,
                    "ious": M.shape_ious(pred, target, ps, pc, max_parts),
                    "cats": batch["cat"], "valid": vm}
        pred = torch.argmax(log_probs, -1)
        hit = (pred == target).to(torch.int32) * wm
        return {"loss": loss, "correct": hit.sum(), "count": count,
                "cm": M.confusion_matrix(pred, target, num_classes,
                                         weights=wm)}

    return step


# ------------------------------------------------------------ vote eval
#
# Test-time vote ensembling (``steps.py:235-356`` of the JAX package): the
# eval forward runs num_votes times on transformed copies of the batch and
# the class probabilities are summed; vote 0 is the batch as it is. The JAX
# steps draw each vote's transform from fold_in(key, vote); here the draws
# are arguments, made by ``draw_vote_angles`` / ``draw_vote_perms`` from a
# generator, or given (the tests give JAX's own). Each step runs the model
# in eval mode without gradients, on the kernel path on the card (the bf16
# forwards take the fused SA and FP kernels), and returns int32 predictions
# as JAX's do; ``return_probs=True`` also returns the summed probabilities.


def draw_vote_angles(generator: Optional[torch.Generator], num_votes: int,
                     batch_size: int, device=None) -> torch.Tensor:
    """Rotation angles of votes 1 .. num_votes-1, [num_votes-1, B],
    U(0, 2 pi)."""
    u = torch.rand((num_votes - 1, batch_size), generator=generator,
                   device=device)
    return u * 2.0 * math.pi


def draw_vote_perms(generator: Optional[torch.Generator], num_votes: int,
                    batch_size: int, npoint: int,
                    device=None) -> torch.Tensor:
    """Point orders of votes 1 .. num_votes-1, one permutation a cloud,
    [num_votes-1, B, N] int64."""
    u = torch.rand((num_votes - 1, batch_size, npoint), generator=generator,
                   device=device)
    return torch.argsort(u, dim=-1)


def _check_draws(draws: torch.Tensor, num_votes: int) -> None:
    if draws.shape[0] != num_votes - 1:
        raise ValueError(f"{num_votes} votes take {num_votes - 1} draws "
                         f"(vote 0 is the batch as it is), got "
                         f"{draws.shape[0]}")


def _vote_result(probs: torch.Tensor, pred: torch.Tensor,
                 return_probs: bool):
    pred = pred.to(torch.int32)
    return (pred, probs) if return_probs else pred


def _shuffle_vote_probs(probs_of: Callable, points: torch.Tensor,
                        perms: torch.Tensor) -> torch.Tensor:
    """Per-point probabilities summed over the batch as it is and each
    reordering ``perms`` [V-1, B, N] of its points, every vote's put back
    in the original order (``steps.py:258-274``): a new order starts FPS
    from another point, so the groupings change."""
    probs = probs_of(points)
    C = points.shape[-1]
    for perm in perms:
        shuffled = torch.gather(points, 1, perm[..., None].expand(-1, -1, C))
        p = probs_of(shuffled)
        inv = torch.argsort(perm, dim=1)
        probs = probs + torch.gather(
            p, 1, inv[..., None].expand(-1, -1, p.shape[-1]))
    return probs


def make_vote_eval_step(model: torch.nn.Module,
                        num_votes: int = 3) -> Callable:
    """Classification votes (``steps.py:332-356``). Returns
    step(points, angles[, return_probs]) -> pred [B]: the probabilities of
    the cloud as it is plus those of the cloud turned about Y by each of
    ``angles`` [V-1, B] (normals in channels 3:6 turned with it)."""

    @torch.no_grad()
    def step(points, angles, return_probs: bool = False):
        _check_draws(angles, num_votes)
        model.eval()
        probs = torch.exp(model(points)[0])
        for angle in angles:
            rotated = aug.rotate_point_cloud(points, angle,
                                             rotate_normals=True)
            probs = probs + torch.exp(model(rotated)[0])
        return _vote_result(probs, torch.argmax(probs, -1), return_probs)

    return step


def make_vote_partseg_step(model: torch.nn.Module, num_votes: int,
                           num_category: int, part_start: torch.Tensor,
                           part_count: torch.Tensor) -> Callable:
    """Part-segmentation votes (``steps.py:235-255``). Returns
    step(points, cat, perms[, return_probs]) -> pred [B, N]: per-point
    probabilities summed over the shuffle votes of ``perms`` [V-1, B, N],
    then the argmax among the parts of each shape's category
    (``part_start`` / ``part_count`` [num_category])."""

    @torch.no_grad()
    def step(points, cat, perms, return_probs: bool = False):
        _check_draws(perms, num_votes)
        model.eval()
        cat = cat.long()
        onehot = torch.nn.functional.one_hot(cat, num_category).to(
            points.dtype)
        probs = _shuffle_vote_probs(
            lambda pts: torch.exp(model(pts, onehot)[0]), points, perms)
        pred = M.masked_part_argmax(torch.log(probs + 1e-12),
                                    part_start[cat], part_count[cat])
        return _vote_result(probs, pred, return_probs)

    return step


def make_vote_fusion_cls_step(model: torch.nn.Module,
                              num_votes: int = 3) -> Callable:
    """Multimodal classification votes (``steps.py:277-308``). Returns
    step(points, image, K, R, t, angles[, return_probs]) -> pred [B]: each
    vote turns the cloud (normals too) about Y by rot and gives the model
    the extrinsics R' = R rot^T, so the camera-frame points, the projection
    and the image features do not move; only the point trunk sees another
    pose."""

    @torch.no_grad()
    def step(points, image, K, R, t, angles, return_probs: bool = False):
        _check_draws(angles, num_votes)
        model.eval()
        probs = torch.exp(model(points, image, K, R, t)[0])
        for angle in angles:
            rot = aug._rot_y(angle)
            pts = aug._apply_rot(points, rot, True)
            # R'[i,k] = sum_j R[i,j] rot[k,j]
            Rv = aug._rotate(R, rot)
            probs = probs + torch.exp(model(pts, image, K, Rv, t)[0])
        return _vote_result(probs, torch.argmax(probs, -1), return_probs)

    return step


def make_vote_fusion_semseg_step(model: torch.nn.Module,
                                 num_votes: int = 3) -> Callable:
    """Multimodal per-point votes (``steps.py:311-329``). Returns
    step(points, image, K, R, t, perms[, return_probs]) -> pred [B, N]:
    shuffle votes as part segmentation's; the image branch and the
    per-point projection do not depend on the order, so the camera stays."""

    @torch.no_grad()
    def step(points, image, K, R, t, perms, return_probs: bool = False):
        _check_draws(perms, num_votes)
        model.eval()
        probs = _shuffle_vote_probs(
            lambda pts: torch.exp(model(pts, image, K, R, t)[0]), points,
            perms)
        return _vote_result(probs, torch.argmax(probs, -1), return_probs)

    return step
