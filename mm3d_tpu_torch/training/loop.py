"""Trainer: epoch loop and evaluation (counterpart of
``mm3d_tpu/training/loop.py``) for the ``fusion_cls`` and ``fusion_semseg``
tasks (``TrainConfig(model="fusion_cls" | "fusion_sem_seg", ...)``).

The steps run on the Trainer's device (``cuda`` unless the caller passes
``device="cpu"``); the loop schedules the lr and BN momentum per epoch,
feeds prefetched batches and reduces the eval metrics. bf16 mixed precision
(``dtype="bfloat16"``) computes in bf16 with f32 master weights and f32 BN
statistics; it evaluates in f32 on the same parameters unless
``eval_dtype="bfloat16"``, and re-estimates the BN statistics with 8
forward passes before each eval (``loop.py:183-230,345-357``).

Not ported yet: checkpointing and resume, the run-directory logger and the
data-parallel mesh (``TrainConfig`` has no fields for them, so asking for
them raises).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.data.pipeline import DataPipeline
from mm3d_tpu_torch.models import get_model, init_params
from mm3d_tpu_torch.training import schedules, steps
from mm3d_tpu_torch.training.state import make_optimizer
from mm3d_tpu_torch.utils import metrics as M

# per-task headline metric: the best-of-run value ``fit`` reports
# (``loop.py:34-38`` of the JAX package)
BEST_METRIC = {"fusion_cls": "instance_acc", "fusion_semseg": "miou"}


@dataclasses.dataclass
class TrainConfig:
    model: str = "fusion_cls"
    epochs: int = 10
    batch_size: int = 24
    npoint: int = 1024
    learning_rate: float = 1e-3
    optimizer: str = "adam"
    weight_decay: float = 1e-4
    lr_step: int = 20
    lr_gamma: float = 0.7
    min_lr: float = 1e-5
    bn_init_momentum: float = 0.1
    normal_channel: bool = False
    num_class: int = 40
    # fusion_semseg's classes (S3DIS: 13)
    seg_classes: int = 13
    seed: int = 0
    train_size: int = 512
    test_size: int = 128
    log_every: int = 10
    eval_every: int = 1
    augmentations: Optional[Sequence[str]] = None
    class_weights: Optional[Sequence[float]] = None
    image_hw: tuple = (64, 64)
    fusion: str = "concat"
    # "bfloat16": bf16 compute, f32 master weights and BN statistics
    dtype: str = "float32"
    # BN re-estimation passes before each eval; None -> 8 in bf16, 0 in fp32
    bn_refresh_steps: Optional[int] = None
    eval_dtype: str = "float32"
    # random FPS start in training (the lineage's randint seed per call)
    fps_random_start: bool = False
    device: str = "cuda"


_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_datasets(cfg: TrainConfig, task: str = "fusion_cls"):
    """The task's synthetic datasets, shaped like the real ones: same class
    definitions (seed), disjoint instance streams for train and test.
    ``fusion_cls``: ModelNet-style clouds; ``fusion_semseg``: S3DIS-style
    blocks of ``cfg.npoint`` 9-dim points with per-point labels; each with
    its rendered view and camera."""

    def base(size, split):
        if task == "fusion_semseg":
            return syn.SyntheticIndoorScene(npoints=cfg.npoint, size=size,
                                            seed=cfg.seed, split=split)
        if task == "fusion_cls":
            return syn.SyntheticModelNet(
                num_classes=cfg.num_class, npoints=cfg.npoint,
                normals=cfg.normal_channel, size=size, seed=cfg.seed,
                split=split)
        raise ValueError(f"no synthetic datasets for task {task!r}")

    def mk(size, split):
        return syn.SyntheticMultimodal(base=base(size, split),
                                       hw=cfg.image_hw, seed=cfg.seed)

    return mk(cfg.train_size, "train"), mk(cfg.test_size, "test")


class Trainer:
    def __init__(self, cfg: TrainConfig, train_ds=None, test_ds=None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer: device {cfg.device!r} requested but CUDA is not "
                "available; pass device='cpu' to train on the CPU")
        for name, dt in (("dtype", cfg.dtype), ("eval_dtype", cfg.eval_dtype)):
            if dt not in _DTYPES:
                raise ValueError(f"{name} must be one of {sorted(_DTYPES)}")
        self.spec = get_model(cfg.model)
        self.task = self.spec.task
        if self.task not in steps.TASKS:
            raise NotImplementedError(
                f"Trainer: task {self.task!r} is not ported yet")
        if train_ds is None or test_ds is None:
            syn_tr, syn_te = build_datasets(cfg, self.task)
            train_ds = train_ds if train_ds is not None else syn_tr
            test_ds = test_ds if test_ds is not None else syn_te
        self.train_pipe = DataPipeline(train_ds, cfg.batch_size, shuffle=True,
                                       seed=cfg.seed, to_device=self.device)
        # pad_remainder: eval covers the FULL test set; padded rows carry
        # valid=False into the eval step
        self.test_pipe = DataPipeline(test_ds, cfg.batch_size, shuffle=False,
                                      to_device=self.device,
                                      pad_remainder=True)
        if self.task == "fusion_semseg":
            self.num_classes = cfg.seg_classes
            kwargs = {"num_class": cfg.seg_classes, "fusion": cfg.fusion}
        else:
            self.num_classes = cfg.num_class
            kwargs = {"num_class": cfg.num_class,
                      "normal_channel": cfg.normal_channel,
                      "fusion": cfg.fusion}
        self.model = init_params(
            self.spec.builder(dtype=_DTYPES[cfg.dtype], **kwargs),
            cfg.seed).to(self.device)
        # eval in eval_dtype on the same parameters: a second module of
        # that dtype, refilled from the trained one before each eval
        self.eval_model = self.model
        if cfg.eval_dtype != cfg.dtype:
            self.eval_model = self.spec.builder(
                dtype=_DTYPES[cfg.eval_dtype], **kwargs).to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        cfg.optimizer, cfg.weight_decay)
        # every random draw of the run: augmentation and dropout masks,
        # and (optionally) the FPS start indices
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.fps_generator = (
            torch.Generator(self.device).manual_seed(cfg.seed + 2)
            if cfg.fps_random_start else None)

        augs = cfg.augmentations
        if augs is None:
            augs = aug.TASK_PIPELINES.get(self.task, ())
        cw = (torch.tensor(cfg.class_weights, dtype=torch.float32,
                           device=self.device)
              if cfg.class_weights is not None else None)
        self.train_step = steps.make_train_step(
            self.model, self.spec.loss, self.optimizer, self.task,
            augment_names=augs, class_weights=cw, generator=self.generator,
            fps_generator=self.fps_generator)
        self._bn_refresh_n = cfg.bn_refresh_steps
        if self._bn_refresh_n is None:
            self._bn_refresh_n = 8 if cfg.dtype == "bfloat16" else 0
        self.bn_refresh_step = (steps.make_bn_refresh_step(
            self.model, self.task, augment_names=augs,
            generator=self.generator) if self._bn_refresh_n else None)
        self.eval_step = steps.make_eval_step(
            self.eval_model, self.spec.loss, self.task, self.num_classes,
            class_weights=cw)
        self.history = []

    # ------------------------------------------------------------- epochs

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        lr = schedules.step_lr(cfg.learning_rate, epoch, cfg.lr_step,
                               cfg.lr_gamma, cfg.min_lr)
        bn_m = schedules.bn_momentum_schedule(epoch, cfg.bn_init_momentum)
        losses, accs = [], []
        t0 = time.perf_counter()
        last = self.train_pipe.steps_per_epoch()
        for i, batch in enumerate(self.train_pipe.epoch(epoch)):
            m = self.train_step(batch, lr, bn_m)
            # the final step is always recorded, so a short epoch still
            # reports a loss (each record waits for the device)
            if (i + 1) % cfg.log_every == 0 or (i + 1) == last:
                losses.append(float(m["loss"]))
                accs.append(float(m["accuracy"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        out = {"lr": lr, "bn_momentum": bn_m, "epoch_time_s": dt,
               "clouds_per_s": last * cfg.batch_size / max(dt, 1e-9)}
        if losses:
            out.update({"loss": float(np.mean(losses)),
                        "train_acc": float(np.mean(accs))})
        return out

    def evaluate(self) -> dict:
        if self.bn_refresh_step is not None:
            # a fixed epoch index far from the training epochs: its own
            # shuffle stream; max_steps bounds the producer too
            for batch in self.train_pipe.epoch(
                    (1 << 20) - 1, max_steps=self._bn_refresh_n):
                self.bn_refresh_step(batch)
        if self.eval_model is not self.model:
            self.eval_model.load_state_dict(self.model.state_dict())
        total_correct = total_count = 0
        losses = []
        cm = None
        for batch, valid in self.test_pipe.epoch(0):
            m = self.eval_step(batch, valid)
            count = int(m["count"])
            # weight each batch's row-masked loss by its valid count
            losses.append((float(m["loss"]), count))
            total_correct += int(m["correct"])
            total_count += count
            cm = m["cm"] if cm is None else cm + m["cm"]
        lw = sum(w for _, w in losses)
        out = {"eval_loss": (sum(l * w for l, w in losses) / lw
                             if lw else 0.0)}
        if self.task == "fusion_semseg":
            # per point: count is valid rows x N
            out["point_acc"] = total_correct / max(total_count, 1)
            out["miou"] = float(M.iou_from_confusion(cm)[1])
        else:
            out["instance_acc"] = total_correct / max(total_count, 1)
            out["class_acc"] = float(M.per_class_accuracy(cm))
        return out

    def fit(self) -> dict:
        best = -1.0
        best_key = BEST_METRIC[self.task]
        final_eval = {}
        for epoch in range(self.cfg.epochs):
            tm = self.train_epoch(epoch)
            em = {}
            if (epoch + 1) % self.cfg.eval_every == 0:
                em = self.evaluate()
                final_eval = em
                best = max(best, em[best_key])
            self.history.append({"epoch": epoch, "train": tm, "eval": em})
        final_eval[f"best_{best_key}"] = best
        return final_eval
