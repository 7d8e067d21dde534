"""Trainer: epoch loop and evaluation (counterpart of
``mm3d_tpu/training/loop.py``) for every registered model
(``TrainConfig(model=name, ...)``, ``models.available()``) and its task:
``classification``, ``partseg``, ``semseg``, ``fusion_cls`` or
``fusion_semseg``.

The steps run on the Trainer's device (``cuda`` unless the caller passes
``device="cpu"``); the loop schedules the lr and BN momentum per epoch,
feeds prefetched batches and reduces the eval metrics. bf16 mixed precision
(``dtype="bfloat16"``) computes in bf16 with f32 master weights and f32 BN
statistics; it evaluates in f32 on the same parameters unless
``eval_dtype="bfloat16"``, and re-estimates the BN statistics with 8
forward passes before each eval (``loop.py:183-230,345-357``).

Each run writes a run directory, ``<log_dir>/<task>/<run_name or a time
stamp>/`` (``utils.logging_utils``): ``logs/metrics.jsonl`` and
``logs/train.log`` get the train and eval metrics of every epoch, and with
``checkpoint`` (the default) the train state (``training.state
.make_train_state``: parameters, BN buffers, optimizer state, step and the
generators' states) is saved after each eval twice: into ``checkpoints/``,
which keeps the best three by the task's ``BEST_METRIC``, and into
``checkpoints_latest/``, which keeps the newest. ``resume=True`` with the
``run_name`` of an earlier run restores the newest state (from
``checkpoints_latest/``, else ``checkpoints/``) and goes on from its epoch;
the resumed run is bit for bit the uninterrupted one. A checkpoint restores
onto the device type it was written on.

Data parallelism (``loop.py:141-155,272-274`` of the JAX package): in a
process initialised into a ``torch.distributed`` group, the Trainer trains
over the first ``dp`` ranks, ``dp`` the
largest divisor of the batch at most the world size
(``parallel.data_parallel``); the other ranks are idle (``fit`` and
``evaluate`` return ``{}``). Every rank reads the same global batches and
the steps compute the single-process steps on them (each rank's rows, the
global batch's BN statistics and draws, gradients summed over the ranks),
so every rank holds the same state. Only rank 0 writes the run directory,
the metrics and the checkpoints; a resumed state is read by rank 0 and
broadcast, so every rank restores the same one. Without a process group
nothing of this runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.data.pipeline import DataPipeline
from mm3d_tpu_torch.models import get_model, init_params
from mm3d_tpu_torch.parallel.data_parallel import make_data_mesh
from mm3d_tpu_torch.parallel.mesh import broadcast_object, replicate
from mm3d_tpu_torch.training import schedules, steps
from mm3d_tpu_torch.training.state import (load_train_state,
                                           make_optimizer, make_train_state)
from mm3d_tpu_torch.utils import metrics as M
from mm3d_tpu_torch.utils.checkpoint import CheckpointManager
from mm3d_tpu_torch.utils.logging_utils import MetricsLogger, create_run_dir

# per-task headline metric: the best-of-run value ``fit`` reports and the
# one the best-checkpoint retention ranks by (``loop.py:34-38`` of the JAX
# package)
BEST_METRIC = {"classification": "instance_acc",
               "partseg": "instance_miou", "semseg": "miou",
               "fusion_cls": "instance_acc", "fusion_semseg": "miou"}


@dataclasses.dataclass
class TrainConfig:
    model: str = "pointnet2_cls_ssg"
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
    # partseg categories (ShapeNetPart: 16)
    num_category: int = 16
    # semseg and fusion_semseg classes (S3DIS: 13)
    seg_classes: int = 13
    seed: int = 0
    # the run directory's root; run_name None: a fresh time-stamped run
    log_dir: str = "log"
    run_name: Optional[str] = None
    train_size: int = 512
    test_size: int = 128
    log_every: int = 10
    eval_every: int = 1
    checkpoint: bool = True
    # restore the newest checkpoint of run_name's run and go on from there
    resume: bool = False
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
    ``classification``: ModelNet-style clouds with their labels;
    ``partseg``: ShapeNetPart-style clouds with their category and
    per-point part labels; ``semseg``: S3DIS-style blocks of ``cfg.npoint``
    9-dim points with per-point labels; ``fusion_cls``: the ModelNet-style
    clouds and ``fusion_semseg``: the S3DIS-style blocks, each with its
    rendered view and camera."""

    def base(size, split):
        if task == "partseg":
            return syn.SyntheticShapeNetPart(
                npoints=cfg.npoint, normals=cfg.normal_channel, size=size,
                seed=cfg.seed, split=split)
        if task in ("semseg", "fusion_semseg"):
            return syn.SyntheticIndoorScene(npoints=cfg.npoint, size=size,
                                            seed=cfg.seed, split=split)
        if task in ("classification", "fusion_cls"):
            return syn.SyntheticModelNet(
                num_classes=cfg.num_class, npoints=cfg.npoint,
                normals=cfg.normal_channel, size=size, seed=cfg.seed,
                split=split)
        raise ValueError(f"no synthetic datasets for task {task!r}")

    def mk(size, split):
        if task in ("classification", "partseg", "semseg"):
            return base(size, split)
        return syn.SyntheticMultimodal(base=base(size, split),
                                       hw=cfg.image_hw, seed=cfg.seed)

    return mk(cfg.train_size, "train"), mk(cfg.test_size, "test")


class _NullLog:
    """The logger of a rank that writes nothing (every rank but 0)."""

    def info(self, msg: str, *args):
        pass

    def log_metrics(self, step: int, metrics: dict, prefix: str = ""):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, cfg: TrainConfig, train_ds=None, test_ds=None):
        self.cfg = cfg
        # data parallelism: the initialised world's first dp ranks (the
        # others idle); none without a process group
        self.mesh, self.idle = None, False
        if dist.is_available() and dist.is_initialized():
            self.mesh = make_data_mesh(cfg.batch_size)
            self.idle = self.mesh is None
        self.is_main = not self.idle and (self.mesh is None
                                          or self.mesh.rank == 0)
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
        elif self.task == "semseg":
            self.num_classes = cfg.seg_classes
            kwargs = {"num_class": cfg.seg_classes}
        elif self.task == "partseg":
            self.num_classes = 50  # ShapeNetPart's parts
            kwargs = {"num_category": cfg.num_category,
                      "normal_channel": cfg.normal_channel}
        else:
            self.num_classes = cfg.num_class
            kwargs = {"num_class": cfg.num_class,
                      "normal_channel": cfg.normal_channel}
            if self.task == "fusion_cls":
                kwargs["fusion"] = cfg.fusion
        self.model = init_params(
            self.spec.builder(dtype=_DTYPES[cfg.dtype], **kwargs),
            cfg.seed).to(self.device)
        if self.mesh is not None:
            replicate(self.mesh, [*self.model.parameters(),
                                  *self.model.buffers()])
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
            fps_generator=self.fps_generator,
            num_category=cfg.num_category, mesh=self.mesh)
        self._bn_refresh_n = cfg.bn_refresh_steps
        if self._bn_refresh_n is None:
            self._bn_refresh_n = 8 if cfg.dtype == "bfloat16" else 0
        self.bn_refresh_step = (steps.make_bn_refresh_step(
            self.model, self.task, augment_names=augs,
            generator=self.generator, num_category=cfg.num_category,
            mesh=self.mesh) if self._bn_refresh_n else None)
        eval_kwargs = {}
        if self.task == "partseg":
            # each category's global part range (``loop.py:232-238``)
            start, count = M.part_ranges(syn.shapenet_part_ranges(),
                                         self.device)
            eval_kwargs = {"part_start": start, "part_count": count,
                           "max_parts": int(count.max())}
        self.eval_step = steps.make_eval_step(
            self.eval_model, self.spec.loss, self.task, self.num_classes,
            class_weights=cw, num_category=cfg.num_category, mesh=self.mesh,
            **eval_kwargs)
        self.history = []
        # train steps taken over the run, resumed ones included
        self.step = 0

        # only rank 0 writes: the run directory, its logs, the checkpoints
        self.run_dir = None
        self.log = _NullLog()
        self.ckpt = self.ckpt_latest = None
        if self.is_main:
            self.run_dir = create_run_dir(cfg.log_dir, self.task,
                                          cfg.run_name)
            self.log = MetricsLogger(self.run_dir)
        if self.is_main and cfg.checkpoint:
            self.ckpt = CheckpointManager(
                os.path.join(self.run_dir, "checkpoints"),
                best_metric=BEST_METRIC[self.task])
            # best-metric retention can drop the newest state when the
            # best epochs came early; this one keeps it for resume
            self.ckpt_latest = CheckpointManager(
                os.path.join(self.run_dir, "checkpoints_latest"),
                max_to_keep=1)
        self.start_epoch = 0
        if cfg.resume and not self.idle:
            self._resume()

    def _resume(self):
        """Restore the newest state of the run (``checkpoints_latest/``,
        else ``checkpoints/``): rank 0 reads it on the host and, with a
        mesh, broadcasts it, so every rank restores the same state."""
        state = None
        if self.ckpt_latest is not None:
            for mgr in (self.ckpt_latest, self.ckpt):
                if mgr.latest_step() is not None:
                    state = mgr.restore(map_location="cpu")
                    break
        if self.mesh is not None:
            state = broadcast_object(state, self.mesh)
        if state is None:
            # without run_name the run directory is a fresh one: training
            # from scratch there would drop the run meant to go on
            self.close()
            raise SystemExit(
                f"resume: no checkpoint found under {self.run_dir}; pass the "
                "run_name of the run to resume (and keep checkpointing on)")
        # loading copies the model's and the optimizer's tensors onto the
        # model's device
        self.step = load_train_state(state, self.model, self.optimizer,
                                     self.generator, self.fps_generator)
        self.start_epoch = self.step // max(
            self.train_pipe.steps_per_epoch(), 1)
        self.log.info("resumed from step %d (epoch %d)", self.step,
                      self.start_epoch)

    def train_state(self) -> dict:
        """What a checkpoint of this run holds
        (``training.state.make_train_state``)."""
        return make_train_state(self.model, self.optimizer, self.step,
                                self.generator, self.fps_generator)

    def close(self):
        """Close the run's log files; the logger is process-wide, so a
        process that builds many Trainers should close each."""
        self.log.close()
        if self.ckpt is not None:
            self.ckpt.close()
            self.ckpt_latest.close()

    # ------------------------------------------------------------- epochs

    def train_epoch(self, epoch: int) -> dict:
        if self.idle:
            return {}
        cfg = self.cfg
        lr = schedules.step_lr(cfg.learning_rate, epoch, cfg.lr_step,
                               cfg.lr_gamma, cfg.min_lr)
        bn_m = schedules.bn_momentum_schedule(epoch, cfg.bn_init_momentum)
        losses, accs = [], []
        t0 = time.perf_counter()
        last = self.train_pipe.steps_per_epoch()
        for i, batch in enumerate(self.train_pipe.epoch(epoch)):
            m = self.train_step(batch, lr, bn_m)
            self.step += 1
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
        if self.idle:
            return {}
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
        ious, cats = [], []
        for batch, valid in self.test_pipe.epoch(0):
            m = self.eval_step(batch, valid)
            count = int(m["count"])
            # weight each batch's row-masked loss by its valid count
            losses.append((float(m["loss"]), count))
            total_correct += int(m["correct"])
            total_count += count
            if "cm" in m:
                cm = m["cm"] if cm is None else cm + m["cm"]
            else:  # partseg: the valid rows' shape IoUs and categories
                keep = m["valid"].bool()
                ious.append(m["ious"][keep].cpu().numpy())
                cats.append(m["cats"][keep].cpu().numpy())
        lw = sum(w for _, w in losses)
        out = {"eval_loss": (sum(l * w for l, w in losses) / lw
                             if lw else 0.0)}
        if self.task == "partseg":
            out["point_acc"] = total_correct / max(total_count, 1)
            out.update(M.partseg_metrics_host(
                np.concatenate(ious) if ious else np.zeros(0),
                np.concatenate(cats) if cats else np.zeros(0, np.int32),
                self.cfg.num_category))
        elif self.task in ("semseg", "fusion_semseg"):
            # per point: count is valid rows x N
            out["point_acc"] = total_correct / max(total_count, 1)
            out["miou"] = float(M.iou_from_confusion(cm)[1])
        else:
            out["instance_acc"] = total_correct / max(total_count, 1)
            out["class_acc"] = float(M.per_class_accuracy(cm))
        return out

    def fit(self) -> dict:
        if self.idle:
            return {}
        best = -1.0
        best_key = BEST_METRIC[self.task]
        final_eval = {}
        for epoch in range(self.start_epoch, self.cfg.epochs):
            tm = self.train_epoch(epoch)
            self.log.log_metrics(epoch, tm, prefix="train/")
            em = {}
            if (epoch + 1) % self.cfg.eval_every == 0:
                em = self.evaluate()
                final_eval = em
                self.log.log_metrics(epoch, em, prefix="eval/")
                if self.ckpt is not None:
                    state = self.train_state()
                    self.ckpt.save(self.step, state,
                                   metrics={best_key: em[best_key]})
                    self.ckpt_latest.save(self.step, state)
                best = max(best, em[best_key])
            self.history.append({"epoch": epoch, "train": tm, "eval": em})
        final_eval[f"best_{best_key}"] = best
        return final_eval
