"""Evaluation command line of the port (counterpart of the repository's
``test.py``).

    python -m mm3d_tpu_torch.test --model fusion_cls --log_dir RUN_DIR \\
        --dataset multimodal --data_root DIR --num_votes 3
    python -m mm3d_tpu_torch.test --model pointnet2_sem_seg --log_dir RUN_DIR \\
        --scene area --data_root S3DIS_DIR --test_area 5
    python -m mm3d_tpu_torch.test --model fusion_cls --log_dir RUN_DIR \\
        --export artifact.pt2

Restores a training run's best checkpoint (else its latest), or a lineage
``.pth`` (``--torch_ckpt``), and evaluates it on the test split, with vote
ensembling (``--num_votes``); or scores whole rooms (``--scene``: a room
file, a directory of rooms, ``area`` for the held-out S3DIS area of
``--data_root``, or ``synthetic``); or freezes the eval forward into a
serving artifact (``--export``, served by ``python -m
mm3d_tpu_torch.serving``). The flags are the JAX CLI's, but for ``--impl``
(``auto|torch|cuda``) and ``--device cuda|cpu`` (the card unless ``--device
cpu``; without CUDA it exits with a message). ``--export_platforms`` has no
counterpart (an artifact serves on the device type it was exported on) and
``--point_shard MIN_N`` evaluates with the point axis of every eval
block of at least MIN_N points split over the ranks
(``parallel.point_shard``), through the vote passes and ``--scene`` too.
It runs in one process, or under ``torchrun --nproc_per_node K`` (rank and
world size from the environment, ``--backend`` as in the train CLI), where
the ranks share the work and only rank 0 prints and writes. The vote draws
come from one ``torch.Generator`` seeded by ``--seed`` on the trainer's
device, one draw a batch. TF32 is turned off. ``main(argv)`` returns the
result dict.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import sys

import numpy as np

from mm3d_tpu_torch.models.registry import available
from mm3d_tpu_torch.ops.dispatch import MODES
from mm3d_tpu_torch.train import (add_backend_arg, add_dataset_args,
                                  build_cli_datasets, check_device,
                                  init_distributed, load_torch_into_trainer,
                                  strict_fp32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mm3d_tpu_torch evaluation")
    p.add_argument("--model", default="pointnet2_cls_ssg",
                   choices=sorted(available()))
    p.add_argument("--log_dir", required=True,
                   help="run directory of a training run (holds "
                        "checkpoints/)")
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--npoint", type=int, default=None)
    p.add_argument("--normal", action="store_true")
    p.add_argument("--num_class", type=int, default=40)
    p.add_argument("--seg_classes", type=int, default=13,
                   help="semseg / fusion_semseg head size (S3DIS: 13)")
    p.add_argument("--num_votes", type=int, default=1)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: bf16 eval (the fused SA and FP kernels); "
                        "float32: strict fp32")
    p.add_argument("--impl", default="auto", choices=list(MODES),
                   help="kernel-backed ops: auto (the kernels on the card), "
                        "torch (the plain PyTorch versions), cuda")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the evaluation runs (default: the card)")
    p.add_argument("--test_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--torch_ckpt", default=None, metavar="PATH",
                   help="evaluate a lineage PyTorch .pth checkpoint "
                        "(canonical state_dict layout) instead of the run "
                        "directory's checkpoints")
    p.add_argument("--export", default=None, metavar="PATH",
                   help="instead of evaluating, freeze the eval forward "
                        "(weights inside) into a serving artifact at PATH "
                        "(torch.export; mm3d_tpu_torch.serving serves it)")
    p.add_argument("--export_batch", default="fixed",
                   choices=["fixed", "poly"],
                   help="poly: one symbolic batch axis, so the artifact "
                        "serves any batch size")
    p.add_argument("--scene", default=None, metavar="PATH|DIR|synthetic",
                   help="whole-room evaluation (semseg / fusion_semseg): "
                        "tile each room into overlapping blocks and add up "
                        "per-point probabilities; PATH = one room as .npz "
                        "(xyz, optional rgb / labels) or .npy ([N,3|4|6|7+]); "
                        "DIR = a directory of rooms, scored over the summed "
                        "confusion matrix; 'area' = the --test_area rooms "
                        "of --data_root; 'synthetic' = a generated room")
    p.add_argument("--scene_points", type=int, default=20000,
                   help="synthetic room size (--scene synthetic)")
    p.add_argument("--block_size", type=float, default=1.0,
                   help="scene tiling block edge (meters)")
    p.add_argument("--stride", type=float, default=0.5,
                   help="scene tiling stride (meters)")
    p.add_argument("--point_shard", type=int, default=0, metavar="MIN_N",
                   help="split the point axis of eval blocks with >= MIN_N "
                        "points over the ranks (0 = off): sharded FPS, ball "
                        "query, kNN and SA / FP tails, exact semantics")
    add_dataset_args(p)
    add_backend_arg(p)
    return p.parse_args(argv)


def _load_room(path):
    """One room from disk: .npz (xyz / rgb / labels keys) or .npy ([N,3]
    xyz, [N,6] with rgb, [N,4] xyz and label, [N,7+] xyz rgb label ...:
    the preprocessed S3DIS layouts, whose semantic label is column 6)."""
    d = np.load(path)
    if hasattr(d, "files"):  # .npz
        xyz = d["xyz"]
        rgb = d["rgb"] if "rgb" in d.files else None
        labels = d["labels"] if "labels" in d.files else None
    else:
        xyz, rgb, labels = d[:, :3], None, None
        if d.shape[1] >= 6:
            rgb = d[:, 3:6]
        if d.shape[1] == 4:
            labels = d[:, 3].astype(np.int32)
        elif d.shape[1] >= 7:
            labels = d[:, 6].astype(np.int32)
    return xyz, rgb, labels


def _sync_eval_model(trainer):
    """The eval model holds the restored weights (a second module when
    --dtype differs from the trainer's fp32 model)."""
    if trainer.eval_model is not trainer.model:
        trainer.eval_model.load_state_dict(trainer.model.state_dict())
    trainer.eval_model.eval()
    return trainer.eval_model


def _eval_predictor(trainer):
    """The eval forward as a predictor: host tensors in, log-probs on the
    trainer's device out."""
    import torch
    model = _sync_eval_model(trainer)
    dev = trainer.device

    @torch.no_grad()
    def predict(*args):
        return model(*(torch.as_tensor(x).to(dev) for x in args))[0]

    predict.model = model
    return predict


def _eval_scene(a, trainer, npoint):
    """--scene: the lineage's whole-room protocol. A directory of rooms is
    scored over the sum of its rooms' confusion matrices (the whole-area
    protocol)."""
    from mm3d_tpu_torch.data.loaders import s3dis_room_in_area
    from mm3d_tpu_torch.training import scene_eval
    if trainer.task not in ("semseg", "fusion_semseg"):
        raise SystemExit("--scene requires a semseg or fusion_semseg model")
    predict = _eval_predictor(trainer)
    common = dict(num_classes=trainer.cfg.seg_classes, npoints=npoint,
                  block_size=a.block_size, stride=a.stride,
                  batch_size=a.batch_size, seed=a.seed,
                  num_votes=a.num_votes)
    if trainer.task == "semseg":
        run = lambda xyz, rgb, labels: scene_eval.evaluate_scene(
            predict, xyz, labels=labels, rgb=rgb, **common)
    else:
        # the blocks' views at the run's image size (the intrinsics scale
        # with it)
        run = lambda xyz, rgb, labels: scene_eval.evaluate_scene_multimodal(
            predict, xyz, labels=labels, rgb=rgb, hw=trainer.cfg.image_hw,
            **common)

    if a.scene == "synthetic":
        from mm3d_tpu_torch.data.synthetic import synthetic_room
        xyz, rgb, labels = synthetic_room(a.scene_points, seed=a.seed)
        _, metrics = run(xyz, rgb, labels)
        metrics.pop("_cm", None)
        return metrics
    scene_dir = a.scene
    room_filter = lambda f: f.endswith((".npy", ".npz"))
    # the keyword 'area' applies only when no file or directory of that
    # name exists
    if a.scene == "area" and not os.path.exists(a.scene):
        # the held-out area's rooms of the tree (an S3DIS layout by
        # definition, for semseg and fusion_semseg models alike)
        if not a.data_root:
            raise SystemExit("--scene area requires --data_root "
                             "(the S3DIS-layout tree holding the "
                             "Area_N rooms)")
        scene_dir = a.data_root
        room_filter = (lambda f: f.endswith((".npy", ".npz"))
                       and s3dis_room_in_area(f, a.test_area))
    if os.path.isdir(scene_dir):
        rooms = sorted(filter(room_filter, os.listdir(scene_dir)))
        if not rooms:
            raise SystemExit(f"--scene {a.scene}: no matching rooms "
                             f"in {scene_dir}")
        nc = trainer.cfg.seg_classes
        cm = np.zeros((nc, nc), np.int64)
        cov_pts = total_pts = 0
        unlabeled = []
        for name in rooms:
            xyz, rgb, labels = _load_room(os.path.join(scene_dir, name))
            _, m = run(xyz, rgb, labels)
            room_cm = m.pop("_cm", None)
            trainer.log.info("room %s (%d pts): %s", name, len(xyz), m)
            cov_pts += m["coverage"] * len(xyz)
            total_pts += len(xyz)
            if room_cm is None:
                unlabeled.append(name)
            else:
                cm += room_cm
        if unlabeled and len(unlabeled) < len(rooms):
            # the area's metrics would leave the labelled rooms out
            raise SystemExit(
                f"--scene {a.scene}: {len(unlabeled)} room(s) without a "
                f"label column alongside labeled ones: {unlabeled}")
        out = {"rooms": len(rooms),
               "coverage": cov_pts / max(total_pts, 1)}
        if not unlabeled:
            out.update(scene_eval.metrics_from_confusion(cm))
        return out
    xyz, rgb, labels = _load_room(a.scene)
    _, metrics = run(xyz, rgb, labels)
    metrics.pop("_cm", None)
    return metrics


def _example_args(trainer):
    """The model inputs of one test batch (the first samples, wrapped when
    the test set is smaller than a batch), on the CPU."""
    from mm3d_tpu_torch.data.pipeline import _collate
    from mm3d_tpu_torch.training import steps
    ds = trainer.test_pipe.dataset
    batch = _collate([ds[i % len(ds)]
                      for i in range(trainer.cfg.batch_size)])
    return steps._model_args(batch, trainer.task, batch["points"],
                             batch.get("R"), trainer.cfg.num_category)


def _export_serving_cli(a, trainer):
    """--export: the restored eval forward (eval dtype, the impl mode in
    force) as a serving artifact. The input shapes are a test batch's, so
    the artifact serves what the evaluation would see."""
    from mm3d_tpu_torch.ops import dispatch
    from mm3d_tpu_torch.training.inference import (export_serving,
                                                   save_serving)
    args = _example_args(trainer)
    exported = export_serving(_eval_predictor(trainer), args,
                              poly_batch=a.export_batch == "poly")
    save_serving(a.export, exported)
    ops_path = ("torch" if trainer.device.type == "cpu"
                or dispatch.get_impl() == "torch" else "cuda")
    return {"exported": a.export, "ops": ops_path,
            "device": trainer.device.type, "batch": a.export_batch,
            "in_shapes": [list(x.shape) for x in args]}


def _eval_and_vote(a, trainer):
    """``Trainer.evaluate``, then with --num_votes > 1 the task's vote step
    over the test set (the trainer's model, as the JAX CLI's votes run)."""
    import torch
    from mm3d_tpu_torch.data import synthetic as syn
    from mm3d_tpu_torch.training import steps
    from mm3d_tpu_torch.utils import metrics as M
    result = trainer.evaluate()
    if a.num_votes <= 1:
        return result
    model, dev, V = trainer.model, trainer.device, a.num_votes
    gen = torch.Generator(dev).manual_seed(a.seed)
    B = trainer.cfg.batch_size
    task = trainer.task
    if task in ("classification", "fusion_cls"):
        vote = (steps.make_vote_eval_step(model, V)
                if task == "classification"
                else steps.make_vote_fusion_cls_step(model, V))
        correct = total = 0
        for b, valid in trainer.test_pipe.epoch(0):
            angles = steps.draw_vote_angles(gen, V, B, dev)
            if task == "classification":
                pred = vote(b["points"], angles)
            else:
                pred = vote(b["points"], b["image"], b["K"], b["R"],
                            b["t"], angles)
            keep = valid.bool()
            correct += int(((pred == b["label"]) & keep).sum())
            total += int(keep.sum())
        result["vote_instance_acc"] = correct / max(total, 1)
    elif task == "partseg":
        ncat = trainer.cfg.num_category
        start, count = M.part_ranges(syn.shapenet_part_ranges(), dev)
        vote = steps.make_vote_partseg_step(model, V, ncat, start, count)
        ious, cats = [], []
        for b, valid in trainer.test_pipe.epoch(0):
            pts = b["points"]
            perms = steps.draw_vote_perms(gen, V, B, pts.shape[1], dev)
            cat = b["cat"].long()
            pred = vote(pts, cat, perms)
            sh = M.shape_ious(pred, b["seg"], start[cat], count[cat],
                              int(count.max()))
            keep = valid.bool()
            ious.append(sh[keep].cpu().numpy())
            cats.append(cat[keep].cpu().numpy())
        agg = M.partseg_metrics_host(np.concatenate(ious),
                                     np.concatenate(cats), ncat)
        result["vote_instance_miou"] = agg["instance_miou"]
        result["vote_class_miou"] = agg["class_miou"]
    elif task == "fusion_semseg":
        vote = steps.make_vote_fusion_semseg_step(model, V)
        nc = trainer.cfg.seg_classes
        cm = None
        for b, valid in trainer.test_pipe.epoch(0):
            pts = b["points"]
            perms = steps.draw_vote_perms(gen, V, B, pts.shape[1], dev)
            pred = vote(pts, b["image"], b["K"], b["R"], b["t"], perms)
            wm = valid.to(torch.int32)[:, None]
            c = M.confusion_matrix(pred, b["seg"], nc, weights=wm)
            cm = c if cm is None else cm + c
        result["vote_miou"] = float(M.iou_from_confusion(cm)[1])
    return result


def main(argv=None):
    a = parse_args(argv)
    check_device(a.device)
    strict_fp32()
    from mm3d_tpu_torch.models import get_model
    from mm3d_tpu_torch.ops import dispatch
    from mm3d_tpu_torch.training.loop import TrainConfig, Trainer
    spec = get_model(a.model)
    npoint = a.npoint or spec.default_npoint
    cfg = TrainConfig(
        model=a.model, batch_size=a.batch_size, npoint=npoint,
        normal_channel=a.normal, num_class=a.num_class,
        seg_classes=a.seg_classes, seed=a.seed, test_size=a.test_size,
        log_dir=os.path.join(a.log_dir, "eval"), checkpoint=False,
        eval_dtype=a.dtype, device=a.device)
    ds_args = a
    if a.scene:
        # scene mode reads its rooms itself; the trainer's test set gives
        # the shapes only, so it is the synthetic one (a fusion_semseg
        # model with --dataset s3dis would fail the dataset-task check)
        ds_args = copy.copy(a)
        ds_args.dataset = "synthetic"
    _, test_ds = build_cli_datasets(ds_args, spec.task, npoint,
                                    test_only=True)
    joined = init_distributed(a.backend, a.device)
    try:
        with dispatch.use_impl(a.impl):
            trainer = Trainer(cfg, test_ds=test_ds)
            try:
                return _main_with_trainer(a, trainer, npoint)
            finally:
                trainer.close()
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def restore_best(trainer, log_dir):
    """Load the run's best checkpoint by the task's metric (its latest
    when none has metrics) into the trainer's model; returns the step."""
    from mm3d_tpu_torch.training.loop import BEST_METRIC
    from mm3d_tpu_torch.utils.checkpoint import CheckpointManager
    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"),
                             best_metric=BEST_METRIC[trainer.task])
    step = ckpt.best_step()
    if step is None:
        step = ckpt.latest_step()
    state = ckpt.restore(step, map_location="cpu")
    trainer.model.load_state_dict(state["model"])
    return step


def _main_with_trainer(a, trainer, npoint):
    if trainer.idle:  # a rank past the batch's data-parallel width
        return {}
    if a.torch_ckpt:
        load_torch_into_trainer(trainer, a.torch_ckpt)
    else:
        step = restore_best(trainer, a.log_dir)
        trainer.log.info("restored checkpoint step %s from %s", step,
                         a.log_dir)
    if a.export:
        if not trainer.is_main:
            return {}
        result = _export_serving_cli(a, trainer)
        trainer.log.info("export: %s", result)
        print(result)
        return result
    shard = contextlib.nullcontext()
    if a.point_shard:
        from mm3d_tpu_torch.parallel import make_mesh, point_shard
        # the Trainer's data ranks (or this process alone); the context
        # stays open through the vote passes and the rooms, as in JAX
        mesh = trainer.mesh if trainer.mesh is not None else make_mesh()
        shard = point_shard(mesh, min_points=a.point_shard)
    with shard:
        if a.scene:
            result = _eval_scene(a, trainer, npoint)
        else:
            result = _eval_and_vote(a, trainer)
    trainer.log.info("eval: %s", result)
    if trainer.is_main:
        print(result)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
