"""Training command line of the port (counterpart of the repository's
``train.py``); the task follows from the model registry.

    python -m mm3d_tpu_torch.train --model pointnet2_cls_ssg --epoch 10
    python -m mm3d_tpu_torch.train --model pointnet2_sem_seg --dataset s3dis \\
        --data_root DIR --npoint 4096 --torch_ckpt lineage.pth

The flags are the JAX CLI's, but for ``--impl`` (the port's modes
``auto|torch|cuda``, ``ops/dispatch.py``) and ``--device cuda|cpu``: it
runs on the card unless ``--device cpu`` is given, and without CUDA it
exits with a message instead. The kernels' build cache is keyed by digest
(``ops/_build.py``), so there is no compilation cache to switch on. TF32 is
turned off for the run (strict fp32). ``main(argv)`` returns the result of
``Trainer.fit``.
"""

from __future__ import annotations

import argparse
import sys

from mm3d_tpu_torch.data.loaders import REAL_DATASETS
from mm3d_tpu_torch.models.registry import available
from mm3d_tpu_torch.ops.dispatch import MODES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mm3d_tpu_torch training")
    p.add_argument("--model", default="pointnet2_cls_ssg",
                   choices=sorted(available()))
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--epoch", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--npoint", type=int, default=None,
                   help="points per cloud (default: the model's own)")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--decay_rate", type=float, default=1e-4,
                   help="weight decay")
    p.add_argument("--lr_step", type=int, default=20)
    p.add_argument("--lr_gamma", type=float, default=0.7)
    p.add_argument("--normal", action="store_true",
                   help="use normals as extra channels")
    p.add_argument("--num_class", type=int, default=40)
    p.add_argument("--seg_classes", type=int, default=13,
                   help="semseg / fusion_semseg head size (S3DIS: 13; a "
                        "tree with more label classes must set it)")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--run_name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_size", type=int, default=512)
    p.add_argument("--test_size", type=int, default=128)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--torch_ckpt", default=None, metavar="PATH",
                   help="start from a lineage PyTorch .pth checkpoint "
                        "(canonical state_dict layout; see "
                        "mm3d_tpu_torch.utils.torch_import)")
    p.add_argument("--no_checkpoint", action="store_true")
    p.add_argument("--bn_momentum", type=float, default=0.1,
                   help="initial BN running-statistics momentum (halved "
                        "every 20 epochs)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: mixed precision (bf16 compute, f32 "
                        "master weights and BN statistics)")
    p.add_argument("--bn_refresh_steps", type=int, default=None,
                   help="forward-only BN re-estimation passes before each "
                        "eval (default: 8 in bf16, 0 in fp32)")
    p.add_argument("--impl", default="auto", choices=list(MODES),
                   help="kernel-backed ops: auto (the kernels on the card), "
                        "torch (the plain PyTorch versions), cuda (the "
                        "kernels always)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the run goes (default: the card)")
    p.add_argument("--fps_random_start", action="store_true",
                   help="a random FPS start per train step, as the lineage "
                        "seeds FPS in training; eval stays deterministic")
    add_dataset_args(p)
    return p.parse_args(argv)


def add_dataset_args(p):
    """--dataset / --data_root, shared by the train and test CLIs."""
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", *REAL_DATASETS],
                   help="'synthetic' generates data in memory; the rest "
                        "read the canonical on-disk formats under "
                        "--data_root")
    p.add_argument("--data_root", default=None,
                   help="dataset directory (required unless --dataset "
                        "synthetic)")
    p.add_argument("--test_area", type=int, default=5,
                   help="S3DIS held-out area (the standard protocol "
                        "evaluates on Area 5)")
    p.add_argument("--uniform_sample", action="store_true",
                   help="ModelNet: FPS-downsample each shape at load time "
                        "instead of truncating it (the lineage's "
                        "--use_uniform_sample)")


def check_device(device: str) -> None:
    """Exit with a message when the card is asked for and there is none:
    an entry point never carries on on the CPU unasked."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")


def strict_fp32() -> None:
    """Turn TF32 off, so fp32 matmuls and convolutions are strict fp32
    (PyTorch lets cuDNN convolutions use TF32 by default)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_cli_datasets(a, task, npoint, test_only=False):
    """--dataset / --data_root -> (train_ds, test_ds); (None, None) for
    synthetic (the Trainer builds its own). ``test_only`` skips the train
    split."""
    if a.dataset == "synthetic":
        return None, None
    if not a.data_root:
        raise SystemExit(f"--dataset {a.dataset} requires --data_root")
    from mm3d_tpu_torch.data.loaders import build_real_datasets
    train_ds, test_ds = build_real_datasets(
        a.dataset, a.data_root, task, npoints=npoint, normals=a.normal,
        test_area=a.test_area, uniform_sample=a.uniform_sample,
        splits=("test",) if test_only else ("train", "test"))
    # a tree with more classes than the head would give labels past it;
    # fewer (a subset tree under a larger head) is fine
    ds = train_ds if train_ds is not None else test_ds
    base = getattr(ds, "base", ds)  # multimodal wraps the point set
    classes = getattr(base, "classes", None)
    if classes is not None and len(classes) > a.num_class:
        raise SystemExit(
            f"--data_root has {len(classes)} classes but --num_class is "
            f"{a.num_class}; pass --num_class {len(classes)}")
    if classes is not None and len(classes) < a.num_class:
        print(f"[mm3d] note: tree has {len(classes)} classes, head has "
              f"{a.num_class} (extra logits unused)")
    return train_ds, test_ds


def load_torch_into_trainer(trainer, path):
    """Replace the trainer's parameters and BN statistics with a lineage
    ``.pth`` (canonical torch state_dict). Shared by the train CLI
    (fine-tune migrated weights) and the test CLI (evaluate them)."""
    from mm3d_tpu_torch.utils.torch_import import load_torch_into_model
    load_torch_into_model(trainer.cfg.model, trainer.model, path)
    trainer.log.info("imported lineage torch checkpoint %s", path)


def main(argv=None):
    a = parse_args(argv)
    if a.torch_ckpt and a.resume:
        raise SystemExit("--torch_ckpt and --resume are mutually "
                         "exclusive (one set of weights must win)")
    check_device(a.device)
    strict_fp32()
    from mm3d_tpu_torch.models import get_model
    from mm3d_tpu_torch.ops import dispatch
    from mm3d_tpu_torch.training.loop import TrainConfig, Trainer
    spec = get_model(a.model)
    npoint = a.npoint or spec.default_npoint
    cfg = TrainConfig(
        model=a.model, epochs=a.epoch, batch_size=a.batch_size,
        npoint=npoint, learning_rate=a.learning_rate,
        optimizer=a.optimizer, weight_decay=a.decay_rate,
        lr_step=a.lr_step, lr_gamma=a.lr_gamma, normal_channel=a.normal,
        num_class=a.num_class, seg_classes=a.seg_classes, seed=a.seed,
        log_dir=a.log_dir, run_name=a.run_name, train_size=a.train_size,
        test_size=a.test_size, resume=a.resume,
        checkpoint=not a.no_checkpoint, dtype=a.dtype,
        bn_init_momentum=a.bn_momentum,
        bn_refresh_steps=a.bn_refresh_steps,
        fps_random_start=a.fps_random_start, device=a.device)
    train_ds, test_ds = build_cli_datasets(a, spec.task, npoint)
    with dispatch.use_impl(a.impl):
        trainer = Trainer(cfg, train_ds=train_ds, test_ds=test_ds)
        try:
            if a.torch_ckpt:
                load_torch_into_trainer(trainer, a.torch_ckpt)
            result = trainer.fit()
            trainer.log.info("final: %s", result)
            return result
        finally:
            trainer.close()


if __name__ == "__main__":
    main(sys.argv[1:])
