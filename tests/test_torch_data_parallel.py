"""Data parallelism of the port (``parallel.data_parallel``, the Trainer and
the steps) on the CPU over ``gloo``, and the ``--point_shard`` flag of the
test CLI and the dryrun.

A data-parallel step must be the single-process step on the same global
batch: the augmentation, dropout and FPS-start draws of the global batch,
train-mode BN over the global batch (a synchronised BN), the loss on the
gathered outputs and the gradients summed over the ranks. In f64 the
loss, accuracy, every gradient, the BN running statistics and the
parameters after Adam agree to rtol 1e-6 (gradients that are rounding
residue in exact arithmetic, a bias ahead of a train-mode BN, to 1e-12 of
the model's largest). Ranks are spawned processes
(``tests/_torch_parallel_ranks.py``), each test with its own time limit.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from mm3d_tpu_torch.parallel.data_parallel import (data_parallel_size,
                                                   draw_rows, DataParallelCtx)
from mm3d_tpu_torch.parallel.launch import run_ranks
from mm3d_tpu_torch.parallel.mesh import Mesh

RANK_TIMEOUT = 120.0
LR = 1e-3  # the steps' learning rate (_torch_parallel_ranks.train_step)


def _cls_case(B=4, N=64, seed=0):
    r = np.random.RandomState(seed)
    return {"kwargs": {"num_class": 5},
            "augs": ("random_point_dropout", "random_scale_point_cloud",
                     "shift_point_cloud"),
            "batch": {"points": r.randn(B, N, 3) * 0.5,
                      "label": r.randint(0, 5, B).astype(np.int32)}}


def _semseg_case(B=4, N=128, seed=1):
    r = np.random.RandomState(seed)
    return {"kwargs": {"num_class": 13}, "augs": (),
            "batch": {"points": r.randn(B, N, 9) * 0.5,
                      "seg": r.randint(0, 13, (B, N)).astype(np.int32)}}


def _fusion_case(B=4, N=64, seed=2):
    r = np.random.RandomState(seed)
    return {"kwargs": {"num_class": 5}, "augs": None,
            "batch": {"points": r.randn(B, N, 3) * 0.5,
                      "image": r.rand(B, 16, 16, 3),
                      "K": np.broadcast_to(np.eye(3) * 8, (B, 3, 3)).copy(),
                      "R": np.broadcast_to(np.eye(3), (B, 3, 3)).copy(),
                      "t": np.tile([0.0, 0.0, 3.0], (B, 1)),
                      "label": r.randint(0, 5, B).astype(np.int32)}}


def _partseg_case(B=4, N=64, seed=3):
    r = np.random.RandomState(seed)
    return {"kwargs": {"num_part": 6, "num_category": 4}, "augs": (),
            "batch": {"points": r.randn(B, N, 3) * 0.5,
                      "cat": r.randint(0, 4, B).astype(np.int32),
                      "seg": r.randint(0, 6, (B, N)).astype(np.int32)}}


STEP_CASES = {
    # augmentations, dropout and the random FPS start, 2 ranks
    "pointnet2_cls_ssg": (2, _cls_case),
    # the sem-seg trunk's FP blocks and per-point loss
    "pointnet2_sem_seg": (2, _semseg_case),
    # the image CNN's channels-first BN and the fusion augmentations
    "fusion_cls": (2, _fusion_case),
    # the feature-transform regulariser (an aux output) and the STNs' BN
    "pointnet_part_seg": (2, _partseg_case),
}


def _residue_scale(grads):
    return max(np.abs(g).max() for g in grads.values())


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_data_parallel_step_matches_single_process(name, tmp_path):
    world, make = STEP_CASES[name]
    case = make()
    if case["augs"] is None:
        from mm3d_tpu_torch.data import augment as aug
        case["augs"] = aug.TASK_PIPELINES["fusion_cls"]
    want = ranks.train_step(None, name, case)
    torch.set_default_dtype(torch.float32)  # train_step sets f64
    got = run_ranks(ranks.train_step, world, (name, case),
                    timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    top = _residue_scale(want["grads"])
    for rank, out in enumerate(got):
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-6)
        assert out["accuracy"] == want["accuracy"]
        for k, w in want["grads"].items():
            err = np.abs(out["grads"][k] - w).max()
            assert err <= 1e-6 * np.abs(w).max() + 1e-12 * top, (rank, k)
        for k, w in want["state"].items():
            diff = np.abs(out["state"][k] - w)
            if k not in want["grads"]:  # the BN running statistics
                np.testing.assert_allclose(out["state"][k], w, rtol=1e-6,
                                           atol=1e-9, err_msg=f"{rank} {k}")
                continue
            # a parameter after one Adam step moves by lr*g/(|g|+eps):
            # where its gradient is rounding (its sign undetermined) the
            # steps may be up to 2 lr apart, elsewhere 1e-3 lr
            g = np.abs(want["grads"][k])
            loose = g <= 1e-6 * g.max() + 1e-12 * top
            assert np.all(diff[loose] <= 2 * LR * (1 + 1e-6)), (rank, k)
            assert np.all(diff[~loose] <= 1e-3 * LR), (rank, k)
        # every rank holds the same state, bit for bit
        for k, w in got[0]["state"].items():
            np.testing.assert_array_equal(out["state"][k], w)


def test_data_parallel_size_is_jax_rule():
    """The largest divisor of the batch at most the world size
    (``mm3d_tpu/training/loop.py:141-148``)."""
    assert data_parallel_size(12, 8) == 6
    assert data_parallel_size(6, 4) == 3
    assert data_parallel_size(24, 2) == 2
    assert data_parallel_size(7, 4) == 1
    assert data_parallel_size(4, 8) == 4


def test_draw_rows_is_the_global_draw_sliced():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    ctx = DataParallelCtx(Mesh(None, 1, 3), 6)
    got = draw_rows(lambda s: torch.rand(s, generator=g1), (2, 4), ctx)
    want = torch.rand((6, 4), generator=g2)[2:4]
    assert torch.equal(got, want)
    # the generators advanced alike
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))


def _trainer_kwargs(**kw):
    base = dict(model="pointnet2_cls_ssg", epochs=1, batch_size=4,
                npoint=64, num_class=4, train_size=8, test_size=6,
                log_every=1, seed=3)
    base.update(kw)
    return base


def test_trainer_batch_that_does_not_divide(tmp_path):
    """Batch 4 on 3 ranks: data-parallel over the first 2, rank 2 idle
    (returns {} and writes nothing). The 2 ranks hold one state, bit for
    bit, and their fit and eval equal the single-process Trainer's (eval
    over 6 shapes in batches of 4: the pad rows count nowhere)."""
    kw = _trainer_kwargs(checkpoint=False, optimizer="sgd")
    got = run_ranks(ranks.trainer_fit, 3, (kw, str(tmp_path / "dp")),
                    timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    single = ranks.trainer_fit(None, kw, str(tmp_path / "one"))
    assert [o["idle"] for o in got] == [False, False, True]
    assert [o["is_main"] for o in got] == [True, False, False]
    assert got[2]["result"] == {} and got[2]["eval"] == {}
    assert [o["run_dir"] is None for o in got] == [False, True, True]
    for o in got[:2]:
        for k, w in got[0]["state"].items():
            np.testing.assert_array_equal(o["state"][k], w)
        assert o["result"] == got[0]["result"]
    # fp32 (the f64 step test above holds the function exactly): the BN
    # sums run by rank, one ulp from the single sum, which can flip a ReLU
    # or a max-over-neighbours winner near a tie and move that row's share
    # of a gradient; so the update of the whole model (SGD: Adam would move
    # a rounding-level gradient by up to lr) is held by its relative L2
    # norm, as chip_smoke.py's 7c holds each gradient (dp_parity)
    init = got[0]["init"]
    num = sum(float(np.sum((got[0]["state"][k] - w) ** 2))
              for k, w in single["state"].items())
    den = sum(float(np.sum((w - init[k]) ** 2))
              for k, w in single["state"].items())
    print(f"update ||d||/||u|| {np.sqrt(num / den):.3g}")
    assert np.sqrt(num) <= 1e-2 * np.sqrt(den)
    for k in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(got[0][k], single[k], rtol=1e-4,
                                   err_msg=k)


def test_rank0_checkpoints_every_rank_restores_the_same(tmp_path):
    """2 ranks: only rank 0 writes the run directory, its metrics and the
    checkpoints; a resumed run restores the same state on both ranks (read
    by rank 0 and broadcast), equal to the saved one."""
    log_dir = str(tmp_path / "runs")
    kw = _trainer_kwargs(batch_size=4, train_size=8, run_name="ckpt")
    fit = run_ranks(ranks.trainer_fit, 2, (kw, log_dir),
                    timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    assert [o["has_ckpt"] for o in fit] == [True, False]
    assert fit[1]["run_dir"] is None
    run_dir = fit[0]["run_dir"]
    assert sorted(os.listdir(log_dir)) == ["classification"]
    assert os.listdir(os.path.join(log_dir, "classification")) == ["ckpt"]
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 2  # one train and one eval line, written once
    assert len(os.listdir(os.path.join(run_dir, "checkpoints_latest"))) == 2
    res = run_ranks(ranks.trainer_resume, 2, (dict(kw, epochs=2), log_dir),
                    timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    assert res[0]["step"] == res[1]["step"] == 2
    assert res[0]["start_epoch"] == 1
    for k, w in fit[0]["state"].items():
        for r in res:
            np.testing.assert_array_equal(r["state"][k], w)
    np.testing.assert_array_equal(res[0]["opt"], res[1]["opt"])
    np.testing.assert_array_equal(res[0]["generator"], res[1]["generator"])


def test_test_cli_point_shard(tmp_path):
    """``test --point_shard MIN_N`` on a pointnet2_sem_seg run gives the
    metrics of the run without the flag: in one process, and on 2 ranks
    of one process group (as under torchrun), where both ranks return
    them and split the points of each block of at least MIN_N."""
    from mm3d_tpu_torch import test as test_cli
    from mm3d_tpu_torch import train as train_cli
    log = str(tmp_path / "runs")
    common = ["--model", "pointnet2_sem_seg", "--npoint", "256",
              "--batch_size", "2", "--test_size", "4", "--device", "cpu"]
    train_cli.main(common + ["--epoch", "1", "--train_size", "4",
                             "--log_dir", log, "--run_name", "r"])
    run = ["--log_dir", os.path.join(log, "semseg", "r")]
    plain = test_cli.main(common + run)
    sharded = test_cli.main(common + run + ["--point_shard", "128"])
    two = run_ranks(ranks.test_cli, 2, (common + run
                                        + ["--point_shard", "128"],),
                    timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    for got in (sharded, *two):
        assert set(got) == set(plain)
        for k in ("point_acc", "miou"):
            assert got[k] == plain[k], k
        np.testing.assert_allclose(got["eval_loss"], plain["eval_loss"],
                                   rtol=1e-5)


def test_dryrun_two_ranks():
    """``python -m mm3d_tpu_torch.parallel.dryrun 2 --device cpu``: the
    data-parallel fusion_cls and pointnet2_sem_seg steps, sharded FPS,
    ball query and kNN exact at 2,048 -> 512 points, both tails and the
    point-sharded sem-seg forwards within 1e-5 (it raises otherwise)."""
    from mm3d_tpu_torch.parallel import dryrun
    line = dryrun.main(["2", "--device", "cpu", "--timeout", "300"])
    assert line.startswith("dryrun_multichip(2): loss=")
    assert "backend=gloo" in line and "point_sharded_knn=exact" in line
