"""Rank bodies of the port's parallel tests (``tests/test_torch_parallel_ops.py``,
``test_torch_point_shard.py``, ``test_torch_data_parallel.py``).

``parallel.launch.run_ranks`` sends a function to each spawned rank by
import path, so the bodies live in this torch-only module: a rank imports
neither JAX nor a test file. Each takes the rank's mesh first and returns
numpy arrays and numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from mm3d_tpu_torch.models import get_model, init_params
from mm3d_tpu_torch.models import pointnet2
from mm3d_tpu_torch.parallel import point_shard
from mm3d_tpu_torch.parallel import sharded_group as sg
from mm3d_tpu_torch.parallel.sharded_fps import sharded_fps
from mm3d_tpu_torch.training import steps
from mm3d_tpu_torch.training.loop import TrainConfig, Trainer
from mm3d_tpu_torch.training.state import make_optimizer


def _t(a):
    return torch.from_numpy(np.asarray(a))


def sharded_ops(mesh, case):
    """Every sharded op of ``case`` (numpy inputs): FPS, the ball query
    around given centroids, kNN, both SA tails and the FP tail."""
    xyz, cents = _t(case["xyz"]), _t(case["centroids"])
    pre, cb = _t(case["pre"]), _t(case["cbias"])
    w = [_t(case[k]) for k in ("w1", "b1", "w2", "b2")]
    bq = sg.sharded_ball_query(case["radius"], case["K"], xyz, cents, mesh)
    kn = sg.sharded_knn_point(case["K"], xyz, cents, mesh)
    out = {
        "fps": sharded_fps(xyz, case["npoint"], mesh),
        "ball_query": bq, "knn": kn,
        "sa_tail": sg.sharded_sa_group_max(case["radius"], case["K"], xyz,
                                           cents, pre, cb, *w, mesh),
        "idx_tail": sg.sharded_idx_group_max(kn, pre, cb, *w, mesh),
        "fp": sg.sharded_fp(xyz, cents, _t(case["fp_pre"]),
                            _t(case["fp_skip"]), mesh),
        "knn_ties": sg.sharded_knn_point(case["K"], _t(case["grid"]),
                                         _t(case["grid_centroids"]), mesh),
        "fps_ties": sharded_fps(_t(case["grid"]), case["npoint"], mesh),
    }
    return {k: v.numpy() for k, v in out.items()}


def point_sharded_forward(mesh, name, state, num_class, inputs, min_points):
    """The eval forward of ``name`` with ``state`` under ``point_shard``;
    returns each input's log-probs and the point counts of the blocks that
    sharded (their FPS and FP tails), in call order."""
    model = get_model(name).builder(num_class=num_class)
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    model.eval()
    seen = []

    def fps(xyz, npoint, m):
        seen.append(("sa", xyz.shape[1]))
        return sharded_fps(xyz, npoint, m)

    def fp(xyz1, *args):
        seen.append(("fp", xyz1.shape[1]))
        return real_fp(xyz1, *args)

    real_fp = sg.sharded_fp
    pointnet2.sharded_fps, sg.sharded_fp = fps, fp
    outs = []
    try:
        with torch.no_grad(), point_shard(mesh, min_points=min_points):
            for args in inputs:
                start = len(seen)
                logp = model(*map(_t, args))[0].numpy()
                outs.append((logp, seen[start:]))
    finally:
        pointnet2.sharded_fps, sg.sharded_fp = sharded_fps, real_fp
    return outs


def train_step(mesh, name, case, f64=True):
    """One train step of ``name`` on the global batch of ``case``, with
    augmentations, dropout and the random FPS start on (the draws seeded),
    data-parallel over ``mesh`` (None: one process). Returns the loss,
    accuracy, gradients and the state after the update."""
    if f64:
        torch.set_default_dtype(torch.float64)
    spec = get_model(name)
    model = init_params(spec.builder(**case["kwargs"]), 3)
    opt = make_optimizer(model.parameters(), "adam", 1e-4)
    g = torch.Generator().manual_seed(11)
    fg = torch.Generator().manual_seed(12)
    batch = {k: _t(v) for k, v in case["batch"].items()}
    step = steps.make_train_step(
        model, spec.loss, opt, spec.task, augment_names=case["augs"],
        generator=g, fps_generator=fg, num_category=4, mesh=mesh)
    m = step(batch, 1e-3, 0.1)
    return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()},
            "state": {k: v.numpy().copy()
                      for k, v in model.state_dict().items()}}


def _digest(state):
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def trainer_fit(mesh_unused, cfg_kwargs, log_dir):
    """``Trainer.fit`` of ``cfg_kwargs`` in the initialised world (the
    Trainer picks its data-parallel ranks); returns the result, whether the
    rank was idle, what it wrote and its final state."""
    cfg = TrainConfig(device="cpu", log_dir=log_dir, **cfg_kwargs)
    tr = Trainer(cfg)
    try:
        init = _digest(tr.model.state_dict())
        res = tr.fit()
        out = {"result": res, "idle": tr.idle, "is_main": tr.is_main,
               "init": init,
               "run_dir": tr.run_dir, "has_ckpt": tr.ckpt is not None,
               "state": _digest(tr.model.state_dict()),
               "eval": tr.evaluate()}
        if not tr.idle:
            out["train_loss"] = tr.history[-1]["train"]["loss"]
            out["eval_loss"] = res["eval_loss"]
        return out
    finally:
        tr.close()


def trainer_resume(mesh_unused, cfg_kwargs, log_dir):
    """A resumed Trainer's restored state, step and generator state."""
    cfg = TrainConfig(device="cpu", log_dir=log_dir, resume=True,
                      **cfg_kwargs)
    tr = Trainer(cfg)
    try:
        return {"step": tr.step, "start_epoch": tr.start_epoch,
                "state": _digest(tr.model.state_dict()),
                "opt": tr.optimizer.state_dict()["state"][0]["exp_avg"]
                .numpy().copy(),
                "generator": tr.generator.get_state().numpy().copy()}
    finally:
        tr.close()


def test_cli(mesh_unused, argv):
    """``python -m mm3d_tpu_torch.test`` on this rank of the initialised
    world (what ``torchrun`` starts), as its ``main``."""
    from mm3d_tpu_torch import test as test_cli_main
    return test_cli_main.main(argv)
