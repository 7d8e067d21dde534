"""Multi-rank dry run of the port's parallel paths (counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``)::

    python -m mm3d_tpu_torch.parallel.dryrun N [--device cpu|cuda]
        [--backend gloo|nccl]

spawns N ranks (``parallel.launch.run_ranks``) and makes the JAX dry run's
checks on them:

* a data-parallel fusion_cls train step with the fusion_cls augmentations
  (B = 2N clouds of 64 points, 16x16 views, 4 classes) and a
  data-parallel pointnet2_sem_seg train step (B = 2N blocks of 128
  points): finite losses;
* sharded FPS, ball query and kNN on 2 clouds of 2,048 points, 512
  centroids: equal to the single-process ops (the kernels on the card, the
  plain ops on the CPU);
* both sharded SA tails within 1e-5 of the single-process composition;
* point-sharded pointnet2_sem_seg (2 x 2,048 points) and
  pointnet2_sem_seg_msg (1 x 2,048) eval forwards, ``min_points`` 1024,
  within 1e-5 of the single-process forward with the same weights.

Rank 0 prints one line in the style of JAX's. The device defaults to the
card and the backend to ``nccl`` there (``gloo`` on the CPU); NCCL takes one
rank a card, so N ranks sharing one card need ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _ranks(mesh, device: str):
    import torch

    from mm3d_tpu_torch import ops
    from mm3d_tpu_torch.data import augment as aug
    from mm3d_tpu_torch.data import synthetic as syn
    from mm3d_tpu_torch.data.pipeline import _collate
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.parallel import point_shard
    from mm3d_tpu_torch.parallel import sharded_group as sg
    from mm3d_tpu_torch.parallel.sharded_fps import sharded_fps
    from mm3d_tpu_torch.training import steps
    from mm3d_tpu_torch.training.state import make_optimizer

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = mesh.world_size
    B = 2 * n

    def train_loss(name, batch, task_augs, **kw):
        spec = get_model(name)
        model = init_params(spec.builder(**kw), 0).to(dev)
        step = steps.make_train_step(
            model, spec.loss, make_optimizer(model.parameters(), "adam"),
            spec.task, augment_names=task_augs,
            generator=torch.Generator(dev).manual_seed(7), mesh=mesh)
        loss = float(step({k: v.to(dev) for k, v in batch.items()},
                          1e-3, 0.1)["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"{name} data-parallel step: loss {loss}")
        return loss

    r = np.random.RandomState(0)
    fusion = {"points": torch.from_numpy(
        r.randn(B, 64, 3).astype(np.float32) * 0.5),
        "image": torch.from_numpy(r.rand(B, 16, 16, 3).astype(np.float32)),
        "K": torch.eye(3).expand(B, 3, 3) * 8.0,
        "R": torch.eye(3).expand(B, 3, 3).contiguous(),
        "t": torch.tensor([0.0, 0.0, 3.0]).expand(B, 3).contiguous(),
        "label": torch.from_numpy(r.randint(0, 4, B).astype(np.int32))}
    loss = train_loss("fusion_cls", fusion, aug.TASK_PIPELINES["fusion_cls"],
                      num_class=4)
    ds = syn.SyntheticIndoorScene(npoints=128, size=B, seed=1)
    sem_loss = train_loss("pointnet2_sem_seg",
                          _collate([ds[i] for i in range(B)]), (),
                          num_class=13)

    # point-axis paths at 2,048 points, 512 centroids
    xyz = torch.from_numpy(r.randn(2, 2048, 3).astype(np.float32)
                           * 0.5).to(dev)
    idx = sharded_fps(xyz, 512, mesh)
    exact = {"fps": torch.equal(idx, ops.farthest_point_sample(xyz, 512))}
    cents = ops.index_points(xyz, idx)
    bq = sg.sharded_ball_query(0.3, 16, xyz, cents, mesh)
    bq_ref = ops.query_ball_point(0.3, 16, xyz, cents)
    exact["ball_query"] = torch.equal(bq, bq_ref)
    kn = sg.sharded_knn_point(16, xyz, cents, mesh)
    kn_ref = ops.knn_point(16, xyz, cents)
    exact["knn"] = torch.equal(kn, kn_ref)

    def t(*shape, scale=1.0):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)
                                * scale).to(dev)

    pre, cb = t(2, 2048, 16), t(2, 512, 16)
    w = (t(16, 16, scale=0.3), t(16), t(16, 32, scale=0.3), t(32))
    tails = {
        "sa_tail": (sg.sharded_sa_group_max(0.3, 16, xyz, cents, pre, cb,
                                            *w, mesh),
                    ops.fused_sa_idx_torch(16, bq_ref, pre, cb, *w)),
        "knn_tail": (sg.sharded_idx_group_max(kn_ref, pre, cb, *w, mesh),
                     ops.fused_sa_idx_torch(16, kn_ref, pre, cb, *w))}
    for k, (got, want) in tails.items():
        exact[k] = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))

    errs = {}
    for name, batch in (("pointnet2_sem_seg", 2),
                        ("pointnet2_sem_seg_msg", 1)):
        model = init_params(get_model(name).builder(num_class=13),
                            3).to(dev).eval()
        pts = t(batch, 2048, 9)
        with torch.no_grad():
            ref = model(pts)[0]
            with point_shard(mesh, min_points=1024):
                got = model(pts)[0]
        errs[name] = float((got - ref).abs().max())
    return {"loss": loss, "semseg_loss": sem_loss, "exact": exact,
            "errs": errs, "backend": (str(torch.distributed.get_backend())
                                        if mesh.group is not None
                                        else None)}


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks to spawn")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl with --device cuda, gloo with cpu")
    p.add_argument("--timeout", type=float, default=600.0)
    a = p.parse_args(argv)
    import torch
    from mm3d_tpu_torch.parallel.launch import run_ranks
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    out = run_ranks(_ranks, a.n, (a.device,), backend=backend,
                    timeout=a.timeout)[0]
    bad = [k for k, ok in out["exact"].items() if not ok]
    bad += [k for k, e in out["errs"].items() if not e <= 1e-5]
    if bad:
        raise SystemExit(f"dryrun({a.n}): diverged: {bad} {out}")
    line = (f"dryrun_multichip({a.n}): loss={out['loss']:.4f} "
            f"semseg_loss={out['semseg_loss']:.4f} "
            f"mesh={{'data': {a.n}, 'model': 1}} "
            f"backend={out['backend']} device={a.device} "
            f"point_sharded_fps=exact point_sharded_ball_query=exact "
            f"point_sharded_knn=exact point_sharded_sa_tail=exact "
            f"point_sharded_knn_tail=exact "
            f"point_sharded_model_fwd_maxerr="
            f"{out['errs']['pointnet2_sem_seg']:.2e} "
            f"point_sharded_msg_fwd_maxerr="
            f"{out['errs']['pointnet2_sem_seg_msg']:.2e}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
