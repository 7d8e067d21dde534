"""Where the time of serving and of training goes on the card.

Counterpart of ``mm3d_tpu/utils/profiling.py``. Views of the eval forward
served by ``make_predictor`` (``--mode serve``) and of one train step of
``steps.make_train_step`` (``--mode train``), each for one of ``MODELS``
(every registered model but the attention-head variants):

* ``stage_times`` -- CUDA events at the start and end of each stage of the
  model, recorded by forward hooks: for ``fusion_cls`` SA1, SA2, SA3 and the
  image CNN, the rest of the forward (concat, FC head, log-softmax) being
  the total less the stages; for ``fusion_sem_seg`` SA1, SA2, FP2, FP1, the
  image CNN, projection + sampling (from the CNN's end to the head's start,
  the fusion included) and the head (head MLP to log-softmax); for the
  PointNet++ classifiers SA1, SA2, SA3 and the head (fc1 to log-softmax),
  and in serving the kNN selection inside SA1 and SA2 (``knn_sa1``,
  ``knn_sa2``, events around each ``ops.knn_point`` call); for the part-seg
  models SA1, SA2, SA3, FP3, FP2, FP1 and the head (head MLP to
  log-softmax); for the PointNet++ sem-seg models SA1 to SA4, FP4 to FP1
  and the head; for the PointNet models the input STN, the feature STN
  and the head (its first layer to log-softmax), the rest of the encoder
  being the total less the stages;
* ``train_stage_times`` -- the same for the train step's forward (for
  ``fusion_sem_seg`` the head MLP is a stage of its own), plus its backward:
  an event where each stage's backward starts (a backward pre-hook, when
  the gradient of the stage's output is ready; for ``fusion_sem_seg`` the
  sampling's backward starts when the head MLP's input gradient is ready;
  the head's backward is the span before the first stage's),
  each stage's span running to the next start (the image and point branches
  are independent, so the engine may interleave them), and the
  augmentation and optimizer step;
* ``kernel_table`` -- ``torch.profiler`` over a few calls: device time by
  kernel name, and the share of the window in which the device ran no
  kernel.

Run on one card from the repository root::

    python -m mm3d_tpu_torch.utils.profiling [--mode serve|train]
        [--dtype bfloat16|float32] [--model NAME]

Serving ``fusion_cls`` takes B=128 clouds of 1024 points with 64x64 images
and 40 classes, the classifiers the same clouds without images; serving
``fusion_sem_seg`` B=16 synthetic S3DIS-style blocks of 2048 points with
their 64x64 rendered views and cameras and 13 classes; serving a sem-seg
model B=16 such blocks of 4096 points without the views; serving a
part-seg model B=16 synthetic ShapeNetPart-style clouds of 2048 points
with their categories (16, 50 parts); training B=24 of the same inputs
(random seeded weights, seeded inputs; each task's augmentations). It prints one JSON line and writes it to
``profile_<mode>_<model>_<dtype>.json`` in the ``--out`` directory. It fails
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def stage_times(model: torch.nn.Module, call: Callable[[], object],
                spans: Dict[str, tuple], reps: int = 10) -> Dict[str, float]:
    """Median device ms of each span of a forward, 'total' and 'rest'.

    ``spans``: name -> (start, end), each point a (module, "start" | "end")
    pair: a forward pre-hook or forward hook of the module records a CUDA
    event there. 'rest' is the total less the spans."""
    points = {p for span in spans.values() for p in span}
    marks: Dict[tuple, list] = {p: [] for p in points}
    handles = []
    for mod, kind in points:
        rec = (lambda *a, p=(mod, kind): marks[p].append(_event()))
        handles.append(mod.register_forward_pre_hook(rec) if kind == "start"
                       else mod.register_forward_hook(rec))
    totals = []
    try:
        call()  # warm-up
        for v in marks.values():
            v.clear()
        for _ in range(reps):
            e0 = _event()
            call()
            totals.append((e0, _event()))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {n: float(np.median([a.elapsed_time(b) for a, b in
                               zip(marks[s], marks[e])]))
           for n, (s, e) in spans.items()}
    out["total"] = float(np.median([a.elapsed_time(b) for a, b in totals]))
    out["rest"] = out["total"] - sum(out[n] for n in spans)
    return out


@contextlib.contextmanager
def timed_calls(owner, attr: str):
    """Replace ``owner.attr`` with a wrapper that records a CUDA event
    before and after each call; yields the list of (start, end) pairs."""
    fn = getattr(owner, attr)
    pairs = []

    def wrapper(*args, **kwargs):
        e0 = _event()
        out = fn(*args, **kwargs)
        pairs.append((e0, _event()))
        return out

    setattr(owner, attr, wrapper)
    try:
        yield pairs
    finally:
        setattr(owner, attr, fn)


MODELS = ("fusion_cls", "fusion_sem_seg", "pointnet_cls",
          "pointnet_part_seg", "pointnet_part_seg_lineage", "pointnet_sem_seg",
          "pointnet2_cls_knn", "pointnet2_cls_msg", "pointnet2_cls_ssg",
          "pointnet2_part_seg_msg", "pointnet2_part_seg_ssg",
          "pointnet2_sem_seg", "pointnet2_sem_seg_msg")


def _head(model: torch.nn.Module) -> torch.nn.Module:
    """The first module of the head of a model without an image branch."""
    for name in ("head_mlp", "fc1", "convs1"):
        if hasattr(model, name):
            return getattr(model, name)
    raise ValueError(f"no head in {type(model).__name__}")


def _stns(model: torch.nn.Module):
    """A PointNet model's input and feature STNs, or None."""
    enc = getattr(model, "feat", model)
    if not hasattr(enc, "stn"):
        return None
    return enc.stn, enc.fstn


def serve_spans(model: torch.nn.Module) -> Dict[str, tuple]:
    """The stages ``stage_times`` reads for a FusionCls, FusionSemSeg,
    PointNet, PointNet++ classifier, part-seg or sem-seg model."""
    def whole(m):
        return ((m, "start"), (m, "end"))

    stns = _stns(model)
    if stns is not None:  # the PointNet models
        return {"stn": whole(stns[0]), "fstn": whole(stns[1]),
                "head": ((_head(model), "start"), (model, "end"))}
    if hasattr(model, "fp4"):  # the PointNet++ sem-seg models
        return {**{n: whole(getattr(model, n))
                   for n in ("sa1", "sa2", "sa3", "sa4", "fp4", "fp3", "fp2",
                             "fp1")},
                "head": ((model.head_mlp, "start"), (model, "end"))}
    if hasattr(model, "fp3"):  # the part-seg models
        return {**{n: whole(getattr(model, n))
                   for n in ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")},
                "head": ((model.head_mlp, "start"), (model, "end"))}
    if not hasattr(model, "point_trunk"):  # PointNet2ClsSSG
        return {"sa1": whole(model.sa1), "sa2": whole(model.sa2),
                "sa3": whole(model.sa3),
                "head": ((model.fc1, "start"), (model, "end"))}
    pt = model.point_trunk
    if hasattr(pt, "fp1"):  # FusionSemSeg
        return {"sa1": whole(pt.sa1), "sa2": whole(pt.sa2),
                "fp2": whole(pt.fp2), "fp1": whole(pt.fp1),
                "image": whole(model.image_trunk),
                "sampling": ((model.image_trunk, "end"),
                             (model.head_mlp, "start")),
                "head": ((model.head_mlp, "start"), (model, "end"))}
    return {"sa1": whole(pt.sa1), "sa2": whole(pt.sa2),
            "sa3": whole(pt.sa3), "image": whole(model.image_trunk)}


def _train_stages(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The modules whose forward and backward ``train_stage_times`` marks."""
    stns = _stns(model)
    if stns is not None:  # the PointNet models
        return {"stn": stns[0], "fstn": stns[1]}
    if hasattr(model, "fp4"):  # the PointNet++ sem-seg models
        return {n: getattr(model, n) for n in ("sa1", "sa2", "sa3", "sa4",
                                               "fp4", "fp3", "fp2", "fp1")}
    if hasattr(model, "fp3"):  # the part-seg models
        return {n: getattr(model, n)
                for n in ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")}
    if not hasattr(model, "point_trunk"):  # PointNet2ClsSSG
        return {"sa1": model.sa1, "sa2": model.sa2, "sa3": model.sa3}
    pt = model.point_trunk
    if hasattr(pt, "fp1"):  # FusionSemSeg
        return {"sa1": pt.sa1, "sa2": pt.sa2, "fp2": pt.fp2, "fp1": pt.fp1,
                "image": model.image_trunk, "head_mlp": model.head_mlp}
    return {"sa1": pt.sa1, "sa2": pt.sa2, "sa3": pt.sa3,
            "image": model.image_trunk}


def train_stage_times(model: torch.nn.Module,
                      optimizer: torch.optim.Optimizer,
                      step: Callable[[], object],
                      reps: int = 10) -> Dict[str, float]:
    """Median device ms of one train step by part: 'augment'; the forward
    stages as in ``stage_times`` ('fwd_*'; for a FusionSemSeg also
    'fwd_sampling', from the CNN's end to the head MLP's start); the
    backward from its start to the first stage's backward ('bwd_head') and
    each stage's backward ('bwd_*', 'bwd_sampling' from the head MLP's input
    gradient to the CNN's output gradient); 'optimizer'; and 'total'.
    ``step`` must run the model once, the backward and ``optimizer.step``
    (a step of ``steps.make_train_step`` does)."""
    stages = _train_stages(model)
    semseg = "image" in stages and "fp1" in stages  # FusionSemSeg
    marks: Dict[str, list] = {}

    def mark(name):
        marks.setdefault(name, []).append(_event())

    handles = [
        model.register_forward_pre_hook(lambda m, a: mark("fwd_start")),
        model.register_forward_hook(lambda m, a, o: mark("fwd_end")),
        model.register_full_backward_pre_hook(lambda m, g: mark("bwd_start")),
        optimizer.register_step_pre_hook(lambda o, a, k: mark("opt_start")),
        optimizer.register_step_post_hook(lambda o, a, k: mark("opt_end"))]
    for name, mod in stages.items():
        handles += [
            mod.register_forward_pre_hook(
                lambda m, a, name=name: mark(f"fwd_{name}_start")),
            mod.register_forward_hook(
                lambda m, a, o, name=name: mark(f"fwd_{name}_end")),
            mod.register_full_backward_pre_hook(
                lambda m, g, name=name: mark(f"bwd_{name}"))]
    # the models without an image branch: the head, from its first layer
    # on, is a forward span too
    head = None if hasattr(model, "point_trunk") else _head(model)
    if head is not None:
        handles.append(head.register_forward_pre_hook(
            lambda m, a: mark("fwd_head_start")))
    bwd_names = list(stages)
    if semseg:
        handles.append(model.head_mlp.register_full_backward_hook(
            lambda m, gi, go: mark("bwd_sampling")))
        bwd_names.append("sampling")
    totals = []
    try:
        step()  # warm-up
        marks.clear()
        for _ in range(reps):
            e0 = _event()
            step()
            totals.append((e0, _event()))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()

    def med(a, b):
        return float(np.median([x.elapsed_time(y) for x, y in zip(a, b)]))

    out = {"augment": med([a for a, _ in totals], marks["fwd_start"])}
    for name in stages:
        out[f"fwd_{name}"] = med(marks[f"fwd_{name}_start"],
                                 marks[f"fwd_{name}_end"])
    fwd = [f"fwd_{n}" for n in stages]
    if semseg:
        out["fwd_sampling"] = med(marks["fwd_image_end"],
                                  marks["fwd_head_mlp_start"])
        fwd.append("fwd_sampling")
    if head is not None:
        out["fwd_head"] = med(marks["fwd_head_start"], marks["fwd_end"])
        fwd.append("fwd_head")
    out["fwd_total"] = med(marks["fwd_start"], marks["fwd_end"])
    out["fwd_rest"] = out["fwd_total"] - sum(out[k] for k in fwd)
    # per step, order the stages' backward starts in time; a stage runs to
    # the next start, the last one to the optimizer's start
    spans: Dict[str, list] = {f"bwd_{n}": [] for n in ("head", *bwd_names)}
    for i in range(reps):
        t0 = marks["bwd_start"][i]
        starts = sorted((t0.elapsed_time(marks[f"bwd_{n}"][i]), n)
                        for n in bwd_names)
        starts.append((t0.elapsed_time(marks["opt_start"][i]), None))
        spans["bwd_head"].append(starts[0][0])
        for (t, n), (t_next, _) in zip(starts, starts[1:]):
            spans[f"bwd_{n}"].append(t_next - t)
    out.update({k: float(np.median(v)) for k, v in spans.items()})
    out["bwd_total"] = med(marks["bwd_start"], marks["opt_start"])
    out["optimizer"] = med(marks["opt_start"], marks["opt_end"])
    out["total"] = med([a for a, _ in totals], [b for _, b in totals])
    return out


def _profile(call: Callable[[], object], reps: int):
    """torch.profiler over ``reps`` calls after one warm-up -> (the device
    events, host wall us)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device work only: not the ranges that annotate host calls on the
    # device timeline (e.g. "Optimizer.step#Adam.step")
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return events, wall_us


def device_kernels(call: Callable[[], object], reps: int = 10
                   ) -> Dict[str, Tuple[float, int]]:
    """The device work of one call of ``call``, by kernel (or copy) name:
    (ms a call, launches a call), from torch.profiler over ``reps`` calls,
    the host's launch time excluded.

    A name's ms is its mean duration times its launches a call (its count
    over ``reps``, rounded up): every call puts the same work on the card,
    and the profiler can drop an activity record (seen on the card: one in
    forty, and a window read 14x low), which then moves neither the mean
    nor the count a call. With no record lost the sum over names is the
    plain sum over ``reps``. A window in which the profiler recorded no
    device work at all (seen on the card once in a few hundred windows, and
    once three windows running) is taken again after a pause that grows by
    a quarter second each time, five times at most; then it raises."""
    for attempt in range(6):
        events, _ = _profile(call, reps)
        if events:
            break
        time.sleep(0.25 * (attempt + 1))
    else:
        raise RuntimeError("device_kernels: the profiler recorded no device "
                           "work")
    by_name: Dict[str, list] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    out = {}
    for name, d in by_name.items():
        per_call = math.ceil(len(d) / reps)
        out[name] = (float(np.mean(d)) * per_call / 1e3, per_call)
    return out


def kernel_table(call: Callable[[], object], reps: int = 3,
                 top: int = 15) -> dict:
    """Device time by kernel over ``reps`` calls, and the idle share."""
    events, wall_us = _profile(call, reps)
    by_name: Dict[str, list] = {}
    spans = []
    for e in events:
        spans.append((e.time_range.start, e.time_range.end))
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):  # union of kernel intervals
        if t > end:
            busy += t - max(s, end)
            end = t
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "calls": reps,
        "wall_ms_per_call": wall_us / reps / 1e3,
        "device_busy_ms_per_call": busy / reps / 1e3 if spans else None,
        "device_idle_share": 1.0 - busy / wall_us if spans else None,
        "kernel_launches_per_call": sum(c for _, c in by_name.values()) / reps,
        "top_kernels": [{"name": n[:120], "ms_per_call": us / reps / 1e3,
                         "launches_per_call": c / reps}
                        for n, (us, c) in kernels[:top]],
    }


def _clouds(r: np.random.RandomState, B: int) -> np.ndarray:
    pts = r.randn(B, 1024, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    return pts


def nontrivial_bn(model: torch.nn.Module, seed: int = 1) -> None:
    """Random BN statistics, so the eval folds do real work."""
    from mm3d_tpu_torch.models.layers import BatchNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.normal_(0.0, 0.1, generator=g)
                m.var.uniform_(0.5, 1.5, generator=g)


def _serve(model_name: str, dtype, batch: int) -> dict:
    from mm3d_tpu_torch import ops
    from mm3d_tpu_torch.data.synthetic import (partseg_request,
                                               scene_request, semseg_request)
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import make_predictor

    spec = get_model(model_name)
    kw = ({} if spec.task == "partseg" else
          {"num_class": 13 if "semseg" in spec.task else 40})
    model = init_params(spec.builder(**kw), 0)
    nontrivial_bn(model)
    pred = make_predictor(model_name, model.state_dict(), device="cuda",
                          dtype=dtype, **kw)
    r = np.random.RandomState(0)
    if model_name == "fusion_sem_seg":
        arrays = semseg_request(batch)
    elif spec.task == "partseg":
        arrays = partseg_request(batch)[:2]  # points, one-hot
    elif spec.task == "semseg":
        arrays = scene_request(batch)[:1]
    elif spec.task == "classification":
        arrays = [_clouds(r, batch)]
    else:
        arrays = [_clouds(r, batch), r.rand(batch, 64, 64, 3).astype(
            np.float32)]
    inputs = [torch.from_numpy(a).cuda() for a in arrays]

    def call():
        return pred(*inputs)

    reps = 10
    with timed_calls(ops, "knn_point") as knn:
        stage = stage_times(pred.model, call, serve_spans(pred.model), reps)
    if knn:  # two selections a forward, SA1's then SA2's, in the timed reps
        torch.cuda.synchronize()
        timed = knn[-2 * reps:]
        for i, name in enumerate(("knn_sa1", "knn_sa2")):
            stage[name] = float(np.median([a.elapsed_time(b)
                                           for a, b in timed[i::2]]))
    return {"stage_ms": stage, "profile": kernel_table(call)}


def _train(model_name: str, dtype, batch: int) -> dict:
    from mm3d_tpu_torch.data.augment import TASK_PIPELINES
    from mm3d_tpu_torch.data.synthetic import (partseg_request,
                                               scene_request, semseg_request)
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import steps
    from mm3d_tpu_torch.training.state import make_optimizer

    spec = get_model(model_name)
    ncls = 13 if "semseg" in spec.task else 40
    kw = {} if spec.task == "partseg" else {"num_class": ncls}
    model = init_params(spec.builder(dtype=dtype, **kw), 0).cuda()
    opt = make_optimizer(model.parameters(), "adam", 1e-4)
    step = steps.make_train_step(
        model, spec.loss, opt, spec.task,
        augment_names=TASK_PIPELINES[spec.task],
        generator=torch.Generator("cuda").manual_seed(1))
    r = np.random.RandomState(0)
    if model_name == "fusion_sem_seg":
        names = ("points", "image", "K", "R", "t")
        arrays = dict(zip(names, semseg_request(batch)))
        arrays["seg"] = r.randint(0, ncls, arrays["points"].shape[:2]
                                  ).astype(np.int32)
    elif spec.task == "partseg":
        points, _, cat, seg = partseg_request(batch)
        arrays = {"points": points, "cat": cat, "seg": seg}
    elif spec.task == "semseg":
        arrays = dict(zip(("points", "seg"), scene_request(batch)))
    elif spec.task == "classification":
        arrays = {"points": _clouds(r, batch),
                  "label": r.randint(0, ncls, batch).astype(np.int32)}
    else:
        eye = np.eye(3, dtype=np.float32)
        arrays = {
            "points": _clouds(r, batch),
            "image": r.rand(batch, 64, 64, 3).astype(np.float32),
            "K": np.broadcast_to(eye * 32, (batch, 3, 3)).copy(),
            "R": np.broadcast_to(eye, (batch, 3, 3)).copy(),
            "t": np.tile(np.array([0, 0, 3], np.float32), (batch, 1)),
            "label": r.randint(0, ncls, batch).astype(np.int32)}
    batch_ = {k: torch.from_numpy(a).cuda() for k, a in arrays.items()}

    def call():
        return step(batch_, 1e-3, 0.1)

    return {"stage_ms": train_stage_times(model, opt, call),
            "profile": kernel_table(call)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("serve", "train"), default="serve")
    p.add_argument("--model", choices=MODELS, default="fusion_cls")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--batch", type=int, default=None,
                   help="default: 128 serving a cloud classifier, 16 "
                        "serving a segmentation model, 24 training")
    p.add_argument("--out", default="chiprun_out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device; this runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    if args.mode == "serve":
        batch = args.batch or (16 if "seg" in args.model else 128)
        run = _serve(args.model, dtype, batch)
    else:
        batch = args.batch or 24
        run = _train(args.model, dtype, batch)
    result = {"card": card, "mode": args.mode, "model": args.model,
              "dtype": args.dtype, "batch": batch, **run}
    os.makedirs(args.out, exist_ok=True)
    name = f"profile_{args.mode}_{args.model}_{args.dtype}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
