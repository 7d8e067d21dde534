#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mm3d_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

What it does, failing (non-zero exit, no result line) at the first phase
that goes wrong:

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels of mm3d_tpu_torch/csrc from source, printing the build seconds;
2. holds each kernel against its plain PyTorch twin (``use_impl("torch")``)
   on the card at the shapes of the serving and training paths: FPS and
   ball query bit-exact (timed at SA1, SA2 and fusion_sem_seg's shapes;
   FPS also at N one below and one above each of its launcher's
   boundaries, at 4,096 and 16,384 points and with duplicated points tied
   across warps; the ball query with the K-th hit at the edges of its
   rounds, K = 128, every point a hit, d2 == r2 exactly, a ragged N, a
   cloud too large for shared memory and rows too long for it), the fused
   SA tail (SA1, SA2 and zero-hit
   centroids), the given-index fused SA tail (SA1 and SA2 over the indices
   of knn_point, plus a row of repeated indices at K=48), both forms at the
   other widths the JAX models route to the fused tail (config 3's
   (128,196,256) at K=128, the segmentation models' sa4 blocks, whose
   weights stream through shared memory, and (16,16,32) at K=16; bf16, and
   f32 where its plan fits), a bf16 width only the loop kernel holds
   ((32,640,64)), the ball-query form at K=256 and K=200 (and K=256 at
   (64,128,512), weights streamed), the gather backward, the fused
   FP tail (fusion_sem_seg's FP2 and FP1, plus tie cases) and the bilinear
   image sampling within the stated tolerances (the gather backward also
   bit-identical across two launches and bit for bit equal to its twin run
   on the host copies, in f32 and bf16); at fusion_sem_seg's training
   shapes (B=24 blocks of 2048 points) three_nn and three_interpolate
   bit-exact (tie cases included), the backwards of three_interpolate and
   of the sampling against autograd of the plain path, and the weighted
   gather-backward launch each of them makes, captured and held to the
   host twin bit for bit and timed alone. It times the kernel, its
   plain twin and, where one PyTorch call computes the same function, that
   call: the device time per call from torch.profiler (``ms``, ``plain_ms``,
   ``library_ms``, the numbers of the kernels line) and CUDA events around
   a call (``*call_ms``, the host's launch time included); knn_point, the
   plain selection ahead of the given-index kernel, is timed beside it.
   At config 3's shapes (pointnet2_part_seg_msg), each timed: FPS 2,048 ->
   512 and 512 -> 128, the ball query (bit-exact) and the ball-query fused
   SA tail (bf16 and f32) at the five MSG scales (K = 32, 64, 128 over 2,048
   points; K = 64, 128 over 512; widths up to (128,196,256)), the fused FP
   tail at FP2 and FP1 (bf16, f32), and at B=24 three_nn, three_interpolate
   and its backward at FP2 and FP1 and the gather backward of each scale.
   At the sem-seg tops' shapes (S3DIS-style blocks of 4,096 points), each
   timed: FPS 4,096 -> 1,024 (and the three levels below it, untimed), the
   ball query and the ball-query fused SA tail (bf16 and f32, with its tile
   plan) at sa1 of pointnet2_sem_seg and of pointnet2_sem_seg_msg, the fused
   FP tail at FP1 (M = 1,024 over N = 4,096) and FP4 (M = 16 over N = 64),
   each with its launch plan, and at B=24 three_nn, three_interpolate and
   its backward at FP1 and the gather backward of sa1's gather;
3. serves fusion_cls through ``make_predictor`` at full width (B=128 clouds
   of 1024 points, 64x64 images, 40 classes, random seeded weights) in bf16
   and fp32: 3 requests each with the launch counts reset just before, then
   checks shapes, finiteness, fp32 parity of the kernels path with the plain
   path, bf16-vs-fp32 agreement, and measures clouds/s;
3b. serves fusion_sem_seg (config 5) the same way at full width: B=16
   synthetic S3DIS-style blocks of 2048 9-dim points with their 64x64
   rendered views and cameras, 13 classes; checks per-point log-probs
   (shape, finiteness, normalisation), the launches per forward, fp32
   kernels-vs-plain parity, bf16-vs-fp32 per-point argmax agreement and the
   share of points the camera sees, and measures clouds/s and points/s;
3c. serves pointnet2_cls_knn and pointnet2_cls_ssg (config 2) the same way
   at B=128 unit-sphere clouds of 1024 points, 40 classes: 3 requests each
   in bf16 and fp32, the launches per forward (kNN bf16: FPS and the
   given-index fused SA twice each; fp32: FPS twice; SSG bf16: FPS and the
   fused SA twice each; fp32: FPS and ball query twice each), fp32
   kernels-vs-plain parity, bf16-vs-fp32 agreement, ms per forward and
   clouds/s;
3d. serves pointnet2_part_seg_msg (config 3) at full width: B=16
   ShapeNetPart-style clouds of 2,048 points with their one-hot categories,
   50 parts, 3 requests in bf16 and fp32: per-point log-probs (shape,
   finiteness, normalisation), the launches per forward (FPS twice; bf16
   the fused SA tail a scale, five; fp32 the ball query a scale; the fused
   FP tail twice), fp32 kernels-vs-plain parity, bf16-vs-fp32 agreement of
   the category-masked argmax per point, ms per forward, clouds/s and
   points/s; pointnet2_part_seg_ssg the same with one request per dtype;
3e. serves config 1 and the PointNet tops, which launch no kernel (checked):
   pointnet_cls at B=128 unit-sphere clouds of 1,024 points, 40 classes, 3
   requests in bf16 and fp32 (as 3c); pointnet_part_seg and
   pointnet_part_seg_lineage at B=16 x 2,048 (as 3d, 1 request);
   pointnet_sem_seg at B=16 S3DIS-style blocks of 4,096 9-dim points, 13
   classes, 1 request: shapes, finiteness, normalisation, bf16-vs-fp32
   agreement (per cloud, or per point, category-masked for part-seg), ms
   per forward, clouds/s and peak memory;
3f. serves pointnet2_sem_seg (B=16 x 4,096, 3 requests a dtype),
   pointnet2_sem_seg_msg (1 request) and pointnet2_cls_msg (B=128 x 1,024,
   1 request) the same way: the launches per forward (sem-seg: FPS four
   times, bf16 the fused SA tail a scale, fp32 the ball query a scale, the
   fused FP tail four times; cls_msg: FPS twice and six scales), fp32
   kernels-vs-plain parity, bf16-vs-fp32 agreement, ms, clouds/s,
   points/s and peak memory;
3g. exports fusion_cls (bf16 and fp32), pointnet2_cls_knn (bf16) and
   fusion_sem_seg (bf16) from make_predictor at the widths of 3-3c
   (random seeded weights) into serving artifacts (``export_serving``,
   ``save_serving``): each graph must hold the ``mm3d::*`` operator nodes
   of one forward's launches. Each artifact is loaded into a fresh
   ``PredictionService``, warmed and served by ``make_server`` on
   loopback: requests at B = the artifact's batch, batch + 72 (chunked,
   wrap-padded) and 1, their log-probs held to make_predictor's on the
   same chunks (fp32 max|d| <= 1e-5, bf16 argmax agreement 1.0); 4
   concurrent clients x those 3 requests must get the serial answers bit
   for bit; /metrics must count the requests; an oversize body must get
   413; the launch counts while serving must be the graph's nodes a
   forward (and all six operators must run over the phase). Prints export
   and load + warmup seconds, the artifact's and make_predictor's ms a
   forward (CUDA events) and the HTTP p50 latency;
4. trains fusion_cls at full width (B=24 clouds, the trainer's default), in
   fp32 with TF32 off and then in bf16 mixed precision: one step on the
   kernel path against one on the plain path from the same state and batch
   (loss, every gradient, BN statistics), the launches of one step, of a BN
   refresh and of an eval forward, ten steps on one batch (the loss must
   fall), one epoch of ``Trainer.fit`` on synthetic data (the main path: its
   launch counts are reset just before and read just after), and the median
   step time, clouds/s and peak memory;
4b. trains fusion_sem_seg (config 5) at full width the same way: B=24
   synthetic S3DIS-style blocks of 2048 points with 64x64 views and 13
   classes, the calib-aware Z rotation and dropout 0.5, fp32 with TF32 off
   then bf16: kernel-vs-plain step parity, the launches of one step (three_nn
   and three_interpolate twice, the gather backward five times), of a BN
   refresh and of an eval forward, the median step time, clouds/s, points/s
   and peak memory, and one short epoch of ``Trainer.fit`` (the main path)
   that ends in an eval with a finite mIoU;
4c. trains pointnet2_cls_knn the same way (B=24 SyntheticModelNet clouds,
   no image, the cls augmentations and dropout 0.4): kernel-vs-plain step
   parity, launches per step (FPS and the gather backward twice each, no
   ball query), step time, clouds/s, peak memory and one epoch of
   ``Trainer.fit``;
4d. trains pointnet2_part_seg_msg the same way (B=24 clouds of 2,048
   points, random scale and shift, dropout 0.5): kernel-vs-plain step
   parity, the launches of one step (FPS twice, the ball query and the
   gather backward five times, three_nn and three_interpolate twice and the
   interpolation's two weighted gather backwards), of a BN refresh and of
   an eval forward, ten steps on one batch, step time, clouds/s, points/s,
   peak memory and one short epoch of ``Trainer.fit`` ending in an eval
   with its instance and class mIoU;
4e. trains pointnet_cls (config 1) as phase 4 does (B=24 clouds): no
   kernel launch a step, the feature-transform regulariser's term finite,
   ten steps on one batch, step time, clouds/s, peak memory and one epoch
   of ``Trainer.fit``;
4f. trains pointnet2_sem_seg as phase 4d does (B=24 blocks of 4,096 points,
   the Z rotation, dropout 0.5): the kernel step against the deterministic
   plain step, the launches of one step (FPS and the ball query four times,
   three_nn and three_interpolate four times, the gather backward eight
   times), of a BN refresh and of an eval forward, ten steps on one batch,
   step time, points/s, peak memory and one short epoch of
   ``Trainer.fit`` ending in an eval with its mIoU;
5. training completeness. 5a: fusion_cls at full width in bf16 mixed
   precision (B=24, 64x64 views, 4 steps an epoch, 2 eval batches), in
   deterministic mode: run A trains 2 epochs through ``Trainer.fit``; run B
   trains 1, then a new ``Trainer(resume=True, run_name=...)`` restores the
   newest checkpoint and trains the second. B's restored model, optimizer
   state, step and generator states must be bit-identical with what was
   saved; after epoch 2 A's and B's parameters, BN buffers, Adam moments,
   step and generators must be bit-identical, their metrics.jsonl equal
   but the epoch times, and each run's gather-backward launches 2 a step.
   Prints the checkpoint's bytes and the seconds a save and a restore take.
   5b: the four vote steps at V=3 (fusion_cls and pointnet2_cls_ssg at
   B=128 x 1024, pointnet2_part_seg_msg and fusion_sem_seg at B=16 x
   2048), bf16 and fp32 on the same draws: a vote step launches each
   kernel V times a serving forward's count; fp32 summed probabilities
   within 1e-4 of the plain path's and predictions equal wherever the
   top-two margin exceeds 1e-4; bf16 agreement with the fp32 vote >= 0.95;
   ms a vote step (CUDA events, median of 5 after 2 warm-ups). Every
   Trainer of phases 4-5a writes its run directory under one temporary
   directory, removed at the end;
6. the entry points, ``python -m mm3d_tpu_torch.train`` / ``.test``,
   through their ``main(argv)`` at full width, each call's launches
   counted from 0, on trees written under one temporary directory (removed
   at the end) in the canonical formats; the native parser and renderer
   must build from native/*.cpp. 6a: a multimodal ModelNet40 tree (40
   class folders, 72 train and 48 test shapes of 10,000 x,y,z,nx,ny,nz
   rows, 64x64 views); the train split parsed natively (shapes/s);
   fusion_cls trained 2 epochs in bf16 at B=24 (epoch seconds); ``test``
   in bf16 and fp32 with 3 votes, whose instance and vote accuracy must
   equal ``Trainer.evaluate`` and the vote steps on the run's best
   checkpoint in this process (seconds a vote pass); ``test --export`` in
   both dtypes, the artifact against make_predictor on one test batch
   (fp32 max|d| <= 1e-5, bf16 argmax agreement 1.0); and one ``python -m
   mm3d_tpu_torch.test`` in a new process. 6b: an S3DIS tree of four rooms
   of 500,000 points; a lineage .pth of pointnet2_sem_seg (imported bit for
   bit) fine-tuned one epoch at B=24 x 4,096; ``test --scene area`` (the
   two area-5 rooms) in bf16, fp32 and fp32 on the plain path: coverage
   equal, fp32 kernel vs plain predictions equal past a 1e-3 top-two
   margin and point_acc / mIoU within 1e-3, no launch on the plain path,
   bf16 vs fp32 per-point agreement >= 0.95; blocks a room, seconds a room,
   points/s; one room's predictions rendered to a PNG natively. 6c:
   fusion_sem_seg trained one short epoch, then ``test --scene synthetic``
   on a 500,000-point room in bf16 and fp32 (the bilinear kernel on the
   CLI path): coverage equal, agreement >= 0.95. 6d: pointnet2_cls_knn on
   the 6a tree's points, one epoch and a bf16 ``test`` (the given-index
   fused SA on a CLI path);
7. prints the ``{"kernels": [...]}`` line, then, last, the
   ``{"ok": true, "device": ...}`` line.

It imports nothing of JAX or of the JAX package. The details also go to
chiprun_out/chip_smoke.json.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, NPOINT, IMAGE_HW, NUM_CLASS = 128, 1024, (64, 64), 40
TRAIN_BATCH = 24  # TrainConfig's default batch
# fusion_sem_seg serving: 16 blocks of the registry's 2048 points (32,768
# points per request), TrainConfig's 64x64 views, S3DIS's 13 classes
SEG_BATCH, SEG_NPOINT, SEG_CLASSES = 16, 2048, 13
TRAIN_SIZE, TEST_SIZE = 240, 48  # one epoch of 10 steps, 2 eval batches
# fusion_sem_seg training: TrainConfig's batch of the registry's 2048-point
# blocks; one short epoch of 3 steps and 1 eval batch
SEG_TRAIN_SIZE, SEG_TEST_SIZE = 72, 24
# config 3 (pointnet2_part_seg_msg): 16 ShapeNetPart-style clouds of the
# registry's 2048 points a request, 16 categories, 50 parts; training at
# TrainConfig's batch, one short epoch of 3 steps and 1 eval batch
PART_BATCH, PART_NPOINT, PART_CATS, PART_PARTS = 16, 2048, 16, 50
PART_TRAIN_SIZE, PART_TEST_SIZE = 72, 24
# the sem-seg tops (pointnet_sem_seg, pointnet2_sem_seg and
# pointnet2_sem_seg_msg): 16 S3DIS-style blocks of the registry's 4,096
# 9-dim points a request, 13 classes; training pointnet2_sem_seg at
# TrainConfig's batch, one short epoch of 3 steps and 1 eval batch
SCENE_BATCH, SCENE_NPOINT = 16, 4096
SCENE_TRAIN_SIZE, SCENE_TEST_SIZE = 72, 24
# H100 SXM published peaks (NVIDIA H100 data sheet):
# device memory rate, dense bf16 tensor-core rate, f32 CUDA-core rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# fused SA, bf16 kernel vs bf16 plain twin: both round at the same places
# and differ only in the f32 accumulation order, which can flip a bf16
# rounding of a hidden activation by one ulp (2^-8 relative) and carry it
# through the next layer; held to the bound tests/test_fused_sa.py holds the
# bf16 Pallas kernel to, max|d| / (|ref| + 1) < 0.05
BF16_REL_TOL = 0.05
# fp32: the bound tests/test_fused_sa.py holds the f32 Pallas kernel to;
# also the gather backward's (tests/test_gather_bwd.py), whose f32 sums run
# in another order than the plain twin's index_add_ (there relative to the
# sum of the terms' sizes, see kernel_checks)
F32_RTOL = F32_ATOL = 1e-5
# train step, kernel path vs plain path: the two differ only in the order of
# the gather backward's f32 sums, which the backward carries on; each
# gradient within GRAD_REL of its largest element (+ GRAD_ABS). In bf16 a
# sum that differs in its last f32 bits can round to a neighbouring bf16
# value (2^-8 relative) and carry that through the bf16 backward of the
# layers below, so bf16 gets BF16_GRAD_REL: 2.5 bf16 ulps of the largest
# element. A gradient that is zero in exact arithmetic (a bias ahead of a
# train-mode BN, which subtracts the batch mean) is rounding residue on both
# paths: one whose largest element on both is below RESIDUE of the model's
# largest gradient element is held, like the residue itself, to that scale.
# In bf16 such a residue is bf16 rounding of the BN backward's sums: the
# fusion_sem_seg step takes BF16_RESIDUE, half a bf16 ulp (2^-9) of the
# largest element (measured: sa2's proj_bias at 5e-4 of it). In the
# fusion_sem_seg step a kernel also feeds the image CNN's backward (the
# sampling's d_feat, one bf16 rounding of an f32 sum taken in another order
# than index_add_'s), and the CNN's bf16 BN backward over small maps
# magnifies a one-ulp difference: its bf16 gradients get BF16_SEG_GRAD_REL,
# 8 bf16 ulps (2^-5) of each tensor's largest element (measured: 1.13e-2 at
# image_trunk.s0b1.bn1.bias).
GRAD_REL, GRAD_ABS, BF16_GRAD_REL, RESIDUE = 1e-4, 1e-7, 1e-2, 1e-4
BF16_RESIDUE, BF16_SEG_GRAD_REL = 2.0 ** -9, 2.0 ** -5


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def unit_sphere_clouds(rng, B, N):
    """bench.py's clouds: centred, scaled into the unit sphere."""
    pts = rng.randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    return pts


def request(seed, batch=None):
    """One serving request as bench.py builds it: points, image, K, R, t
    (``batch`` clouds, BATCH by default)."""
    B = batch or BATCH
    r = np.random.RandomState(seed)
    return (unit_sphere_clouds(r, B, NPOINT),
            r.rand(B, *IMAGE_HW, 3).astype(np.float32),
            np.broadcast_to(np.eye(3, dtype=np.float32) * 32,
                            (B, 3, 3)).copy(),
            np.broadcast_to(np.eye(3, dtype=np.float32),
                            (B, 3, 3)).copy(),
            np.tile(np.array([0, 0, 3], np.float32), (B, 1)))


def cuda_ms(torch, fn, reps, warmup=2):
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def times(torch, fn, reps, key="", warmup=2, kernel=None):
    """``{key}ms``: device time per call of fn(), the kernels and copies it
    puts on the card (torch.profiler), the host's launch time excluded;
    ``{key}call_ms``: CUDA events around one call, which also count the
    time the card waits for the host to launch it. With ``kernel`` (a part
    of the kernel's name) also ``{key}kernel_ms``, that kernel's own device
    time a call, and ``{key}kernels_per_call``, the kernels and copies one
    call puts on the card."""
    from mm3d_tpu_torch.utils.profiling import device_kernels
    per = device_kernels(fn, reps)
    out = {f"{key}ms": sum(ms for ms, _ in per.values())}
    if kernel is not None:
        out[f"{key}kernel_ms"] = sum(ms for name, (ms, _) in per.items()
                                     if kernel in name)
        out[f"{key}kernels_per_call"] = sum(n for _, n in per.values())
    out[f"{key}call_ms"] = cuda_ms(torch, fn, reps, warmup)
    return out


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


# ------------------------------------------------------------ bounds


def ball_query_visits(torch, geometry, radius, K, xyz, new_xyz):
    """Points this data needs examined: up to the K-th hit, else all N."""
    d2 = geometry.square_distance(new_xyz, xyz)
    hits = (d2 <= float(np.float32(radius * radius))).to(torch.int32)
    cum = hits.cumsum(-1)
    kth = (cum >= K).float().argmax(-1) + 1
    N = xyz.shape[1]
    return int(torch.where(cum[..., -1] >= K, kth,
                           torch.full_like(kth, N)).sum().item())


# the ball query's least work: |p|^2 once a point (a 3-term dot), then a
# visit's 3-term dot c.p, 2*cross, sub, add |p|^2 and compare
BQ_FLOPS_PER_POINT, BQ_FLOPS_PER_VISIT = 5, 9


# the 3-NN selection's least work a candidate: the distance (the 3-term dot
# of -2 x1, scaled once a dense point, with x2, then the additions of |x1|^2
# and |x2|^2: 7, exact wherever the coordinates are in range, as on every
# path input) and its compare with the running third. The bit-exact
# contract allows no FMA, and the published f32 rate counts an FMA as two
# operations, so the issue floor is about twice this bound.
NN_FLOPS_PER_CANDIDATE = 8


def ball_query_flops(B, N, visits):
    return BQ_FLOPS_PER_POINT * B * N + BQ_FLOPS_PER_VISIT * visits


def bound(nbytes, flops_by_type):
    """{"bound_ms", "bound_by"}: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = sum(f / PEAK_FLOPS[k] for k, f in flops_by_type.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def launch_counts(cuda_kernels):
    """Each kernel wrapper's launch count, by name."""
    return {k.__name__: k.launches for k in cuda_kernels.KERNELS}


def expect(cuda_kernels, **nonzero):
    """The launch counts of every kernel: those named, 0 for the rest."""
    return {k.__name__: nonzero.get(k.__name__, 0)
            for k in cuda_kernels.KERNELS}


# ------------------------------------------------------------ phases


def gather_backward_check(torch, ops, label, gg, idx, n, w=None):
    """The gather backward's kernel (either form) on the card: bit for bit
    the plain twin run on the host copies (CPU index_add_ sums each row in
    ascending order, the kernel's order), two launches identical, and
    within the sum-order bound of the card's twin (whose CUDA index_add_
    takes a new order on every call) -> the entry of its row."""
    dt = gg.dtype
    wcpu = None if w is None else w.cpu()
    got = ops.gather_backward(gg, idx, n, w)
    again = ops.gather_backward(gg, idx, n, w)
    with ops.use_impl("torch"):
        want = ops.gather_backward(gg, idx, n, w)
    host = ops.gather_backward(gg.cpu(), idx.cpu(), n, wcpu)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == dt,
          f"gather backward {label}: shape/dtype")
    check(torch.equal(got, again),
          f"gather backward {label}: two launches differ")
    check(torch.equal(got.cpu(), host),
          f"gather backward {label}: not bit-identical with the host twin "
          f"(max|d| {float((got.cpu().float() - host.float()).abs().max())})")
    gf, wf = got.float(), want.float()
    err = (gf - wf).abs()
    # two f32 sums of the same terms in different orders differ by a
    # rounding error that scales with the sum of the terms' sizes, not with
    # the size of the sum: that part of the tolerance is relative to
    # sum |term| per output element
    with ops.use_impl("torch"):
        size = ops.gather_backward(gg.abs(), idx, n,
                                   None if w is None else w.abs()).float()
    if dt == torch.bfloat16:
        # one bf16 ulp of the larger of the two values; the weighted
        # backwards' sums cancel (signed weights times signed cotangents),
        # so there the f32 order error, carried through the one rounding to
        # bf16, is added
        mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
        ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
        if w is not None:
            ulp = ulp + F32_RTOL * size
        check(bool((err <= ulp).all()),
              f"gather backward {label}: more than one bf16 ulp from the "
              "card's twin")
    else:
        worst = float((err - F32_RTOL * size).max())
        check(worst <= F32_ATOL,
              f"gather backward {label}: |d| - rtol sum|g| max {worst}")
    return {"dtype": str(dt).split(".")[-1], "bit_identical_host": True,
            "relaunch_identical": True, "max_abs_err": float(err.max())}


def captured_gathers(cuda_kernels, fn):
    """Run fn() and return the operands (g, idx, n, weight) of each
    gather_backward call it makes: the weighted launches at the shapes the
    backwards of three_interpolate and of the sampling give them."""
    calls, orig = [], cuda_kernels.gather_backward

    def recorder(g, idx, n, weight=None):
        calls.append((g, idx, n, weight))
        return orig(g, idx, n, weight)

    # the wrapper counts its launches on the module's gather_backward
    recorder.launches = orig.launches
    cuda_kernels.gather_backward = recorder
    try:
        fn()
    finally:
        cuda_kernels.gather_backward = orig
        orig.launches = recorder.launches
    return calls


def weighted_gather_row(torch, ops, cuda_kernels, label, fn, record):
    """The weighted gather launch that fn() (one backward) makes: checked
    as ``gather_backward_check`` does, timed alone against its byte bound
    and against the card's twin."""
    calls = captured_gathers(cuda_kernels, fn)
    check(len(calls) == 1 and calls[0][3] is not None,
          f"{label}: expected one weighted gather backward, got "
          f"{[(tuple(c[0].shape), c[3] is not None) for c in calls]}")
    gg, idx, n, w = calls[0]
    entry = gather_backward_check(torch, ops, label, gg, idx, n, w)
    entry.update(times(torch, lambda: ops.gather_backward(gg, idx, n, w), 20))
    with ops.use_impl("torch"):
        entry.update(times(torch, lambda: ops.gather_backward(
            gg, idx, n, w), 10, "plain_"))
    entry["library_ms"] = None  # no single PyTorch call weighs and scatters
    B, R, C = gg.shape
    k, es = idx.shape[-1], gg.element_size()
    # g, idx and weight read once, d written once; a product and a sum per
    # contribution and channel
    entry.update(bound(B * R * C * es + B * R * k * (4 + es)
                       + B * n * C * es, {"float32": 2 * B * R * k * C}))
    record("gather_backward_weighted", label, entry)


def sa_operands(torch, g, dev, B, N, S, C1, C2, C3):
    """pre, cbias, w1, b1, w2, b2 of a fused SA call, f32 on the card (the
    draws of tests/test_fused_sa.py)."""
    return [torch.from_numpy(a).to(dev) for a in (
        g.randn(B, N, C1).astype(np.float32),
        g.randn(B, S, C1).astype(np.float32),
        (g.randn(C1, C2) * 0.3).astype(np.float32),
        g.randn(C2).astype(np.float32),
        (g.randn(C2, C3) * 0.3).astype(np.float32),
        g.randn(C3).astype(np.float32))]


def sa_check(torch, ops, label, fn, shape, dt):
    """One fused SA form (fn) against its plain twin on the same inputs:
    bf16 max|d| / (|ref| + 1) < BF16_REL_TOL, f32 within F32_RTOL and
    F32_ATOL -> the entry of its row."""
    got = fn()
    with ops.use_impl("torch"):
        want = fn()
    torch.cuda.synchronize()
    check(got.shape == shape and got.dtype == dt, f"{label}: shape/dtype")
    gf, wf = got.float(), want.float()
    err = (gf - wf).abs()
    if dt == torch.bfloat16:
        rel = float((err / (wf.abs() + 1)).max())
        check(rel < BF16_REL_TOL, f"{label}: max|d|/(|ref|+1) {rel}")
    else:
        worst = float((err - F32_RTOL * wf.abs()).max())
        check(worst <= F32_ATOL, f"{label}: |d| - rtol|ref| max {worst}")
    return {"dtype": str(dt).split(".")[-1], "max_abs_err": float(err.max())}


def fps_entry(torch, ops, label, x, npoint, start, timed):
    """FPS on the card bit for bit its plain twin; ``timed``: its device
    time, the twin's and its bound -> the entry of its row."""
    got = ops.farthest_point_sample(x, npoint, start)
    with ops.use_impl("torch"):
        want = ops.farthest_point_sample(x, npoint, start)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"FPS {label}: not bit-exact")
    entry = {"bit_exact": True}
    if timed:
        B, N, _ = x.shape
        entry.update(times(torch, lambda: ops.farthest_point_sample(
            x, npoint, start), 20))
        with ops.use_impl("torch"):
            entry.update(times(
                torch, lambda: ops.farthest_point_sample(x, npoint, start),
                3, "plain_", warmup=1))
        entry.update(bound(
            B * N * 12 + B * npoint * 4,
            {"float32": 9 * B * (npoint - 1) * N}))
    return entry


def ball_query_entry(torch, ops, geometry, label, radius, K, x, cents,
                     timed):
    """The ball query on the card bit for bit its plain twin; ``timed``: as
    ``fps_entry`` -> (the entry of its row, the indices)."""
    got = ops.query_ball_point(radius, K, x, cents)
    with ops.use_impl("torch"):
        want = ops.query_ball_point(radius, K, x, cents)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"ball query {label}: not bit-exact")
    entry = {"bit_exact": True}
    if timed:
        B, N, _ = x.shape
        S = cents.shape[1]
        entry.update(times(torch, lambda: ops.query_ball_point(
            radius, K, x, cents), 20))
        with ops.use_impl("torch"):
            entry.update(times(torch, lambda: ops.query_ball_point(
                radius, K, x, cents), 5, "plain_"))
        visits = ball_query_visits(torch, geometry, radius, K, x, cents)
        entry.update(bound(
            (B * N + B * S) * 12 + B * S * K * 4,
            {"float32": ball_query_flops(B, N, visits)}))
    return entry, got


def fused_sa_entry(torch, ops, geometry, label, radius, K, x, cents, base,
                   dtname, timed):
    """The ball-query fused SA tail on the card against its plain twin
    (``sa_check``) over ``base`` (``sa_operands``) cast to ``dtname``;
    ``timed``: as ``fps_entry`` -> the entry of its row."""
    dt = getattr(torch, dtname)
    B, N, _ = x.shape
    S = cents.shape[1]
    C1, C2, C3 = base[0].shape[-1], base[2].shape[-1], base[4].shape[-1]
    args = (radius, K, x, cents, *[a.to(dt) for a in base])
    entry = sa_check(torch, ops, f"fused SA {label} {dtname}",
                     lambda: ops.fused_sa(*args), (B, S, C3), dt)
    if timed:
        entry.update(times(torch, lambda: ops.fused_sa(*args), 20))
        with ops.use_impl("torch"):
            entry.update(times(torch, lambda: ops.fused_sa(*args), 5,
                               "plain_"))
        # MLP products in the features' dtype, selection in f32
        es = 2 if dt == torch.bfloat16 else 4
        visits = ball_query_visits(torch, geometry, radius, K, x, cents)
        flops = {"bfloat16": 0, "float32": ball_query_flops(B, N, visits)}
        flops[dtname] += 2 * B * S * K * (C1 * C2 + C2 * C3)
        entry.update(bound(
            (B * N + B * S) * 12 + (B * N * C1 + B * S * C1) * es
            + (C1 * C2 + C2 + C2 * C3 + C3) * es + B * S * C3 * es,
            flops))
    return entry


def gather_entry(torch, ops, label, gg, idx, n, timed):
    """The gather backward's unweighted kernel (``gather_backward_check``);
    ``timed``: its device time, the twin's, one index_add_'s and its bound
    -> the entry of its row."""
    entry = gather_backward_check(torch, ops, label, gg, idx, n)
    if timed:
        dev, dt = gg.device, gg.dtype
        B, C_ = gg.shape[0], gg.shape[-1]
        F = idx[0].numel()
        entry.update(times(torch, lambda: ops.gather_backward(
            gg, idx, n), 20))
        with ops.use_impl("torch"):
            entry.update(times(
                torch, lambda: ops.gather_backward(gg, idx, n), 20,
                "plain_"))
        # the library yardstick: one index_add_ into zeros of g's dtype
        # (bf16 sums in bf16 there), with the flat int64 row index built
        # beforehand
        offs = (torch.arange(B, device=dev) * n).reshape(B, 1, 1)
        flat_idx = (idx.long() + offs).reshape(-1)
        flat_g = gg.reshape(-1, C_)
        entry.update(times(torch, lambda: torch.zeros(
            B * n, C_, device=dev, dtype=dt).index_add_(
                0, flat_idx, flat_g), 20, "library_"))
        es = gg.element_size()
        entry.update(bound(B * F * C_ * es + B * F * 4 + B * n * C_ * es,
                           {"float32": B * F * C_}))
    return entry


def fused_fp_entry(torch, ops, label, x1, x2, pre32, skip32, dtname,
                   timed):
    """The fused FP tail on the card against its plain twin (f32 1e-6, bf16
    2e-2 of max|ref|) on pre32 / skip32 cast to ``dtname``; ``timed``: its
    device time, the twin's and its bound -> the entry of its row."""
    dt = getattr(torch, dtname)
    Bx, Nx, Mx = x1.shape[0], x1.shape[1], x2.shape[1]
    C = pre32.shape[-1]
    pre, skip = pre32.to(dt), skip32.to(dt)
    got = ops.fused_fp(x1, x2, pre, skip)
    with ops.use_impl("torch"):
        want = ops.fused_fp(x1, x2, pre, skip)
    torch.cuda.synchronize()
    check(got.shape == (Bx, Nx, C) and got.dtype == dt,
          f"fused FP {label} {dtname}: shape/dtype")
    rel, err = _rel_err(got, want)
    check(rel < (2e-2 if dt == torch.bfloat16 else 1e-6),
          f"fused FP {label} {dtname}: max|d|/max|ref| {rel}")
    entry = {"dtype": dtname, "max_abs_err": err,
             "bit_exact": bool(torch.equal(got, want))}
    if timed:
        entry.update(times(torch, lambda: ops.fused_fp(x1, x2, pre, skip),
                           20))
        with ops.use_impl("torch"):
            entry.update(times(torch, lambda: ops.fused_fp(
                x1, x2, pre, skip), 10, "plain_"))
        # no single PyTorch call computes this function
        entry["library_ms"] = None
        es = pre.element_size()
        entry.update(bound(
            (Bx * Nx + Bx * Mx) * 12 + (Bx * Mx * C + 2 * Bx * Nx * C) * es,
            # 8 f32 operations a candidate (NN_FLOPS_PER_CANDIDATE), 6 per
            # interpolated channel (3 products, 2 sums, the skip add)
            {"float32": NN_FLOPS_PER_CANDIDATE * Bx * Nx * Mx
             + 6 * Bx * Nx * C}))
    return entry


def three_nn_entry(torch, ops, label, x1, x2, timed):
    """three_nn on the card bit for bit its plain twin; ``timed``: its
    device time, the twin's, cdist + topk's and its bound -> (the entry of
    its row, (d2, idx))."""
    d, idx = ops.three_nn(x1, x2)
    with ops.use_impl("torch"):
        wd, wi = ops.three_nn(x1, x2)
    torch.cuda.synchronize()
    check(d.shape == idx.shape == (x1.shape[0], x1.shape[1], 3)
          and idx.dtype == torch.int32, f"three_nn {label}: shape/dtype")
    check(torch.equal(idx, wi) and torch.equal(d, wd),
          f"three_nn {label}: not bit-exact")
    entry = {"bit_exact": True, "max_abs_err": 0.0}
    if timed:
        Bx, Nx, Mx = x1.shape[0], x1.shape[1], x2.shape[1]
        entry.update(times(torch, lambda: ops.three_nn(x1, x2), 20))
        with ops.use_impl("torch"):
            entry.update(times(torch, lambda: ops.three_nn(x1, x2), 10,
                               "plain_"))
        # the library yardstick: all distances, then the 3 smallest
        entry.update(times(torch, lambda: torch.cdist(x1, x2).topk(
            3, dim=-1, largest=False), 20, "library_"))
        entry.update(bound((Bx * Nx + Bx * Mx) * 12 + Bx * Nx * 3 * 8,
                           {"float32": NN_FLOPS_PER_CANDIDATE * Bx * Nx
                            * Mx}))
    return entry, (d, idx)


def three_interp_rows(torch, ops, cuda_kernels, label, d, idx, pre32, co32,
                      record):
    """three_interpolate at one shape (pre32 [B,M,C], the 3-NN d2 and idx
    [B,N,3], a cotangent co32 [B,N,C]), bf16 and f32: the forward bit for
    bit its twin, one kernel a call, timed; the backward (d_points, one
    weighted gather-backward launch) against autograd of the plain path
    (max|d| / max|ref| <= 1e-6 f32, 1e-2 bf16), timed; and that launch,
    captured, checked and timed alone (``weighted_gather_row``)."""
    B, M, C = pre32.shape
    Nx = idx.shape[1]
    w32 = ops.interpolation_weights(d)
    for dtname in ("bfloat16", "float32"):
        dt = getattr(torch, dtname)
        pre, w, co = pre32.to(dt), w32.to(dt), co32.to(dt)
        got = ops.three_interpolate(pre, idx, w)
        with ops.use_impl("torch"):
            want = ops.three_interpolate(pre, idx, w)
        torch.cuda.synchronize()
        check(got.shape == (B, Nx, C) and got.dtype == dt,
              f"three_interpolate {label} {dtname}: shape/dtype")
        check(torch.equal(got, want),
              f"three_interpolate {label} {dtname}: not bit-exact")
        entry = {"dtype": dtname, "bit_exact": True, "max_abs_err": 0.0,
                 **times(torch, lambda: ops.three_interpolate(
                     pre, idx, w), 20, kernel="three_interp")}
        # the weights reach the kernel in the dtype passed: one kernel a
        # call, no cast ahead of it
        check(entry["kernels_per_call"] == 1,
              f"three_interpolate {label} {dtname}: "
              f"{entry['kernels_per_call']} kernels a call")
        with ops.use_impl("torch"):
            entry.update(times(torch, lambda: ops.three_interpolate(
                pre, idx, w), 10, "plain_"))
        # no single PyTorch call computes this function
        entry["library_ms"] = None
        es = pre.element_size()
        entry.update(bound(B * M * C * es + B * Nx * 3 * (4 + w.element_size())
                           + B * Nx * C * es, {"float32": 5 * B * Nx * C}))
        record("three_interpolate", f"{label} {dtname}", entry)

        # backward: d_points through the gather-backward kernel
        def grad_of(impl):
            with ops.use_impl(impl):
                p = pre.clone().requires_grad_(True)
                out = ops.three_interpolate(p, idx, w)
            return p, out

        pk, ok_ = grad_of("auto")
        pp, op_ = grad_of("torch")
        gk = torch.autograd.grad(ok_, pk, co, retain_graph=True)[0]
        gp = torch.autograd.grad(op_, pp, co, retain_graph=True)[0]
        torch.cuda.synchronize()
        rel, err = _rel_err(gk, gp)
        check(gk.dtype == dt and rel <= (1e-2 if dt == torch.bfloat16
                                         else 1e-6),
              f"three_interpolate backward {label} {dtname}: "
              f"max|d|/max|ref| {rel}")
        entry = {"dtype": dtname, "max_abs_err": err, "rel_err": rel,
                 **times(torch, lambda: torch.autograd.grad(
                     ok_, pk, co, retain_graph=True), 20)}
        entry.update(times(torch, lambda: torch.autograd.grad(
            op_, pp, co, retain_graph=True), 10, "plain_"))
        entry["library_ms"] = None
        # g and w read, d_points written; f32 sums of the 3 products
        entry.update(bound(B * Nx * C * es + B * Nx * 3 * (4 + es)
                           + B * M * C * es,
                           {"float32": 2 * 3 * B * Nx * C}))
        record("three_interpolate_backward", f"{label} {dtname}", entry)
        weighted_gather_row(
            torch, ops, cuda_kernels,
            f"three_interpolate d_points {label} {dtname}",
            lambda: torch.autograd.grad(ok_, pk, co, retain_graph=True),
            record)


def kernel_checks(torch, ops, geometry, dev):
    """Each kernel against its plain twin at the serving path's shapes."""
    from mm3d_tpu_torch.ops import cuda_kernels
    rng = np.random.RandomState(0)
    xyz1 = torch.from_numpy(unit_sphere_clouds(rng, BATCH, NPOINT)).to(dev)
    with ops.use_impl("torch"):
        c1 = geometry.index_points(xyz1, geometry.fps_torch(xyz1, 512))
        c2 = geometry.index_points(c1, geometry.fps_torch(c1, 128))
    rows = {}

    def record(kernel, label, entry):
        rows.setdefault(kernel, []).append(entry)
        print(f"kernel {kernel} {label}: " + ", ".join(
            f"{k}={v}" for k, v in entry.items()), flush=True)

    # --- FPS: SA1, SA2 and fusion_sem_seg's first FPS (B=16, 2048 -> 256)
    # timed; a ragged N with per-cloud starts, npoint > N; N one below and
    # one above each of the launcher's boundaries (1, 2, 4 and 8 points a
    # thread up to 128 threads, 8 up to 256, then 16, then the coordinates
    # in shared memory past 4,096 points) with per-cloud starts, N = 4,096
    # and 16,384 (the most it takes) past one chunk of 2,048 indices;
    # duplicated points whose equal distances fall in different lanes and
    # warps
    from mm3d_tpu_torch.data.synthetic import semseg_request
    seg = torch.from_numpy(semseg_request(SEG_BATCH, SEG_NPOINT, IMAGE_HW,
                                          seed=5)[0][..., :3].copy()).to(dev)
    with ops.use_impl("torch"):
        l1 = geometry.index_points(seg, geometry.fps_torch(seg, 256))
        l2 = geometry.index_points(l1, geometry.fps_torch(l1, 64))
    ragged = torch.from_numpy(unit_sphere_clouds(rng, 16, 1000)).to(dev)
    starts = torch.from_numpy(rng.randint(0, 1000, 16).astype(np.int32))
    small = torch.from_numpy(unit_sphere_clouds(rng, 4, 128)).to(dev)
    gs = np.random.RandomState(9)

    def cloud(B, N):
        return torch.from_numpy(unit_sphere_clouds(gs, B, N)).to(dev)

    def tiled(B, unique, N):
        return cloud(B, unique).repeat(1, -(-N // unique), 1)[:, :N].contiguous()

    fps_cases = [("SA1 N=1024 npoint=512", xyz1, 512, 0, True),
                 ("SA2 N=512 npoint=128", c1, 128, 0, True),
                 ("semseg B=16 N=2048 npoint=256", seg, 256, 0, True),
                 ("ragged N=1000 per-cloud start", ragged, 256, starts,
                  False),
                 ("N=128 npoint=512", small, 512, 0, False)]
    for N in (127, 129, 255, 257, 511, 513, 1023, 1025, 2047, 2049, 4095,
              4097, 16383):
        fps_cases.append((f"N={N} per-cloud start", cloud(4, N), 200,
                          torch.from_numpy(gs.randint(0, N, 4).astype(
                              np.int32)), False))
    fps_cases += [
        ("N=4096 npoint=3000", cloud(2, 4096), 3000, 17, False),
        ("N=16384 npoint=2500", cloud(2, 16384), 2500,
         torch.tensor([0, 16383], dtype=torch.int32), False),
        ("48 points tiled to 1024", tiled(4, 48, 1024), 300, 5, False),
        ("40 points tiled to 6000", tiled(2, 40, 6000), 100, 0, False)]
    for label, x, npoint, start, timed in fps_cases:
        record("fps", label, fps_entry(torch, ops, label, x, npoint, start,
                                       timed))

    # --- ball query: SA1, SA2 and fusion_sem_seg's SA1 and SA2 (B=16)
    # timed; zero-hit centroids, ragged N (not a multiple of the 256 points
    # a round); the 32nd hit at index 31, 32, 127, 128, 255 and 256 (the
    # edges of a ballot's 32 points, of the fused kernel's rounds of 4
    # points a lane and of the standalone kernel's of 8); K = 128; every
    # point a hit (the walk ends in its first round); points at exactly
    # d2 == r2 (grid coordinates, exact arithmetic); N = 16,384, whose
    # cloud does not fit in shared memory; K = 1,100, whose rows do not
    far = c1.clone()
    far[:, :7] = 100.0
    bq_cases = [
        ("SA1 S=512 N=1024 K=32 r=0.2", 0.2, 32, xyz1, c1, True),
        ("SA2 S=128 N=512 K=64 r=0.4", 0.4, 64, c1, c2, True),
        ("semseg SA1 B=16 S=256 N=2048 K=32 r=0.2", 0.2, 32, seg, l1, True),
        ("semseg SA2 B=16 S=64 N=256 K=64 r=0.4", 0.4, 64, l1, l2, True),
        ("zero-hit centroids", 0.2, 32, xyz1, far, False),
        ("ragged N=1000", 0.3, 48, ragged, ragged[:, :200].contiguous(),
         False),
        ("ragged N=133 K=128", 0.8, 128, cloud(4, 133), cloud(4, 40),
         False)]
    for h in (31, 32, 127, 128, 255, 256):
        pts = (3.0 + gs.rand(4, 400, 3)).astype(np.float32)
        pts[:, h - 31:h + 1] = gs.rand(4, 32, 3) * 0.1
        pts[:, h + 1:h + 40] = gs.rand(4, 39, 3) * 0.1
        bq_cases.append((f"32nd hit at {h}", 0.5, 32,
                         torch.from_numpy(pts).to(dev),
                         torch.full((4, 5, 3), 0.05, device=dev), False))
    x = cloud(4, 2048)
    bq_cases += [
        ("K=128 N=2048", 0.5, 128, x, x[:, ::16].contiguous(), False),
        ("every point a hit", 0.5, 32, x * 0.01, x[:, :64] * 0.01, False),
        ("N=16384", 0.1, 32, cloud(2, 16384), cloud(2, 300), False),
        ("K=1100 N=2000", 0.9, 1100, x[:, :2000].contiguous(), x[:, :20],
         False)]
    grid = torch.from_numpy(gs.randint(-8, 9, (4, 1000, 3)).astype(np.float32)
                            / 16).to(dev)
    sphere = torch.tensor([[0.5, 0, 0], [0, -0.5, 0], [0, 0, 0.5],
                           [0.25, 0.25, 0.25]], device=dev)
    grid[:, 500:504] = grid[:, :1] + sphere  # d2 == r2 == 0.25 from point 0
    bq_cases.append(("d2 == r2 on the 1/16 grid", 0.5, 32, grid,
                     grid[:, :50].contiguous(), False))
    for label, radius, K, x, cents, timed in bq_cases:
        entry, got = ball_query_entry(torch, ops, geometry, label, radius, K,
                                      x, cents, timed)
        if label.startswith("zero-hit"):
            check(bool((got[:, :7] == 0).all()), "zero-hit rows not all 0")
        record("ball_query", label, entry)

    # --- fused SA tail: SA1 and SA2 shapes, bf16 and fp32, timed; zero-hit
    # centroids (untimed)
    g = np.random.RandomState(1)
    for label, radius, K, x, cents, (C1, C2, C3), timed in (
            ("SA1", 0.2, 32, xyz1, c1, (64, 64, 128), True),
            ("SA2", 0.4, 64, c1, c2, (128, 128, 256), True),
            ("zero-hit centroids", 0.2, 32, xyz1, far, (64, 64, 128),
             False)):
        B, N, _ = x.shape
        base = sa_operands(torch, g, dev, B, N, cents.shape[1], C1, C2, C3)
        for dtname in ("bfloat16", "float32"):
            record("fused_sa", f"{label} {dtname}", fused_sa_entry(
                torch, ops, geometry, label, radius, K, x, cents, base,
                dtname, timed))

    # --- fused SA tail over given indices: SA1 and SA2 shapes with the kNN
    # indices of knn_point on the card, bf16 and fp32; then a row of one
    # repeated index and K=48 (not a power of two, St=2)
    g = np.random.RandomState(5)
    for label, K, x, cents, (C1, C2, C3), timed in (
            ("SA1 kNN K=32", 32, xyz1, c1, (64, 64, 128), True),
            ("SA2 kNN K=64", 64, c1, c2, (128, 128, 256), True),
            ("repeated idx K=48", 48, c1, c2, (128, 128, 256), False)):
        B, N, _ = x.shape
        S = cents.shape[1]
        idx = ops.knn_point(K, x, cents)
        if not timed:
            idx[:, 5] = idx[:, 5, :1]
            idx[:, 9, ::2] = idx[:, 9, 1::2]
        base = sa_operands(torch, g, dev, B, N, S, C1, C2, C3)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
            args = (K, idx, *[a.to(dt) for a in base])
            entry = sa_check(torch, ops, f"fused SA idx {label} {dtname}",
                             lambda: ops.fused_sa_idx(*args), (B, S, C3), dt)
            if timed:
                entry.update(times(torch, lambda: ops.fused_sa_idx(*args),
                                   20))
                with ops.use_impl("torch"):
                    entry.update(times(torch, lambda: ops.fused_sa_idx(
                        *args), 5, "plain_"))
                # the kNN selection ahead of the kernel (plain PyTorch on
                # the card by design: a stable sort of all N distances)
                entry.update(times(torch, lambda: ops.knn_point(K, x, cents),
                                   5, "knn_point_"))
                # no single PyTorch call computes this function
                entry["library_ms"] = None
                es = 2 if dt == torch.bfloat16 else 4
                entry.update(bound(
                    B * S * K * 4 + (B * N * C1 + B * S * C1) * es
                    + (C1 * C2 + C2 + C2 * C3 + C3) * es + B * S * C3 * es,
                    {dtname: 2 * B * S * K * (C1 * C2 + C2 * C3)}))
            record("fused_sa_idx", f"{label} {dtname}", entry)

    # --- the ball-query form past 128 neighbours (untimed; the JAX kernel
    # takes any K there): one centroid a tile, walked in blocks of 128 rows;
    # at (64,128,512) the weights stream, once for each block (bf16: the f32
    # plan does not fit)
    g = np.random.RandomState(8)
    for label, B, N, S, radius, K, (C1, C2, C3), f32, resident in (
            ("K=256 (64,64,128)", 8, 1024, 64, 0.6, 256, (64, 64, 128), True,
             True),
            ("K=200 (64,64,128)", 8, 512, 64, 0.8, 200, (64, 64, 128), True,
             True),
            ("K=256 streamed (64,128,512)", 8, 1024, 64, 0.6, 256,
             (64, 128, 512), False, False)):
        plan = cuda_kernels.sa_plan(C1, C2, C3, K, S, torch.bfloat16, N)
        check((plan.rows, plan.resident) == (256, resident),
              f"fused SA {label}: plan {plan}")
        x = torch.from_numpy(unit_sphere_clouds(g, B, N)).to(dev)
        with ops.use_impl("torch"):
            cents = geometry.index_points(x, geometry.fps_torch(x, S))
        base = sa_operands(torch, g, dev, B, N, S, C1, C2, C3)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32))[:2 if f32 else 1]:
            w = [a.to(dt) for a in base]
            record("fused_sa", f"{label} {dtname}", sa_check(
                torch, ops, f"fused SA {label} {dtname}",
                lambda: ops.fused_sa(radius, K, x, cents, *w), (B, S, C3),
                dt))

    # --- both forms at the other widths the JAX models route to the fused
    # tail in bf16 eval (untimed), each at its block's own point and
    # centroid counts: config 3's sa2 (128,196,256) at K=128, St=1 (C2 not a
    # multiple of 16); the sa4 blocks of PointNet2SemSeg (256,256,512) and
    # PointNet2SemSegMSG (256,384,512) at K=32, whose weights stream through
    # shared memory; PointNet2SemSegMSG's sa1 (16,16,32) at K=16. bf16, the
    # serving dtype, always; f32 where its plan fits shared memory (the sa4
    # widths' is refused before any launch, tests/test_torch_fused_sa.py).
    # Then a width no model routes, (32,640,64), whose bf16 tile the wgmma
    # kernel cannot hold: the loop kernel takes it (producers 0)
    g = np.random.RandomState(7)
    for label, B, N, S, radius, K, (C1, C2, C3), f32 in (
            ("config 3 sa2 (128,196,256) K=128", 16, 512, 128, 0.8, 128,
             (128, 196, 256), True),
            ("semseg sa4 (256,256,512) K=32", 16, 64, 16, 0.8, 32,
             (256, 256, 512), False),
            ("semseg MSG sa4 (256,384,512) K=32", 16, 64, 16, 0.8, 32,
             (256, 384, 512), False),
            ("semseg MSG sa1 (16,16,32) K=16", 8, 4096, 1024, 0.05, 16,
             (16, 16, 32), True),
            ("bf16 loop kernel (32,640,64) K=32", 8, 1024, 256, 0.2, 32,
             (32, 640, 64), False)):
        check((cuda_kernels.sa_plan(C1, C2, C3, K, S, torch.bfloat16,
                                    N).producers == 0) == (C2 == 640),
              f"fused SA {label}: not on the kernel it names")
        x = torch.from_numpy(unit_sphere_clouds(g, B, N)).to(dev)
        with ops.use_impl("torch"):
            cents = geometry.index_points(x, geometry.fps_torch(x, S))
        idx = ops.knn_point(K, x, cents)
        base = sa_operands(torch, g, dev, B, N, S, C1, C2, C3)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32))[:2 if f32 else 1]:
            w = [a.to(dt) for a in base]
            record("fused_sa", f"{label} {dtname}", sa_check(
                torch, ops, f"fused SA {label} {dtname}",
                lambda: ops.fused_sa(radius, K, x, cents, *w), (B, S, C3),
                dt))
            record("fused_sa_idx", f"{label} {dtname}", sa_check(
                torch, ops, f"fused SA idx {label} {dtname}",
                lambda: ops.fused_sa_idx(K, idx, *w), (B, S, C3), dt))

    # --- gather backward: the train path's SA1 and SA2 shapes at B=24 with
    # the ball query's own indices, in f32 and bf16, and random indices
    # (out-of-range ones among them) with an unaligned n=100, C=24
    TB = TRAIN_BATCH
    with ops.use_impl("torch"):
        idx1 = ops.query_ball_point(0.2, 32, xyz1[:TB], c1[:TB])
        idx2 = ops.query_ball_point(0.4, 64, c1[:TB], c2[:TB])
    g = np.random.RandomState(2)
    ridx = torch.from_numpy(g.randint(-3, 103, (2, 30, 4)).astype(np.int32))
    for label, idx, n, C, dt, timed in (
            ("SA1 g[24,512,32,64] n=1024 f32", idx1, NPOINT, 64,
             torch.float32, True),
            ("SA2 g[24,128,64,128] n=512 f32", idx2, 512, 128,
             torch.float32, True),
            ("SA1 g[24,512,32,64] n=1024 bf16", idx1, NPOINT, 64,
             torch.bfloat16, True),
            ("SA2 g[24,128,64,128] n=512 bf16", idx2, 512, 128,
             torch.bfloat16, True),
            ("random idx n=100 C=24 f32", ridx.to(dev), 100, 24,
             torch.float32, False),
            ("random idx n=50000 C=3 f32", torch.from_numpy(g.randint(
                -5, 50005, (2, 4096)).astype(np.int32)).to(dev), 50000, 3,
             torch.float32, False)):
        gg = torch.from_numpy(g.randn(*idx.shape, C).astype(np.float32)).to(
            dev).to(dt)
        record("gather_backward", label, gather_entry(
            torch, ops, label, gg, idx, n, timed))
    # the weighted form on the scalar path (C=24), out-of-range indices,
    # f32 and bf16
    for dt in (torch.float32, torch.bfloat16):
        label = f"random weighted idx [2,30,4] n=100 C=24 {dt}"
        gg = torch.from_numpy(g.randn(2, 30, 24).astype(np.float32)).to(
            dev).to(dt)
        w = torch.from_numpy(g.rand(2, 30, 4).astype(np.float32)).to(
            dev).to(dt)
        record("gather_backward_weighted", label, gather_backward_check(
            torch, ops, label, gg, ridx.to(dev), 100, w))
    semseg_kernel_checks(torch, ops, dev, record)
    semseg_train_kernel_checks(torch, ops, dev, record)
    partseg_kernel_checks(torch, ops, geometry, dev, record)
    scene_kernel_checks(torch, ops, geometry, dev, record)
    nn_edge_checks(torch, ops, dev, record)
    return rows


def _rel_err(got, want):
    """max|d| / max|ref|, the bound tests/test_fused_fp.py uses."""
    gf, wf = got.float(), want.float()
    return (float((gf - wf).abs().max()) / max(float(wf.abs().max()), 1e-9),
            float((gf - wf).abs().max()))


def nn_edge_cases(torch, dev):
    """(label, xyz1, xyz2) at the edges of the 3-NN selection's design
    (csrc/three_nn.cuh): G lanes scan a dense point (cuda_kernels.nn_lanes
    picks G from B and N), each over its share in steps of kNnUnroll (8)
    candidates after the candidates that fill its three slots.

    - M one below and one above multiples of G x 8 at each G the launcher
      picks for three_nn (G = 1 at B=24 N=1024, 2 at N=600, 4 at N=300, 16
      at B=2), and M = 3, 4, ..., 11 at G = 1 (every remainder of the
      steady-state steps);
    - M = 2,048, the most the kernels take, with a ragged N = 2,047, and
      N = 33 (one ragged tile);
    - a sparse point duplicated at adjacent indices (different lanes where
      G > 1) with a dense point on it;
    - a third and a fourth neighbour at exactly equal distance, at adjacent
      indices (1/16-grid coordinates: exact arithmetic);
    - every sparse point the same point: the indices must read 0, 1, 2;
    - coordinates scaled by 1e-20 and by 6e18, outside the range in which
      the selection takes its 7-operation distance (three_nn.cuh,
      mm3d_nn_in_range): the 8-operation path."""
    from mm3d_tpu_torch.ops import cuda_kernels
    rng = np.random.RandomState(7)
    threads = cuda_kernels._fn("mm3d_three_nn_threads")()
    sms = cuda_kernels._sm_count(dev)

    def cloud(B, N):
        return torch.from_numpy(unit_sphere_clouds(rng, B, N)).to(dev)

    def label(B, N, M, what=""):
        G = cuda_kernels.nn_lanes(B, N, threads, sms)
        return f"B={B} N={N} M={M} lanes={G}{what}"

    out = []
    for B, N, Ms in ((24, 1024, (3, 4, 5, 6, 7, 8, 9, 10, 11, 255, 257)),
                     (24, 600, (15, 17, 31, 33)),
                     (24, 300, (31, 33, 63, 65)),
                     (2, 33, (63, 65, 127, 129)),
                     (4, 2047, (2047, 2048))):
        for M in Ms:
            out.append((label(B, N, M), cloud(B, N), cloud(B, M)))
    for B, N, M in ((24, 1024, 256), (24, 300, 64), (2, 33, 64)):
        x1, x2 = cloud(B, N), cloud(B, M)
        x2[:, 11] = x2[:, 10]
        x1[:, 0] = x2[:, 10]
        out.append((label(B, N, M, ", duplicate at 10 and 11"), x1, x2))
        # 1/16 grid; dense point 0 at the origin: neighbours 4 (d2 1/16), 9
        # (1/4), then 13 and 14 both at 9/16; every other point >= 1.5 out
        far = rng.randint(24, 33, (B, M, 3)) * rng.choice([-1, 1], (B, M, 3))
        x2 = far.astype(np.float32) / 16
        x2[:, 4], x2[:, 9] = (0.25, 0, 0), (0, 0.5, 0)
        x2[:, 13], x2[:, 14] = (0.75, 0, 0), (0, -0.75, 0)
        x1 = rng.randint(-32, 33, (B, N, 3)).astype(np.float32) / 16
        x1[:, 0] = 0
        out.append((label(B, N, M, ", 3rd and 4th equal at 13 and 14"),
                    torch.from_numpy(x1).to(dev),
                    torch.from_numpy(x2).to(dev)))
    for B, N, M in ((24, 1024, 257), (2, 33, 64)):
        x2 = torch.from_numpy(rng.rand(B, 1, 3).astype(np.float32)).to(
            dev).expand(B, M, 3).contiguous()
        out.append((label(B, N, M, ", one point repeated"), cloud(B, N), x2))
    for scale in (1e-20, 6e18):
        out.append((label(24, 1024, 256, f", coordinates x {scale:g}"),
                    cloud(24, 1024) * scale, cloud(24, 256) * scale))
    return out


def nn_edge_checks(torch, ops, dev, record):
    """three_nn bit-exact (d2 and idx) and the fused FP tail, bf16 and f32,
    within its bounds (bit_exact recorded) at ``nn_edge_cases``; at every
    third case the fused tail also with C = 24 (three or six 16-byte moves a
    row: a thread's steps wrap rows), C = 18 (not a whole number of 16-byte
    moves in either dtype: the scalar path) and with an operand at an
    offset that is not 16-byte aligned (the scalar path too). Untimed."""
    g = np.random.RandomState(8)
    for i, (label, x1, x2) in enumerate(nn_edge_cases(torch, dev)):
        d, idx = ops.three_nn(x1, x2)
        with ops.use_impl("torch"):
            wd, wi = ops.three_nn(x1, x2)
        torch.cuda.synchronize()
        check(torch.equal(idx, wi) and torch.equal(d, wd),
              f"three_nn {label}: not bit-exact")
        if "one point repeated" in label:
            check(bool((idx == torch.arange(3, device=dev, dtype=idx.dtype))
                       .all()), f"three_nn {label}: idx not 0, 1, 2")
        if "3rd and 4th" in label:
            check(idx[:, 0].tolist() == [[4, 9, 13]] * x1.shape[0],
                  f"three_nn {label}: idx {idx[:, 0].tolist()}")
        record("three_nn", label, {"bit_exact": True, "max_abs_err": 0.0})
        B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
        for C, offset in ((128, 0), (24, 0), (18, 0),
                          (128, 1))[:1 if i % 3 else 4]:
            pre32 = torch.from_numpy(g.randn(B, M, C).astype(np.float32))
            skip32 = torch.from_numpy(g.randn(B, N, C).astype(np.float32))
            for dtname, dt in (("bfloat16", torch.bfloat16),
                               ("float32", torch.float32)):
                pre, skip = pre32.to(dev, dt), skip32.to(dev, dt)
                if offset:
                    # the same values one element into a buffer: contiguous,
                    # not 16-byte aligned
                    buf = torch.empty(B * M * C + offset, dtype=dt,
                                      device=dev)
                    pre = buf[offset:].view(B, M, C).copy_(pre)
                got = ops.fused_fp(x1, x2, pre, skip)
                with ops.use_impl("torch"):
                    want = ops.fused_fp(x1, x2, pre, skip)
                torch.cuda.synchronize()
                rel, err = _rel_err(got, want)
                what = f"{label} C={C}{' unaligned pre' if offset else ''}"
                check(got.shape == (B, N, C) and got.dtype == dt,
                      f"fused FP {what} {dtname}: shape/dtype")
                check(rel < (2e-2 if dt == torch.bfloat16 else 1e-6),
                      f"fused FP {what} {dtname}: max|d|/max|ref| {rel}")
                record("fused_fp", f"{what} {dtname}", {
                    "dtype": dtname, "max_abs_err": err,
                    "bit_exact": bool(torch.equal(got, want))})


def _edge_operand(torch, g, dev, shape, dt, scale=1.0, offset=0):
    """g.randn(*shape) * scale in dt on the card; with ``offset`` the same
    values that many elements into a buffer: contiguous, not 16-byte
    aligned (the kernels' scalar moves)."""
    t = torch.from_numpy((g.randn(*shape) * scale).astype(np.float32)).to(
        dev, dt)
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=dt, device=dev)
    return buf[offset:].view(*shape).copy_(t)


# the edges of the byte-bound forwards' plan (csrc/three_interp.cu,
# csrc/bilinear.cu): (what, B, N, C, feature scale, feature offset). The
# path shapes take the tile kernel: 2^k lanes a point, kPacks 16-byte packs
# a lane. C = 20 (bf16: the scalar moves; f32: 5 packs a point, the
# any-shape kernel), C = 18 (scalar moves in both), C = 48 (bf16: 6 packs,
# 3 lanes of 2: the any-shape kernel) and C = 512 (a point over more than
# one warp); an operand one element off 16-byte alignment; N = 1001, not a
# multiple of any tile; one cloud; features at 2^-120 (products of the
# small weights below 2^-126, subnormal or 0 in f32) and 2^100
BYTE_EDGES = (("C=20", 3, 1001, 20, 1.0, 0), ("C=18", 2, 300, 18, 1.0, 0),
              ("C=48", 2, 300, 48, 1.0, 0), ("C=512", 2, 300, 512, 1.0, 0),
              ("unaligned C=128", 2, 1001, 128, 1.0, 1),
              ("N=1001 C=128", 3, 1001, 128, 1.0, 0),
              ("B=1 C=256", 1, 256, 256, 1.0, 0),
              ("features x 2^-120", 2, 1001, 128, 2.0 ** -120, 0),
              ("features x 2^100", 2, 1001, 128, 2.0 ** 100, 0))


def interp_edge_checks(torch, ops, dev, record):
    """three_interpolate bit-exact with its twin at ``BYTE_EDGES`` (M = 64
    sparse rows), bf16 and f32 points, each with f32 weights and with bf16
    weights (the kernel rounds them to the points' dtype itself); a fifth
    of the points carry a weight of 1e-30. Untimed."""
    g = np.random.RandomState(12)
    M = 64
    for what, B, N, C, scale, offset in BYTE_EDGES:
        idx = torch.from_numpy(g.randint(0, M, (B, N, 3)).astype(
            np.int32)).to(dev)
        w = g.rand(B, N, 3) + 1e-3
        w /= w.sum(-1, keepdims=True)
        w[g.rand(B, N) < 0.2, 2] = 1e-30
        w32 = torch.from_numpy(w.astype(np.float32)).to(dev)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
            pts = _edge_operand(torch, g, dev, (B, M, C), dt, scale, offset)
            for wname, wt in (("f32 weights", w32),
                              ("bf16 weights", w32.to(torch.bfloat16))):
                got = ops.three_interpolate(pts, idx, wt)
                with ops.use_impl("torch"):
                    want = ops.three_interpolate(pts, idx, wt)
                torch.cuda.synchronize()
                label = f"edge {what} B={B} N={N} {wname} {dtname}"
                check(got.shape == (B, N, C) and got.dtype == dt,
                      f"three_interpolate {label}: shape/dtype")
                check(torch.equal(got, want),
                      f"three_interpolate {label}: not bit-exact")
                record("three_interpolate", label,
                       {"dtype": dtname, "bit_exact": True,
                        "max_abs_err": 0.0})


def bilinear_edge_checks(torch, ops, dev, record):
    """The bilinear sampling bit-exact with its twin at ``BYTE_EDGES`` on a
    [B,16,16,C] map, bf16 and f32, at coordinates random over [-2, 18), a
    fifth of them whole numbers, and a third of them drawn from whole, negative
    (-1e-10 among them, where u - floor(u) rounds to du = 1.0), past the right
    and bottom edges (15.5, 16, 17.25) and far outside (+-1e6). Untimed."""
    g = np.random.RandomState(13)
    H = W = 16
    special = np.array([0.0, 1.0, 7.0, 15.0, -1e-10, -0.5, -1.0, -1.5, -3.0,
                        15.5, 16.0, 17.25, 1e6, -1e6], np.float32)
    for what, B, N, C, scale, offset in BYTE_EDGES:
        uv = g.uniform(-2.0, 18.0, (B, N, 2)).astype(np.float32)
        flat = uv.reshape(-1)
        pick = g.rand(flat.size) < 0.3
        flat[pick] = g.choice(special, int(pick.sum()))
        whole = g.rand(flat.size) < 0.2
        flat[whole] = np.floor(flat[whole])
        uv_t = torch.from_numpy(uv).to(dev)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
            fmap = _edge_operand(torch, g, dev, (B, H, W, C), dt, scale,
                                 offset)
            got = ops.bilinear_sample(fmap, uv_t)
            with ops.use_impl("torch"):
                want = ops.bilinear_sample(fmap, uv_t)
            torch.cuda.synchronize()
            label = f"edge {what} B={B} N={N} {dtname}"
            check(got.shape == (B, N, C) and got.dtype == dt,
                  f"bilinear {label}: shape/dtype")
            check(torch.equal(got, want), f"bilinear {label}: not bit-exact")
            record("bilinear_sample", label,
                   {"dtype": dtname, "bit_exact": True, "max_abs_err": 0.0})


def msg_scales():
    """(block, radius, K, widths) of config 3's five MSG scales, read from
    the port's model: sa1's three over 2,048 points, sa2's two over 512."""
    from mm3d_tpu_torch.models import get_model
    m = get_model("pointnet2_part_seg_msg").builder()
    return [(blk, r, k, mlp) for blk in ("sa1", "sa2")
            for r, k, mlp in zip(getattr(m, blk).radius_list,
                                 getattr(m, blk).nsample_list,
                                 getattr(m, blk).mlp_list)]


def partseg_kernel_checks(torch, ops, geometry, dev, record):
    """The kernels at config 3's shapes, each against its plain twin and
    timed. Serving (B=16 ShapeNetPart-style clouds of 2,048 points): FPS
    2,048 -> 512 and 512 -> 128; the ball query and the ball-query fused SA
    tail (bf16 and f32) at the five MSG scales, among them K = 128 over
    2,048 points, (64,96,128) on one centroid's 128-row tile and
    (128,196,256), whose 196 is not a multiple of 16; the fused FP tail at
    FP2 (N=512, M=128, C=256) and FP1 (N=2,048, M=512, C=128), bf16 and
    f32. Training (B=24): three_nn and three_interpolate (forward and
    backward) at FP2 and FP1, and the gather backward of each scale's
    gather (f32, the ball query's own indices). Tolerances as at the other
    shapes."""
    from mm3d_tpu_torch.data.synthetic import partseg_request
    from mm3d_tpu_torch.ops import cuda_kernels

    def levels(B, seed):
        xyz = torch.from_numpy(partseg_request(B, PART_NPOINT, seed=seed)[0]
                               ).to(dev)
        with ops.use_impl("torch"):
            l1 = geometry.index_points(xyz, geometry.fps_torch(xyz, 512))
            l2 = geometry.index_points(l1, geometry.fps_torch(l1, 128))
        return {"sa1": (xyz, l1), "sa2": (l1, l2)}

    lv = levels(PART_BATCH, 40)
    for blk, (x, cents) in lv.items():
        B, N, _ = x.shape
        S = cents.shape[1]
        label = f"config 3 {blk} B={B} N={N} npoint={S}"
        record("fps", label, fps_entry(torch, ops, label, x, S, 0, True))
    g = np.random.RandomState(12)
    for blk, radius, K, (C1, C2, C3) in msg_scales():
        x, cents = lv[blk]
        B, N, _ = x.shape
        S = cents.shape[1]
        label = f"config 3 {blk} B={B} S={S} N={N} K={K} r={radius}"
        record("ball_query", label, ball_query_entry(
            torch, ops, geometry, label, radius, K, x, cents, True)[0])
        base = sa_operands(torch, g, dev, B, N, S, C1, C2, C3)
        wlabel = f"{label} ({C1},{C2},{C3})"
        for dtname in ("bfloat16", "float32"):
            record("fused_sa", f"{wlabel} {dtname}", fused_sa_entry(
                torch, ops, geometry, wlabel, radius, K, x, cents, base,
                dtname, True))
    fp = {"FP2": (lv["sa1"][1], lv["sa2"][1], 256),
          "FP1": (lv["sa1"][0], lv["sa1"][1], 128)}
    for name, (x1, x2, C) in fp.items():
        label = (f"config 3 {name} B={x1.shape[0]} N={x1.shape[1]} "
                 f"M={x2.shape[1]} C={C}")
        pre32 = torch.from_numpy(g.randn(x1.shape[0], x2.shape[1], C).astype(
            np.float32)).to(dev)
        skip32 = torch.from_numpy(g.randn(x1.shape[0], x1.shape[1], C).astype(
            np.float32)).to(dev)
        for dtname in ("bfloat16", "float32"):
            record("fused_fp", f"{label} {dtname}", fused_fp_entry(
                torch, ops, label, x1, x2, pre32, skip32, dtname, True))

    # training shapes, B=24
    lt = levels(TRAIN_BATCH, 41)
    B = TRAIN_BATCH
    fp = {"FP2": (lt["sa1"][1], lt["sa2"][1], 256),
          "FP1": (lt["sa1"][0], lt["sa1"][1], 128)}
    for name, (x1, x2, C) in fp.items():
        N, M = x1.shape[1], x2.shape[1]
        label = f"config 3 {name} B={B} N={N} M={M}"
        entry, (d, idx) = three_nn_entry(torch, ops, label, x1, x2, True)
        record("three_nn", label, entry)
        three_interp_rows(
            torch, ops, cuda_kernels, f"{label} C={C}", d, idx,
            torch.from_numpy(g.randn(B, M, C).astype(np.float32)).to(dev),
            torch.from_numpy(g.randn(B, N, C).astype(np.float32)).to(dev),
            record)
    for blk, radius, K, (C1, _, _) in msg_scales():
        x, cents = lt[blk]
        N, S = x.shape[1], cents.shape[1]
        with ops.use_impl("torch"):
            idx = ops.query_ball_point(radius, K, x, cents)
        label = f"config 3 {blk} g[{B},{S},{K},{C1}] n={N} f32"
        gg = torch.from_numpy(g.randn(B, S, K, C1).astype(np.float32)).to(dev)
        record("gather_backward", label, gather_entry(
            torch, ops, label, gg, idx, N, True))


def scene_sa1_scales():
    """(model, radius, K, widths) of the sa1 scales of pointnet2_sem_seg and
    pointnet2_sem_seg_msg, read from the port's models: 1,024 centroids
    over 4,096 points of 3 + 9 input channels."""
    from mm3d_tpu_torch.models import get_model
    ssg = get_model("pointnet2_sem_seg").builder().sa1
    msg = get_model("pointnet2_sem_seg_msg").builder().sa1
    return ([("pointnet2_sem_seg", ssg.radius, ssg.nsample, ssg.mlp_widths)]
            + [("pointnet2_sem_seg_msg", r, k, mlp) for r, k, mlp in zip(
                msg.radius_list, msg.nsample_list, msg.mlp_list)])


def scene_kernel_checks(torch, ops, geometry, dev, record):
    """The kernels at the sem-seg tops' shapes (S3DIS-style blocks of 4,096
    points), each against its plain twin. Serving (B=16): FPS 4,096 ->
    1,024 (timed) and the three levels below it; the ball query and the
    ball-query fused SA tail (bf16 and f32, timed) at sa1 of both sem-seg
    models, each with the tile plan ``sa_plan`` gives it (the bf16
    (32,32,64) K=32 plan keeps the 4,096 points out of shared memory); the
    fused FP tail at FP1 (N=4,096, M=1,024, C=128) and FP4 (N=64, M=16,
    C=256), bf16 and f32, timed, each with its ``fp_plan``. Training (B=24):
    three_nn and three_interpolate (forward and backward) at FP1 and the
    gather backward of sa1's gather (f32, the ball query's own indices).
    Tolerances as at the other shapes."""
    from mm3d_tpu_torch.data.synthetic import scene_request
    from mm3d_tpu_torch.ops import cuda_kernels

    def levels(B, seed):
        """The block's xyz and FPS's four levels below it (the plain
        twin): 4,096, 1,024, 256, 64 and 16 points."""
        x = torch.from_numpy(scene_request(B, SCENE_NPOINT, seed=seed)[0]
                             [..., :3].copy()).to(dev)
        out = [x]
        with ops.use_impl("torch"):
            for S in (1024, 256, 64, 16):
                out.append(geometry.index_points(
                    out[-1], geometry.fps_torch(out[-1], S)))
        return out

    lv = levels(SCENE_BATCH, 50)
    for i, (x, c) in enumerate(zip(lv, lv[1:])):
        B, N, _ = x.shape
        S = c.shape[1]
        label = f"semseg B={B} N={N} npoint={S}"
        record("fps", label, fps_entry(torch, ops, label, x, S, 0, i == 0))
    g = np.random.RandomState(13)
    x, cents = lv[0], lv[1]
    B, N, S = SCENE_BATCH, SCENE_NPOINT, cents.shape[1]
    for model, radius, K, (C1, C2, C3) in scene_sa1_scales():
        label = f"{model} sa1 B={B} S={S} N={N} K={K} r={radius}"
        record("ball_query", label, ball_query_entry(
            torch, ops, geometry, label, radius, K, x, cents, True)[0])
        base = sa_operands(torch, g, dev, B, N, S, C1, C2, C3)
        wlabel = f"{label} 12 input channels ({C1},{C2},{C3})"
        for dtname in ("bfloat16", "float32"):
            entry = fused_sa_entry(torch, ops, geometry, wlabel, radius, K,
                                   x, cents, base, dtname, True)
            entry["plan"] = cuda_kernels.sa_plan(
                C1, C2, C3, K, S, getattr(torch, dtname), N)._asdict()
            record("fused_sa", f"{wlabel} {dtname}", entry)
    for name, (x1, x2, C) in {"FP1": (lv[0], lv[1], 128),
                              "FP4": (lv[3], lv[4], 256)}.items():
        Bx, Nx, Mx = x1.shape[0], x1.shape[1], x2.shape[1]
        label = f"semseg {name} B={Bx} N={Nx} M={Mx} C={C}"
        pre32 = torch.from_numpy(g.randn(Bx, Mx, C).astype(np.float32)).to(
            dev)
        skip32 = torch.from_numpy(g.randn(Bx, Nx, C).astype(np.float32)).to(
            dev)
        for dtname in ("bfloat16", "float32"):
            entry = fused_fp_entry(torch, ops, label, x1, x2, pre32, skip32,
                                   dtname, True)
            es = getattr(torch, dtname).itemsize
            entry["plan"] = cuda_kernels.fp_plan(Bx, Nx, Mx, C, es,
                                                 1)._asdict()
            record("fused_fp", f"{label} {dtname}", entry)

    # training shapes, B=24
    lt = levels(TRAIN_BATCH, 51)
    B, N, M = TRAIN_BATCH, SCENE_NPOINT, lt[1].shape[1]
    label = f"semseg FP1 B={B} N={N} M={M}"
    entry, (d, idx) = three_nn_entry(torch, ops, label, lt[0], lt[1], True)
    record("three_nn", label, entry)
    three_interp_rows(
        torch, ops, cuda_kernels, f"{label} C=128", d, idx,
        torch.from_numpy(g.randn(B, M, 128).astype(np.float32)).to(dev),
        torch.from_numpy(g.randn(B, N, 128).astype(np.float32)).to(dev),
        record)
    _, radius, K, (C1, _, _) = scene_sa1_scales()[0]
    with ops.use_impl("torch"):
        idx = ops.query_ball_point(radius, K, lt[0], lt[1])
    label = f"semseg sa1 g[{B},{M},{K},{C1}] n={N} f32"
    gg = torch.from_numpy(g.randn(B, M, K, C1).astype(np.float32)).to(dev)
    record("gather_backward", label, gather_entry(
        torch, ops, label, gg, idx, N, True))


def semseg_kernel_checks(torch, ops, dev, record):
    """The fused FP tail and the bilinear sampling at fusion_sem_seg's
    serving shapes (B=16 blocks of 2048 points), against their plain twins.

    Both twins repeat their kernel's arithmetic in the same order, so the
    expected difference is 0; the bounds are the ones tests/test_fused_fp.py
    holds the Pallas kernel to (f32 1e-6, bf16 2e-2 of max|ref|) and, for
    the sampling, 1e-6 of max|ref| (f32) and one bf16 ulp (bf16)."""
    import torch.nn.functional as F
    from mm3d_tpu_torch.data.synthetic import semseg_request
    from mm3d_tpu_torch.ops import projection

    B, N = SEG_BATCH, SEG_NPOINT
    pts, _, K, R, t = (torch.from_numpy(a).to(dev)
                       for a in semseg_request(B, N, IMAGE_HW, seed=5))
    xyz = pts[..., :3].contiguous()
    with ops.use_impl("torch"):
        l1 = ops.index_points(xyz, ops.fps_torch(xyz, 256))
        l2 = ops.index_points(l1, ops.fps_torch(l1, 64))
    g = np.random.RandomState(3)

    def feats(*shape):
        return torch.from_numpy(g.randn(*shape).astype(np.float32)).to(dev)

    # ties: a duplicated sparse point with a dense point on it, and a cloud
    # on the 1/16 grid (exact distances, many equal)
    dup1, dup2 = xyz[:, :512].clone(), l1.clone()
    dup2[:, 10] = dup2[:, 3]
    dup1[:, 0] = dup2[:, 3]
    grid1 = torch.from_numpy(g.randint(-32, 33, (4, 300, 3)).astype(
        np.float32) / 16).to(dev)
    grid2 = torch.from_numpy(g.randint(-32, 33, (4, 40, 3)).astype(
        np.float32) / 16).to(dev)
    for label, x1, x2, C, timed in (
            ("FP2 N=256 M=64 C=256", l1, l2, 256, True),
            ("FP1 N=2048 M=256 C=128", xyz, l1, 128, True),
            ("duplicated sparse point", dup1, dup2, 128, False),
            ("1/16 grid, ties", grid1, grid2, 24, False)):
        pre32 = feats(x1.shape[0], x2.shape[1], C)
        skip32 = feats(x1.shape[0], x1.shape[1], C)
        for dtname in ("bfloat16", "float32"):
            record("fused_fp", f"{label} {dtname}", fused_fp_entry(
                torch, ops, label, x1, x2, pre32, skip32, dtname, timed))

    # bilinear sampling at the projected points of the request (out-of-frame
    # and behind-camera points included), on a [16,16,16,128] stride-4 map
    H, W, C = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4, 128
    uv, depth = projection.project_points(xyz, K, R, t)
    uv = (uv / 4.0).contiguous()
    integer = torch.floor(uv)
    fmap32 = feats(B, H, W, C)
    # grid_sample's normalised coordinates for the same pixel positions
    # (align_corners=True maps -1..1 onto pixel centres 0..W-1)
    grid = torch.stack([uv[..., 0] / (W - 1) * 2 - 1,
                        uv[..., 1] / (H - 1) * 2 - 1], -1)[:, :, None, :]
    for dtname, dt in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
        fmap = fmap32.to(dt)
        for label, u in ((f"map [{B},{H},{W},{C}] at {B}x{N} points", uv),
                         ("integer coordinates", integer)):
            got = ops.bilinear_sample(fmap, u)
            with ops.use_impl("torch"):
                want = ops.bilinear_sample(fmap, u)
            torch.cuda.synchronize()
            check(got.shape == (B, N, C) and got.dtype == dt,
                  f"bilinear {label} {dtname}: shape/dtype")
            gf, wf = got.float(), want.float()
            err = (gf - wf).abs()
            if dt == torch.bfloat16:
                mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
                ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
                check(bool((err <= ulp).all()),
                      f"bilinear {label} bf16: more than one bf16 ulp")
            else:
                rel = float(err.max()) / max(float(wf.abs().max()), 1e-9)
                check(rel < 1e-6, f"bilinear {label} fp32: max|d|/max|ref| "
                                  f"{rel}")
            entry = {"dtype": dtname, "max_abs_err": float(err.max()),
                     "bit_exact": bool(torch.equal(got, want))}
            if u is uv:
                inside = ((u[..., 0] > -1) & (u[..., 0] < W)
                          & (u[..., 1] > -1) & (u[..., 1] < H))
                entry["points_touching_the_map"] = float(
                    inside.float().mean())
                entry.update(times(torch, lambda: ops.bilinear_sample(
                    fmap, u), 20, kernel="bilinear"))
                check(entry["kernels_per_call"] == 1,
                      f"bilinear {label} {dtname}: "
                      f"{entry['kernels_per_call']} kernels a call")
                with ops.use_impl("torch"):
                    entry.update(times(
                        torch, lambda: ops.bilinear_sample(fmap, u), 10,
                        "plain_"))
                # the library yardstick: one grid_sample over the NCHW view
                # (it takes bf16 and f32 on the card)
                nchw = fmap.permute(0, 3, 1, 2)
                gs = grid.to(dt)

                def library():
                    return F.grid_sample(nchw, gs, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True)

                entry.update(times(torch, library, 20, "library_"))
                entry["library_max_abs_diff"] = float(
                    (library()[..., 0].permute(0, 2, 1).float() - gf).abs()
                    .max())
                es = fmap.element_size()
                entry.update(bound(B * H * W * C * es + B * N * 8
                                   + B * N * C * es,
                                   {"float32": 10 * B * N * C}))
            record("bilinear_sample", f"{label} {dtname}", entry)
    bilinear_edge_checks(torch, ops, dev, record)


def semseg_train_kernel_checks(torch, ops, dev, record):
    """three_nn and three_interpolate (forward and backward) and the
    bilinear sampling's backward at fusion_sem_seg's training shapes (B=24
    blocks of 2048 points), against their plain twins.

    three_nn and three_interpolate repeat their twin's arithmetic in the
    same order: both must be bit-exact. The backwards (three_interpolate's
    d_points and the sampling's d_feat, each one gather-backward launch)
    against autograd of the plain path: their f32 sums run in another order
    than index_add_'s, so max|d| / max|ref| <= 1e-6 in f32 and <= 1e-2 in
    bf16 (a different f32 sum can round to a neighbouring bf16 value)."""
    import torch.nn.functional as F
    from mm3d_tpu_torch.data.synthetic import semseg_request
    from mm3d_tpu_torch.ops import cuda_kernels, projection

    B, N = TRAIN_BATCH, SEG_NPOINT
    pts, _, K, R, t = (torch.from_numpy(a).to(dev)
                       for a in semseg_request(B, N, IMAGE_HW, seed=6))
    xyz = pts[..., :3].contiguous()
    with ops.use_impl("torch"):
        l1 = ops.index_points(xyz, ops.fps_torch(xyz, 256))
        l2 = ops.index_points(l1, ops.fps_torch(l1, 64))
    g = np.random.RandomState(4)

    def feats(*shape):
        return torch.from_numpy(g.randn(*shape).astype(np.float32)).to(dev)

    # --- three_nn: FP2 and FP1, a duplicated sparse point with a dense
    # point on it, and a cloud on the 1/16 grid (exact distances, many equal)
    dup1, dup2 = xyz[:, :512].clone(), l1.clone()
    dup2[:, 10] = dup2[:, 3]
    dup1[:, 0] = dup2[:, 3]
    grid1 = torch.from_numpy(g.randint(-32, 33, (4, 300, 3)).astype(
        np.float32) / 16).to(dev)
    grid2 = torch.from_numpy(g.randint(-32, 33, (4, 40, 3)).astype(
        np.float32) / 16).to(dev)
    nn = {}
    for label, x1, x2, timed in (
            ("FP2 N=256 M=64", l1, l2, True),
            ("FP1 N=2048 M=256", xyz, l1, True),
            ("duplicated sparse point", dup1, dup2, False),
            ("1/16 grid, ties", grid1, grid2, False)):
        entry, nn[label] = three_nn_entry(torch, ops, label, x1, x2, timed)
        record("three_nn", label, entry)

    # --- three_interpolate: the forward bit-exact, the backward (d_points)
    # against autograd of the plain path, at FP2 (C=256) and FP1 (C=128)
    for label, key, M, C in (("FP2 N=256 M=64 C=256", "FP2 N=256 M=64", 64,
                              256),
                             ("FP1 N=2048 M=256 C=128", "FP1 N=2048 M=256",
                              256, 128)):
        d, idx = nn[key]
        three_interp_rows(torch, ops, cuda_kernels, label, d, idx,
                          feats(B, M, C), feats(B, idx.shape[1], C), record)

    interp_edge_checks(torch, ops, dev, record)

    # --- the sampling's backward: a [24,16,16,128] map at the projected
    # points (out-of-frame and behind-camera points included)
    H, W, C = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4, 128
    uv, _ = projection.project_points(xyz, K, R, t)
    uv = (uv / 4.0).contiguous()
    fmap32, co32 = feats(B, H, W, C), feats(B, N, C)
    grid = torch.stack([uv[..., 0] / (W - 1) * 2 - 1,
                        uv[..., 1] / (H - 1) * 2 - 1], -1)[:, :, None, :]
    for dtname, dt in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
        fmap, co = fmap32.to(dt), co32.to(dt)

        def grad_of(impl):
            with ops.use_impl(impl):
                f = fmap.clone().requires_grad_(True)
                out = ops.bilinear_sample(f, uv)
            return f, out

        fk, ok_ = grad_of("auto")
        fp, op_ = grad_of("torch")
        gk = torch.autograd.grad(ok_, fk, co, retain_graph=True)[0]
        gp = torch.autograd.grad(op_, fp, co, retain_graph=True)[0]
        torch.cuda.synchronize()
        rel, err = _rel_err(gk, gp)
        check(gk.dtype == dt and gk.shape == fmap.shape
              and rel <= (1e-2 if dt == torch.bfloat16 else 1e-6),
              f"bilinear backward {dtname}: max|d|/max|ref| {rel}")
        entry = {"dtype": dtname, "max_abs_err": err, "rel_err": rel,
                 **times(torch, lambda: torch.autograd.grad(
                     ok_, fk, co, retain_graph=True), 20)}
        entry.update(times(torch, lambda: torch.autograd.grad(
            op_, fp, co, retain_graph=True), 10, "plain_"))
        # the library yardstick: grid_sample's backward on the NCHW view
        nchw = fmap.permute(0, 3, 1, 2).detach().requires_grad_(True)
        gs_out = F.grid_sample(nchw, grid.to(dt), mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        gs_co = co.permute(0, 2, 1)[..., None].contiguous()
        entry.update(times(torch, lambda: torch.autograd.grad(
            gs_out, nchw, gs_co, retain_graph=True), 20, "library_"))
        es = fmap.element_size()
        # g and uv read, d_feat written; 4 corner weights and 4 sums a
        # channel
        entry.update(bound(B * N * C * es + B * N * 8 + B * H * W * C * es,
                           {"float32": 12 * B * N * C}))
        record("bilinear_backward", f"map [{B},{H},{W},{C}] at {B}x{N} "
                                    f"points {dtname}", entry)
        weighted_gather_row(
            torch, ops, cuda_kernels, f"bilinear d_feat map [{B},{H},{W},"
            f"{C}] at {B}x{N} points {dtname} (f32 g)",
            lambda: torch.autograd.grad(ok_, fk, co, retain_graph=True),
            record)


# launches per serving forward of the cloud classifiers: FPS at SA1 and SA2,
# then bf16 the fused SA tail (over its own ball query, or over the kNN
# indices of knn_point), fp32 the unfused branch (the ball-query kernel, or
# knn_point)
SERVE_LAUNCHES = {
    # config 1: dense matmuls only, no geometry kernel
    "pointnet_cls": {"bfloat16": {}, "float32": {}},
    # three scales a block: the fused SA tail a scale (bf16) or the ball
    # query a scale (fp32), six in all
    "pointnet2_cls_msg": {
        "bfloat16": {"farthest_point_sample": 2, "fused_sa": 6},
        "float32": {"farthest_point_sample": 2, "query_ball_point": 6}},
    "fusion_cls": {
        "bfloat16": {"farthest_point_sample": 2, "fused_sa": 2},
        "float32": {"farthest_point_sample": 2, "query_ball_point": 2}},
    "pointnet2_cls_knn": {
        "bfloat16": {"farthest_point_sample": 2, "fused_sa_idx": 2},
        "float32": {"farthest_point_sample": 2}},
    "pointnet2_cls_ssg": {
        "bfloat16": {"farthest_point_sample": 2, "fused_sa": 2},
        "float32": {"farthest_point_sample": 2, "query_ball_point": 2}}}


def serve(torch, ops, cuda_kernels, dev, name, reqs):
    """A cloud classifier through make_predictor at full width (B=128, 40
    classes, random seeded weights), bf16 and fp32; ``reqs`` holds each
    request's input tensors."""
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.utils.profiling import nontrivial_bn

    model = init_params(get_model(name).builder(num_class=NUM_CLASS), seed=0)
    nontrivial_bn(model, seed=1)  # so the folds matter
    state = model.state_dict()
    preds = {"bfloat16": make_predictor(name, state, dtype=torch.bfloat16,
                                        device=dev, num_class=NUM_CLASS),
             "float32": make_predictor(name, state, device=dev,
                                       num_class=NUM_CLASS)}
    n = len(reqs)
    counts, logp = {}, {}
    for dtname, pred in preds.items():
        cuda_kernels.reset_launches()
        logp[dtname] = [pred(*r) for r in reqs]
        torch.cuda.synchronize()
        counts[dtname] = launch_counts(cuda_kernels)
        print(f"serve {name} {dtname}: {n} requests of B={BATCH}, launches "
              f"{counts[dtname]}", flush=True)
        for lp in logp[dtname]:
            check(lp.shape == (BATCH, NUM_CLASS) and lp.dtype == torch.float32,
                  f"{name} {dtname} logits shape {tuple(lp.shape)} "
                  f"{lp.dtype}")
            check(bool(torch.isfinite(lp).all()), f"{name} {dtname}: "
                                                  "non-finite")
        want = expect(cuda_kernels, **{
            k: v * n for k, v in SERVE_LAUNCHES[name][dtname].items()})
        check(counts[dtname] == want, f"{name} {dtname} launches "
                                      f"{counts[dtname]}, want {want}")
    launches = {k: counts["bfloat16"][k] + counts["float32"][k]
                for k in counts["float32"]}

    with ops.use_impl("torch"):
        plain = [preds["float32"](*r) for r in reqs]
    fp32_delta = max(float((a - b).abs().max())
                     for a, b in zip(logp["float32"], plain))
    print(f"{name} fp32 kernels path vs plain path: max|d logp| "
          f"{fp32_delta}", flush=True)
    check(fp32_delta <= 1e-4, f"{name} fp32 kernels vs plain: {fp32_delta} "
                              "> 1e-4")

    a16, a32 = torch.cat(logp["bfloat16"]), torch.cat(logp["float32"])
    agree = float((a16.argmax(-1) == a32.argmax(-1)).float().mean())
    bf16_delta = float((a16 - a32).abs().max())
    print(f"{name} bf16 vs fp32: argmax agreement {agree}, max|d logp| "
          f"{bf16_delta}", flush=True)
    check(agree >= 0.95, f"{name} bf16 vs fp32 argmax agreement {agree} "
                         "< 0.95")

    rates = {}
    for dtname, pred in preds.items():
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(torch, lambda: pred(*reqs[0]), 12, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        rates[dtname] = {"forward_ms": ms, "clouds_per_s": BATCH / ms * 1e3,
                         "peak_memory_bytes": peak}
        print(f"serve {name} {dtname}: median forward {ms} ms, "
              f"{rates[dtname]['clouds_per_s']} clouds/s at B={BATCH}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
    return {"launches": launches, "launches_by_dtype": counts,
            "fp32_kernels_vs_plain": fp32_delta,
            "bf16_vs_fp32": {"argmax_agreement": agree,
                             "max_logp_delta": bf16_delta},
            "throughput": rates}


def serve_semseg(torch, ops, cuda_kernels, dev):
    """fusion_sem_seg through make_predictor at full width, bf16 and fp32."""
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.data.synthetic import semseg_request
    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.utils.profiling import nontrivial_bn

    B, N, ncls = SEG_BATCH, SEG_NPOINT, SEG_CLASSES
    model = init_params(get_model("fusion_sem_seg").builder(num_class=ncls),
                        seed=0)
    nontrivial_bn(model, seed=1)
    state = model.state_dict()
    preds = {"bfloat16": make_predictor("fusion_sem_seg", state,
                                        dtype=torch.bfloat16, device=dev,
                                        num_class=ncls),
             "float32": make_predictor("fusion_sem_seg", state, device=dev,
                                       num_class=ncls)}
    reqs = [[torch.from_numpy(a).to(dev)
             for a in semseg_request(B, N, IMAGE_HW, seed=s)]
            for s in (20, 21, 22)]
    counts, logp = {}, {}
    for dtname, pred in preds.items():
        cuda_kernels.reset_launches()
        logp[dtname] = [pred(*r) for r in reqs]
        torch.cuda.synchronize()
        counts[dtname] = launch_counts(cuda_kernels)
        print(f"serve fusion_sem_seg {dtname}: 3 requests of B={B} x N={N}, "
              f"launches {counts[dtname]}", flush=True)
        for lp in logp[dtname]:
            check(lp.shape == (B, N, ncls) and lp.dtype == torch.float32,
                  f"semseg {dtname} log-probs shape {tuple(lp.shape)} "
                  f"{lp.dtype}")
            check(bool(torch.isfinite(lp).all()), f"semseg {dtname}: "
                                                  "non-finite")
            norm = float((lp.exp().sum(-1) - 1).abs().max())
            check(norm < 1e-4, f"semseg {dtname}: exp(log-probs) sums off 1 "
                               f"by {norm}")
    n = len(reqs)
    check(counts["bfloat16"] == expect(
        cuda_kernels, farthest_point_sample=2 * n, fused_sa=2 * n,
        fused_fp=2 * n, bilinear_sample=n),
          f"semseg bf16 launches {counts['bfloat16']}: want 2 FPS + 2 fused "
          "SA + 2 fused FP + 1 bilinear per forward")
    check(counts["float32"] == expect(
        cuda_kernels, farthest_point_sample=2 * n, query_ball_point=2 * n,
        fused_fp=2 * n, bilinear_sample=n),
          f"semseg fp32 launches {counts['float32']}: want 2 FPS + 2 ball "
          "query + 2 fused FP + 1 bilinear per forward")
    launches = {k: counts["bfloat16"][k] + counts["float32"][k]
                for k in counts["float32"]}

    # the sampling on the model's own map: ImageEncoder's NHWC map is a view
    # of a channels-last tensor, so the wrapper's feat.contiguous() copies
    # nothing and a sampling call puts one kernel on the card
    from mm3d_tpu_torch.ops import projection
    from mm3d_tpu_torch.utils.profiling import device_kernels
    pts, img, K, R, t = reqs[0]
    sampling = {}
    for dtname, pred in preds.items():
        m = pred.model
        with torch.no_grad():
            fmap, _ = m.image_trunk(img.to(m.dtype or img.dtype))
            uv = (projection.project_points(pts[..., :3], K, R, t)[0]
                  / float(m.image_stride))
        per = device_kernels(lambda: ops.bilinear_sample(fmap, uv), 10)
        sampling[dtname] = {"map_contiguous": fmap.is_contiguous(),
                            "kernels_per_call": sum(
                                n for _, n in per.values()),
                            "kernels": sorted(per)}
        print(f"semseg {dtname} sampling on the model's map: "
              f"{sampling[dtname]}", flush=True)
        check(fmap.is_contiguous() and sampling[dtname][
            "kernels_per_call"] == 1, f"semseg {dtname}: the sampling of the "
            f"model's map is not one kernel: {sampling[dtname]}")

    with torch.no_grad():
        valid = torch.cat([preds["float32"].model(*r)[1]["proj_valid"]
                           for r in reqs])
    share = float(valid.float().mean())
    print(f"semseg: share of points the camera sees (proj_valid) {share}",
          flush=True)
    check(share > 0.0, "semseg: no point projects into the image")

    with ops.use_impl("torch"):
        plain = [preds["float32"](*r) for r in reqs]
    fp32_delta = max(float((a - b).abs().max())
                     for a, b in zip(logp["float32"], plain))
    print(f"semseg fp32 kernels path vs plain path: max|d logp| "
          f"{fp32_delta}", flush=True)
    check(fp32_delta <= 1e-4, f"semseg fp32 kernels vs plain: {fp32_delta} "
                              "> 1e-4")

    a16, a32 = torch.cat(logp["bfloat16"]), torch.cat(logp["float32"])
    agree = float((a16.argmax(-1) == a32.argmax(-1)).float().mean())
    bf16_delta = float((a16 - a32).abs().max())
    print(f"semseg bf16 vs fp32: per-point argmax agreement {agree}, "
          f"max|d logp| {bf16_delta}", flush=True)
    check(agree >= 0.95, f"semseg bf16 vs fp32 argmax agreement {agree} "
                         "< 0.95")

    rates = {}
    for dtname, pred in preds.items():
        ms = cuda_ms(torch, lambda: pred(*reqs[0]), 12, warmup=3)
        rates[dtname] = {"forward_ms": ms, "clouds_per_s": B / ms * 1e3,
                         "points_per_s": B * N / ms * 1e3}
        print(f"serve fusion_sem_seg {dtname}: median forward {ms} ms, "
              f"{rates[dtname]['clouds_per_s']} clouds/s, "
              f"{rates[dtname]['points_per_s']} points/s at B={B} x N={N}",
              flush=True)
    return {"launches": launches, "launches_by_dtype": counts,
            "sampling_of_the_model_map": sampling,
            "proj_valid_share": share,
            "fp32_kernels_vs_plain": fp32_delta,
            "bf16_vs_fp32": {"argmax_agreement": agree,
                             "max_logp_delta": bf16_delta},
            "throughput": rates}


# launches of one segmentation serving forward. Part-seg: FPS at sa1 and
# sa2; bf16 the fused SA tail a scale, fp32 the ball-query kernel a scale;
# the fused FP tail at FP2 and FP1 (FP3 broadcasts sa3's one point). Sem-seg:
# FPS at sa1..sa4, the fused SA tail or the ball query a scale, the fused FP
# tail at FP4..FP1. The PointNet models: dense matmuls only, no kernel
SEG_SERVE_LAUNCHES = {
    "pointnet2_part_seg_msg": {
        "bfloat16": {"farthest_point_sample": 2, "fused_sa": 5,
                     "fused_fp": 2},
        "float32": {"farthest_point_sample": 2, "query_ball_point": 5,
                    "fused_fp": 2}},
    "pointnet2_part_seg_ssg": {
        "bfloat16": {"farthest_point_sample": 2, "fused_sa": 2,
                     "fused_fp": 2},
        "float32": {"farthest_point_sample": 2, "query_ball_point": 2,
                    "fused_fp": 2}},
    "pointnet2_sem_seg": {
        "bfloat16": {"farthest_point_sample": 4, "fused_sa": 4,
                     "fused_fp": 4},
        "float32": {"farthest_point_sample": 4, "query_ball_point": 4,
                    "fused_fp": 4}},
    "pointnet2_sem_seg_msg": {
        "bfloat16": {"farthest_point_sample": 4, "fused_sa": 8,
                     "fused_fp": 4},
        "float32": {"farthest_point_sample": 4, "query_ball_point": 8,
                    "fused_fp": 4}},
    "pointnet_part_seg": {"bfloat16": {}, "float32": {}},
    "pointnet_part_seg_lineage": {"bfloat16": {}, "float32": {}},
    "pointnet_sem_seg": {"bfloat16": {}, "float32": {}}}


def serve_seg(torch, ops, cuda_kernels, dev, name, nreq):
    """A segmentation model through make_predictor at full width, random
    seeded weights, bf16 and fp32, ``nreq`` requests each. Part-seg: B=16
    ShapeNetPart-style clouds of 2,048 points and their one-hot categories,
    50 parts, each point's argmax among its category's parts. Sem-seg: B=16
    S3DIS-style blocks of 4,096 9-dim points, 13 classes."""
    from mm3d_tpu_torch.data.synthetic import (partseg_request, scene_request,
                                               shapenet_part_ranges)
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.utils.metrics import masked_part_argmax, part_ranges
    from mm3d_tpu_torch.utils.profiling import nontrivial_bn

    spec = get_model(name)
    part = spec.task == "partseg"
    if part:
        B, N, ncls, kw = PART_BATCH, PART_NPOINT, PART_PARTS, {}
        reqs = [[torch.from_numpy(a).to(dev)
                 for a in partseg_request(B, N, seed=s)] for s in range(nreq)]
        nargs = 2  # points, one-hot
    else:
        B, N, ncls = SCENE_BATCH, SCENE_NPOINT, SEG_CLASSES
        kw = {"num_class": ncls}
        reqs = [[torch.from_numpy(a).to(dev)
                 for a in scene_request(B, N, seed=60 + s)]
                for s in range(nreq)]
        nargs = 1  # points
    model = init_params(spec.builder(**kw), seed=0)
    nontrivial_bn(model, seed=1)
    state = model.state_dict()
    preds = {"bfloat16": make_predictor(name, state, dtype=torch.bfloat16,
                                        device=dev, **kw),
             "float32": make_predictor(name, state, device=dev, **kw)}
    start, count = part_ranges(shapenet_part_ranges(), dev)
    counts, logp = {}, {}
    for dtname, pred in preds.items():
        cuda_kernels.reset_launches()
        logp[dtname] = [pred(*r[:nargs]) for r in reqs]
        torch.cuda.synchronize()
        counts[dtname] = launch_counts(cuda_kernels)
        print(f"serve {name} {dtname}: {nreq} requests of B={B} x N={N}, "
              f"launches {counts[dtname]}", flush=True)
        for lp in logp[dtname]:
            check(lp.shape == (B, N, ncls) and lp.dtype == torch.float32,
                  f"{name} {dtname} log-probs shape {tuple(lp.shape)} "
                  f"{lp.dtype}")
            check(bool(torch.isfinite(lp).all()), f"{name} {dtname}: "
                                                  "non-finite")
            norm = float((lp.exp().sum(-1) - 1).abs().max())
            check(norm < 1e-4, f"{name} {dtname}: exp(log-probs) sums off 1 "
                               f"by {norm}")
        want = expect(cuda_kernels, **{
            k: v * nreq for k, v in SEG_SERVE_LAUNCHES[name][dtname].items()})
        check(counts[dtname] == want, f"{name} {dtname} launches "
                                      f"{counts[dtname]}, want {want}")
    launches = {k: counts["bfloat16"][k] + counts["float32"][k]
                for k in counts["float32"]}

    with ops.use_impl("torch"):
        plain = [preds["float32"](*r[:nargs]) for r in reqs]
    fp32_delta = max(float((a - b).abs().max())
                     for a, b in zip(logp["float32"], plain))
    print(f"{name} fp32 kernels path vs plain path: max|d logp| "
          f"{fp32_delta}", flush=True)
    check(fp32_delta <= 1e-4, f"{name} fp32 kernels vs plain: {fp32_delta} "
                              "> 1e-4")

    # part-seg: each point's part among its category's parts, as the eval
    # takes it
    def labels(lp, r):
        if not part:
            return lp.argmax(-1)
        cat = r[2].long()
        return masked_part_argmax(lp, start[cat], count[cat])

    a16 = torch.cat([labels(lp, r) for lp, r in zip(logp["bfloat16"], reqs)])
    a32 = torch.cat([labels(lp, r) for lp, r in zip(logp["float32"], reqs)])
    agree = float((a16 == a32).float().mean())
    bf16_delta = max(float((a - b).abs().max())
                     for a, b in zip(logp["bfloat16"], logp["float32"]))
    what = "category-masked argmax" if part else "argmax"
    print(f"{name} bf16 vs fp32: per-point {what} agreement {agree}, "
          f"max|d logp| {bf16_delta}", flush=True)
    check(agree >= 0.95, f"{name} bf16 vs fp32 argmax agreement {agree} "
                         "< 0.95")

    rates = {}
    for dtname, pred in preds.items():
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(torch, lambda: pred(*reqs[0][:nargs]), 12, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        rates[dtname] = {"forward_ms": ms, "clouds_per_s": B / ms * 1e3,
                         "points_per_s": B * N / ms * 1e3,
                         "peak_memory_bytes": peak}
        print(f"serve {name} {dtname}: median forward {ms} ms, "
              f"{rates[dtname]['clouds_per_s']} clouds/s, "
              f"{rates[dtname]['points_per_s']} points/s at B={B} x N={N}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
    del preds
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_dtype": counts,
            "fp32_kernels_vs_plain": fp32_delta,
            "bf16_vs_fp32": {("masked_argmax_agreement" if part
                              else "argmax_agreement"): agree,
                             "max_logp_delta": bf16_delta},
            "throughput": rates}


# phase 3g: the artifacts served through mm3d_tpu_torch.serving, each with
# the mm3d operator nodes its graph must hold (one a kernel launch of a
# forward, as phases 3, 3b and 3c count them)
ARTIFACTS = (
    ("fusion_cls", "bfloat16", SERVE_LAUNCHES["fusion_cls"]["bfloat16"]),
    ("fusion_cls", "float32", SERVE_LAUNCHES["fusion_cls"]["float32"]),
    ("pointnet2_cls_knn", "bfloat16",
     SERVE_LAUNCHES["pointnet2_cls_knn"]["bfloat16"]),
    ("fusion_sem_seg", "bfloat16",
     {"farthest_point_sample": 2, "fused_sa": 2, "fused_fp": 2,
      "bilinear_sample": 1}))
# requests a served artifact gets over HTTP: one round at the artifact's
# batch, batch + 72 (two chunks, the second wrap-padded) and 1, then
# CLIENTS concurrent clients sending that round each, then P50_REQUESTS at
# the artifact's batch for the latency
EXTRA_ROWS, CLIENTS, P50_REQUESTS = 72, 4, 8


def _post(base, arrays, timeout=300):
    """(status, log_probs or the error body) of one /predict."""
    import io
    import urllib.error
    import urllib.request
    from mm3d_tpu_torch.serving import _npz_bytes

    req = urllib.request.Request(
        f"{base}/predict", method="POST",
        data=_npz_bytes(**{f"arg{i}": a for i, a in enumerate(arrays)}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, np.load(io.BytesIO(resp.read()))["log_probs"]
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(base, route):
    import urllib.request
    with urllib.request.urlopen(f"{base}{route}", timeout=60) as resp:
        return json.loads(resp.read())


def _chunked(pred, arrays, batch):
    """make_predictor's log-probs for the chunks a fixed-batch artifact
    runs (each of ``batch`` rows, the last wrap-padded with its first
    row), the padding dropped."""
    out = []
    for lo in range(0, arrays[0].shape[0], batch):
        chunk = [a[lo:lo + batch] for a in arrays]
        got = chunk[0].shape[0]
        chunk = [np.concatenate([c] + [c[:1]] * (batch - got)) for c in chunk]
        out.append(pred(*chunk).cpu().numpy()[:got])
    return np.concatenate(out)


def serve_artifacts(torch, cuda_kernels, dev, card):
    """3g: each of ARTIFACTS exported on the card from make_predictor at
    full width (random seeded weights), saved, loaded into a fresh
    PredictionService and served over HTTP on loopback."""
    import tempfile
    import threading
    from mm3d_tpu_torch import serving
    from mm3d_tpu_torch.data.synthetic import semseg_request
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.training.inference import export_serving, save_serving
    from mm3d_tpu_torch.utils.profiling import nontrivial_bn

    def inputs(name, B, seed):
        if name == "fusion_sem_seg":
            return semseg_request(B, SEG_NPOINT, IMAGE_HW, seed=seed)
        if name == "pointnet2_cls_knn":
            return [unit_sphere_clouds(np.random.RandomState(seed), B,
                                       NPOINT)]
        return list(request(seed, B))

    total = {k.__name__: 0 for k in cuda_kernels.KERNELS}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, dtname, nodes in ARTIFACTS:
            label = f"{name} {dtname}"
            ncls = SEG_CLASSES if name == "fusion_sem_seg" else NUM_CLASS
            batch = SEG_BATCH if name == "fusion_sem_seg" else BATCH
            model = init_params(get_model(name).builder(num_class=ncls),
                                seed=0)
            nontrivial_bn(model, seed=1)
            pred = make_predictor(
                name, model.state_dict(), device=dev, num_class=ncls,
                dtype=torch.bfloat16 if dtname == "bfloat16" else None)
            t0 = time.perf_counter()
            ep = export_serving(pred, inputs(name, batch, 70))
            export_s = time.perf_counter() - t0
            got_nodes, calls = {}, {}
            for n in ep.graph.nodes:
                if n.op == "call_function":
                    calls[str(n.target)] = calls.get(str(n.target), 0) + 1
                    if str(n.target).startswith("mm3d."):
                        op = str(n.target).split(".")[1]
                        got_nodes[op] = got_nodes.get(op, 0) + 1
            check(got_nodes == nodes, f"3g {label}: graph's mm3d nodes "
                                      f"{got_nodes}, want {nodes}")
            path = os.path.join(tmp, f"{name}_{dtname}.pt2")
            save_serving(path, ep)
            del ep
            t0 = time.perf_counter()
            service = serving.PredictionService(path, device=dev.type)
            service.warmup()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            check(service.batch == batch, f"3g {label}: artifact batch "
                                          f"{service.batch}, want {batch}")

            rnd = [inputs(name, B, 71 + i)
                   for i, B in enumerate((batch, batch + EXTRA_ROWS, 1))]
            want = [_chunked(pred, r, batch) for r in rnd]
            server = serving.make_server(service, "127.0.0.1", 0)
            small = serving.make_server(service, "127.0.0.1", 0,
                                        max_body_mb=0.001)
            for s in (server, small):
                threading.Thread(target=s.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            try:
                cuda_kernels.reset_launches()
                serial = [_post(base, r) for r in rnd]
                answers = [None] * (CLIENTS * len(rnd))

                def client(c):
                    for i, r in enumerate(rnd):
                        answers[c * len(rnd) + i] = _post(base, r)

                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(CLIENTS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                torch.cuda.synchronize()
                launches = launch_counts(cuda_kernels)
                check(not any(t.is_alive() for t in threads),
                      f"3g {label}: a client did not finish")
                metrics = _get(base, "/metrics")
                spec = _get(base, "/spec")
                code413, _ = _post(
                    f"http://127.0.0.1:{small.server_address[1]}", rnd[0])
                lat = []
                for _ in range(P50_REQUESTS):
                    t0 = time.perf_counter()
                    code, _ = _post(base, rnd[0])
                    lat.append(time.perf_counter() - t0)
                    check(code == 200, f"3g {label}: /predict {code}")
            finally:
                for s in (server, small):
                    s.shutdown()
                    s.server_close()

            for (code, lp), r in zip(serial, rnd):
                check(code == 200, f"3g {label}: /predict at B="
                                   f"{r[0].shape[0]} answered {code}: {lp}")
                check(lp.shape[0] == r[0].shape[0]
                      and bool(np.isfinite(lp).all()),
                      f"3g {label}: log-probs {lp.shape}, or not finite")
            deltas = [float(np.abs(lp - w).max())
                      for (_, lp), w in zip(serial, want)]
            agree = min(float(np.mean(lp.argmax(-1) == w.argmax(-1)))
                        for (_, lp), w in zip(serial, want))
            print(f"3g {label}: artifact vs make_predictor at B = {batch}, "
                  f"{batch + EXTRA_ROWS}, 1: max|d logp| {deltas}, argmax "
                  f"agreement {agree}", flush=True)
            if dtname == "float32":
                check(max(deltas) <= 1e-5, f"3g {label}: artifact vs "
                      f"make_predictor max|d logp| {max(deltas)} > 1e-5")
            else:
                check(agree == 1.0, f"3g {label}: artifact vs make_predictor "
                                    f"argmax agreement {agree} < 1")
            same = all(code == 200 and np.array_equal(lp, serial[i % len(
                rnd)][1]) for i, (code, lp) in enumerate(answers))
            check(same, f"3g {label}: {CLIENTS} concurrent clients did not "
                        "get the serial answers bit for bit")
            nreq = (1 + CLIENTS) * len(rnd)
            forwards = (1 + CLIENTS) * sum(-(-r[0].shape[0] // batch)
                                           for r in rnd)
            clouds = (1 + CLIENTS) * sum(r[0].shape[0] for r in rnd)
            check((metrics["requests_total"], metrics["errors_total"],
                   metrics["clouds_total"]) == (nreq, 0, clouds),
                  f"3g {label}: /metrics {metrics}, want {nreq} requests, "
                  f"0 errors, {clouds} clouds")
            check(code413 == 413, f"3g {label}: an oversize body got "
                                  f"{code413}, not 413")
            check(spec["batch"] == batch and spec["platforms"] == [dev.type],
                  f"3g {label}: /spec {spec}")
            want_launches = expect(cuda_kernels, **{
                k: v * forwards for k, v in nodes.items()})
            check(launches == want_launches, f"3g {label}: launches "
                  f"{launches} while serving, want {want_launches}")
            for k, v in launches.items():
                total[k] += v

            targs = [torch.from_numpy(a).to(dev) for a in rnd[0]]
            with torch.no_grad():
                art_ms = cuda_ms(torch, lambda: service._fn(*targs), 12,
                                 warmup=3)
                # device time and kernels of a forward (torch.profiler): the
                # same work on the card, or more?
                art_dev = times(torch, lambda: service._fn(*targs), 5,
                                kernel="")
            pred_ms = cuda_ms(torch, lambda: pred(*targs), 12, warmup=3)
            pred_dev = times(torch, lambda: pred(*targs), 5, kernel="")
            p50 = float(np.median(lat))
            out[label] = {
                "export_s": export_s, "load_warmup_s": load_s,
                "graph_nodes": got_nodes, "forwards": forwards,
                "launches": launches, "max_logp_delta": deltas,
                "argmax_agreement": agree, "artifact_forward_ms": art_ms,
                "predictor_forward_ms": pred_ms,
                "artifact_device": art_dev, "predictor_device": pred_dev,
                "graph_calls": sum(calls.values()),
                "graph_calls_by_target": calls, "http_p50_s": p50,
                "http_latency_s": lat, "metrics": metrics}
            print(f"3g {label}: export {export_s} s, load + warmup {load_s} "
                  f"s; forward at B={batch}: artifact {art_ms} ms, "
                  f"make_predictor {pred_ms} ms (device busy "
                  f"{art_dev['ms']} / {pred_dev['ms']} ms, kernels "
                  f"{art_dev['kernels_per_call']} / "
                  f"{pred_dev['kernels_per_call']}; graph "
                  f"{sum(calls.values())} calls, "
                  f"{calls.get('aten._assert_tensor_metadata.default', 0)} "
                  f"of them dtype asserts); HTTP p50 {p50} s over "
                  f"{P50_REQUESTS} requests; {card}", flush=True)
            del service, pred, model
            torch.cuda.empty_cache()
    check(all(total[k] > 0 for k in (
        "farthest_point_sample", "query_ball_point", "fused_sa",
        "fused_sa_idx", "fused_fp", "bilinear_sample")),
          f"3g: an operator never launched while the artifacts served: "
          f"{total}")
    return {"launches": total, "artifacts": out}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()}


def step_parity(torch, label, dtype, kmodel, pmodel, mk, mp,
                residue_share=RESIDUE, rel=None):
    """One train step on the kernel path (kmodel, metrics mk) against one on
    the plain path (pmodel, mp) from the same state, batch and draws: the
    loss, every gradient and the BN statistics, to PERF.md's limits. Each
    gradient within ``rel`` (default GRAD_REL, bf16 BF16_GRAD_REL) of its
    largest element; one whose largest element is below ``residue_share``
    of the model's largest is rounding residue, held to that scale."""
    lk, lp = float(mk["loss"]), float(mp["loss"])
    loss_rel = abs(lk - lp) / abs(lp)
    check(loss_rel <= 1e-5, f"{label}: loss kernel {lk} vs plain {lp}")
    if rel is None:
        rel = BF16_GRAD_REL if dtype is not None else GRAD_REL
    gk, gp = _grads(kmodel), _grads(pmodel)
    top = max(float(g.float().abs().max()) for g in gp.values())
    residue, errs, bad = [], {}, []
    for n in gk:
        d = float((gk[n].float() - gp[n].float()).abs().max())
        scale = float(gp[n].float().abs().max())
        biggest = max(scale, float(gk[n].float().abs().max()))
        if biggest <= residue_share * top:
            residue.append(n)
            if d > residue_share * top:
                bad.append(f"residue grad {n} max|d| {d}")
            continue
        errs[n] = d / (scale + 1e-30)
        if d > rel * scale + GRAD_ABS:
            bad.append(f"grad {n} max|d| {d} vs max|g| {scale}")
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    check(not bad, f"{label}: {bad}; worst max|d|/max|g| {worst}")
    worst_grad = worst[0][1] if worst else 0.0
    sk, sp = _stats(kmodel), _stats(pmodel)
    worst_stat = max(float(((sk[n] - sp[n]).abs()
                            - 1e-5 * sp[n].abs()).max()) for n in sk)
    check(worst_stat <= 1e-5, f"{label}: BN statistics differ ({worst_stat})")
    print(f"{label}: kernel vs plain step: loss {lk} vs {lp}, worst grad "
          f"max|d|/max|g| {worst_grad} over {len(gk) - len(residue)} tensors, "
          f"{len(residue)} residue tensors (max|g| <= {residue_share} x {top}),"
          " BN stats ok", flush=True)
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel": loss_rel,
            "max_grad_rel_to_max": worst_grad, "worst_grads": worst,
            "largest_grad": top, "residue_grads": residue,
            "bn_stats_excess": worst_stat}


# launches of one train step: the FPS and grouping of SA1 and SA2 (kNN
# grouping is knn_point, no kernel) and the gather backward of each
TRAIN_LAUNCHES = {
    "pointnet_cls": {},  # config 1: dense matmuls only
    "fusion_cls": {"farthest_point_sample": 2, "query_ball_point": 2,
                   "gather_backward": 2},
    "pointnet2_cls_knn": {"farthest_point_sample": 2, "gather_backward": 2}}


def train(torch, ops, cuda_kernels, dev, log_root, name="fusion_cls"):
    """Training of a cloud classifier at full width (``fusion_cls``,
    ``pointnet2_cls_knn`` or ``pointnet_cls``), fp32 (TF32 off) then bf16.
    For ``pointnet_cls`` also the feature-transform regulariser's term of
    the stepped model, which must be finite."""
    import copy

    from mm3d_tpu_torch.data.augment import TASK_PIPELINES
    from mm3d_tpu_torch.data.pipeline import DataPipeline
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import TrainConfig, Trainer, steps
    from mm3d_tpu_torch.training.loop import build_datasets
    from mm3d_tpu_torch.training.state import make_optimizer

    spec = get_model(name)
    task = spec.task
    names = TASK_PIPELINES[task]
    cfg0 = TrainConfig(model=name, train_size=TRAIN_SIZE,
                       test_size=TEST_SIZE, epochs=1, num_class=NUM_CLASS,
                       batch_size=TRAIN_BATCH, npoint=NPOINT)
    train_ds, _ = build_datasets(cfg0, task)
    batch = next(iter(DataPipeline(train_ds, TRAIN_BATCH, shuffle=False,
                                   to_device=dev).epoch(0)))
    out = {"launches": expect(cuda_kernels)}

    def make(dtype, seed=0):
        model = init_params(spec.builder(num_class=NUM_CLASS, dtype=dtype),
                            seed).to(dev)
        return model

    def stepper(model, gen_seed=7, fixed=False):
        """The train step; ``fixed``: no augmentation and no dropout, so
        every step sees the very same batch."""
        opt = make_optimizer(model.parameters(), "adam", 1e-4)
        gen = torch.Generator(dev).manual_seed(gen_seed)
        return steps.make_train_step(
            model, spec.loss, opt, task,
            augment_names=() if fixed else names, generator=gen,
            deterministic=True if fixed else None)

    for dtname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        res = {}
        # (a) kernel path vs plain path, one step from the same state and
        # batch (same generator seed: same augmentation and dropout draws);
        # cuDNN deterministic, so the convolutions agree too
        torch.backends.cudnn.deterministic = True
        kmodel = make(dtype)
        pmodel = copy.deepcopy(kmodel)
        kstep, pstep = stepper(kmodel), stepper(pmodel)
        cuda_kernels.reset_launches()
        mk = kstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        per_step = launch_counts(cuda_kernels)
        with ops.use_impl("torch"):
            mp = pstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        label = f"train {name} {dtname}"
        res["kernel_vs_plain"] = step_parity(torch, label, dtype, kmodel,
                                             pmodel, mk, mp)
        if name == "pointnet_cls":  # the model with a feature transform
            from mm3d_tpu_torch.models.pointnet import (
                feature_transform_regularizer)
            with torch.no_grad():
                _, aux = kmodel.eval()(batch["points"])
            reg = float(feature_transform_regularizer(aux["trans_feat"]))
            check(np.isfinite(reg), f"{label}: regulariser {reg}")
            res["regularizer_term"] = 0.001 * reg
            print(f"{label}: feature-transform regulariser {reg} (term "
                  f"{0.001 * reg} of the loss)", flush=True)
        # (b) launches of one step, of a BN refresh and of an eval forward
        want = expect(cuda_kernels, **TRAIN_LAUNCHES[name])
        check(per_step == want, f"{label}: launches per step "
                                f"{per_step}, want {want}")
        refresh = steps.make_bn_refresh_step(
            kmodel, task, names, torch.Generator(dev).manual_seed(3))
        evaluate = steps.make_eval_step(kmodel, spec.loss, task, NUM_CLASS)
        cuda_kernels.reset_launches()
        refresh(batch)
        em = evaluate(batch)
        torch.cuda.synchronize()
        side = launch_counts(cuda_kernels)
        check(side["gather_backward"] == 0,
              f"{label}: BN refresh + eval launched {side}")
        check(int(em["count"]) == TRAIN_BATCH, "eval count")
        res["launches_per_step"] = per_step
        res["launches_refresh_plus_eval"] = side
        print(f"{label}: launches per step {per_step}; BN refresh + "
              f"eval forward {side}", flush=True)
        # (c) ten steps on one fixed batch: finite losses, and the loss
        # falls
        model = make(dtype, seed=1)
        fixed = stepper(model, gen_seed=11, fixed=True)
        losses = [float(fixed(batch, 1e-3, 0.1)["loss"]) for _ in range(10)]
        check(all(np.isfinite(losses)), f"{label}: losses {losses}")
        check(losses[-1] < losses[0], f"{label}: loss did not fall "
                                      f"{losses}")
        res["fixed_batch_losses"] = losses
        print(f"{label}: 10 steps on one batch, losses {losses}",
              flush=True)
        # (e) step time at B=24 (the full step: augmentation, dropout):
        # CUDA events over 10 steps after 3 warm-ups
        step = stepper(model, gen_seed=13)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(torch, lambda: step(batch, 1e-3, 0.1), 10, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        res["step_ms"] = ms
        res["clouds_per_s"] = TRAIN_BATCH / ms * 1e3
        res["peak_memory_bytes"] = peak
        print(f"{label}: median step {ms} ms, "
              f"{res['clouds_per_s']} clouds/s at B={TRAIN_BATCH}, peak "
              f"memory {peak / 2**30:.3f} GiB", flush=True)
        del kmodel, pmodel, model
        # (d) the main path: one epoch of Trainer.fit (10 steps; eval over
        # 48 clouds; in bf16 the 8-step BN refresh before it)
        cfg = TrainConfig(model=name, train_size=TRAIN_SIZE,
                          test_size=TEST_SIZE, epochs=1, num_class=NUM_CLASS,
                          batch_size=TRAIN_BATCH, npoint=NPOINT,
                          dtype=dtname, device=str(dev), log_dir=log_root)
        trainer = Trainer(cfg)
        cuda_kernels.reset_launches()
        final = trainer.fit()
        torch.cuda.synchronize()
        fit_launches = launch_counts(cuda_kernels)
        nsteps = trainer.train_pipe.steps_per_epoch()
        hist = trainer.history[0]
        check(nsteps == 10, f"fit: {nsteps} steps")
        check(fit_launches["gather_backward"]
              == TRAIN_LAUNCHES[name].get("gather_backward", 0) * nsteps,
              f"fit {label}: launches {fit_launches}")
        check(np.isfinite(hist["train"]["loss"])
              and np.isfinite(final["eval_loss"])
              and 0.0 <= final["instance_acc"] <= 1.0,
              f"fit {label}: metrics {hist}")
        for k, v in fit_launches.items():
            out["launches"][k] += v
        res["fit"] = {"train": hist["train"], "eval": final,
                      "launches": fit_launches,
                      "bn_refresh_steps": trainer._bn_refresh_n}
        print(f"fit {label}: 1 epoch of {nsteps} steps, train "
              f"{hist['train']}, eval {final}, launches {fit_launches}",
              flush=True)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
        out[dtname] = res
    return out


def train_semseg(torch, ops, cuda_kernels, dev, log_root):
    """fusion_sem_seg training at full width, fp32 (TF32 off) then bf16."""
    import copy

    from mm3d_tpu_torch.data.augment import TASK_PIPELINES
    from mm3d_tpu_torch.data.pipeline import DataPipeline
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import TrainConfig, Trainer, steps
    from mm3d_tpu_torch.training.loop import build_datasets
    from mm3d_tpu_torch.training.state import make_optimizer

    spec = get_model("fusion_sem_seg")
    task, names = "fusion_semseg", TASK_PIPELINES["fusion_semseg"]
    B, N, ncls = TRAIN_BATCH, SEG_NPOINT, SEG_CLASSES

    def config(**kw):
        return TrainConfig(model="fusion_sem_seg", train_size=SEG_TRAIN_SIZE,
                           test_size=SEG_TEST_SIZE, epochs=1, batch_size=B,
                           npoint=N, seg_classes=ncls, **kw)

    train_ds, _ = build_datasets(config(), task)
    batch = next(iter(DataPipeline(train_ds, B, shuffle=False,
                                   to_device=dev).epoch(0)))
    out = {"launches": expect(cuda_kernels)}

    def make(dtype, seed=0):
        return init_params(spec.builder(num_class=ncls, dtype=dtype),
                           seed).to(dev)

    def stepper(model, gen_seed=7):
        opt = make_optimizer(model.parameters(), "adam", 1e-4)
        return steps.make_train_step(
            model, spec.loss, opt, task, augment_names=names,
            generator=torch.Generator(dev).manual_seed(gen_seed))

    for dtname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        res = {}
        # (a) kernel path vs plain path, one step from the same state and
        # batch (same generator seed: same rotation and dropout draws)
        torch.backends.cudnn.deterministic = True
        kmodel = make(dtype)
        pmodel = copy.deepcopy(kmodel)
        kstep, pstep = stepper(kmodel), stepper(pmodel)
        cuda_kernels.reset_launches()
        mk = kstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        per_step = launch_counts(cuda_kernels)
        with ops.use_impl("torch"):
            mp = pstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        label = f"train fusion_sem_seg {dtname}"
        res["kernel_vs_plain"] = step_parity(
            torch, label, dtype, kmodel, pmodel, mk, mp,
            *((RESIDUE, GRAD_REL) if dtype is None
              else (BF16_RESIDUE, BF16_SEG_GRAD_REL)))
        # (b) launches of one step, of a BN refresh and of an eval forward
        want = expect(cuda_kernels, farthest_point_sample=2,
                      query_ball_point=2, gather_backward=5,
                      bilinear_sample=1, three_nn=2, three_interpolate=2)
        check(per_step == want, f"{label}: launches per step {per_step}, "
                                f"want {want}")
        refresh = steps.make_bn_refresh_step(
            kmodel, task, names, torch.Generator(dev).manual_seed(3))
        evaluate = steps.make_eval_step(kmodel, spec.loss, task, ncls)
        cuda_kernels.reset_launches()
        refresh(batch)
        em = evaluate(batch)
        torch.cuda.synchronize()
        side = launch_counts(cuda_kernels)
        check(side["gather_backward"] == 0 and side["three_nn"] == 2
              and side["three_interpolate"] == 2 and side["fused_fp"] == 2
              and side["bilinear_sample"] == 2,
              f"{label}: BN refresh + eval launched {side}")
        check(int(em["count"]) == B * N, f"{label}: eval count")
        res["launches_per_step"] = per_step
        res["launches_refresh_plus_eval"] = side
        print(f"{label}: launches per step {per_step}; BN refresh + eval "
              f"forward {side}", flush=True)
        # (e) step time at B=24 x 2048 (the full step: rotation, dropout):
        # CUDA events over 10 steps after 3 warm-ups
        step = stepper(kmodel, gen_seed=13)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(torch, lambda: step(batch, 1e-3, 0.1), 10, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        res.update({"step_ms": ms, "clouds_per_s": B / ms * 1e3,
                    "points_per_s": B * N / ms * 1e3,
                    "peak_memory_bytes": peak})
        print(f"{label}: median step {ms} ms, {res['clouds_per_s']} "
              f"clouds/s, {res['points_per_s']} points/s at B={B} x N={N}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
        del kmodel, pmodel, step, kstep, pstep
        # (d) the main path: one short epoch of Trainer.fit (3 steps; eval
        # over 24 blocks; in bf16 the BN refresh before it)
        trainer = Trainer(config(dtype=dtname, device=str(dev),
                                 log_dir=log_root))
        cuda_kernels.reset_launches()
        final = trainer.fit()
        torch.cuda.synchronize()
        fit_launches = launch_counts(cuda_kernels)
        nsteps = trainer.train_pipe.steps_per_epoch()
        hist = trainer.history[0]
        check(nsteps == SEG_TRAIN_SIZE // B, f"fit: {nsteps} steps")
        check(fit_launches["gather_backward"] == 5 * nsteps
              and fit_launches["three_nn"] >= 2 * nsteps
              and fit_launches["three_interpolate"] >= 2 * nsteps
              and fit_launches["fused_fp"] == 2 * (SEG_TEST_SIZE // B),
              f"fit {label}: launches {fit_launches}")
        check(np.isfinite(hist["train"]["loss"])
              and np.isfinite(final["eval_loss"])
              and 0.0 <= final["point_acc"] <= 1.0
              and 0.0 <= final["miou"] <= 1.0,
              f"fit {label}: metrics {hist}")
        for k, v in fit_launches.items():
            out["launches"][k] += v
        res["fit"] = {"train": hist["train"], "eval": final,
                      "launches": fit_launches,
                      "bn_refresh_steps": trainer._bn_refresh_n}
        print(f"fit {label}: 1 epoch of {nsteps} steps, train "
              f"{hist['train']}, eval {final}, launches {fit_launches}",
              flush=True)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
        out[dtname] = res
    return out


# launches of one segmentation train step: FPS at each SA block, the ball
# query a scale and the gather backward of each scale's gather, the 3-NN
# and interpolation of each FP block past one sparse point (pointnet2_part_
# seg_msg: FP2 and FP1; pointnet2_sem_seg: FP4..FP1) and each
# interpolation's (weighted) gather backward
SEG_TRAIN_LAUNCHES = {
    "pointnet2_part_seg_msg": {
        "farthest_point_sample": 2, "query_ball_point": 5, "three_nn": 2,
        "three_interpolate": 2, "gather_backward": 7},
    "pointnet2_sem_seg": {
        "farthest_point_sample": 4, "query_ball_point": 4, "three_nn": 4,
        "three_interpolate": 4, "gather_backward": 8}}


def train_seg(torch, ops, cuda_kernels, dev, name, log_root):
    """Training of a segmentation model at full width, fp32 (TF32 off) then
    bf16: pointnet2_part_seg_msg (B=24 clouds of 2,048 points, the part-seg
    eval) or pointnet2_sem_seg (B=24 blocks of 4,096 points, the semseg
    eval: a confusion matrix and its mIoU)."""
    import copy

    from mm3d_tpu_torch.data.augment import TASK_PIPELINES
    from mm3d_tpu_torch.data.pipeline import DataPipeline
    from mm3d_tpu_torch.data.synthetic import shapenet_part_ranges
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import TrainConfig, Trainer, steps
    from mm3d_tpu_torch.training.loop import build_datasets
    from mm3d_tpu_torch.training.state import make_optimizer
    from mm3d_tpu_torch.utils.metrics import part_ranges

    spec = get_model(name)
    task = spec.task
    part = task == "partseg"
    names = TASK_PIPELINES[task]
    B = TRAIN_BATCH
    if part:
        N, ncls, model_kw = PART_NPOINT, PART_PARTS, {}
        sizes = {"train_size": PART_TRAIN_SIZE, "test_size": PART_TEST_SIZE}
    else:
        N, ncls = SCENE_NPOINT, SEG_CLASSES
        model_kw = {"num_class": SEG_CLASSES}
        sizes = {"train_size": SCENE_TRAIN_SIZE,
                 "test_size": SCENE_TEST_SIZE, "seg_classes": SEG_CLASSES}
    train_launches = SEG_TRAIN_LAUNCHES[name]

    def config(**kw):
        return TrainConfig(model=name, epochs=1, batch_size=B, npoint=N,
                           **sizes, **kw)

    train_ds, _ = build_datasets(config(), task)
    batch = next(iter(DataPipeline(train_ds, B, shuffle=False,
                                   to_device=dev).epoch(0)))
    start, count = part_ranges(shapenet_part_ranges(), dev)
    out = {"launches": expect(cuda_kernels)}

    def make(dtype, seed=0):
        return init_params(spec.builder(dtype=dtype, **model_kw),
                           seed).to(dev)

    def stepper(model, gen_seed=7, fixed=False):
        """The train step; ``fixed``: no augmentation and no dropout, so
        every step sees the very same batch."""
        opt = make_optimizer(model.parameters(), "adam", 1e-4)
        return steps.make_train_step(
            model, spec.loss, opt, task,
            augment_names=() if fixed else names,
            generator=torch.Generator(dev).manual_seed(gen_seed),
            deterministic=True if fixed else None)

    for dtname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        res = {}
        # (a) kernel path vs plain path, one step from the same state and
        # batch (same generator seed: same augmentation and dropout draws).
        # The plain path's gather backward is CUDA index_add_, whose atomics
        # sum each row in a new order on every call; in bf16 the backward
        # carries such an f32 difference, rounded to a neighbouring bf16
        # value, through BN backwards whose sums cancel. In deterministic
        # mode index_add_ sums each row in ascending order, the kernel's, so
        # that plain step is the reference here; two more plain steps in
        # the atomic order measure the spread of the default one
        kmodel = make(dtype)
        pmodel, amodel, bmodel = (copy.deepcopy(kmodel) for _ in range(3))
        kstep, pstep = stepper(kmodel), stepper(pmodel)
        astep, bstep = stepper(amodel), stepper(bmodel)
        cuda_kernels.reset_launches()
        mk = kstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        per_step = launch_counts(cuda_kernels)
        with ops.use_impl("torch"):
            torch.use_deterministic_algorithms(True)
            try:
                mp = pstep(batch, 1e-3, 0.1)
            finally:
                torch.use_deterministic_algorithms(False)
            astep(batch, 1e-3, 0.1)
            bstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        label = f"train {name} {dtname}"
        res["kernel_vs_plain"] = step_parity(torch, label, dtype, kmodel,
                                             pmodel, mk, mp)
        gk, gp = _grads(kmodel), _grads(pmodel)
        sk, sp = _stats(kmodel), _stats(pmodel)
        res["bit_identical"] = (
            float(mk["loss"]) == float(mp["loss"])
            and all(torch.equal(gk[n], gp[n]) for n in gk)
            and all(torch.equal(sk[n], sp[n]) for n in sk))
        # recorded, not gates: the largest gradient difference over the
        # model's largest gradient element, kernel vs the atomic-order
        # plain step and that step vs another
        ga, gb = _grads(amodel), _grads(bmodel)
        top = max(float(g.float().abs().max()) for g in ga.values())

        def spread(x, y):
            d, n = max((float((x[n].float() - y[n].float()).abs().max()), n)
                       for n in x)
            return {"max_abs_over_top": d / top, "tensor": n}

        res["kernel_vs_atomic_plain"] = spread(gk, ga)
        res["atomic_plain_vs_itself"] = spread(gb, ga)
        print(f"{label}: kernel step bit-identical with the deterministic "
              f"plain step: {res['bit_identical']}; largest gradient "
              f"difference / largest gradient, kernel vs atomic-order plain "
              f"{res['kernel_vs_atomic_plain']}, atomic-order plain twice "
              f"{res['atomic_plain_vs_itself']}", flush=True)
        # (b) launches of one step, of a BN refresh and of an eval forward
        want = expect(cuda_kernels, **train_launches)
        check(per_step == want, f"{label}: launches per step {per_step}, "
                                f"want {want}")
        refresh = steps.make_bn_refresh_step(
            kmodel, task, names, torch.Generator(dev).manual_seed(3))
        evaluate = steps.make_eval_step(
            kmodel, spec.loss, task, ncls,
            **({"part_start": start, "part_count": count,
                "max_parts": int(count.max())} if part else {}))
        cuda_kernels.reset_launches()
        refresh(batch)
        em = evaluate(batch)
        torch.cuda.synchronize()
        side = launch_counts(cuda_kernels)
        # the refresh: a train forward (ball queries, 3-NN, interpolation);
        # the eval: serving's launches in the model's dtype
        serve_l = SEG_SERVE_LAUNCHES[name][dtname]
        check(side == expect(cuda_kernels, **{
            k: train_launches.get(k, 0) + serve_l.get(k, 0)
            for k in ("farthest_point_sample", "query_ball_point", "three_nn",
                      "three_interpolate", "fused_sa", "fused_fp")}),
              f"{label}: BN refresh + eval launched {side}")
        check(int(em["count"]) == B * N
              and (em["ious"].shape == (B,) if part
                   else em["cm"].shape == (ncls, ncls)),
              f"{label}: eval count / ious / confusion matrix")
        res["launches_per_step"] = per_step
        res["launches_refresh_plus_eval"] = side
        print(f"{label}: launches per step {per_step}; BN refresh + eval "
              f"forward {side}", flush=True)
        # (c) ten steps on one fixed batch: finite losses, and the loss
        # falls
        model = make(dtype, seed=1)
        fixed = stepper(model, gen_seed=11, fixed=True)
        losses = [float(fixed(batch, 1e-3, 0.1)["loss"]) for _ in range(10)]
        check(all(np.isfinite(losses)), f"{label}: losses {losses}")
        check(losses[-1] < losses[0], f"{label}: loss did not fall "
                                      f"{losses}")
        res["fixed_batch_losses"] = losses
        print(f"{label}: 10 steps on one batch, losses {losses}",
              flush=True)
        # (e) step time at B=24 x N (the full step: augmentation,
        # dropout): CUDA events over 10 steps after 3 warm-ups
        step = stepper(kmodel, gen_seed=13)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(torch, lambda: step(batch, 1e-3, 0.1), 10, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        res.update({"step_ms": ms, "clouds_per_s": B / ms * 1e3,
                    "points_per_s": B * N / ms * 1e3,
                    "peak_memory_bytes": peak})
        print(f"{label}: median step {ms} ms, {res['clouds_per_s']} "
              f"clouds/s, {res['points_per_s']} points/s at B={B} x N={N}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
        del (kmodel, pmodel, amodel, bmodel, model, step, kstep, pstep,
             astep, bstep, fixed)
        # (d) the main path: one short epoch of Trainer.fit (3 steps; eval
        # over 24 clouds or blocks; in bf16 the BN refresh before it)
        trainer = Trainer(config(dtype=dtname, device=str(dev),
                                 log_dir=log_root))
        cuda_kernels.reset_launches()
        final = trainer.fit()
        torch.cuda.synchronize()
        fit_launches = launch_counts(cuda_kernels)
        nsteps = trainer.train_pipe.steps_per_epoch()
        hist = trainer.history[0]
        check(nsteps == sizes["train_size"] // B, f"fit: {nsteps} steps")
        nfp = train_launches["three_nn"]
        check(fit_launches["gather_backward"]
              == train_launches["gather_backward"] * nsteps
              and fit_launches["three_nn"] >= nfp * nsteps
              and fit_launches["three_interpolate"] >= nfp * nsteps
              and fit_launches["fused_fp"]
              == nfp * (sizes["test_size"] // B),
              f"fit {label}: launches {fit_launches}")
        check(np.isfinite(hist["train"]["loss"])
              and np.isfinite(final["eval_loss"])
              and 0.0 <= final["point_acc"] <= 1.0
              and all(0.0 <= final[k] <= 1.0 for k in (
                  ("instance_miou", "class_miou") if part else ("miou",))),
              f"fit {label}: metrics {hist} {final}")
        for k, v in fit_launches.items():
            out["launches"][k] += v
        res["fit"] = {"train": hist["train"], "eval": final,
                      "launches": fit_launches,
                      "bn_refresh_steps": trainer._bn_refresh_n}
        print(f"fit {label}: 1 epoch of {nsteps} steps, train "
              f"{hist['train']}, eval {final}, launches {fit_launches}",
              flush=True)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
        out[dtname] = res
    return out


# phase 5a: fusion_cls resumed at full width, bf16 mixed precision: 4 steps
# an epoch (B=24), 2 eval batches; phase 5b: V votes a vote step
RESUME_TRAIN_SIZE, RESUME_TEST_SIZE, VOTES = 96, 48, 3
# the keys of a metrics.jsonl record that are the epoch's times, not its
# numbers
TIME_KEYS = ("train/epoch_time_s", "train/clouds_per_s")


def _state_diff(torch, a, b, where=""):
    """Names of the entries of two train states (nested dicts of tensors
    and numbers) that are not bit-identical."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{where}: keys {sorted(a)} vs {sorted(b)}"]
        return [d for k in a for d in _state_diff(torch, a[k], b[k],
                                                  f"{where}/{k}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [where]
    return [] if a == b else [f"{where}: {a} vs {b}"]


def train_resume(torch, cuda_kernels, dev, log_root):
    """Phase 5a: fusion_cls at full width in bf16 mixed precision, trained
    two epochs straight (run A) and one epoch, then a new Trainer with
    ``resume=True`` for the second (run B), both in deterministic mode, as
    phases 4d and 4f take their plain step. B's restored state must be what
    was saved, and after epoch 2 A and B must be bit-identical."""
    from mm3d_tpu_torch.training import TrainConfig, Trainer
    from mm3d_tpu_torch.training.state import load_train_state
    from mm3d_tpu_torch.utils.checkpoint import CheckpointManager

    def config(epochs=2, **kw):
        return TrainConfig(model="fusion_cls", epochs=epochs,
                           batch_size=TRAIN_BATCH, npoint=NPOINT,
                           num_class=NUM_CLASS, image_hw=IMAGE_HW,
                           dtype="bfloat16", train_size=RESUME_TRAIN_SIZE,
                           test_size=RESUME_TEST_SIZE, device=str(dev),
                           log_dir=log_root, **kw)

    def metrics(tr):
        with open(os.path.join(tr.run_dir, "logs", "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k not in TIME_KEYS} for line in f]

    out = {"launches": expect(cuda_kernels)}
    runs = {}

    def fit(tr, name):
        cuda_kernels.reset_launches()
        step0 = tr.step
        tr.fit()
        torch.cuda.synchronize()
        got = launch_counts(cuda_kernels)
        nsteps = tr.step - step0
        check(got["gather_backward"] == 2 * nsteps,
              f"resume {name}: launches {got} over {nsteps} steps")
        for k, v in got.items():
            out["launches"][k] += v
        runs[name] = {"steps": nsteps, "launches": got}

    # bincount (the eval's confusion matrix) has no deterministic CUDA
    # form; its weights are whole numbers, so its sums are exact in any
    # order: warn_only keeps the eval running
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = Trainer(config(run_name="A"))
        fit(a, "A epochs 1-2")
        b1 = Trainer(config(run_name="B", epochs=1))
        check(b1.train_pipe.steps_per_epoch() == 4, "resume: 4 steps an "
                                                    "epoch")
        fit(b1, "B epoch 1")
        b1.close()
        saved = b1.ckpt_latest.restore()
        bad = _state_diff(torch, b1.train_state(), saved)
        check(not bad, f"resume: the checkpoint differs from the state "
                       f"it saved: {bad[:5]}")
        b = Trainer(config(run_name="B", resume=True))
        check((b.start_epoch, b.step) == (1, 4),
              f"resume: start epoch {b.start_epoch}, step {b.step}")
        bad = _state_diff(torch, b.train_state(), saved)
        check(not bad, f"resume: restored state differs: {bad[:5]}")
        fit(b, "B epoch 2")
    finally:
        torch.use_deterministic_algorithms(False)
    bad = _state_diff(torch, a.train_state(), b.train_state())
    check(a.step == b.step == 8 and not bad,
          f"resume: A and B differ after epoch 2 (steps {a.step} / "
          f"{b.step}): {bad[:5]}")
    ma, mb = metrics(a), metrics(b)
    check(len(ma) == 4 and ma == mb, f"resume: metrics.jsonl differ "
                                     f"{ma} vs {mb}")
    n_tensors = len(a.train_state()["model"])
    print(f"resume fusion_cls bf16 B={TRAIN_BATCH}: run A 2 epochs, run B 1 "
          f"+ resume + 1; restored state bit-identical with the saved one; "
          f"after epoch 2 parameters, BN buffers ({n_tensors} tensors), "
          f"Adam moments, step {a.step} and generators bit-identical; "
          f"metrics.jsonl equal but {TIME_KEYS}; launches {runs}",
          flush=True)
    # what a save and a restore cost (the file was just written: a warm
    # read)
    timing = CheckpointManager(os.path.join(log_root, "timing"),
                               max_to_keep=1)
    state = b.train_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.save(b.step, state)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(timing.directory, f"{b.step}.pt"))
    t0 = time.perf_counter()
    load_train_state(timing.restore(), b.model, b.optimizer, b.generator,
                     b.fps_generator)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    print(f"resume: checkpoint {nbytes} bytes, save {save_s} s, restore "
          f"{restore_s} s (warm read)", flush=True)
    for tr in (a, b):
        tr.close()
    out.update({"runs": runs, "checkpoint_bytes": nbytes, "save_s": save_s,
                "restore_s": restore_s, "bit_identical": True,
                "metrics_records": len(ma),
                "final_eval": {k: v for k, v in ma[-1].items()}})
    return out


# phase 5b: each vote step's model and full-width request
VOTE_CASES = (("fusion_cls", BATCH, NPOINT),
              ("pointnet2_cls_ssg", BATCH, NPOINT),
              ("pointnet2_part_seg_msg", PART_BATCH, PART_NPOINT),
              ("fusion_sem_seg", SEG_BATCH, SEG_NPOINT))


def vote_eval(torch, ops, cuda_kernels, dev):
    """Phase 5b: the four vote steps at full width, V votes, random seeded
    weights, bf16 and fp32 with the same draws: the kernel path against the
    plain path (fp32), launches against the serving forward's, bf16 against
    fp32, ms a vote step."""
    from mm3d_tpu_torch.data.synthetic import (partseg_request,
                                               semseg_request,
                                               shapenet_part_ranges)
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import steps
    from mm3d_tpu_torch.utils.metrics import part_ranges
    from mm3d_tpu_torch.utils.profiling import nontrivial_bn

    start, count = part_ranges(shapenet_part_ranges(), dev)
    out = {"launches": expect(cuda_kernels)}
    for name, B, N in VOTE_CASES:
        spec = get_model(name)
        task = spec.task
        kw = ({} if task == "partseg" else
              {"num_class": SEG_CLASSES if task == "fusion_semseg"
               else NUM_CLASS})
        gen = torch.Generator(dev).manual_seed(70)
        valid = None  # partseg: each point's category parts
        if task == "partseg":
            pts, onehot, cat, _ = (torch.from_numpy(a).to(dev)
                                   for a in partseg_request(B, N, seed=70))
            args, forward = (pts, cat), (pts, onehot)
            draws = steps.draw_vote_perms(gen, VOTES, B, N, dev)
            pid = torch.arange(PART_PARTS, device=dev)
            lo = start[cat.long()][:, None, None]
            valid = (pid >= lo) & (pid < lo + count[cat.long()][:, None,
                                                                  None])

            def make(m):
                return steps.make_vote_partseg_step(m, VOTES, PART_CATS,
                                                    start, count)
        elif task == "fusion_semseg":
            args = forward = tuple(torch.from_numpy(a).to(dev) for a in
                                   semseg_request(B, N, IMAGE_HW, seed=70))
            draws = steps.draw_vote_perms(gen, VOTES, B, N, dev)

            def make(m):
                return steps.make_vote_fusion_semseg_step(m, VOTES)
        elif task == "fusion_cls":
            args = forward = tuple(torch.from_numpy(a).to(dev)
                                   for a in request(70))
            draws = steps.draw_vote_angles(gen, VOTES, B, dev)

            def make(m):
                return steps.make_vote_fusion_cls_step(m, VOTES)
        else:
            args = forward = (torch.from_numpy(unit_sphere_clouds(
                np.random.RandomState(70), B, N)).to(dev),)
            draws = steps.draw_vote_angles(gen, VOTES, B, dev)

            def make(m):
                return steps.make_vote_eval_step(m, VOTES)
        base = init_params(spec.builder(**kw), seed=0)
        nontrivial_bn(base, seed=1)
        state = base.state_dict()
        res, preds = {}, {}
        for dtname, dtype in (("float32", None),
                              ("bfloat16", torch.bfloat16)):
            label = f"vote {name} {dtname}"
            model = spec.builder(dtype=dtype, **kw)
            model.load_state_dict(state)
            model.to(dev).eval()
            step = make(model)
            # one serving forward's launches, then the vote step's (the
            # main path)
            cuda_kernels.reset_launches()
            with torch.no_grad():
                model(*forward)
            torch.cuda.synchronize()
            one = launch_counts(cuda_kernels)
            cuda_kernels.reset_launches()
            pred, probs = step(*args, draws, return_probs=True)
            torch.cuda.synchronize()
            got = launch_counts(cuda_kernels)
            check(any(one.values()) and got == {k: VOTES * v
                                                for k, v in one.items()},
                  f"{label}: launches {got}, a forward {one}")
            for k, v in got.items():
                out["launches"][k] += v
            shape = (B, N) if task in ("partseg", "fusion_semseg") else (B,)
            check(tuple(pred.shape) == shape and pred.dtype == torch.int32
                  and bool(torch.isfinite(probs).all()),
                  f"{label}: predictions {tuple(pred.shape)} {pred.dtype}")
            sums = float((probs.sum(-1) - VOTES).abs().max())
            check(sums < 1e-3 * VOTES, f"{label}: probabilities sum off "
                                       f"{VOTES} by {sums}")
            r = {"launches": got, "launches_a_forward": one,
                 "ms": cuda_ms(torch, lambda: step(*args, draws), 5,
                               warmup=2)}
            if dtname == "float32":
                with ops.use_impl("torch"):
                    ppred, pprobs = step(*args, draws, return_probs=True)
                d = float((probs - pprobs).abs().max())
                check(d <= 1e-4, f"{label}: summed probabilities, kernel vs "
                                 f"plain, max|d| {d} > 1e-4")
                ranked = (pprobs if valid is None else torch.where(
                    valid, pprobs, torch.full_like(pprobs, -1.0)))
                top2 = ranked.topk(2, dim=-1).values
                clear = (top2[..., 0] - top2[..., 1]) > 1e-4
                differ = int(((pred != ppred) & clear).sum())
                check(differ == 0, f"{label}: {differ} predictions differ "
                                   "from the plain path's past a 1e-4 "
                                   "margin")
                r.update({"kernel_vs_plain_max_abs": d,
                          "differ_past_margin": differ,
                          "within_margin": int((~clear).sum())})
            preds[dtname] = pred
            res[dtname] = r
            print(f"{label}: B={B} x N={N}, V={VOTES}: {r}", flush=True)
            del model, step
        agree = float((preds["bfloat16"] == preds["float32"]).float().mean())
        check(agree >= 0.95, f"vote {name}: bf16 vs fp32 agreement {agree} "
                             "< 0.95")
        res["bf16_vs_fp32_agreement"] = agree
        print(f"vote {name}: bf16 vs fp32 vote agreement {agree}", flush=True)
        out[name] = res
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 6
# the entry points: python -m mm3d_tpu_torch.train / .test, called through
# their main(argv) in this process (the kernels built once), on trees
# written here in the canonical on-disk formats

# the ModelNet40 categories, the names of the tree's class folders (one has
# an underscore, which a shape id's class name keeps)
MODELNET40 = (
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox")
# 6a: a multimodal ModelNet40 tree, 72 train and 48 test shapes of 10,000
# x,y,z,nx,ny,nz rows (the normal_resampled files' size): 3 train steps of
# 24 and 2 eval batches an epoch
CLI_TRAIN_SHAPES, CLI_TEST_SHAPES, CLI_ROWS = 72, 48, 10_000
# 6b: an S3DIS tree of four rooms of 500,000 points (the size of a real
# S3DIS room), two of them in the held-out area 5
ROOM_POINTS = 500_000
ROOMS = ("Area_1_office_1", "Area_2_office_1", "Area_5_office_1",
         "Area_5_conferenceRoom_1")
# the rooms' batch of blocks, and fusion_sem_seg's short synthetic run (two
# train steps, one eval batch)
ROOM_BATCH = 16
FSS_TRAIN_SIZE, FSS_TEST_SIZE = 48, 24
# room predictions, fp32 kernel path vs plain path: equal wherever the
# summed votes' top-two margin exceeds it; point_acc and mIoU within it
ROOM_MARGIN = 1e-3


def write_modelnet_tree(root):
    """A multimodal ModelNet40 tree: the class folders of ``MODELNET40``,
    ``<class>_NNNN.txt`` shapes (synthetic clouds of CLI_ROWS points with
    normals, rows shuffled, as the resampled files' rows come in no order),
    the split lists, and ``views_<split>/<index>.npz``: a 64x64 depth view
    of the cloud the loader gives (its first NPOINT rows, normalised) with
    its camera, rendered by the port's ``render_depth_image``."""
    from mm3d_tpu_torch.data import synthetic as syn
    from mm3d_tpu_torch.data.loaders import pc_normalize
    os.makedirs(root)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(MODELNET40) + "\n")
    K = syn.default_intrinsics(IMAGE_HW)
    seen = {c: 0 for c in MODELNET40}
    row = ",".join(["%.6f"] * 6) + "\n"
    for split, size in (("train", CLI_TRAIN_SHAPES),
                        ("test", CLI_TEST_SHAPES)):
        gen = syn.SyntheticModelNet(num_classes=NUM_CLASS, npoints=CLI_ROWS,
                                    normals=True, size=size, split=split)
        views = os.path.join(root, f"views_{split}")
        os.makedirs(views)
        ids = []
        for i in range(size):
            pts, label = gen[i]
            rng = np.random.RandomState(1000 * (split == "test") + i)
            pts = pts[rng.permutation(len(pts))]
            cls = MODELNET40[label]
            seen[cls] += 1
            sid = f"{cls}_{seen[cls]:04d}"
            ids.append(sid)
            os.makedirs(os.path.join(root, cls), exist_ok=True)
            with open(os.path.join(root, cls, sid + ".txt"), "w") as f:
                f.write((row * len(pts)) % tuple(pts.ravel().tolist()))
            xyz = pc_normalize(pts[:NPOINT, :3])
            R, t = syn.random_viewpoint_extrinsics(rng)
            np.savez(os.path.join(views, f"{i}.npz"),
                     image=syn.render_depth_image(xyz, K, R, t, IMAGE_HW),
                     K=K, R=R, t=t)
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


def write_s3dis_tree(root):
    """The ``ROOMS`` as preprocessed S3DIS rooms, [N,7] = xyz, rgb in
    0..255, label: each a ``synthetic_room`` of ROOM_POINTS points."""
    from mm3d_tpu_torch.data.synthetic import synthetic_room
    os.makedirs(root)
    for k, name in enumerate(ROOMS):
        xyz, rgb, seg = synthetic_room(ROOM_POINTS, seed=k)
        np.save(os.path.join(root, name + ".npy"),
                np.concatenate([xyz, np.round(rgb * 255.0),
                                seg[:, None]], 1).astype(np.float32))


def write_lineage_ckpt(torch, path):
    """A lineage ``.pth`` of pointnet2_sem_seg: the port's
    ``export_state_dict`` of a seeded init in the lineage's train-script
    wrapper, with DataParallel's ``module.`` prefixes. Returns the model."""
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.utils.torch_import import export_state_dict
    model = init_params(get_model("pointnet2_sem_seg").builder(
        num_class=SEG_CLASSES), 7)
    sd = export_state_dict("pointnet2_sem_seg", model)
    torch.save({"model_state_dict": {
        f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
        for k, v in sd.items()}}, path)
    return model


class RoomVotes:
    """Records, while a ``--scene`` run lasts, each room's summed votes and
    its blocks (``scene_eval._vote_loop`` wrapped; the run is unchanged)."""

    def __init__(self):
        from mm3d_tpu_torch.training import scene_eval
        self.mod, self.orig, self.rooms = scene_eval, scene_eval._vote_loop, []

    def __enter__(self):
        def loop(predict_fn, arrays, pidx, nblocks, *args):
            votes = self.orig(predict_fn, arrays, pidx, nblocks, *args)
            self.rooms.append({"blocks": int(nblocks), "votes": votes})
            return votes
        self.mod._vote_loop = loop
        return self

    def __exit__(self, *exc):
        self.mod._vote_loop = self.orig


def _margin_equal(a, b):
    """(share of points whose argmax a and b agree, whether they agree
    wherever a's top-two margin exceeds ROOM_MARGIN)."""
    top2 = np.sort(a, -1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > ROOM_MARGIN
    same = a.argmax(-1) == b.argmax(-1)
    return float(same.mean()), bool(same[sure].all())


def entry_points(torch, cuda_kernels, dev, work):
    """Phase 6: the train and test CLIs at full width on trees written under
    ``work``: 6a fusion_cls on a multimodal ModelNet40 tree (the main
    path), 6b pointnet2_sem_seg on an S3DIS tree from a lineage checkpoint,
    6c fusion_sem_seg on a synthetic room, 6d pointnet2_cls_knn on the 6a
    tree's points. Each CLI call's launches are counted from 0."""
    import argparse
    from mm3d_tpu_torch import test as test_cli
    from mm3d_tpu_torch import train as train_cli
    from mm3d_tpu_torch.data import loaders, native_io
    from mm3d_tpu_torch.serving import load_serving
    from mm3d_tpu_torch.training import TrainConfig, Trainer, make_predictor
    from mm3d_tpu_torch.utils import visualizer
    from mm3d_tpu_torch.utils.checkpoint import CheckpointManager
    from mm3d_tpu_torch.utils.jax_import import _flatten, to_jax_tree
    from mm3d_tpu_torch.utils.torch_import import load_torch_checkpoint

    t_phase = time.perf_counter()
    out = {"launches": expect(cuda_kernels), "runs": {}}
    logs = os.path.join(work, "logs")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(label, main, argv):
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        res = main(argv + ["--device", dev.type])
        sync()
        s = time.perf_counter() - t0
        got = launch_counts(cuda_kernels)
        for k, v in got.items():
            out["launches"][k] += v
        out["runs"][label] = {"s": s, "launches": got, "result": res}
        print(f"cli {label}: {s:.3f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }, result {res}",
              flush=True)
        return res, got, s

    # the host libraries, built from native/*.cpp into mm3d_tpu_torch/build
    check(native_io.available(),
          f"native parser did not build: {native_io.load_error()}")
    check(visualizer.available(),
          f"native renderer did not build: {visualizer.load_error()}")

    # --- 6a: fusion_cls on a multimodal ModelNet40 tree
    mn = os.path.join(work, "modelnet40")
    t0 = time.perf_counter()
    write_modelnet_tree(mn)
    out["modelnet_write_s"] = time.perf_counter() - t0
    paths = [p for p, _ in loaders.ModelNetDataset(mn, "train").paths]
    t0 = time.perf_counter()
    tables = native_io.parse_many(paths, 6)
    parse_s = time.perf_counter() - t0
    check(all(t.shape == (CLI_ROWS, 6) for t in tables),
          f"native parse shapes {[t.shape for t in tables[:3]]}")
    want = np.loadtxt(paths[0], delimiter=",", dtype=np.float32)
    check(np.allclose(tables[0], want, rtol=1e-5, atol=1e-6),
          "native parse differs from np.loadtxt")
    out.update({"parse_s": parse_s, "shapes_per_s": len(paths) / parse_s})
    print(f"6a: ModelNet40 tree written in {out['modelnet_write_s']:.2f} s; "
          f"train split ({len(paths)} shapes x {CLI_ROWS} rows) parsed by "
          f"the native parser in {parse_s:.4f} s, "
          f"{out['shapes_per_s']:.1f} shapes/s", flush=True)
    common = ["--dataset", "multimodal", "--data_root", mn, "--npoint",
              str(NPOINT), "--batch_size", str(TRAIN_BATCH), "--num_class",
              str(NUM_CLASS)]
    _, got, _ = run("6a train fusion_cls bf16", train_cli.main, [
        "--model", "fusion_cls", "--epoch", "2", "--dtype", "bfloat16",
        "--log_dir", logs, "--run_name", "fusion_cls"] + common)
    check(min(got["farthest_point_sample"], got["query_ball_point"],
              got["gather_backward"]) > 0, f"6a train launches {got}")
    run_dir = os.path.join(logs, "fusion_cls", "fusion_cls")
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    out["epoch_s"] = [r["train/epoch_time_s"] for r in recs
                      if "train/epoch_time_s" in r]
    check(len(out["epoch_s"]) == 2, f"6a: epochs logged {recs}")
    print(f"6a: epoch seconds {out['epoch_s']}", flush=True)
    best = CheckpointManager(os.path.join(run_dir, "checkpoints"),
                             best_metric="instance_acc").best_step()
    test_ds = loaders.build_real_datasets(
        "multimodal", mn, "fusion_cls", npoints=NPOINT, splits=("test",))[1]
    example = None
    for dt in ("bfloat16", "float32"):
        res, got, _ = run(f"6a test fusion_cls {dt} votes", test_cli.main, [
            "--model", "fusion_cls", "--log_dir", run_dir, "--dtype", dt,
            "--num_votes", str(VOTES)] + common)
        eval_kernel = ("fused_sa" if dt == "bfloat16"
                       else "query_ball_point")
        check(got[eval_kernel] > 0 and got["farthest_point_sample"] > 0,
              f"6a test {dt} launches {got}")
        # the same restored state, evaluated and voted in this process
        tr = Trainer(TrainConfig(
            model="fusion_cls", batch_size=TRAIN_BATCH, npoint=NPOINT,
            num_class=NUM_CLASS, eval_dtype=dt, checkpoint=False,
            log_dir=os.path.join(work, "check"), device=str(dev)),
            test_ds=test_ds)
        step = test_cli.restore_best(tr, run_dir)
        check(step == best, f"6a: restored step {step}, best {best}")
        t0 = time.perf_counter()
        ev = tr.evaluate()
        sync()
        t1 = time.perf_counter()
        voted = test_cli._eval_and_vote(
            argparse.Namespace(num_votes=VOTES, seed=0), tr)
        sync()
        vote_s = (time.perf_counter() - t1) - (t1 - t0)
        check(ev["instance_acc"] == res["instance_acc"]
              and voted["vote_instance_acc"] == res["vote_instance_acc"],
              f"6a {dt}: CLI {res} vs Trainer.evaluate {ev}, votes "
              f"{voted}")
        out[f"vote_pass_s_{dt}"] = vote_s
        print(f"6a {dt}: restored best step {step}; instance_acc "
              f"{ev['instance_acc']} and vote_instance_acc "
              f"{voted['vote_instance_acc']} equal the CLI's; eval pass "
              f"{t1 - t0:.3f} s, vote pass ({VOTES} votes) {vote_s:.3f} s",
              flush=True)
        if example is None:
            example = [a.to(dev) for a in test_cli._example_args(tr)]
        tr.close()
    state = CheckpointManager(os.path.join(run_dir, "checkpoints")).restore(
        best)["model"]
    for dt, tdt in (("bfloat16", torch.bfloat16), ("float32", None)):
        path = os.path.join(work, f"fusion_cls_{dt}.pt2")
        run(f"6a export fusion_cls {dt}", test_cli.main, [
            "--model", "fusion_cls", "--log_dir", run_dir, "--dtype", dt,
            "--export", path] + common)
        served = load_serving(path, dev.type)
        pred = make_predictor("fusion_cls", state, dtype=tdt,
                              device=str(dev), num_class=NUM_CLASS)
        with torch.no_grad():
            a = served(*example).float()
        b = pred(*example).float()
        if tdt is None:
            d = float((a - b).abs().max())
            check(d <= 1e-5, f"6a export fp32: max|d| {d} vs make_predictor")
            out["export_fp32_max_abs"] = d
        else:
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            check(agree == 1.0, f"6a export bf16: argmax agreement {agree}")
            out["export_bf16_agreement"] = agree
    print(f"6a export: fp32 max|d| {out['export_fp32_max_abs']}, bf16 "
          f"argmax agreement {out['export_bf16_agreement']} against "
          "make_predictor on one test batch", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mm3d_tpu_torch.test", "--model",
         "fusion_cls", "--log_dir", run_dir, "--device", dev.type] + common,
        cwd=REPO, capture_output=True, text=True, timeout=600)
    out["subprocess_s"] = time.perf_counter() - t0
    check(proc.returncode == 0 and "instance_acc" in proc.stdout,
          f"python -m mm3d_tpu_torch.test exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"6a: python -m mm3d_tpu_torch.test in a new process, "
          f"{out['subprocess_s']:.2f} s: {proc.stdout.strip()[-300:]}",
          flush=True)

    # --- 6b: pointnet2_sem_seg on an S3DIS tree, from a lineage checkpoint
    s3 = os.path.join(work, "s3dis")
    t0 = time.perf_counter()
    write_s3dis_tree(s3)
    out["s3dis_write_s"] = time.perf_counter() - t0
    pth = os.path.join(work, "pointnet2_sem_seg_lineage.pth")
    lineage = write_lineage_ckpt(torch, pth)
    got_tree = dict(_flatten(load_torch_checkpoint("pointnet2_sem_seg",
                                                   lineage, pth)))
    want_tree = dict(_flatten(to_jax_tree(lineage)))
    check(got_tree.keys() == want_tree.keys() and all(
        np.array_equal(got_tree[k], want_tree[k]) for k in want_tree),
        "6b: the lineage .pth does not import bit for bit")
    _, got, _ = run("6b train pointnet2_sem_seg fp32 from lineage",
                    train_cli.main, [
                        "--model", "pointnet2_sem_seg", "--dataset", "s3dis",
                        "--data_root", s3, "--npoint", str(SCENE_NPOINT),
                        "--batch_size", str(TRAIN_BATCH), "--epoch", "1",
                        "--torch_ckpt", pth, "--log_dir", logs,
                        "--run_name", "s3dis"])
    check(min(got["gather_backward"], got["three_nn"],
              got["three_interpolate"]) > 0, f"6b train launches {got}")
    scene = ["--model", "pointnet2_sem_seg", "--log_dir",
             os.path.join(logs, "semseg", "s3dis"), "--scene", "area",
             "--data_root", s3, "--test_area", "5", "--batch_size",
             str(ROOM_BATCH), "--npoint", str(SCENE_NPOINT)]
    rooms = {}
    for label, extra in (("bf16", ["--dtype", "bfloat16"]),
                         ("fp32", ["--dtype", "float32"]),
                         ("fp32 plain", ["--dtype", "float32", "--impl",
                                         "torch"])):
        with RoomVotes() as rv:
            res, got, s = run(f"6b test --scene area {label}",
                              test_cli.main, scene + extra)
        rooms[label] = {"res": res, "rooms": rv.rooms, "s": s, "got": got}
        check(res["rooms"] == 2 and len(rv.rooms) == 2,
              f"6b {label}: {res['rooms']} rooms scored")
    check(not any(rooms["fp32 plain"]["got"].values()),
          f"6b: the plain path launched {rooms['fp32 plain']['got']}")
    check(min(rooms["bf16"]["got"][k] for k in (
        "farthest_point_sample", "fused_sa", "fused_fp")) > 0
        and min(rooms["fp32"]["got"][k] for k in (
            "farthest_point_sample", "query_ball_point", "fused_fp")) > 0,
        f"6b launches {rooms['bf16']['got']} / {rooms['fp32']['got']}")
    cov = {k: r["res"]["coverage"] for k, r in rooms.items()}
    check(len(set(cov.values())) == 1, f"6b: coverage differs {cov}")
    k, p = rooms["fp32"], rooms["fp32 plain"]
    for rk, rp in zip(k["rooms"], p["rooms"]):
        _, same = _margin_equal(rk["votes"], rp["votes"])
        check(same, "6b: fp32 kernel and plain room predictions differ "
                    f"past a {ROOM_MARGIN} margin")
    for m in ("point_acc", "miou"):
        d = abs(k["res"][m] - p["res"][m])
        check(d <= ROOM_MARGIN, f"6b: fp32 kernel vs plain {m} differ by {d}")
    agree = _margin_equal(
        np.concatenate([r["votes"] for r in rooms["fp32"]["rooms"]]),
        np.concatenate([r["votes"] for r in rooms["bf16"]["rooms"]]))[0]
    check(agree >= 0.95, f"6b: bf16 vs fp32 per-point agreement {agree}")
    blocks = [r["blocks"] for r in rooms["bf16"]["rooms"]]
    out["rooms"] = {label: {"s": r["s"], "s_per_room": r["s"] / 2,
                            "points_per_s": 2 * ROOM_POINTS / r["s"],
                            "metrics": r["res"], "launches": r["got"]}
                    for label, r in rooms.items()}
    out.update({"room_blocks": blocks, "room_bf16_vs_fp32": agree})
    print(f"6b: blocks a room {blocks} (batches of {ROOM_BATCH} x "
          f"{SCENE_NPOINT}); coverage {cov['bf16']}; bf16 vs fp32 "
          f"per-point agreement {agree}; " + "; ".join(
              f"{label} {r['s'] / 2:.3f} s a room, "
              f"{2 * ROOM_POINTS / r['s']:.0f} points/s"
              for label, r in rooms.items()), flush=True)
    room = sorted(f for f in os.listdir(s3) if f.startswith("Area_5_"))[0]
    xyz, _, _ = test_cli._load_room(os.path.join(s3, room))
    png = visualizer.show_points(
        xyz, labels=rooms["bf16"]["rooms"][0]["votes"].argmax(-1),
        out_path=os.path.join(work, "room.png"))
    check(visualizer.available() and os.path.getsize(png) > 1000,
          "6b: the room's PNG was not rendered natively")
    print(f"6b: {room}'s predicted labels rendered by the native renderer, "
          f"{os.path.getsize(png)} bytes of PNG", flush=True)

    # --- 6c: fusion_sem_seg on one synthetic room
    run("6c train fusion_sem_seg fp32", train_cli.main, [
        "--model", "fusion_sem_seg", "--epoch", "1", "--batch_size",
        str(TRAIN_BATCH), "--train_size", str(FSS_TRAIN_SIZE),
        "--test_size", str(FSS_TEST_SIZE), "--log_dir", logs,
        "--run_name", "fss"])
    fss = {}
    for dt in ("bfloat16", "float32"):
        with RoomVotes() as rv:
            res, got, s = run(f"6c test --scene synthetic {dt}",
                              test_cli.main, [
                                  "--model", "fusion_sem_seg", "--log_dir",
                                  os.path.join(logs, "fusion_semseg", "fss"),
                                  "--scene", "synthetic", "--scene_points",
                                  str(ROOM_POINTS), "--batch_size",
                                  str(ROOM_BATCH), "--dtype", dt])
        check(got["bilinear_sample"] > 0 and got["fused_fp"] > 0,
              f"6c {dt} launches {got}")
        fss[dt] = {"res": res, "votes": rv.rooms[0]["votes"], "s": s,
                   "blocks": rv.rooms[0]["blocks"]}
    check(fss["bfloat16"]["res"]["coverage"]
          == fss["float32"]["res"]["coverage"], "6c: coverage differs")
    agree = _margin_equal(fss["float32"]["votes"],
                          fss["bfloat16"]["votes"])[0]
    check(agree >= 0.95, f"6c: bf16 vs fp32 per-point agreement {agree}")
    out["fusion_room"] = {dt: {"s": r["s"], "blocks": r["blocks"],
                               "metrics": r["res"]} for dt, r in fss.items()}
    out["fusion_room_bf16_vs_fp32"] = agree
    print(f"6c: {fss['float32']['blocks']} blocks of 2048 points; bf16 vs "
          f"fp32 agreement {agree}; s a room bf16 "
          f"{fss['bfloat16']['s']:.3f}, fp32 {fss['float32']['s']:.3f}",
          flush=True)

    # --- 6d: pointnet2_cls_knn on the 6a tree's points
    knn = ["--dataset", "modelnet40", "--data_root", mn, "--npoint",
           str(NPOINT), "--batch_size", str(TRAIN_BATCH), "--num_class",
           str(NUM_CLASS), "--model", "pointnet2_cls_knn"]
    run("6d train pointnet2_cls_knn fp32", train_cli.main, knn + [
        "--epoch", "1", "--log_dir", logs, "--run_name", "knn"])
    _, got, _ = run("6d test pointnet2_cls_knn bf16", test_cli.main, knn + [
        "--log_dir", os.path.join(logs, "classification", "knn"), "--dtype",
        "bfloat16"])
    check(got["fused_sa_idx"] > 0, f"6d launches {got}")
    out["s"] = time.perf_counter() - t_phase
    print(f"phase 6: {out['s']:.1f} s; launches "
          f"{ {k: v for k, v in out['launches'].items() if v} }", flush=True)
    return out


def kernels_line(rows, launches):
    """One entry per kernel, summed over its path's shapes, in the dtype
    named (fused SA, given-index fused SA and fused FP: bf16 serving;
    gather backward: the f32
    train step; bilinear: f32, where grid_sample is the yardstick;
    three_nn: f32; three_interpolate: the f32 train step). ms, plain_ms and
    library_ms are device times per call (torch.profiler)."""
    path = {
        "fps": ("farthest_point_sample", "mm3d_tpu_torch/csrc/fps.cu",
                "mm3d_tpu/ops/pallas_kernels.py:174", None),
        "ball_query": ("query_ball_point", "mm3d_tpu_torch/csrc/ball_query.cu",
                       "mm3d_tpu/ops/pallas_kernels.py:324", None),
        "fused_sa": ("fused_sa", "mm3d_tpu_torch/csrc/fused_sa.cu",
                     "mm3d_tpu/ops/pallas_kernels.py:961", "bfloat16"),
        "gather_backward": ("gather_backward",
                            "mm3d_tpu_torch/csrc/gather_bwd.cu",
                            "mm3d_tpu/ops/pallas_kernels.py:1704", "float32"),
        "fused_fp": ("fused_fp", "mm3d_tpu_torch/csrc/fused_fp.cu",
                     "mm3d_tpu/ops/pallas_kernels.py:1584", "bfloat16"),
        "bilinear_sample": ("bilinear_sample",
                            "mm3d_tpu_torch/csrc/bilinear.cu",
                            "mm3d_tpu/ops/pallas_kernels.py:1459", "float32"),
        "three_nn": ("three_nn", "mm3d_tpu_torch/csrc/three_nn.cu",
                     "mm3d_tpu/ops/pallas_kernels.py:470", None),
        "three_interpolate": ("three_interpolate",
                              "mm3d_tpu_torch/csrc/three_interp.cu",
                              "mm3d_tpu/ops/pallas_kernels.py:1387",
                              "float32"),
        "fused_sa_idx": ("fused_sa_idx", "mm3d_tpu_torch/csrc/fused_sa.cu",
                         "mm3d_tpu/ops/pallas_kernels.py:1214", "bfloat16"),
    }
    out = []
    for name, (wrapper, src, replaces, dtname) in path.items():
        timed = [e for e in rows[name] if "ms" in e
                 and (dtname is None or e["dtype"] == dtname)]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[wrapper],
            "max_abs_err": max(e.get("max_abs_err", 0.0) for e in rows[name]),
            "ms": sum(e["ms"] for e in timed),
            "plain_ms": sum(e["plain_ms"] for e in timed),
            "bound_ms": sum(e["bound_ms"] for e in timed),
            "bound_by": max(timed, key=lambda e: e["bound_ms"])["bound_by"],
            # one PyTorch call computes the gather backward (index_add_),
            # the sampling (grid_sample) and the 3-NN (cdist + topk); FPS,
            # ball query, the fused SA tails (both forms), the fused FP tail
            # and the interpolation have none
            "library_ms": (sum(e["library_ms"] for e in timed)
                           if timed[0].get("library_ms") is not None
                           else None)})
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "mm3d_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mm3d_tpu_torch/ not found)", file=sys.stderr)
        return 2
    from mm3d_tpu_torch import ops
    from mm3d_tpu_torch.ops import _build, cuda_kernels, geometry

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    build_s = _build.build()
    print(f"kernels built in {build_s:.1f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # strict fp32: the plain twins and the model's fp32 path use no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False", flush=True)

    rows = kernel_checks(torch, ops, geometry, dev)
    served = serve(torch, ops, cuda_kernels, dev, "fusion_cls",
                   [[torch.from_numpy(a).to(dev) for a in request(s)]
                    for s in (10, 11, 12)])
    semseg = serve_semseg(torch, ops, cuda_kernels, dev)
    clouds = [[torch.from_numpy(unit_sphere_clouds(
        np.random.RandomState(s), BATCH, NPOINT)).to(dev)]
        for s in (30, 31, 32)]
    served_pn2 = {name: serve(torch, ops, cuda_kernels, dev, name, clouds)
                  for name in ("pointnet2_cls_knn", "pointnet2_cls_ssg")}
    served_part = {"pointnet2_part_seg_msg": serve_seg(
        torch, ops, cuda_kernels, dev, "pointnet2_part_seg_msg", 3),
        "pointnet2_part_seg_ssg": serve_seg(
            torch, ops, cuda_kernels, dev, "pointnet2_part_seg_ssg", 1)}
    # 3e: config 1 and the PointNet tops (no kernel)
    served_pn = {"pointnet_cls": serve(torch, ops, cuda_kernels, dev,
                                       "pointnet_cls", clouds)}
    for name in ("pointnet_part_seg", "pointnet_part_seg_lineage",
                 "pointnet_sem_seg"):
        served_pn[name] = serve_seg(torch, ops, cuda_kernels, dev, name, 1)
    # 3f: the PointNet++ sem-seg models and the MSG classifier
    served_tops = {
        "pointnet2_sem_seg": serve_seg(torch, ops, cuda_kernels, dev,
                                       "pointnet2_sem_seg", 3),
        "pointnet2_sem_seg_msg": serve_seg(torch, ops, cuda_kernels, dev,
                                           "pointnet2_sem_seg_msg", 1),
        "pointnet2_cls_msg": serve(torch, ops, cuda_kernels, dev,
                                   "pointnet2_cls_msg", clouds[:1])}
    torch.cuda.empty_cache()
    artifacts = serve_artifacts(torch, cuda_kernels, dev, card)  # 3g
    # every Trainer's run directory and checkpoints, removed at the end
    log_root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        trained = train(torch, ops, cuda_kernels, dev, log_root)
        trained_seg = train_semseg(torch, ops, cuda_kernels, dev, log_root)
        trained_knn = train(torch, ops, cuda_kernels, dev, log_root,
                            "pointnet2_cls_knn")
        trained_part = train_seg(torch, ops, cuda_kernels, dev,
                                 "pointnet2_part_seg_msg", log_root)
        trained_pn = train(torch, ops, cuda_kernels, dev, log_root,
                           "pointnet_cls")  # 4e
        trained_scene = train_seg(torch, ops, cuda_kernels, dev,
                                  "pointnet2_sem_seg", log_root)  # 4f
        resumed = train_resume(torch, cuda_kernels, dev, log_root)  # 5a
    finally:
        shutil.rmtree(log_root, ignore_errors=True)
    voted = vote_eval(torch, ops, cuda_kernels, dev)  # 5b
    # the trees, runs, artifacts and PNG of the CLIs, removed at the end
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli = entry_points(torch, cuda_kernels, dev, work)  # 6
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # each kernel's launches on the main paths: serving every registered
    # model but the attention-head variants (bf16 + fp32), serving the
    # exported artifacts over HTTP, one epoch of Trainer.fit of
    # fusion_cls, fusion_sem_seg, pointnet2_cls_knn, pointnet2_part_seg_msg,
    # pointnet_cls and pointnet2_sem_seg (fp32 + bf16), the resumed
    # fusion_cls runs, the four vote steps (bf16 + fp32) and the train and
    # test CLIs
    phases = (served, semseg, *served_pn2.values(), *served_part.values(),
              *served_pn.values(), *served_tops.values(), artifacts, trained,
              trained_seg, trained_knn, trained_part, trained_pn,
              trained_scene, resumed, voted, cli)
    main_launches = {k: sum(p["launches"][k] for p in phases)
                     for k in served["launches"]}
    kernels = kernels_line(rows, main_launches)
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on "
                                 "the main paths")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_s": build_s, "kernel_checks": rows,
                   "serve": served, "serve_fusion_sem_seg": semseg,
                   "serve_pointnet2_cls": served_pn2,
                   "serve_pointnet2_part_seg": served_part,
                   "serve_pointnet": served_pn,
                   "serve_pointnet2_tops": served_tops,
                   "serve_artifacts": artifacts, "train": trained,
                   "train_pointnet_cls": trained_pn,
                   "train_pointnet2_sem_seg": trained_scene,
                   "train_pointnet2_cls_knn": trained_knn,
                   "train_fusion_sem_seg": trained_seg,
                   "train_pointnet2_part_seg_msg": trained_part,
                   "train_resume": resumed, "vote_eval": voted,
                   "entry_points": cli,
                   "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
