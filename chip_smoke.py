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
   ball query bit-exact, the fused SA tail, the gather backward, the fused
   FP tail (fusion_sem_seg's FP2 and FP1, plus tie cases) and the bilinear
   image sampling within the stated tolerances (the gather backward also
   bit-identical across two launches); at fusion_sem_seg's training shapes
   (B=24 blocks of 2048 points) three_nn and three_interpolate bit-exact
   (tie cases included), and the backwards of three_interpolate and of the
   sampling against autograd of the plain path. It times the kernel, its
   plain twin and, where one PyTorch call computes the same function, that
   call: the device time per call from torch.profiler (``ms``, ``plain_ms``,
   ``library_ms``, the numbers of the kernels line) and CUDA events around
   a call (``*call_ms``, the host's launch time included);
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
5. prints the ``{"kernels": [...]}`` line, then, last, the
   ``{"ok": true, "device": ...}`` line.

It imports nothing of JAX or of the JAX package. The details also go to
chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
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


def request(seed):
    """One serving request as bench.py builds it: points, image, K, R, t."""
    r = np.random.RandomState(seed)
    return (unit_sphere_clouds(r, BATCH, NPOINT),
            r.rand(BATCH, *IMAGE_HW, 3).astype(np.float32),
            np.broadcast_to(np.eye(3, dtype=np.float32) * 32,
                            (BATCH, 3, 3)).copy(),
            np.broadcast_to(np.eye(3, dtype=np.float32),
                            (BATCH, 3, 3)).copy(),
            np.tile(np.array([0, 0, 3], np.float32), (BATCH, 1)))


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


def times(torch, fn, reps, key="", warmup=2):
    """``{key}ms``: device time per call of fn(), the kernels and copies it
    puts on the card (torch.profiler), the host's launch time excluded;
    ``{key}call_ms``: CUDA events around one call, which also count the
    time the card waits for the host to launch it."""
    from mm3d_tpu_torch.utils.profiling import device_ms
    return {f"{key}ms": device_ms(fn, reps),
            f"{key}call_ms": cuda_ms(torch, fn, reps, warmup)}


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


BQ_FLOPS_PER_POINT = 13  # two 3-term dots, 2*cross, sub, add, compare


def bound(nbytes, flops_by_type):
    """{"bound_ms", "bound_by"}: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = sum(f / PEAK_FLOPS[k] for k, f in flops_by_type.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------ phases


def kernel_checks(torch, ops, geometry, dev):
    """Each kernel against its plain twin at the serving path's shapes."""
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

    # --- FPS: SA1 and SA2 shapes, a ragged N with per-cloud starts,
    # npoint > N
    ragged = torch.from_numpy(unit_sphere_clouds(rng, 16, 1000)).to(dev)
    starts = torch.from_numpy(rng.randint(0, 1000, 16).astype(np.int32))
    small = torch.from_numpy(unit_sphere_clouds(rng, 4, 128)).to(dev)
    for label, x, npoint, start, timed in (
            ("SA1 N=1024 npoint=512", xyz1, 512, 0, True),
            ("SA2 N=512 npoint=128", c1, 128, 0, True),
            ("ragged N=1000 per-cloud start", ragged, 256, starts, False),
            ("N=128 npoint=512", small, 512, 0, False)):
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
        record("fps", label, entry)

    # --- ball query: SA1, SA2, zero-hit centroids, ragged N
    far = c1.clone()
    far[:, :7] = 100.0
    for label, radius, K, x, cents, timed in (
            ("SA1 S=512 N=1024 K=32 r=0.2", 0.2, 32, xyz1, c1, True),
            ("SA2 S=128 N=512 K=64 r=0.4", 0.4, 64, c1, c2, True),
            ("zero-hit centroids", 0.2, 32, xyz1, far, False),
            ("ragged N=1000", 0.3, 48, ragged, ragged[:, :200].contiguous(),
             False)):
        got = ops.query_ball_point(radius, K, x, cents)
        with ops.use_impl("torch"):
            want = ops.query_ball_point(radius, K, x, cents)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"ball query {label}: not bit-exact")
        entry = {"bit_exact": True}
        if label.startswith("zero-hit"):
            check(bool((got[:, :7] == 0).all()), "zero-hit rows not all 0")
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
                {"float32": BQ_FLOPS_PER_POINT * visits}))
        record("ball_query", label, entry)

    # --- fused SA tail: SA1 and SA2 shapes, bf16 and fp32
    g = np.random.RandomState(1)
    for label, radius, K, x, cents, (C1, C2, C3) in (
            ("SA1", 0.2, 32, xyz1, c1, (64, 64, 128)),
            ("SA2", 0.4, 64, c1, c2, (128, 128, 256))):
        B, N, _ = x.shape
        S = cents.shape[1]
        base = [torch.from_numpy(a).to(dev) for a in (
            g.randn(B, N, C1).astype(np.float32),
            g.randn(B, S, C1).astype(np.float32),
            (g.randn(C1, C2) * 0.3).astype(np.float32),
            g.randn(C2).astype(np.float32),
            (g.randn(C2, C3) * 0.3).astype(np.float32),
            g.randn(C3).astype(np.float32))]
        visits = ball_query_visits(torch, geometry, radius, K, x, cents)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
            args = (radius, K, x, cents, *[a.to(dt) for a in base])
            got = ops.fused_sa(*args)
            with ops.use_impl("torch"):
                want = ops.fused_sa(*args)
            torch.cuda.synchronize()
            check(got.shape == (B, S, C3) and got.dtype == dt,
                  f"fused SA {label} {dtname}: shape/dtype")
            gf, wf = got.float(), want.float()
            err = (gf - wf).abs()
            if dt == torch.bfloat16:
                rel = float((err / (wf.abs() + 1)).max())
                check(rel < BF16_REL_TOL,
                      f"fused SA {label} bf16: max|d|/(|ref|+1) {rel}")
            else:
                worst = float((err - F32_RTOL * wf.abs()).max())
                check(worst <= F32_ATOL,
                      f"fused SA {label} fp32: |d| - rtol|ref| max {worst}")
            es = 2 if dt == torch.bfloat16 else 4
            entry = {"dtype": dtname, "max_abs_err": float(err.max()),
                     **times(torch, lambda: ops.fused_sa(*args), 20)}
            with ops.use_impl("torch"):
                entry.update(times(torch, lambda: ops.fused_sa(*args), 5,
                                   "plain_"))
            # MLP products in the features' dtype, selection in f32
            flops = {"bfloat16": 0, "float32": BQ_FLOPS_PER_POINT * visits}
            flops[dtname] += 2 * B * S * K * (C1 * C2 + C2 * C3)
            entry.update(bound(
                (B * N + B * S) * 12 + (B * N * C1 + B * S * C1) * es
                + (C1 * C2 + C2 + C2 * C3 + C3) * es + B * S * C3 * es,
                flops))
            record("fused_sa", f"{label} {dtname}", entry)

    # --- gather backward: the train path's SA1 and SA2 shapes at B=24 with
    # the ball query's own indices, a bf16 g, and random indices with an
    # unaligned n=100, C=24
    TB = TRAIN_BATCH
    with ops.use_impl("torch"):
        idx1 = ops.query_ball_point(0.2, 32, xyz1[:TB], c1[:TB])
        idx2 = ops.query_ball_point(0.4, 64, c1[:TB], c2[:TB])
    g = np.random.RandomState(2)
    ridx = torch.from_numpy(g.randint(0, 100, (2, 30, 4)).astype(np.int32))
    for label, idx, n, C, dt, timed in (
            ("SA1 g[24,512,32,64] n=1024 f32", idx1, NPOINT, 64,
             torch.float32, True),
            ("SA2 g[24,128,64,128] n=512 f32", idx2, 512, 128,
             torch.float32, True),
            ("SA1 g[24,512,32,64] n=1024 bf16", idx1, NPOINT, 64,
             torch.bfloat16, False),
            ("random idx n=100 C=24 f32", ridx.to(dev), 100, 24,
             torch.float32, False)):
        gg = torch.from_numpy(g.randn(*idx.shape, C).astype(np.float32)).to(
            dev).to(dt)
        got = ops.gather_backward(gg, idx, n)
        again = ops.gather_backward(gg, idx, n)
        with ops.use_impl("torch"):
            want = ops.gather_backward(gg, idx, n)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == dt,
              f"gather backward {label}: shape/dtype")
        check(torch.equal(got, again),
              f"gather backward {label}: two launches differ")
        gf, wf = got.float(), want.float()
        err = (gf - wf).abs()
        if dt == torch.bfloat16:
            # one bf16 ulp of the larger of the two values
            mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
            ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
            check(bool((err <= ulp).all()),
                  f"gather backward {label}: more than one bf16 ulp")
        else:
            # two f32 sums of the same terms in different orders (the plain
            # twin's atomics take a new order on every call) differ by a
            # rounding error that scales with the sum of the terms' sizes,
            # not with the size of the sum: the tolerance is relative to
            # sum |g| per output element
            with ops.use_impl("torch"):
                size = ops.gather_backward(gg.abs(), idx, n)
            worst = float((err - F32_RTOL * size).max())
            check(worst <= F32_ATOL,
                  f"gather backward {label}: |d| - rtol sum|g| max {worst}")
        entry = {"dtype": str(dt).split(".")[-1], "bit_identical": True,
                 "max_abs_err": float(err.max())}
        if timed:
            B, C_ = gg.shape[0], gg.shape[-1]
            F = idx[0].numel()
            entry.update(times(torch, lambda: ops.gather_backward(
                gg, idx, n), 20))
            with ops.use_impl("torch"):
                entry.update(times(
                    torch, lambda: ops.gather_backward(gg, idx, n), 20,
                    "plain_"))
            # the library yardstick: one index_add_ into zeros, with the
            # flat int64 row index built beforehand
            offs = (torch.arange(B, device=dev) * n).reshape(B, 1, 1)
            flat_idx = (idx.long() + offs).reshape(-1)
            flat_g = gg.reshape(-1, C_)
            entry.update(times(torch, lambda: torch.zeros(
                B * n, C_, device=dev).index_add_(0, flat_idx, flat_g), 20,
                "library_"))
            es = gg.element_size()
            entry.update(bound(B * F * C_ * es + B * F * 4 + B * n * C_ * es,
                               {"float32": B * F * C_}))
        record("gather_backward", label, entry)
    semseg_kernel_checks(torch, ops, dev, record)
    semseg_train_kernel_checks(torch, ops, dev, record)
    return rows


def _rel_err(got, want):
    """max|d| / max|ref|, the bound tests/test_fused_fp.py uses."""
    gf, wf = got.float(), want.float()
    return (float((gf - wf).abs().max()) / max(float(wf.abs().max()), 1e-9),
            float((gf - wf).abs().max()))


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
        Bx, Nx, Mx = x1.shape[0], x1.shape[1], x2.shape[1]
        pre32, skip32 = feats(Bx, Mx, C), feats(Bx, Nx, C)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
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
                entry.update(times(torch, lambda: ops.fused_fp(
                    x1, x2, pre, skip), 20))
                with ops.use_impl("torch"):
                    entry.update(times(torch, lambda: ops.fused_fp(
                        x1, x2, pre, skip), 10, "plain_"))
                # no single PyTorch call computes this function
                entry["library_ms"] = None
                es = pre.element_size()
                entry.update(bound(
                    (Bx * Nx + Bx * Mx) * 12
                    + (Bx * Mx * C + 2 * Bx * Nx * C) * es,
                    # 8 f32 operations per distance, 6 per interpolated
                    # channel (3 products, 2 sums, the skip add)
                    {"float32": 8 * Bx * Nx * Mx + 6 * Bx * Nx * C}))
            record("fused_fp", f"{label} {dtname}", entry)

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
                    fmap, u), 20))
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
    from mm3d_tpu_torch.ops import projection

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
        d, idx = ops.three_nn(x1, x2)
        with ops.use_impl("torch"):
            wd, wi = ops.three_nn(x1, x2)
        torch.cuda.synchronize()
        check(d.shape == idx.shape == (x1.shape[0], x1.shape[1], 3)
              and idx.dtype == torch.int32, f"three_nn {label}: shape/dtype")
        check(torch.equal(idx, wi) and torch.equal(d, wd),
              f"three_nn {label}: not bit-exact")
        nn[label] = (d, idx)
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
            # 8 f32 operations per distance (two 3-term dots, the doubling,
            # a subtraction and an addition; the comparisons not counted)
            entry.update(bound((Bx * Nx + Bx * Mx) * 12 + Bx * Nx * 3 * 8,
                               {"float32": 8 * Bx * Nx * Mx}))
        record("three_nn", label, entry)

    # --- three_interpolate: the forward bit-exact, the backward (d_points)
    # against autograd of the plain path, at FP2 (C=256) and FP1 (C=128)
    for label, key, M, C in (("FP2 N=256 M=64 C=256", "FP2 N=256 M=64", 64,
                              256),
                             ("FP1 N=2048 M=256 C=128", "FP1 N=2048 M=256",
                              256, 128)):
        d, idx = nn[key]
        w32 = ops.interpolation_weights(d)
        Nx = idx.shape[1]
        pre32, co32 = feats(B, M, C), feats(B, Nx, C)
        for dtname, dt in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
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
                         pre, idx, w), 20)}
            with ops.use_impl("torch"):
                entry.update(times(torch, lambda: ops.three_interpolate(
                    pre, idx, w), 10, "plain_"))
            # no single PyTorch call computes this function
            entry["library_ms"] = None
            es = pre.element_size()
            entry.update(bound(B * M * C * es + B * Nx * 3 * (4 + 4)
                               + B * Nx * C * es,
                               {"float32": 5 * B * Nx * C}))
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


def serve(torch, ops, cuda_kernels, dev):
    """fusion_cls through make_predictor at full width, bf16 and fp32."""
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.utils.profiling import nontrivial_bn

    model = init_params(get_model("fusion_cls").builder(num_class=NUM_CLASS),
                        seed=0)
    nontrivial_bn(model, seed=1)  # so the folds matter
    state = model.state_dict()
    preds = {"bfloat16": make_predictor("fusion_cls", state,
                                        dtype=torch.bfloat16, device=dev,
                                        num_class=NUM_CLASS),
             "float32": make_predictor("fusion_cls", state, device=dev,
                                       num_class=NUM_CLASS)}
    reqs = [[torch.from_numpy(a).to(dev) for a in request(s)]
            for s in (10, 11, 12)]
    counts, logp = {}, {}
    for dtname, pred in preds.items():
        cuda_kernels.reset_launches()
        logp[dtname] = [pred(*r) for r in reqs]
        torch.cuda.synchronize()
        counts[dtname] = {k.__name__: k.launches
                          for k in cuda_kernels.KERNELS}
        print(f"serve {dtname}: 3 requests of B={BATCH}, launches "
              f"{counts[dtname]}", flush=True)
        for lp in logp[dtname]:
            check(lp.shape == (BATCH, NUM_CLASS) and lp.dtype == torch.float32,
                  f"{dtname} logits shape {tuple(lp.shape)} {lp.dtype}")
            check(bool(torch.isfinite(lp).all()), f"{dtname}: non-finite")
    n = len(reqs)
    check(counts["bfloat16"] == {"farthest_point_sample": 2 * n,
                                 "query_ball_point": 0, "fused_sa": 2 * n,
                                 "gather_backward": 0, "fused_fp": 0,
                                 "bilinear_sample": 0, "three_nn": 0,
                                 "three_interpolate": 0},
          f"bf16 launches {counts['bfloat16']}: want 2 FPS + 2 fused SA "
          "per forward")
    check(counts["float32"] == {"farthest_point_sample": 2 * n,
                                "query_ball_point": 2 * n, "fused_sa": 0,
                                "gather_backward": 0, "fused_fp": 0,
                                "bilinear_sample": 0, "three_nn": 0,
                                "three_interpolate": 0},
          f"fp32 launches {counts['float32']}: want 2 FPS + 2 ball query "
          "per forward")
    launches = {k: counts["bfloat16"][k] + counts["float32"][k]
                for k in counts["float32"]}

    with ops.use_impl("torch"):
        plain = [preds["float32"](*r) for r in reqs]
    fp32_delta = max(float((a - b).abs().max())
                     for a, b in zip(logp["float32"], plain))
    print(f"fp32 kernels path vs plain path: max|d logp| {fp32_delta}",
          flush=True)
    check(fp32_delta <= 1e-4, f"fp32 kernels vs plain: {fp32_delta} > 1e-4")

    a16, a32 = torch.cat(logp["bfloat16"]), torch.cat(logp["float32"])
    agree = float((a16.argmax(-1) == a32.argmax(-1)).float().mean())
    bf16_delta = float((a16 - a32).abs().max())
    print(f"bf16 vs fp32: argmax agreement {agree}, max|d logp| "
          f"{bf16_delta}", flush=True)
    check(agree >= 0.95, f"bf16 vs fp32 argmax agreement {agree} < 0.95")

    rates = {}
    for dtname, pred in preds.items():
        ms = cuda_ms(torch, lambda: pred(*reqs[0]), 12, warmup=3)
        rates[dtname] = {"forward_ms": ms, "clouds_per_s": BATCH / ms * 1e3}
        print(f"serve {dtname}: median forward {ms} ms, "
              f"{rates[dtname]['clouds_per_s']} clouds/s at B={BATCH}",
              flush=True)
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
        counts[dtname] = {k.__name__: k.launches
                          for k in cuda_kernels.KERNELS}
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
    check(counts["bfloat16"] == {"farthest_point_sample": 2 * n,
                                 "query_ball_point": 0, "fused_sa": 2 * n,
                                 "gather_backward": 0, "fused_fp": 2 * n,
                                 "bilinear_sample": n, "three_nn": 0,
                                 "three_interpolate": 0},
          f"semseg bf16 launches {counts['bfloat16']}: want 2 FPS + 2 fused "
          "SA + 2 fused FP + 1 bilinear per forward")
    check(counts["float32"] == {"farthest_point_sample": 2 * n,
                                "query_ball_point": 2 * n, "fused_sa": 0,
                                "gather_backward": 0, "fused_fp": 2 * n,
                                "bilinear_sample": n, "three_nn": 0,
                                "three_interpolate": 0},
          f"semseg fp32 launches {counts['float32']}: want 2 FPS + 2 ball "
          "query + 2 fused FP + 1 bilinear per forward")
    launches = {k: counts["bfloat16"][k] + counts["float32"][k]
                for k in counts["float32"]}

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
            "proj_valid_share": share,
            "fp32_kernels_vs_plain": fp32_delta,
            "bf16_vs_fp32": {"argmax_agreement": agree,
                             "max_logp_delta": bf16_delta},
            "throughput": rates}


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


def train(torch, ops, cuda_kernels, dev):
    """fusion_cls training at full width, fp32 (TF32 off) then bf16."""
    import copy

    from mm3d_tpu_torch.data.pipeline import DataPipeline
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import TrainConfig, Trainer, steps
    from mm3d_tpu_torch.training.loop import build_datasets
    from mm3d_tpu_torch.training.state import make_optimizer

    spec = get_model("fusion_cls")
    names = ("random_point_dropout", "random_scale_point_cloud",
             "shift_point_cloud")
    cfg0 = TrainConfig(train_size=TRAIN_SIZE, test_size=TEST_SIZE, epochs=1,
                       num_class=NUM_CLASS, batch_size=TRAIN_BATCH,
                       npoint=NPOINT)
    train_ds, _ = build_datasets(cfg0)
    batch = next(iter(DataPipeline(train_ds, TRAIN_BATCH, shuffle=False,
                                   to_device=dev).epoch(0)))
    out = {"launches": {k.__name__: 0 for k in cuda_kernels.KERNELS}}

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
            model, spec.loss, opt, "fusion_cls",
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
        per_step = {k.__name__: k.launches for k in cuda_kernels.KERNELS}
        with ops.use_impl("torch"):
            mp = pstep(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        res["kernel_vs_plain"] = step_parity(torch, f"train {dtname}",
                                             dtype, kmodel, pmodel, mk, mp)
        # (b) launches of one step, of a BN refresh and of an eval forward
        want = {"farthest_point_sample": 2, "query_ball_point": 2,
                "gather_backward": 2, "fused_sa": 0, "fused_fp": 0,
                "bilinear_sample": 0, "three_nn": 0, "three_interpolate": 0}
        check(per_step == want, f"train {dtname}: launches per step "
                                f"{per_step}, want {want}")
        refresh = steps.make_bn_refresh_step(
            kmodel, "fusion_cls", names, torch.Generator(dev).manual_seed(3))
        evaluate = steps.make_eval_step(kmodel, spec.loss, "fusion_cls",
                                        NUM_CLASS)
        cuda_kernels.reset_launches()
        refresh(batch)
        em = evaluate(batch)
        torch.cuda.synchronize()
        side = {k.__name__: k.launches for k in cuda_kernels.KERNELS}
        check(side["gather_backward"] == 0,
              f"train {dtname}: BN refresh + eval launched {side}")
        check(int(em["count"]) == TRAIN_BATCH, "eval count")
        res["launches_per_step"] = per_step
        res["launches_refresh_plus_eval"] = side
        print(f"train {dtname}: launches per step {per_step}; BN refresh + "
              f"eval forward {side}", flush=True)
        # (c) ten steps on one fixed batch: finite losses, and the loss
        # falls
        model = make(dtype, seed=1)
        fixed = stepper(model, gen_seed=11, fixed=True)
        losses = [float(fixed(batch, 1e-3, 0.1)["loss"]) for _ in range(10)]
        check(all(np.isfinite(losses)), f"train {dtname}: losses {losses}")
        check(losses[-1] < losses[0], f"train {dtname}: loss did not fall "
                                      f"{losses}")
        res["fixed_batch_losses"] = losses
        print(f"train {dtname}: 10 steps on one batch, losses {losses}",
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
        print(f"train {dtname}: median step {ms} ms, "
              f"{res['clouds_per_s']} clouds/s at B={TRAIN_BATCH}, peak "
              f"memory {peak / 2**30:.3f} GiB", flush=True)
        del kmodel, pmodel, model
        # (d) the main path: one epoch of Trainer.fit (10 steps; eval over
        # 48 clouds; in bf16 the 8-step BN refresh before it)
        cfg = TrainConfig(train_size=TRAIN_SIZE, test_size=TEST_SIZE,
                          epochs=1, num_class=NUM_CLASS,
                          batch_size=TRAIN_BATCH, npoint=NPOINT,
                          dtype=dtname, device=str(dev))
        trainer = Trainer(cfg)
        cuda_kernels.reset_launches()
        final = trainer.fit()
        torch.cuda.synchronize()
        fit_launches = {k.__name__: k.launches for k in cuda_kernels.KERNELS}
        nsteps = trainer.train_pipe.steps_per_epoch()
        hist = trainer.history[0]
        check(nsteps == 10, f"fit: {nsteps} steps")
        check(fit_launches["gather_backward"] == 2 * nsteps,
              f"fit {dtname}: launches {fit_launches}")
        check(np.isfinite(hist["train"]["loss"])
              and np.isfinite(final["eval_loss"])
              and 0.0 <= final["instance_acc"] <= 1.0,
              f"fit {dtname}: metrics {hist}")
        for k, v in fit_launches.items():
            out["launches"][k] += v
        res["fit"] = {"train": hist["train"], "eval": final,
                      "launches": fit_launches,
                      "bn_refresh_steps": trainer._bn_refresh_n}
        print(f"fit {dtname}: 1 epoch of {nsteps} steps, train "
              f"{hist['train']}, eval {final}, launches {fit_launches}",
              flush=True)
        del trainer
        torch.cuda.empty_cache()
        out[dtname] = res
    return out


def train_semseg(torch, ops, cuda_kernels, dev):
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
    out = {"launches": {k.__name__: 0 for k in cuda_kernels.KERNELS}}

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
        per_step = {k.__name__: k.launches for k in cuda_kernels.KERNELS}
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
        want = {"farthest_point_sample": 2, "query_ball_point": 2,
                "gather_backward": 5, "fused_sa": 0, "fused_fp": 0,
                "bilinear_sample": 1, "three_nn": 2, "three_interpolate": 2}
        check(per_step == want, f"{label}: launches per step {per_step}, "
                                f"want {want}")
        refresh = steps.make_bn_refresh_step(
            kmodel, task, names, torch.Generator(dev).manual_seed(3))
        evaluate = steps.make_eval_step(kmodel, spec.loss, task, ncls)
        cuda_kernels.reset_launches()
        refresh(batch)
        em = evaluate(batch)
        torch.cuda.synchronize()
        side = {k.__name__: k.launches for k in cuda_kernels.KERNELS}
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
        trainer = Trainer(config(dtype=dtname, device=str(dev)))
        cuda_kernels.reset_launches()
        final = trainer.fit()
        torch.cuda.synchronize()
        fit_launches = {k.__name__: k.launches for k in cuda_kernels.KERNELS}
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
        del trainer
        torch.cuda.empty_cache()
        out[dtname] = res
    return out


def kernels_line(rows, launches):
    """One entry per kernel, summed over its path's shapes, in the dtype
    named (fused SA and fused FP: bf16 serving; gather backward: the f32
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
            # ball query, the fused SA and FP tails and the interpolation
            # have none
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
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # strict fp32: the plain twins and the model's fp32 path use no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False", flush=True)

    rows = kernel_checks(torch, ops, geometry, dev)
    served = serve(torch, ops, cuda_kernels, dev)
    semseg = serve_semseg(torch, ops, cuda_kernels, dev)
    trained = train(torch, ops, cuda_kernels, dev)
    trained_seg = train_semseg(torch, ops, cuda_kernels, dev)
    # each kernel's launches on the main paths: serving fusion_cls and
    # fusion_sem_seg (bf16 + fp32) and one epoch of Trainer.fit of each
    # model (fp32 + bf16)
    launches = {k: served["launches"][k] + semseg["launches"][k]
                + trained["launches"][k] + trained_seg["launches"][k]
                for k in served["launches"]}
    kernels = kernels_line(rows, launches)
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on "
                                 "the main paths")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_s": build_s, "kernel_checks": rows,
                   "serve": served, "serve_fusion_sem_seg": semseg,
                   "train": trained, "train_fusion_sem_seg": trained_seg,
                   "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
