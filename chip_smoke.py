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
   ball query bit-exact, the fused SA tail and the gather backward within
   the stated tolerances (the gather backward also bit-identical across two
   launches), and times the kernel, its plain twin and, where one PyTorch
   call computes the same function, that call;
3. serves fusion_cls through ``make_predictor`` at full width (B=128 clouds
   of 1024 points, 64x64 images, 40 classes, random seeded weights) in bf16
   and fp32: 3 requests each with the launch counts reset just before, then
   checks shapes, finiteness, fp32 parity of the kernels path with the plain
   path, bf16-vs-fp32 agreement, and measures clouds/s;
4. trains fusion_cls at full width (B=24 clouds, the trainer's default), in
   fp32 with TF32 off and then in bf16 mixed precision: one step on the
   kernel path against one on the plain path from the same state and batch
   (loss, every gradient, BN statistics), the launches of one step, of a BN
   refresh and of an eval forward, ten steps on one batch (the loss must
   fall), one epoch of ``Trainer.fit`` on synthetic data (the main path: its
   launch counts are reset just before and read just after), and the median
   step time, clouds/s and peak memory;
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
TRAIN_SIZE, TEST_SIZE = 240, 48  # one epoch of 10 steps, 2 eval batches
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
GRAD_REL, GRAD_ABS, BF16_GRAD_REL, RESIDUE = 1e-4, 1e-7, 1e-2, 1e-4


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
            entry["ms"] = cuda_ms(torch, lambda: ops.farthest_point_sample(
                x, npoint, start), 20)
            with ops.use_impl("torch"):
                entry["plain_ms"] = cuda_ms(
                    torch, lambda: ops.farthest_point_sample(x, npoint, start),
                    3, warmup=1)
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
            entry["ms"] = cuda_ms(torch, lambda: ops.query_ball_point(
                radius, K, x, cents), 20)
            with ops.use_impl("torch"):
                entry["plain_ms"] = cuda_ms(torch, lambda: ops.query_ball_point(
                    radius, K, x, cents), 5)
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
            entry = {
                "dtype": dtname, "max_abs_err": float(err.max()),
                "ms": cuda_ms(torch, lambda: ops.fused_sa(*args), 20)}
            with ops.use_impl("torch"):
                entry["plain_ms"] = cuda_ms(
                    torch, lambda: ops.fused_sa(*args), 5)
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
            entry["ms"] = cuda_ms(torch, lambda: ops.gather_backward(
                gg, idx, n), 20)
            with ops.use_impl("torch"):
                entry["plain_ms"] = cuda_ms(
                    torch, lambda: ops.gather_backward(gg, idx, n), 20)
            # the library yardstick: one index_add_ into zeros, with the
            # flat int64 row index built beforehand
            offs = (torch.arange(B, device=dev) * n).reshape(B, 1, 1)
            flat_idx = (idx.long() + offs).reshape(-1)
            flat_g = gg.reshape(-1, C_)
            entry["library_ms"] = cuda_ms(torch, lambda: torch.zeros(
                B * n, C_, device=dev).index_add_(0, flat_idx, flat_g), 20)
            es = gg.element_size()
            entry.update(bound(B * F * C_ * es + B * F * 4 + B * n * C_ * es,
                               {"float32": B * F * C_}))
        record("gather_backward", label, entry)
    return rows


def serve(torch, ops, cuda_kernels, dev):
    """fusion_cls through make_predictor at full width, bf16 and fp32."""
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.models.layers import BatchNorm
    from mm3d_tpu_torch.training import make_predictor

    model = init_params(get_model("fusion_cls").builder(num_class=NUM_CLASS),
                        seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial BN statistics, so the folds matter
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.normal_(0.0, 0.1, generator=g)
                m.var.uniform_(0.5, 1.5, generator=g)
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
                                 "gather_backward": 0},
          f"bf16 launches {counts['bfloat16']}: want 2 FPS + 2 fused SA "
          "per forward")
    check(counts["float32"] == {"farthest_point_sample": 2 * n,
                                "query_ball_point": 2 * n, "fused_sa": 0,
                                "gather_backward": 0},
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


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()}


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
        lk, lp = float(mk["loss"]), float(mp["loss"])
        loss_rel = abs(lk - lp) / abs(lp)
        check(loss_rel <= 1e-5, f"train {dtname}: loss kernel {lk} vs plain "
                                f"{lp}")
        rel = BF16_GRAD_REL if dtype is not None else GRAD_REL
        gk, gp = _grads(kmodel), _grads(pmodel)
        top = max(float(g.float().abs().max()) for g in gp.values())
        worst_grad, residue = 0.0, []
        for n in gk:
            d = float((gk[n].float() - gp[n].float()).abs().max())
            scale = float(gp[n].float().abs().max())
            if max(scale, float(gk[n].float().abs().max())) <= RESIDUE * top:
                residue.append(n)
                check(d <= RESIDUE * top, f"train {dtname}: residue grad {n} "
                                          f"max|d| {d}")
                continue
            check(d <= rel * scale + GRAD_ABS,
                  f"train {dtname}: grad {n} max|d| {d} vs max|g| {scale}")
            worst_grad = max(worst_grad, d / (scale + 1e-30))
        sk, sp = _stats(kmodel), _stats(pmodel)
        worst_stat = max(float(((sk[n] - sp[n]).abs()
                                - 1e-5 * sp[n].abs()).max()) for n in sk)
        check(worst_stat <= 1e-5, f"train {dtname}: BN statistics differ "
                                  f"({worst_stat})")
        res["kernel_vs_plain"] = {"loss_kernel": lk, "loss_plain": lp,
                                  "loss_rel": loss_rel,
                                  "max_grad_rel_to_max": worst_grad,
                                  "largest_grad": top,
                                  "residue_grads": residue,
                                  "bn_stats_excess": worst_stat}
        print(f"train {dtname}: kernel vs plain step: loss {lk} vs {lp}, "
              f"worst grad max|d|/max|g| {worst_grad} over "
              f"{len(gk) - len(residue)} tensors, {len(residue)} residue "
              f"tensors (max|g| <= {RESIDUE} x {top}), BN stats ok",
              flush=True)
        # (b) launches of one step, of a BN refresh and of an eval forward
        want = {"farthest_point_sample": 2, "query_ball_point": 2,
                "gather_backward": 2, "fused_sa": 0}
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


def kernels_line(rows, launches):
    """One entry per kernel, summed over its path's two shapes."""
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
            # one PyTorch call computes only the gather backward
            # (index_add_); FPS, ball query and the fused SA tail have none
            "library_ms": (sum(e["library_ms"] for e in timed)
                           if "library_ms" in timed[0] else None)})
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
    trained = train(torch, ops, cuda_kernels, dev)
    # each kernel's launches on the main paths: serving (bf16 + fp32) and
    # one epoch of Trainer.fit (fp32 + bf16)
    launches = {k: served["launches"][k] + trained["launches"][k]
                for k in served["launches"]}
    kernels = kernels_line(rows, launches)
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on "
                                 "the main paths")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_s": build_s, "kernel_checks": rows,
                   "serve": served, "train": trained, "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
