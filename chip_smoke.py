#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mm3d_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

What it does, failing (non-zero exit, no result line) at the first phase
that goes wrong:

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels of mm3d_tpu_torch/csrc from source, printing the build seconds;
2. holds each kernel against its plain PyTorch twin (``use_impl("torch")``)
   on the card at the serving path's shapes: FPS and ball query bit-exact,
   the fused SA tail within the stated tolerances, and times both;
3. serves fusion_cls through ``make_predictor`` at full width (B=128 clouds
   of 1024 points, 64x64 images, 40 classes, random seeded weights) in bf16
   and fp32: 3 requests each with the launch counts reset just before, then
   checks shapes, finiteness, fp32 parity of the kernels path with the plain
   path, bf16-vs-fp32 agreement, and measures clouds/s;
4. prints the ``{"kernels": [...]}`` line, then, last, the
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
# fp32: the bound tests/test_fused_sa.py holds the f32 Pallas kernel to
F32_RTOL = F32_ATOL = 1e-5


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
                                 "query_ball_point": 0, "fused_sa": 2 * n},
          f"bf16 launches {counts['bfloat16']}: want 2 FPS + 2 fused SA "
          "per forward")
    check(counts["float32"] == {"farthest_point_sample": 2 * n,
                                "query_ball_point": 2 * n, "fused_sa": 0},
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


def kernels_line(rows, launches):
    """One entry per kernel, summed over the serving path's two shapes."""
    path = {
        "fps": ("farthest_point_sample", "mm3d_tpu_torch/csrc/fps.cu",
                "mm3d_tpu/ops/pallas_kernels.py:174", None),
        "ball_query": ("query_ball_point", "mm3d_tpu_torch/csrc/ball_query.cu",
                       "mm3d_tpu/ops/pallas_kernels.py:324", None),
        "fused_sa": ("fused_sa", "mm3d_tpu_torch/csrc/fused_sa.cu",
                     "mm3d_tpu/ops/pallas_kernels.py:961", "bfloat16"),
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
            "library_ms": None})
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
    kernels = kernels_line(rows, served["launches"])
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on "
                                 "the serving path")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_s": build_s, "kernel_checks": rows,
                   "serve": served, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
