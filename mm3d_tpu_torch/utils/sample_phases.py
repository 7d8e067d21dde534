"""Where FPS and the ball query spend their time, by phase, on the card.

    python -m mm3d_tpu_torch.utils.sample_phases [--out chiprun_out]
                                                 [--src FILE ...]

Runs ``ops.farthest_point_sample`` at SA1 (B=128, 1024 -> 512 points), SA2
(512 -> 128) and fusion_sem_seg's first FPS (B=16, 2048 -> 256), and
``ops.query_ball_point`` at SA1 (S=512 of N=1024, K=32, r=0.2), SA2 (S=128
of 512, K=64, r=0.4) and fusion_sem_seg's SA1 and SA2 (B=16: S=256 of 2048,
K=32, r=0.2; S=64 of 256, K=64, r=0.4), on the clouds ``chip_smoke.py``
uses. For each it prints the device time of a call (torch.profiler) and,
from a second build of ``csrc/fps.cu`` and ``csrc/ball_query.cu`` with
``-DSAMPLE_PHASE_CLOCKS`` (``csrc/sample_phases.cuh``: lane 0 of every warp
adds the ``clock64()`` cycles of each phase to a device array):

* FPS: the mean cycles a warp spends a step in each phase (the distance
  update, the warp's reduction, the barrier, the exchange across warps, the
  lookup of the winner's coordinates, the index store), and the chain
  floor: ``npoint - 1`` times the cycles of the least step (the slot
  writes, barrier, slot reads, ``redux.sync`` reductions and coordinate
  read of a step, no distance work; ``mm3d_fps_floor``) at the clock that
  loop read (its ``clock64()`` cycles over its ``%globaltimer``
  nanoseconds);
* ball query: the cycles of one round of 32 points, the rounds a centroid
  walks, and the cycles a warp spends staging the cloud and storing rows.

It also times the ball-query form of the fused SA tail at SA1 and SA2 (bf16,
the warp-specialised kernel, and f32, the loop kernel; ``sa_phases``'
draws), whose selection is the same walk.

``--src FILE`` (repeatable) times a library built from another copy of
``fps.cu``, ``ball_query.cu`` or ``fused_sa.cu`` (the file's name says which;
its headers are found beside it first) beside the checkout's, in the same
process, in the order checkout, copy, copy, checkout; each copy must keep
the C interface. So an earlier commit's sources
(``git archive <commit> mm3d_tpu_torch/csrc | tar -x -C build/old``) or an
edited copy of a compile-time choice race the checkout's on one card. Writes
``sample_phases.json`` to ``--out``. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from mm3d_tpu_torch import ops
from mm3d_tpu_torch.ops import _build, dispatch, geometry
from mm3d_tpu_torch.utils import sa_phases
from mm3d_tpu_torch.utils.profiling import device_ms

FPS_PHASES = ("distance", "warp_reduce", "barrier", "exchange",
              "coord_lookup", "index_store")
FPS_STEPS, FPS_WARPS = 6, 7  # slots of the step and warp counts
BQ_PHASES = ("stage", "select", "store")
BQ_ROUNDS, BQ_CENTROIDS, BQ_WARPS = 3, 4, 5


def _clouds(r, B, N):
    pts = r.randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    return pts


def cases(dev):
    """(kernel, label, call) at the serving shapes."""
    from mm3d_tpu_torch.data.synthetic import semseg_request

    xyz = torch.from_numpy(_clouds(np.random.RandomState(0), 128,
                                   1024)).to(dev)
    seg = torch.from_numpy(semseg_request(16, 2048, (64, 64), seed=5)[0][
        ..., :3].copy()).to(dev)
    with dispatch.use_impl("torch"):
        c1 = geometry.index_points(xyz, geometry.fps_torch(xyz, 512))
        c2 = geometry.index_points(c1, geometry.fps_torch(c1, 128))
        l1 = geometry.index_points(seg, geometry.fps_torch(seg, 256))
        l2 = geometry.index_points(l1, geometry.fps_torch(l1, 64))
    out = []
    for label, x, npoint in (("SA1 B=128 1024->512", xyz, 512),
                             ("SA2 B=128 512->128", c1, 128),
                             ("semseg B=16 2048->256", seg, 256)):
        out.append(("fps", label, x, npoint,
                    lambda a=(x, npoint): ops.farthest_point_sample(*a)))
    for label, radius, K, x, cents in (
            ("SA1 B=128 S=512 N=1024 K=32", 0.2, 32, xyz, c1),
            ("SA2 B=128 S=128 N=512 K=64", 0.4, 64, c1, c2),
            ("semseg SA1 B=16 S=256 N=2048 K=32", 0.2, 32, seg, l1),
            ("semseg SA2 B=16 S=64 N=256 K=64", 0.4, 64, l1, l2)):
        out.append(("ball_query", label, x, cents.shape[1],
                    lambda a=(radius, K, x, cents): ops.query_ball_point(
                        *a)))
    # the fused SA's ball-query form, sa_phases' operands, bf16 (the
    # warp-specialised kernel) and f32 (the loop kernel)
    g = np.random.RandomState(1)
    for (label, radius, K, (C1, C2, C3)), (x, cents) in zip(
            sa_phases.SA_SHAPES, ((xyz, c1), (c1, c2))):
        B, N, S = x.shape[0], x.shape[1], cents.shape[1]
        w = [torch.from_numpy(a).to(dev) for a in (
            g.randn(B, N, C1).astype(np.float32),
            g.randn(B, S, C1).astype(np.float32),
            (g.randn(C1, C2) * 0.3).astype(np.float32),
            g.randn(C2).astype(np.float32),
            (g.randn(C2, C3) * 0.3).astype(np.float32),
            g.randn(C3).astype(np.float32))]
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            out.append(("fused_sa", f"fused_sa {label} {name}", None, None,
                        lambda a=(radius, K, x, cents,
                                  *[t.to(dt) for t in w]): ops.fused_sa(*a)))
    return out


def _instrumented(name: str) -> ctypes.CDLL:
    lib = _build.build_variant(os.path.join(_build.CSRC_DIR, f"{name}.cu"),
                               name, ["-DSAMPLE_PHASE_CLOCKS"])
    lib.mm3d_sample_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mm3d_sample_phases.restype = ctypes.c_int
    return lib


def _phases(lib, name, call):
    """The phase slots summed over one call of ``call`` with ``lib`` in
    place of the checkout's library."""
    buf = (ctypes.c_ulonglong * 16)()
    plain = _build._LIBS[name]
    _build._LIBS[name] = lib
    try:
        lib.mm3d_sample_phases(buf, 1)
        call()
        torch.cuda.synchronize()
        err = lib.mm3d_sample_phases(buf, 1)
        if err:
            raise RuntimeError(f"reading the phase clocks failed: {err}")
    finally:
        _build._LIBS[name] = plain
    return list(buf)


def _floor(lib, B, threads, npoint, steps=20000):
    """(chain floor ms, cycles a least step, GHz the loop read)."""
    lib.mm3d_fps_floor.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mm3d_fps_floor.restype = ctypes.c_int
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for _ in range(2):  # the second run is read
        err = lib.mm3d_fps_floor(B, threads, steps,
                                 ctypes.c_void_p(out.data_ptr()), stream)
        if err:
            raise RuntimeError(f"mm3d_fps_floor failed: {err}")
    cycles, ns = (int(v) for v in out[:2].cpu())
    per_step, ghz = cycles / steps, cycles / ns
    return (npoint - 1) * per_step / ghz / 1e6, per_step, ghz


def _timed(call, libs, name):
    """Device ms of a call with each library of ``libs`` (tag -> lib) in
    place of the checkout's, in the order checkout, copies, copies reversed,
    checkout; each the mean of its two readings."""
    order = list(libs) + list(reversed(libs))
    readings = {tag: [] for tag in libs}
    plain = _build._LIBS[name]
    try:
        for tag in order:
            _build._LIBS[name] = libs[tag]
            readings[tag].append(device_ms(call, 20))
    finally:
        _build._LIBS[name] = plain
    return {tag: float(np.mean(v)) for tag, v in readings.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--src", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sample_phases: no CUDA device; this runs on the "
                         "card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    names = ("fps", "ball_query", "fused_sa")
    _build.build(names)
    libs = {n: {"checkout": _build.load(n)} for n in names}
    for src in args.src:
        name = os.path.basename(src)[:-3]
        if name not in libs:
            raise SystemExit(f"--src {src}: not one of {names}")
        libs[name][src] = _build.build_variant(src, name)
    ptxas = {}
    for key, log in _build.BUILD_LOGS.items():
        lines = [line.strip() for line in log.splitlines()
                 if "Used" in line or "spill" in line]
        ptxas[key] = lines
        for line in lines:
            print(f"ptxas {os.path.basename(key)}: {line}", flush=True)
    inst = {n: _instrumented(n) for n in ("fps", "ball_query")}
    fps_threads = _build.load("fps").mm3d_fps_threads
    fps_threads.argtypes = [ctypes.c_int]
    rows = []
    for kernel, label, x, n, call in cases(dev):
        row = {"kernel": kernel, "case": label,
               "device_ms": _timed(call, libs[kernel], kernel)}
        if kernel == "fps":
            B, N = x.shape[:2]
            buf = _phases(inst["fps"], "fps", call)
            steps = buf[FPS_STEPS] or 1
            row["cycles_per_step"] = {p: buf[i] / steps
                                      for i, p in enumerate(FPS_PHASES)}
            row["cycles_per_step"]["total"] = sum(
                buf[i] for i in range(len(FPS_PHASES))) / steps
            row["warps"] = buf[FPS_WARPS]
            threads = fps_threads(N)
            floor_ms, per_step, ghz = _floor(inst["fps"], B, threads, n)
            row.update({"threads": threads, "chain_floor_ms": floor_ms,
                        "floor_cycles_per_step": per_step,
                        "clock_ghz": ghz})
        elif kernel == "ball_query":
            buf = _phases(inst["ball_query"], "ball_query", call)
            rounds = buf[BQ_ROUNDS] or 1
            warps = buf[BQ_WARPS] or 1
            row.update({
                "cycles_per_round_of_32": buf[1] / rounds,
                "rounds_per_centroid": rounds / (buf[BQ_CENTROIDS] or 1),
                "stage_cycles_per_warp": buf[0] / warps,
                "store_cycles_per_warp": buf[2] / warps,
                "centroids": buf[BQ_CENTROIDS], "warps": buf[BQ_WARPS]})
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "sample_phases.json"), "w") as f:
        json.dump({"card": card, "src": args.src, "ptxas": ptxas,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
