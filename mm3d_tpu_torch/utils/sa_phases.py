"""Where the fused SA tail's time goes, by phase, on the card.

    python -m mm3d_tpu_torch.utils.sa_phases [--out chiprun_out]

Runs both forms of the fused SA tail (``ops.fused_sa`` over its own ball
query, ``ops.fused_sa_idx`` over ``knn_point``'s indices) in bf16 at the
serving shapes that ``chip_smoke.py`` times: SA1 (B=128, 512 centroids of
1024 points, K=32, widths 64, 64, 128) and SA2 (128 of 512, K=64, widths
128, 128, 256). For each it prints the device time of a call, and, from a
second build of ``csrc/fused_sa.cu`` with ``-DSA_PHASE_CLOCKS`` (lane 0 of
every warp adds the ``clock64()`` cycles of each phase of its timeline to a
device array), the mean cycles a warp of each role spends in each phase and
each phase's share of its role's cycles. The phases' names come from the
library (``role:phase``): the warp-specialised kernel's producer and
consumer warpgroups.
Also prints the ptxas report of the plain build. Writes ``sa_phases.json``
to ``--out``. Needs a card.
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

SA_SHAPES = (("SA1", 0.2, 32, (64, 64, 128)), ("SA2", 0.4, 64, (128, 128, 256)))


def _instrumented(src: str) -> ctypes.CDLL:
    lib = _build.build_variant(src, "fused_sa", ["-DSA_PHASE_CLOCKS"])
    lib.mm3d_fused_sa_phase_names.restype = ctypes.c_char_p
    lib.mm3d_fused_sa_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mm3d_fused_sa_phases.restype = ctypes.c_int
    return lib


def _clouds(r, B, N):
    pts = r.randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    return pts


def cases(dev, dtype=torch.bfloat16):
    """(label, call) for both forms at SA1 and SA2, B=128, in ``dtype``
    (bf16, the warp-specialised kernel; f32, the CUDA-core kernel)."""
    r = np.random.RandomState(0)
    xyz = torch.from_numpy(_clouds(r, 128, 1024)).to(dev)
    with dispatch.use_impl("torch"):
        c1 = geometry.index_points(xyz, geometry.fps_torch(xyz, 512))
        c2 = geometry.index_points(c1, geometry.fps_torch(c1, 128))
    g = np.random.RandomState(1)
    out = []
    for (label, radius, K, (C1, C2, C3)), (x, cents) in zip(
            SA_SHAPES, ((xyz, c1), (c1, c2))):
        B, N, _ = x.shape
        S = cents.shape[1]
        w = [torch.from_numpy(a).to(dev).to(dtype) for a in (
            g.randn(B, N, C1).astype(np.float32),
            g.randn(B, S, C1).astype(np.float32),
            (g.randn(C1, C2) * 0.3).astype(np.float32),
            g.randn(C2).astype(np.float32),
            (g.randn(C2, C3) * 0.3).astype(np.float32),
            g.randn(C3).astype(np.float32))]
        idx = ops.knn_point(K, x, cents)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        out.append((f"fused_sa {label} {name}",
                    lambda a=(radius, K, x, cents, *w): ops.fused_sa(*a)))
        out.append((f"fused_sa_idx {label} {name}",
                    lambda a=(K, idx, *w): ops.fused_sa_idx(*a)))
    return out


def event_ms(fn, reps=20):
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sa_phases: no CUDA device; this runs on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    _build.build(["fused_sa"])
    ptxas = [line.strip() for line in
             _build.BUILD_LOGS.get("fused_sa", "").splitlines()
             if "Used" in line or "spill" in line or "Compiling" in line]
    for line in ptxas:
        print(f"ptxas fused_sa: {line}", flush=True)
    src = os.path.join(_build.CSRC_DIR, "fused_sa.cu")
    inst = _instrumented(src)
    names = inst.mm3d_fused_sa_phase_names().decode().split(",")
    plain_lib = _build.load("fused_sa")
    rows = []
    for label, call in cases(dev):
        ms = event_ms(call)
        # the wrapper launches whatever library _build holds for fused_sa
        _build._LIBS["fused_sa"] = inst
        try:
            inst_ms = event_ms(call)
            buf = (ctypes.c_ulonglong * 32)()
            inst.mm3d_fused_sa_phases(buf, 1)
            call()
            torch.cuda.synchronize()
            err = inst.mm3d_fused_sa_phases(buf, 1)
            if err:
                raise RuntimeError(f"reading the phase clocks failed: {err}")
        finally:
            _build._LIBS["fused_sa"] = plain_lib
        by_role = {}
        for i, name in enumerate(names):
            role, phase = name.split(":")
            if role != "-":
                by_role.setdefault(role, {})[phase] = buf[i]
        row = {"case": label, "call_ms": ms, "instrumented_call_ms": inst_ms,
               "warps_reporting": buf[31], "roles": {}}
        for role, phases in by_role.items():
            n = phases.pop("warps") or 1
            total = sum(phases.values()) or 1
            row["roles"][role] = {
                "warps": n,
                "cycles_per_warp": {p: v / n for p, v in phases.items()},
                "share": {p: v / total for p, v in phases.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "sa_phases.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
