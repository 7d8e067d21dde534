"""Where the gather backward's time goes, by phase, on the card.

    python -m mm3d_tpu_torch.utils.gather_phases [--out chiprun_out]

Runs ``cuda_kernels.gather_backward`` at the training shapes that
``chip_smoke.py`` times: the unweighted form at SA1 and SA2 (f32 and bf16,
the ball query's indices), the weighted form at three_interpolate's FP2 and
FP1 (f32 and bf16) and at the sampling's [24,16,16,128] map. For each it
prints the device time of each of the call's three kernels (torch.profiler:
the count and the bucket sort that take the place of a CSR build, then the
sums), and, from a second build of ``csrc/gather_bwd.cu`` with
``-DGB_PHASE_CLOCKS`` (thread 0 of every block of the sums adds the
``clock64()`` cycles of each phase to a device array), the mean cycles a
block of the sums spends reading entries, issuing loads, sorting, summing
and staging. Writes ``gather_phases.json`` to ``--out``. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from mm3d_tpu_torch.ops import _build, geometry, projection
from mm3d_tpu_torch.ops import cuda_kernels as ck
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.utils.profiling import _profile

PHASES = ("entries", "issue_loads", "sort", "sum_warp0", "barrier",
          "stage+barrier")


def _instrumented() -> ctypes.CDLL:
    path = _build.lib_path("gather_bwd").replace(".so", "-phases.so")
    if not os.path.exists(path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DGB_PHASE_CLOCKS", "-o",
             path, os.path.join(_build.CSRC_DIR, "gather_bwd.cu")],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(path)
    lib.mm3d_gather_bwd.argtypes = ck._SIGNATURES["mm3d_gather_bwd"][1]
    lib.mm3d_gather_bwd.restype = ctypes.c_int
    lib.mm3d_gather_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mm3d_gather_bwd_phases.restype = ctypes.c_int
    return lib


def _clouds(r, B, N):
    pts = r.randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    return pts


def cases(dev):
    """(label, g, idx, n, weight) at the training shapes, B=24."""
    from mm3d_tpu_torch.data.synthetic import semseg_request

    r = np.random.RandomState(0)
    xyz = torch.from_numpy(_clouds(r, 24, 1024)).to(dev)
    with dispatch.use_impl("torch"):
        c1 = geometry.index_points(xyz, geometry.fps_torch(xyz, 512))
        c2 = geometry.index_points(c1, geometry.fps_torch(c1, 128))
        idx1 = geometry.ball_query_torch(0.2, 32, xyz, c1)
        idx2 = geometry.ball_query_torch(0.4, 64, c1, c2)
    pts, _, K, R, t = (torch.from_numpy(a).to(dev)
                       for a in semseg_request(24, 2048, (64, 64), seed=6))
    p = pts[..., :3].contiguous()
    l1 = geometry.index_points(p, geometry.fps_torch(p, 256))
    l2 = geometry.index_points(l1, geometry.fps_torch(l1, 64))
    d1, i1 = geometry.three_nn_torch(p, l1)
    d2, i2 = geometry.three_nn_torch(l1, l2)
    uv = projection.project_points(p, K, R, t)[0] / 4.0
    g = np.random.RandomState(2)

    def feats(*shape):
        return torch.from_numpy(g.randn(*shape).astype(np.float32)).to(dev)

    # the sampling's operands, captured from one backward
    fmap = feats(24, 16, 16, 128).requires_grad_(True)
    calls = []
    orig = ck.gather_backward

    def recorder(gg, idx, n, weight=None):
        calls.append((gg, idx, n, weight))
        return orig(gg, idx, n, weight)

    recorder.launches = orig.launches
    ck.gather_backward = recorder
    try:
        with dispatch.use_impl("torch"):
            ck.bilinear_sample(fmap, uv).backward(feats(24, 2048, 128))
    finally:
        ck.gather_backward = orig
    out = []
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        out += [(f"SA1 g[24,512,32,64] n=1024 {name}",
                 feats(24, 512, 32, 64).to(dt), idx1, 1024, None),
                (f"SA2 g[24,128,64,128] n=512 {name}",
                 feats(24, 128, 64, 128).to(dt), idx2, 512, None),
                (f"FP2 weighted g[24,256,256] k=3 n=64 {name}",
                 feats(24, 256, 256).to(dt), i2, 64,
                 geometry.interpolation_weights(d2).to(dt)),
                (f"FP1 weighted g[24,2048,128] k=3 n=256 {name}",
                 feats(24, 2048, 128).to(dt), i1, 256,
                 geometry.interpolation_weights(d1).to(dt))]
    gg, idx, n, w = calls[0]
    out.append(("bilinear weighted g[24,2048,128] k=4 n=256 f32",
                gg.contiguous(), idx.contiguous(), n, w.contiguous()))
    return out


def _event_ms(fn, reps=20):
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
        raise SystemExit("gather_phases: no CUDA device; this runs on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _instrumented()
    rows = []
    for label, g, idx, n, w in cases(dev):
        B, C = g.shape[0], g.shape[-1]
        R, k = (idx[0].numel(), 1) if w is None else (g.shape[1],
                                                       idx.shape[-1])
        g, idx = g.contiguous(), idx.contiguous()
        rpb = ck._gather_rows_per_block(B, n, C, sms, 128, 512)
        nb, tiles = -(-n // rpb), -(-R * k // 1024)
        out = torch.empty(B, n, C, dtype=g.dtype, device=dev)
        scratch = [torch.empty(shape, dtype=torch.int32, device=dev)
                   for shape in ((B, tiles, nb), (B, R * k), (B, nb + 1))]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        argv_ = (int(g.dtype == torch.bfloat16), ck._vec_ok(C, g),
                 ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
                 None if w is None else ctypes.c_void_p(w.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()),
                 *(ctypes.c_void_p(t.data_ptr()) for t in scratch),
                 B, R, k, n, C, rpb, stream)

        def launch():
            err = lib.mm3d_gather_bwd(*argv_)
            if err:
                raise RuntimeError(f"instrumented launch failed: {err}")

        plain_ms = _event_ms(lambda: ck.gather_backward(g, idx, n, w))
        inst_ms = _event_ms(launch)
        events, _ = _profile(lambda: ck.gather_backward(g, idx, n, w), 10)
        kernels = {}
        for ev in events:
            found = re.search(r"(count_kernel|bucket_kernel|gather_bwd_kernel)",
                              ev.name)
            name = found.group(1) if found else ev.name
            kernels.setdefault(name, []).append(ev.time_range.elapsed_us())
        kernel_ms = {name: float(np.mean(d)) / 1e3
                     for name, d in kernels.items()}
        buf = (ctypes.c_ulonglong * 8)()
        lib.mm3d_gather_bwd_phases(buf, 1)
        launch()
        torch.cuda.synchronize()
        lib.mm3d_gather_bwd_phases(buf, 1)
        blocks = B * -(-n // rpb) * -(-C // 32)
        row = {"shape": label, "rows_per_block": rpb, "blocks": blocks,
               "wrapper_call_ms": plain_ms, "instrumented_launch_ms": inst_ms,
               "kernel_ms": kernel_ms,
               "batches_per_block": buf[6] / blocks,
               "cycles_per_block": {p: buf[i] / blocks
                                    for i, p in enumerate(PHASES)}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "gather_phases.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
