"""Where FPS, the ball query and the 3-NN kernels spend their time, by
phase, on the card.

    python -m mm3d_tpu_torch.utils.sample_phases [--out chiprun_out]
                                                 [--src FILE ...]
                                                 [--kernel NAME ...]
                                                 [--plan NAME=VALUE ...]

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
the warp-specialised kernel, and f32, the CUDA-core kernel
``sa_f32_kernel``; ``sa_phases``' draws), whose selection is the same walk.

The 3-NN selection (``csrc/three_nn.cuh``): ``ops.three_nn`` at
fusion_sem_seg's training shapes (B=24: FP2 256 <- 64, FP1 2048 <- 256
points, ``chip_smoke.py``'s clouds, ``semseg_request(..., seed=6)``
subsampled by FPS) and ``ops.fused_fp`` at its serving shapes (B=16: FP2
N=256 M=64 C=256, FP1 N=2048 M=256 C=128, bf16 and f32, seed 5), from
builds of ``csrc/three_nn.cu`` and ``csrc/fused_fp.cu`` with the same
switch: the cycles a warp spends per phase (three_nn: stage, scan, merge,
store; fused FP: stage, select, weights, stream), the scan steps a warp
and the share of them in which some lane of the warp inserts. Every library's output is held to the plain twin (``bit_exact``).

The two byte-bound forwards, ``csrc/three_interp.cu`` and
``csrc/bilinear.cu``: ``ops.three_interpolate`` at fusion_sem_seg's
training shapes (B=24: FP2 [24,64,256] -> 256 points, FP1 [24,256,128] ->
2048, the 3-NN of ``chip_smoke.py``'s clouds, seed 6; bf16 with bf16
weights, as the model passes them, and f32) and ``ops.bilinear_sample`` on
a [B,16,16,128] map at the projected points of a request (B=16, seed 5:
serving; B=24, seed 6: training; out-of-frame and behind-camera points
included), bf16 and f32. For each: the device time of the call (every
kernel and copy it puts on the card), the kernel's own time (the profiler's
records whose name holds the kernel's), the kernels a call, the byte bound
(each input read once, the output written once, at 3.35 TB/s) and its share
of the kernel's time, ``bit_exact``; and, from ``cuobjdump -sass`` of each
library raced, each kernel function's SASS instructions up to its last
``EXIT`` (one thread's straight-line path), the instructions after it
(subroutines it calls, such as the 64-bit division) and its ``CALL``s. A
three_interp library from before the weights were taken in their own dtype
(no ``mm3d_three_interp_max_batch``) is called as its wrapper called it:
the weights rounded to the points' dtype and widened to f32 ahead of the
launch.

``--src FILE`` (repeatable) times a library built from another copy of
``fps.cu``, ``ball_query.cu``, ``fused_sa.cu``, ``three_nn.cu``,
``fused_fp.cu``, ``three_interp.cu`` or ``bilinear.cu`` (the file's name
says which; its headers are found beside
it first) beside the checkout's, in the same process, in the order
checkout, copy, copy, checkout; each copy keeps the C interface, except
that a three_nn or fused_fp copy from before the launch plan (no
``*_threads``) is called without its lanes argument, and a fused_sa copy
from before the ``stages`` launch argument cannot be raced. So an earlier
commit's sources (``git archive <commit> mm3d_tpu_torch/csrc | tar -x -C
build/old``) or an edited copy of a compile-time choice race the
checkout's on one card. ``--plan NAME=VALUE`` (repeatable) times the
checkout's 3-NN kernels once more with a constant of the launch plan in
``ops.cuda_kernels`` set so (``NN_BLOCKS_PER_SM``,
``FP_PRE_SMEM_BYTES``, ...). ``--kernel NAME`` (repeatable) runs only the
cases of those kernels. Writes ``sample_phases.json`` to ``--out``. Needs
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

from mm3d_tpu_torch import ops
from mm3d_tpu_torch.ops import _build, cuda_kernels, dispatch, geometry
from mm3d_tpu_torch.utils import sa_phases
from mm3d_tpu_torch.utils.profiling import device_kernels

KERNELS = ("fps", "ball_query", "fused_sa", "three_nn", "fused_fp",
           "three_interp", "bilinear")
# the kernels built again with -DSAMPLE_PHASE_CLOCKS
PHASED = ("fps", "ball_query", "three_nn", "fused_fp")
PEAK_BYTES_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FPS_PHASES = ("distance", "warp_reduce", "barrier", "exchange",
              "coord_lookup", "index_store")
FPS_STEPS, FPS_WARPS = 6, 7  # slots of the step and warp counts
BQ_PHASES = ("stage", "select", "store")
BQ_ROUNDS, BQ_CENTROIDS, BQ_WARPS = 3, 4, 5
NN_PHASES = {"three_nn": ("stage", "scan", "merge", "store"),
             "fused_fp": ("stage", "select", "weights", "stream")}
NN_STEPS, NN_INSERTS, NN_WARPS = 4, 5, 6


def src_kernel(path: str) -> str:
    """The kernel a ``--src`` copy replaces, by its file name."""
    name = os.path.basename(path)
    if not name.endswith(".cu") or name[:-3] not in KERNELS:
        raise SystemExit(f"--src {path}: not one of "
                         f"{', '.join(k + '.cu' for k in KERNELS)}")
    return name[:-3]


def _clouds(r, B, N):
    pts = r.randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    return pts


class _NoLanes:
    """A three_nn or fused_fp library from before the launch plan (no
    ``lanes`` argument, no ``*_threads``), called through the checkout's
    wrapper: the launch drops the plan's arguments ahead of the stream
    (lanes; for fused_fp lanes and shared-memory bytes)."""

    def __init__(self, lib, name):
        self._lib = lib
        raw = getattr(lib, f"mm3d_{name}")
        raw.restype = ctypes.c_int
        plan_args = 2 if name == "fused_fp" else 1

        def launch(*args):
            return raw(*args[:-1 - plan_args], args[-1])

        setattr(self, f"mm3d_{name}", launch)
        setattr(self, f"mm3d_{name}_threads", lambda: 128)

    def __getattr__(self, attr):
        return getattr(self._lib, attr)


class _NoMaxBatch:
    """A bilinear library from before the grid put the batch on its y
    axis (no ``mm3d_bilinear_max_batch``; same launch arguments), called
    through the checkout's wrapper: it reports the grid's y limit."""

    def __init__(self, lib):
        self._lib = lib
        self.mm3d_bilinear_max_batch = lambda: 65535

    def __getattr__(self, attr):
        return getattr(self._lib, attr)


def _variant(src, name):
    lib = _build.build_variant(src, name)
    if name in NN_PHASES and not hasattr(lib, f"mm3d_{name}_threads"):
        return _NoLanes(lib, name)
    if name == "bilinear" and not hasattr(lib, "mm3d_bilinear_max_batch"):
        return _NoMaxBatch(lib)
    return lib


def _semseg_levels(dev, B, seed):
    """A semseg request's xyz and its FPS levels of 256 and 64 points."""
    from mm3d_tpu_torch.data.synthetic import semseg_request

    seg = torch.from_numpy(semseg_request(B, 2048, (64, 64), seed=seed)[0][
        ..., :3].copy()).to(dev)
    with dispatch.use_impl("torch"):
        l1 = geometry.index_points(seg, geometry.fps_torch(seg, 256))
        l2 = geometry.index_points(l1, geometry.fps_torch(l1, 64))
    return seg, l1, l2


def nn_cases(dev):
    """(kernel, label, call, plain) of the 3-NN kernels: three_nn at the
    training shapes, the fused FP tail at the serving shapes."""
    out = []
    seg, l1, l2 = _semseg_levels(dev, 24, 6)
    for label, x1, x2 in (("FP2 B=24 N=256 M=64", l1, l2),
                          ("FP1 B=24 N=2048 M=256", seg, l1)):
        out.append(("three_nn", label,
                    lambda a=(x1, x2): ops.three_nn(*a),
                    lambda a=(x1, x2): geometry.three_nn_torch(*a)))
    seg, l1, l2 = _semseg_levels(dev, 16, 5)
    g = np.random.RandomState(3)
    for label, x1, x2, C in (("FP2 B=16 N=256 M=64 C=256", l1, l2, 256),
                             ("FP1 B=16 N=2048 M=256 C=128", seg, l1, 128)):
        B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
        pre, skip = (torch.from_numpy(g.randn(B, n, C).astype(
            np.float32)).to(dev) for n in (M, N))
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            a = (x1, x2, pre.to(dt), skip.to(dt))
            out.append(("fused_fp", f"{label} {name}",
                        lambda a=a: ops.fused_fp(*a),
                        lambda a=a: cuda_kernels.fused_fp_torch(*a)))
    return out


def _f32_weight_three_interp(points, idx, weight):
    """The interpolation as its earlier wrapper launched it, for a three_interp
    library in place that takes f32 weights only: the weights rounded to
    the points' dtype and widened to f32 (cast kernels ahead of the
    launch), then ``mm3d_three_interp(is_bf16, vec, points, idx, w, out, B,
    N, M, C, stream)``."""
    fn = _build._LIBS["three_interp"].mm3d_three_interp
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dt = points.dtype
    B, M, C = points.shape
    N = idx.shape[1]
    w = weight.to(dt).to(torch.float32).contiguous()
    out = torch.empty((B, N, C), dtype=dt, device=points.device)
    err = fn(int(dt == torch.bfloat16), cuda_kernels._vec_ok(C, points, out),
             *(ctypes.c_void_p(t.data_ptr()) for t in (points, idx, w, out)),
             B, N, M, C, ctypes.c_void_p(
                 torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"mm3d_three_interp (f32 weights): {err}")
    return out


def _three_interp(points, idx, weight):
    """``ops.three_interpolate`` with the library in place: the checkout's
    wrapper, or the earlier one for a library that takes f32 weights
    only."""
    if hasattr(_build._LIBS["three_interp"], "mm3d_three_interp_max_batch"):
        return cuda_kernels.three_interpolate(points, idx, weight)
    return _f32_weight_three_interp(points, idx, weight)


def interp_cases(dev):
    """(kernel, label, call, plain, bytes) of the byte-bound forwards:
    three_interpolate at the training shapes, the bilinear sampling at the
    serving and training shapes (see the module's docstring). ``bytes``:
    each input read once (the weights at the dtype passed), the output
    written once."""
    from mm3d_tpu_torch.data.synthetic import semseg_request
    from mm3d_tpu_torch.ops import projection

    out = []
    seg, l1, l2 = _semseg_levels(dev, 24, 6)
    g = np.random.RandomState(4)
    for label, x1, x2, C in (("FP2 B=24 N=256 M=64 C=256", l1, l2, 256),
                             ("FP1 B=24 N=2048 M=256 C=128", seg, l1, 128)):
        d, idx = geometry.three_nn_torch(x1, x2)
        w32 = geometry.interpolation_weights(d)
        B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
        pre = torch.from_numpy(g.randn(B, M, C).astype(np.float32)).to(dev)
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            a = (pre.to(dt), idx, w32.to(dt))
            es = a[0].element_size()
            out.append(("three_interp", f"{label} {name}",
                        lambda a=a: _three_interp(*a),
                        lambda a=a: geometry.three_interpolate_torch(*a),
                        B * M * C * es + B * N * 3 * (4 + es)
                        + B * N * C * es))
    H, W, C = 16, 16, 128
    for B, seed, what in ((16, 5, "serving"), (24, 6, "training")):
        pts, _, K, R, t = (torch.from_numpy(a).to(dev) for a in
                           semseg_request(B, 2048, (64, 64), seed=seed))
        uv, _ = projection.project_points(pts[..., :3].contiguous(), K, R, t)
        uv = (uv / 4.0).contiguous()
        fmap = torch.from_numpy(g.randn(B, H, W, C).astype(np.float32)).to(
            dev)
        N = uv.shape[1]
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            a = (fmap.to(dt), uv)
            es = a[0].element_size()
            out.append(("bilinear", f"{what} map [{B},{H},{W},{C}] at "
                        f"{B}x{N} {name}",
                        lambda a=a: cuda_kernels.bilinear_sample(*a),
                        lambda a=a: cuda_kernels.bilinear_sample_torch(*a),
                        B * H * W * C * es + B * N * 8 + B * N * C * es))
    return out


def sass_counts(path):
    """Each kernel function of a built library, from ``cuobjdump -sass``:
    {"body": SASS instructions up to its last EXIT, NOPs left out (the path
    of one thread that runs to the end), "after": those after it (the
    subroutines the body calls, such as the 64-bit division; the closing
    branch left out), "calls": its CALL instructions}; {} without
    cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    text = subprocess.run([exe, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        ins = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+([^;]*?)\s*;", block)]
        ins = [i for i in ins if not i.startswith("NOP")]
        ends = [k for k, i in enumerate(ins) if "EXIT" in i]
        last = ends[-1] if ends else len(ins) - 1
        after = ins[last + 1:]
        if after and after[0].startswith("BRA"):
            after = after[1:]
        out[name] = {"body": last + 1, "after": len(after),
                     "calls": sum("CALL" in i for i in ins)}
    return out


def cases(dev):
    """(kernel, label, call) at the serving shapes."""
    xyz = torch.from_numpy(_clouds(np.random.RandomState(0), 128,
                                   1024)).to(dev)
    seg, l1, l2 = _semseg_levels(dev, 16, 5)
    with dispatch.use_impl("torch"):
        c1 = geometry.index_points(xyz, geometry.fps_torch(xyz, 512))
        c2 = geometry.index_points(c1, geometry.fps_torch(c1, 128))
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
    # warp-specialised kernel) and f32 (the CUDA-core kernel)
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


@contextmanager
def _using(name, lib, plan):
    """``lib`` in place of the checkout's library of kernel ``name``, and
    the 3-NN launch plan's constants in ``cuda_kernels`` set as ``plan``
    says (name -> value)."""
    keep = _build._LIBS[name], {k: getattr(cuda_kernels, k) for k in plan}
    _build._LIBS[name] = lib
    for k, v in plan.items():
        setattr(cuda_kernels, k, v)
    try:
        yield
    finally:
        _build._LIBS[name] = keep[0]
        for k, v in keep[1].items():
            setattr(cuda_kernels, k, v)


def _same(call, plain, libs, name):
    """tag -> whether ``call`` with that library (and plan) returns the
    plain twin's result bit for bit."""
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    same = {}
    for tag, (lib, k) in libs.items():
        with _using(name, lib, k):
            got = call()
        got = got if isinstance(got, tuple) else (got,)
        same[tag] = all(torch.equal(a, b) for a, b in zip(got, want))
    return same


def _timed(call, libs, name, own=False):
    """Device ms of a call with each library of ``libs`` (tag -> (lib,
    plan)) in place of the checkout's, in the order checkout, copies,
    copies reversed, checkout; each the mean of its two readings. With
    ``own``: (that, the kernel's own ms -- the records whose name holds
    ``name`` --, the kernels and copies a call)."""
    order = list(libs) + list(reversed(libs))
    readings = {tag: [] for tag in libs}
    for tag in order:
        with _using(name, *libs[tag]):
            per = device_kernels(call, 20)
        readings[tag].append((
            sum(ms for ms, _ in per.values()),
            sum(ms for k, (ms, _) in per.items() if name in k),
            sum(n for _, n in per.values())))
    mean = {tag: np.mean(v, axis=0) for tag, v in readings.items()}
    if not own:
        return {tag: float(m[0]) for tag, m in mean.items()}
    return tuple({tag: float(m[i]) for tag, m in mean.items()}
                 for i in range(3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--kernel", action="append", choices=KERNELS)
    ap.add_argument("--plan", action="append", default=[],
                    metavar="NAME=VALUE")
    args = ap.parse_args(argv)
    srcs = [(src_kernel(src), src) for src in args.src]
    if not torch.cuda.is_available():
        raise SystemExit("sample_phases: no CUDA device; this runs on the "
                         "card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    names = tuple(args.kernel or KERNELS)
    _build.build(names)
    libs = {n: {"checkout": (_build.load(n), {})} for n in names}
    for plan in args.plan:
        const, value = plan.split("=")
        for n in set(names) & set(NN_PHASES):
            libs[n][f"checkout, {plan}"] = (libs[n]["checkout"][0],
                                            {const: int(value)})
    # the copies and the instrumented builds, one nvcc each, all at once
    with ThreadPoolExecutor(len(srcs) + len(names)) as pool:
        copies = [(name, src, pool.submit(_variant, src, name))
                  for name, src in srcs if name in libs]
        inst = {n: pool.submit(_instrumented, n) for n in names
                if n in PHASED}
    for name, src, lib in copies:
        libs[name][src] = (lib.result(), {})
    inst = {n: lib.result() for n, lib in inst.items()}
    ptxas = {}
    for key, log in _build.BUILD_LOGS.items():
        lines = [line.strip() for line in log.splitlines()
                 if "Used" in line or "spill" in line]
        ptxas[key] = lines
        for line in lines:
            print(f"ptxas {os.path.basename(key)}: {line}", flush=True)
    rows = []
    if "fps" in names:
        fps_threads = _build.load("fps").mm3d_fps_threads
        fps_threads.argtypes = [ctypes.c_int]
    for kernel, label, x, n, call in cases(dev):
        if kernel not in names:
            continue
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
    for kernel, label, call, plain in nn_cases(dev):
        if kernel not in names:
            continue
        row = {"kernel": kernel, "case": label,
               "device_ms": _timed(call, libs[kernel], kernel),
               "bit_exact": _same(call, plain, libs[kernel], kernel)}
        buf = _phases(inst[kernel], kernel, call)
        warps = buf[NN_WARPS] or 1
        row["cycles_per_warp"] = {p: buf[i] / warps for i, p in
                                  enumerate(NN_PHASES[kernel])}
        row.update({"scan_steps_per_warp": buf[NN_STEPS] / warps,
                    "insert_step_share": buf[NN_INSERTS]
                    / (buf[NN_STEPS] or 1), "warps": buf[NN_WARPS]})
        rows.append(row)
        print(json.dumps(row), flush=True)
    for kernel, label, call, plain, nbytes in interp_cases(dev):
        if kernel not in names:
            continue
        call_ms, own_ms, per_call = _timed(call, libs[kernel], kernel,
                                           own=True)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        row = {"kernel": kernel, "case": label, "device_ms": call_ms,
               "kernel_ms": own_ms, "kernels_per_call": per_call,
               "bound_ms": bound_ms,
               "bound_share": {t: bound_ms / v if v else None
                               for t, v in own_ms.items()},
               "bit_exact": _same(call, plain, libs[kernel], kernel)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    sass = {}
    for n in set(names) & {"three_interp", "bilinear"}:
        for tag, (lib, _) in libs[n].items():
            sass[f"{n} {tag}"] = counts = sass_counts(lib._name)
            for fn, c in counts.items():
                print(f"sass {n} {tag}: {fn}: {json.dumps(c)}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "sample_phases.json"), "w") as f:
        json.dump({"card": card, "src": args.src, "ptxas": ptxas,
                   "rows": rows, "sass": sass}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
