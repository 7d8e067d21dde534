"""Where the serving forward's time goes on the card.

Counterpart of ``mm3d_tpu/utils/profiling.py``. Two views of the
``fusion_cls`` eval forward served by ``make_predictor``:

* ``stage_times`` -- CUDA events around each stage of the model (SA1, SA2,
  SA3, the image CNN), recorded by forward hooks; the rest of the forward
  (concat, FC head, log-softmax) is the total less the stages;
* ``kernel_table`` -- ``torch.profiler`` over a few forwards: device time by
  kernel name, and the share of the window in which the device ran no
  kernel.

Run on one card from the repository root::

    python -m mm3d_tpu_torch.utils.profiling [--dtype bfloat16|float32]

It serves B=128 clouds of 1024 points with 64x64 images (random seeded
weights and inputs), prints one JSON line and writes it to
``chiprun_out/profile_serve_<dtype>.json``. It fails without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch


def stage_times(model: torch.nn.Module, call: Callable[[], object],
                reps: int = 10) -> Dict[str, float]:
    """Median device ms of each stage of a FusionCls forward, and 'total'."""
    stages = {"sa1": model.point_trunk.sa1, "sa2": model.point_trunk.sa2,
              "sa3": model.point_trunk.sa3, "image": model.image_trunk}
    marks: Dict[str, List[list]] = {n: [] for n in stages}
    handles = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for name, mod in stages.items():
        handles.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: marks[name].append([event(), None])))
        handles.append(mod.register_forward_hook(
            lambda m, a, o, name=name: marks[name][-1].__setitem__(
                1, event())))
    totals = []
    try:
        call()  # warm-up
        for v in marks.values():
            v.clear()
        for _ in range(reps):
            e0 = event()
            call()
            totals.append((e0, event()))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {n: float(np.median([a.elapsed_time(b) for a, b in v]))
           for n, v in marks.items()}
    out["total"] = float(np.median([a.elapsed_time(b) for a, b in totals]))
    out["rest"] = out["total"] - sum(out[n] for n in stages)
    return out


def kernel_table(call: Callable[[], object], reps: int = 3,
                 top: int = 15) -> dict:
    """Device time by kernel over ``reps`` forwards, and the idle share."""
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
    by_name: Dict[str, list] = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
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
        "forwards": reps,
        "wall_ms_per_forward": wall_us / reps / 1e3,
        "device_busy_ms_per_forward": busy / reps / 1e3 if spans else None,
        "device_idle_share": 1.0 - busy / wall_us if spans else None,
        "top_kernels": [{"name": n[:120], "ms_per_forward": us / reps / 1e3,
                         "launches_per_forward": c / reps}
                        for n, (us, c) in kernels[:top]],
    }


def main(argv=None) -> int:
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.training import make_predictor

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--batch", type=int, default=128)
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

    model = init_params(get_model("fusion_cls").builder(num_class=40), 0)
    pred = make_predictor(
        "fusion_cls", model.state_dict(), device="cuda", num_class=40,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else None)
    r = np.random.RandomState(0)
    pts = r.randn(args.batch, 1024, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    img = r.rand(args.batch, 64, 64, 3).astype(np.float32)
    inputs = [torch.from_numpy(a).cuda() for a in (pts, img)]

    def call():
        return pred(*inputs)

    result = {"card": card, "dtype": args.dtype, "batch": args.batch,
              "stage_ms": stage_times(pred.model, call),
              "profile": kernel_table(call)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_serve_{args.dtype}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
