"""The fused SA tail's time under each tile plan it can take, on the card.

    python -m mm3d_tpu_torch.utils.sa_plans [--out chiprun_out] [--src FILE]
                                            [--tag NAME] [--dtype bf16|f32]
                                            [--plan NAME=VALUE ...]

``cuda_kernels.sa_plan`` picks one plan a launch. bf16: tile rows, producer
warpgroups (an A stage each), resident or streamed weights, the cloud's
points in shared memory or not, or the loop kernel (producers 0). f32 (the
CUDA-core kernel ``sa_f32_kernel``, two producer warpgroups): block rows,
resident or streamed weights, one or two A stages, the points in shared
memory or not. The
launcher takes any plan whose bytes match the kernel's layout, so this tool
times both forms at ``sa_phases``' shapes (SA1 and SA2, B=128) in each
dtype asked for (both by default) under every plan of the lists below that
fits the card's shared memory, the planner's own first; each row is the
median of three timings of 20 calls (CUDA events). ``--src`` times a
library built from another copy of the source (a variant of a compile-time
choice, with the launch signature of this checkout) in place of the port's
own; ``--plan NAME=VALUE`` (repeatable) sets an integer constant of
``ops.cuda_kernels`` for the run, so that the plans' bytes follow such a
copy's layout (``SA_F32_PANEL=16`` for a copy whose f32 weight panels are
16 rows); ``--tag`` names the run in the output. Prints one JSON line a
(case, plan) and writes ``sa_plans[-TAG].json`` to ``--out``. Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from mm3d_tpu_torch.ops import _build
from mm3d_tpu_torch.ops import cuda_kernels as ck
from mm3d_tpu_torch.utils import sa_phases

# bf16: (rows, producers, resident, points in shared memory); producers 0
# is the loop kernel
PLANS = ((128, 3, True, True), (128, 3, True, False),
         (128, 2, True, True), (128, 2, True, False),
         (128, 1, True, True), (128, 1, True, False),
         (128, 1, False, True), (128, 1, False, False),
         (64, 2, True, False), (64, 1, True, False), (0, 0, False, False))
# f32: (block rows, resident, A stages, points in shared memory)
PLANS_F32 = tuple((rows, resident, stages, xyz)
                  for rows in (128, 64) for resident in (True, False)
                  for stages in (2, 1) for xyz in (True, False))


class _Skip(Exception):
    """The form or the shared memory cannot take the plan."""


def forced(spec, dtype):
    """An sa_plan stand-in that returns this plan, or raises _Skip."""
    def plan(C1, C2, C3, K, S, dt, N=0):
        KR = ck._up(K, 16)
        if dtype == torch.float32:
            rows, resident, stages, xyz = spec
            if xyz and N == 0:
                raise _Skip
            p = ck.SaPlan(rows, max(1, rows // KR), KR, resident, xyz, 2,
                          stages, ck._f32_smem(C1, C2, C3, K, rows, resident,
                                               N if xyz else 0, stages))
        else:
            rows, producers, resident, xyz = spec
            if producers == 0:
                St = max(1, min(S, 128 // K)) if K <= 128 else 1
                p = ck.SaPlan(St * K, St, K, False, False, 0, 0,
                              ck._loop_smem(St, K, C1, C2))
            else:
                if ((xyz or producers == 3) and N == 0) or rows < KR:
                    raise _Skip
                p = ck.SaPlan(rows, rows // KR, KR, resident, xyz, producers,
                              producers,
                              ck._ws_smem(C1, C2, C3, rows, resident,
                                          N if xyz else 0, producers))
        if p.smem > ck.SMEM_LIMIT:
            raise _Skip
        return p
    return plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--src", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--dtype", choices=("bf16", "f32"), action="append")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="NAME=VALUE")
    args = ap.parse_args(argv)
    for item in args.plan:
        name, value = item.split("=")
        if not isinstance(getattr(ck, name, None), int):
            raise SystemExit(f"sa_plans: {name} is no integer constant of "
                             "ops.cuda_kernels")
        setattr(ck, name, int(value))
    if not torch.cuda.is_available():
        raise SystemExit("sa_plans: no CUDA device; this runs on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    _build.build(["fused_sa"])
    if args.src:
        _build._LIBS["fused_sa"] = _build.build_variant(args.src,
                                                         "fused_sa")
    chosen = ck.sa_plan
    rows = []
    try:
        dtypes = [torch.bfloat16 if d == "bf16" else torch.float32
                  for d in args.dtype or ("bf16", "f32")]
        for dtype, (label, call) in ((d, c) for d in dtypes
                                     for c in sa_phases.cases(dev, d)):
            plans = PLANS_F32 if dtype == torch.float32 else PLANS
            for spec in (None,) + plans:
                taken = []

                def plan(*a, spec=spec, taken=taken, dtype=dtype):
                    taken.append((chosen if spec is None
                                  else forced(spec, dtype))(*a))
                    return taken[-1]
                ck.sa_plan = plan
                try:
                    ms = sorted(sa_phases.event_ms(call) for _ in range(3))
                except _Skip:
                    continue
                finally:
                    ck.sa_plan = chosen
                row = {"case": label, "chosen": spec is None,
                       "plan": taken[0]._asdict(), "ms": ms[1]}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        ck.sa_plan = chosen
    os.makedirs(args.out, exist_ok=True)
    name = f"sa_plans-{args.tag}.json" if args.tag else "sa_plans.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump({"card": card, "src": args.src or "checkout",
                   "plan": args.plan, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
