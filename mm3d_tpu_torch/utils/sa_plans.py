"""The fused SA tail's time under each tile plan it can take, on the card.

    python -m mm3d_tpu_torch.utils.sa_plans [--out chiprun_out] [--src FILE]
                                            [--tag NAME]

``cuda_kernels.sa_plan`` picks one plan a launch: tile rows, producer
warpgroups (an A stage each), resident or streamed weights, the cloud's points
in shared memory or not, or the loop kernel (producers 0). The launcher
takes any plan whose bytes match the kernel's layout, so this tool times
both forms at ``sa_phases``' shapes (SA1 and SA2, bf16, B=128) under every
plan of the list below that fits the card's shared memory, the planner's
own first; each row is the median of three timings of 20 calls (CUDA
events). ``--src`` times a library built from another copy of the source
(a variant of a compile-time choice) in place of the port's own; ``--tag``
names the run in the output. Prints one JSON line a (case, plan) and
writes ``sa_plans[-TAG].json`` to ``--out``. Needs a card.
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

# (rows, producers, resident, points in shared memory); producers 0 is the
# loop kernel
PLANS = ((128, 3, True, True), (128, 3, True, False),
         (128, 2, True, True), (128, 2, True, False),
         (128, 1, True, True), (128, 1, True, False),
         (128, 1, False, True), (128, 1, False, False),
         (64, 2, True, False), (64, 1, True, False), (0, 0, False, False))


class _Skip(Exception):
    """The form or the shared memory cannot take the plan."""


def forced(rows, producers, resident, xyz):
    """An sa_plan stand-in that returns this plan, or raises _Skip."""
    def plan(C1, C2, C3, K, S, dtype, N=0):
        if producers == 0:
            St = max(1, min(S, 128 // K)) if K <= 128 else 1
            p = ck.SaPlan(St * K, St, K, False, False, 0,
                          ck._loop_smem(St, K, C1, C2, 2))
        else:
            KR = ck._up(K, 16)
            if ((xyz or producers == 3) and N == 0) or rows < KR:
                raise _Skip
            p = ck.SaPlan(rows, rows // KR, KR, resident, xyz, producers,
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
    args = ap.parse_args(argv)
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
        for label, call in sa_phases.cases(dev):
            for spec in (None,) + PLANS:
                taken = []

                def plan(*a, spec=spec, taken=taken):
                    taken.append((chosen if spec is None else forced(*spec))(
                        *a))
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
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
