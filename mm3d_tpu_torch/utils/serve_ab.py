"""Serving forward time of the mm3d_tpu_torch in a given checkout.

For comparing two versions of the port on one card, in turns within one
call: each run imports ``mm3d_tpu_torch`` from the checkout it is given,
builds its kernels, and times ``make_predictor``'s forward of ``fusion_cls``
(B=128 unit-sphere clouds of 1024 points, 64x64 images, 40 classes, seeded
weights) in bf16 and in fp32 with TF32 off: the median of 20 forwards by
CUDA events after 3 warm-ups. It prints one JSON line. A process can hold
only one ``mm3d_tpu_torch``, so each checkout gets its own run; run it as a
file, so that the package comes from the checkout::

    python3 mm3d_tpu_torch/utils/serve_ab.py <checkout>

e.g. with an unpacked parent commit ``A`` and the change ``B``:
``for t in A B B A A B B A; do python3 .../serve_ab.py $t; done``.
"""

import json
import sys


def main(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from mm3d_tpu_torch.models import get_model, init_params
    from mm3d_tpu_torch.ops import _build
    from mm3d_tpu_torch.training import make_predictor

    if not torch.cuda.is_available():
        raise SystemExit("serve_ab: no CUDA device; this runs on the card")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = init_params(get_model("fusion_cls").builder(num_class=40),
                        0).state_dict()
    r = np.random.RandomState(0)
    pts = r.randn(128, 1024, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max(1, keepdims=True)
    args = [torch.from_numpy(a).cuda()
            for a in (pts, r.rand(128, 64, 64, 3).astype(np.float32))]
    out = {"tree": tree}
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", None)):
        pred = make_predictor("fusion_cls", state, dtype=dt, num_class=40)
        for _ in range(3):
            pred(*args)
        times = []
        for _ in range(20):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            pred(*args)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        out[name] = float(np.median(times))
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(main(sys.argv[1])), flush=True)
