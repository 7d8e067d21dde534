"""Serving entry point (counterpart of ``mm3d_tpu/training/inference.py``).

``make_predictor`` builds the eval-mode forward of a registered model on
the card, optionally in the bf16 serving mode (``dtype=torch.bfloat16``):
network compute runs in bf16 while geometry (FPS, ball query, 3-NN,
projection) stays f32, so neighbour indices are unchanged. It serves any
registered model with the model's own inputs: the classifiers
(``pointnet_cls``, ``pointnet2_cls_*``) take (points) and return
[B, classes]; the part-seg models (``pointnet_part_seg*``,
``pointnet2_part_seg_*``) take (points [B, N, 3(+3)], the category one-hot
[B, 16]) and return per-point part log-probabilities [B, N, 50], over all
50 parts (``utils.metrics.masked_part_argmax`` restricts a point's argmax
to its category's parts); the sem-seg models (``pointnet_sem_seg``,
``pointnet2_sem_seg*``) take (points [B, N, 9]) and return
[B, N, classes]; ``fusion_cls`` and ``fusion_sem_seg`` take (points,
image, K, R, t) and return class log-probabilities, per cloud
[B, classes] or per point [B, N, classes]. ``agreement`` measures
prediction drift between two predictors.

The fp32 mode is strict fp32 only if the caller turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``); PyTorch lets cuDNN convolutions use
TF32 by default.

``export_serving`` / ``save_serving`` / ``load_serving`` freeze the eval
forward into a deployable artifact, the counterpart of the JAX package's
StableHLO export: ``torch.export`` traces the predictor's model (eval mode,
no grad, log-probs only) into an ExportedProgram whose state holds the
weights. On the kernel path each kernel launch of the forward is one node
of the graph, a ``mm3d::*`` operator of ``ops.cuda_kernels``, whose launch
plan is worked out from the real shapes when the artifact runs; under
``use_impl("torch")`` (or for CPU tensors) the graph holds the plain ops.
The artifact is bound to the device type it was exported on: there is no
cross-lowering (the JAX ``platforms``) and no opt-in for kernels (JAX's
``allow_tpu_kernels``). ``mm3d_tpu_torch.serving`` serves it over HTTP
with no model code.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from mm3d_tpu_torch.models import get_model
from mm3d_tpu_torch.serving import load_serving, save_serving

__all__ = ["make_predictor", "agreement", "export_serving", "save_serving",
           "load_serving"]


def make_predictor(model_name: str, state: Dict[str, torch.Tensor],
                   dtype: Optional[torch.dtype] = None,
                   device: str = "cuda", **model_kwargs) -> Callable:
    """Returns fn(*model_inputs) -> log_probs, running on ``device``.

    ``state`` is a state dict of the port's model (``model.state_dict()``,
    or one filled by ``utils.jax_import.load_jax_variables``). The default
    device is the card: without CUDA this raises, it does not fall back to
    the CPU. Pass ``device="cpu"`` to run the plain PyTorch ops on the CPU.
    Inputs are moved to ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"make_predictor: device {device!r} requested but CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be None, float32 or bfloat16: {dtype}")
    if dtype == torch.float32:
        dtype = None
    model = get_model(model_name).builder(dtype=dtype, **model_kwargs)
    model.load_state_dict(state)
    model.to(dev).eval()

    @torch.no_grad()
    def predict(*args):
        args = [torch.as_tensor(a, device=dev) for a in args]
        log_probs, _ = model(*args)
        return log_probs

    predict.model = model
    return predict


class _LogProbs(nn.Module):
    """A model's eval forward, its log-probs only."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return self.model(*args)[0]


def export_serving(predict: Callable, example_args,
                   poly_batch: bool = False) -> torch.export.ExportedProgram:
    """Ahead-of-time export of a ``make_predictor`` predictor.

    ``example_args`` give the shapes and dtypes (moved to the predictor's
    device like a request's inputs). The forward is traced on that device
    under the impl mode in force: on the card the graph calls the
    ``mm3d::*`` kernel operators. ``poly_batch=True`` shares one symbolic
    batch dimension across every input, so one artifact serves any batch of
    1 or more, on the kernel path as on the plain one; an export that
    cannot keep the batch symbolic raises. Save the result with
    ``save_serving``."""
    model = predict.model
    dev = next(model.parameters()).device
    args = tuple(torch.as_tensor(a, device=dev) for a in example_args)
    dynamic = None
    if poly_batch:
        batch = torch.export.Dim("batch", min=1)
        # one entry: forward's *args
        dynamic = (tuple({0: batch} for _ in args),)
    with torch.no_grad():
        return torch.export.export(_LogProbs(model).eval(), args,
                                   dynamic_shapes=dynamic)


def agreement(pred_a: Callable, pred_b: Callable, *args) -> dict:
    """Argmax agreement + max log-prob delta between two predictors."""
    la = pred_a(*args).float()
    lb = pred_b(*args).float()
    agree = (la.argmax(-1) == lb.argmax(-1)).float().mean().item()
    return {"argmax_agreement": agree,
            "max_logp_delta": (la - lb).abs().max().item()}
