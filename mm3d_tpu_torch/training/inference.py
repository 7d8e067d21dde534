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
TF32 by default. The StableHLO export of the JAX package is a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mm3d_tpu_torch.models import get_model


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


def agreement(pred_a: Callable, pred_b: Callable, *args) -> dict:
    """Argmax agreement + max log-prob delta between two predictors."""
    la = pred_a(*args).float()
    lb = pred_b(*args).float()
    agree = (la.argmax(-1) == lb.argmax(-1)).float().mean().item()
    return {"argmax_agreement": agree,
            "max_logp_delta": (la - lb).abs().max().item()}
