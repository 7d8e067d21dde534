"""Serving entry point of the port (training comes in a later slice)."""

from mm3d_tpu_torch.training.inference import agreement, make_predictor

__all__ = ["make_predictor", "agreement"]
