"""Entry points of the port: serving (``make_predictor``) and training
(``Trainer``, the train/eval steps)."""

from mm3d_tpu_torch.training.inference import agreement, make_predictor
from mm3d_tpu_torch.training.loop import TrainConfig, Trainer

__all__ = ["make_predictor", "agreement", "TrainConfig", "Trainer"]
