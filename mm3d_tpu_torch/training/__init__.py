"""Entry points of the port: serving (``make_predictor``), training
(``Trainer``, the train/eval steps) and vote evaluation (the
``make_vote_*_step`` factories and their draws)."""

from mm3d_tpu_torch.training.inference import agreement, make_predictor
from mm3d_tpu_torch.training.loop import TrainConfig, Trainer
from mm3d_tpu_torch.training.steps import (draw_vote_angles, draw_vote_perms,
                                           make_vote_eval_step,
                                           make_vote_fusion_cls_step,
                                           make_vote_fusion_semseg_step,
                                           make_vote_partseg_step)

__all__ = ["make_predictor", "agreement", "TrainConfig", "Trainer",
           "make_vote_eval_step", "make_vote_partseg_step",
           "make_vote_fusion_cls_step", "make_vote_fusion_semseg_step",
           "draw_vote_angles", "draw_vote_perms"]
