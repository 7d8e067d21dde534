"""Classification and segmentation metrics on the device (counterpart of
``mm3d_tpu/utils/metrics.py``, the parts ``fusion_cls`` and
``fusion_semseg`` use).

Every metric is a tensor reduction, so eval stays on the device and only
scalars and a confusion matrix cross to the host per epoch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def accuracy(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean top-1 accuracy. log_probs [..., K], target [...]."""
    pred = torch.argmax(log_probs, dim=-1)
    return (pred == target).float().mean()


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C, C] int32 counts, rows = true class, cols = predicted.

    ``weights`` (int, broadcastable to pred) masks or weights each element:
    padded rows of a full-test-set eval batch carry 0."""
    idx = (target.reshape(-1).long() * num_classes
           + pred.reshape(-1).long())
    w = (None if weights is None
         else weights.expand(pred.shape).reshape(-1).double())
    cm = torch.bincount(idx, weights=w, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes).to(torch.int32)


def per_class_accuracy(cm: torch.Tensor) -> torch.Tensor:
    """Mean recall over classes present in ``cm`` (the lineage's 'class acc')."""
    support = cm.sum(dim=1)
    correct = torch.diagonal(cm)
    acc = torch.where(support > 0, correct / torch.clamp(support, min=1),
                      torch.zeros((), dtype=torch.float32,
                                  device=cm.device))
    present = (support > 0).float()
    return torch.sum(acc * present) / torch.clamp(present.sum(), min=1.0)


def iou_from_confusion(cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class IoU [C] and the mean IoU over classes with a nonzero union
    (``metrics.py:53-62``): tp / (tp + fp + fn), 0 where the union is 0."""
    tp = torch.diagonal(cm).float()
    fp = cm.sum(dim=0).float() - tp
    fn = cm.sum(dim=1).float() - tp
    union = tp + fp + fn
    iou = torch.where(union > 0, tp / torch.clamp(union, min=1.0),
                      torch.zeros_like(union))
    present = (union > 0).float()
    miou = torch.sum(iou * present) / torch.clamp(present.sum(), min=1.0)
    return iou, miou
