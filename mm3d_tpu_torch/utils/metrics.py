"""Classification and segmentation metrics on the device (counterpart of
``mm3d_tpu/utils/metrics.py``, the parts the ported tasks use).

Every metric but the last is a tensor reduction, so eval stays on the
device and only scalars, a confusion matrix and, for part segmentation, the
per-shape IoUs cross to the host per epoch; ``partseg_metrics_host``
reduces those on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
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


# ------------------------------------------------------- part segmentation


def part_ranges(ranges: Dict[int, Tuple[int, int]], device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """category -> (first part, one past the last) as the eval's tables:
    each category's first part and part count, [categories] int32."""
    lo_hi = torch.tensor([ranges[c] for c in range(len(ranges))],
                         dtype=torch.int32, device=device)
    return lo_hi[:, 0], lo_hi[:, 1] - lo_hi[:, 0]


def masked_part_argmax(log_probs: torch.Tensor, part_start: torch.Tensor,
                       part_count: torch.Tensor) -> torch.Tensor:
    """Argmax restricted to each shape's category part range
    (``metrics.py:65-77``): log_probs [B,N,P], part_start / part_count [B]
    -> [B,N] int32. The parts outside the range read -inf; ties go to the
    first index, as ``jnp.argmax``'s do."""
    P = log_probs.shape[-1]
    pid = torch.arange(P, device=log_probs.device).reshape(1, 1, P)
    start = part_start.reshape(-1, 1, 1)
    valid = (pid >= start) & (pid < start + part_count.reshape(-1, 1, 1))
    masked = torch.where(valid, log_probs,
                         torch.full_like(log_probs, float("-inf")))
    return masked.argmax(-1).to(torch.int32)


def shape_ious(pred: torch.Tensor, seg: torch.Tensor,
               part_start: torch.Tensor, part_count: torch.Tensor,
               max_parts: int) -> torch.Tensor:
    """Per-shape mean IoU over its category's parts, the ShapeNetPart
    protocol (``metrics.py:80-97``): pred / seg [B,N] global part labels,
    part_start / part_count [B] -> [B] f32. A part with an empty union of
    prediction and target counts 1."""
    B = pred.shape[0]
    j = torch.arange(max_parts, device=pred.device).reshape(1, max_parts)
    part_id = part_start.reshape(B, 1) + j  # [B, max_parts]
    in_range = j < part_count.reshape(B, 1)
    pred_eq = pred[:, None, :] == part_id[:, :, None]  # [B, max_parts, N]
    seg_eq = seg[:, None, :] == part_id[:, :, None]
    inter = (pred_eq & seg_eq).sum(-1).float()
    union = (pred_eq | seg_eq).sum(-1).float()
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                      torch.ones_like(union))
    iou = torch.where(in_range, iou, torch.zeros_like(iou))
    return iou.sum(1) / torch.clamp(part_count.float(), min=1.0)


def partseg_metrics_host(all_ious: np.ndarray, all_cats: np.ndarray,
                         num_categories: int) -> Dict[str, float]:
    """Per-shape IoUs [S] and categories [S] (host numpy) -> the instance
    mIoU (mean over shapes) and the class mIoU (mean over the categories
    present of their shapes' mean) (``metrics.py:100-109``)."""
    inst = float(all_ious.mean()) if len(all_ious) else 0.0
    per_cat = [float(all_ious[all_cats == c].mean())
               for c in range(num_categories) if (all_cats == c).any()]
    return {"instance_miou": inst,
            "class_miou": float(np.mean(per_cat)) if per_cat else 0.0}
