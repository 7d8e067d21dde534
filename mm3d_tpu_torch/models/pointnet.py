"""Losses of the PointNet family (counterpart of ``mm3d_tpu/models/pointnet.py``).

This slice holds only the losses the ``fusion_cls`` trainer needs
(``pointnet.py:308-337``); the PointNet models, their STN and its
orthogonality regulariser come with the plain-PointNet slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL on log-probabilities; log_probs [..., K], target [...] int.

    ``row_mask`` [B] (target's leading axis) excludes padded rows from the
    mean; class ``weight`` and the mask compose (both weight the sum)."""
    picked = torch.gather(log_probs, -1, target.long()[..., None])[..., 0]
    w = weight[target.long()] if weight is not None else None
    if row_mask is not None:
        rm = row_mask.reshape(
            row_mask.shape + (1,) * (picked.dim() - 1)).to(picked.dtype)
        rm = rm.expand(picked.shape)
        w = rm if w is None else w * rm
    if w is not None:
        return -torch.sum(picked * w) / torch.clamp(torch.sum(w), min=1e-9)
    return -torch.mean(picked)


def pointnet_loss(log_probs, target, aux,
                  weight: Optional[torch.Tensor] = None,
                  row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL + orthogonality regulariser on the feature transform.

    No model of this slice has a feature transform (``aux["trans_feat"]`` is
    None); one that does raises until the PointNet slice ports the
    regulariser."""
    loss = nll_loss(log_probs, target, weight, row_mask=row_mask)
    if aux and aux.get("trans_feat") is not None:
        raise NotImplementedError(
            "feature_transform_regularizer comes with the PointNet slice")
    return loss
