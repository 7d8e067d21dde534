"""Model registry: config name -> (module builder, loss, task metadata).

Counterpart of ``mm3d_tpu/models/registry.py``, with the same fifteen
entries: the five BASELINE configs (``pointnet_cls`` 1,
``pointnet2_cls_ssg`` 2, ``pointnet2_part_seg_msg`` 3, ``fusion_cls`` 4,
``fusion_sem_seg`` 5) and the rest of the model family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from mm3d_tpu_torch.models import fusion as fu
from mm3d_tpu_torch.models import pointnet as pn
from mm3d_tpu_torch.models import pointnet2 as pn2


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    task: str  # classification | partseg | semseg | fusion_cls | fusion_semseg
    builder: Callable[..., Any]
    loss: Callable[..., Any]
    default_npoint: int
    config_id: Optional[int] = None  # BASELINE.json configs 1..5


_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str, **overrides) -> ModelSpec:
    """Look up a registered spec; ``overrides`` pre-bind builder kwargs and
    win over call-site kwargs of the same name."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    spec = _REGISTRY[name]
    if overrides:
        builder = spec.builder
        spec = dataclasses.replace(
            spec, builder=lambda **kw: builder(**{**kw, **overrides}))
    return spec


def available() -> Dict[str, ModelSpec]:
    return dict(_REGISTRY)


register(ModelSpec(
    "pointnet_cls", "classification", pn.PointNetCls, pn.pointnet_loss,
    default_npoint=1024, config_id=1))
register(ModelSpec(
    "pointnet2_cls_ssg", "classification", pn2.PointNet2ClsSSG,
    pn.pointnet_loss, default_npoint=1024, config_id=2))
register(ModelSpec(
    "pointnet2_cls_msg", "classification", pn2.PointNet2ClsMSG,
    pn.pointnet_loss, default_npoint=1024))
register(ModelSpec(
    # SSG topology with kNN grouping instead of the ball query; serving
    # selects in PyTorch and runs the given-index fused SA kernel
    "pointnet2_cls_knn", "classification",
    lambda **kw: pn2.PointNet2ClsSSG(knn=True, **kw),
    pn.pointnet_loss, default_npoint=1024))
register(ModelSpec(
    "pointnet_part_seg", "partseg", pn.PointNetPartSeg, pn.pointnet_loss,
    default_npoint=2048))
register(ModelSpec(
    # the lineage's skip set, onto which its part-seg checkpoints map
    "pointnet_part_seg_lineage", "partseg", pn.PointNetPartSegLineage,
    pn.pointnet_loss, default_npoint=2048))
register(ModelSpec(
    "pointnet2_part_seg_ssg", "partseg", pn2.PointNet2PartSegSSG,
    pn.pointnet_loss, default_npoint=2048))
register(ModelSpec(
    "pointnet2_part_seg_msg", "partseg", pn2.PointNet2PartSegMSG,
    pn.pointnet_loss, default_npoint=2048, config_id=3))
register(ModelSpec(
    "pointnet_sem_seg", "semseg", pn.PointNetSemSeg, pn.pointnet_loss,
    default_npoint=4096))
register(ModelSpec(
    "pointnet2_sem_seg", "semseg", pn2.PointNet2SemSeg, pn.pointnet_loss,
    default_npoint=4096))
register(ModelSpec(
    "pointnet2_sem_seg_msg", "semseg", pn2.PointNet2SemSegMSG,
    pn.pointnet_loss, default_npoint=4096))
register(ModelSpec("fusion_cls", "fusion_cls", fu.FusionCls,
                   pn.pointnet_loss, default_npoint=1024, config_id=4))
# the attention entries name their head: it wins over a caller's
# ``fusion`` (the Trainer passes ``TrainConfig.fusion``), as overrides win
# in ``get_model``
register(ModelSpec(
    "fusion_cls_attention", "fusion_cls",
    lambda **kw: fu.FusionCls(**{**kw, "fusion": "attention"}),
    pn.pointnet_loss, default_npoint=1024))
register(ModelSpec("fusion_sem_seg", "fusion_semseg", fu.FusionSemSeg,
                   pn.pointnet_loss, default_npoint=2048, config_id=5))
register(ModelSpec(
    "fusion_sem_seg_attention", "fusion_semseg",
    lambda **kw: fu.FusionSemSeg(**{**kw, "fusion": "attention"}),
    pn.pointnet_loss, default_npoint=2048))
