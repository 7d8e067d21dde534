"""Model registry: config name -> (module builder, loss, task metadata).

Counterpart of ``mm3d_tpu/models/registry.py``. The fusion configs are
registered (``fusion_cls``, config 4, and ``fusion_sem_seg``, config 5, each
with its attention-head variant); the other configs of the JAX registry
join as their modules are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from mm3d_tpu_torch.models import fusion as fu
from mm3d_tpu_torch.models import pointnet as pn


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


register(ModelSpec("fusion_cls", "fusion_cls", fu.FusionCls,
                   pn.pointnet_loss, default_npoint=1024, config_id=4))
register(ModelSpec(
    "fusion_cls_attention", "fusion_cls",
    lambda **kw: fu.FusionCls(fusion="attention", **kw), pn.pointnet_loss,
    default_npoint=1024))
register(ModelSpec("fusion_sem_seg", "fusion_semseg", fu.FusionSemSeg,
                   pn.pointnet_loss, default_npoint=2048, config_id=5))
register(ModelSpec(
    "fusion_sem_seg_attention", "fusion_semseg",
    lambda **kw: fu.FusionSemSeg(fusion="attention", **kw), pn.pointnet_loss,
    default_npoint=2048))
