"""Model layer of the port: layers, SetAbstraction, FeaturePropagation, image
CNN, fusion models, losses."""

from mm3d_tpu_torch.models import (fusion, image, layers, pointnet, pointnet2,
                                   registry)
from mm3d_tpu_torch.models.layers import init_params
from mm3d_tpu_torch.models.registry import available, get_model

__all__ = ["fusion", "image", "layers", "pointnet", "pointnet2", "registry",
           "get_model", "available", "init_params"]
