"""Fill a port model from the JAX package's flax variables.

``load_jax_variables(model, variables)`` takes the flax tree
``{"params": ..., "batch_stats": ...}`` with numpy leaves (convert jax
arrays with ``np.asarray`` first; this module never imports jax). The port's
parameter and buffer names follow the flax tree, so the mapping is the
identity on names (``a/b/kernel`` -> ``a.b.kernel``) and on layouts, except
that 4-D convolution kernels go from flax HWIO to torch OIHW. Every entry of
the tree must land on a tensor of the same shape, and every parameter and
buffer of the model must be filled, or this raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, name)
        else:
            yield name, v


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    target: Dict[str, torch.Tensor] = model.state_dict()
    missing = set(target)
    for coll in ("params", "batch_stats"):
        for name, arr in _flatten(variables.get(coll, {})):
            if name not in target:
                raise KeyError(f"{coll} entry {name!r} has no counterpart in "
                               f"{type(model).__name__}")
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
            dst = target[name]
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} from the "
                                 f"variables, {tuple(dst.shape)} in the model")
            with torch.no_grad():
                dst.copy_(t)
            missing.discard(name)
    if missing:
        raise KeyError(f"not filled from the variables: {sorted(missing)}")
    return model
