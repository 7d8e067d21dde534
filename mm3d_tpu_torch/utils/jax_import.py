"""Carry weights between a port model and the JAX package's flax variables.

The port's parameter and buffer names follow the flax tree, so the mapping
is the identity on names (``a/b/kernel`` <-> ``a.b.kernel``) and on layouts,
except that 4-D convolution kernels are OIHW in the port and HWIO in flax.
``flax_names`` spells the mapping out per port tensor; the same map loads
flax variables into a model (``load_jax_variables``) and writes port tensors
(parameters, buffers, or gradients keyed by parameter name) as a flax-shaped
numpy tree (``to_jax_tree``), so the tests can pair them leaf by leaf.

The flax trees hold numpy leaves (convert jax arrays with ``np.asarray``);
this module never imports jax.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# port OIHW -> flax HWIO, and back
_TO_FLAX = (2, 3, 1, 0)
_FROM_FLAX = (3, 2, 0, 1)


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, name)
        else:
            yield name, v


def flax_names(model: nn.Module
               ) -> Dict[str, Tuple[str, Tuple[str, ...], Optional[tuple]]]:
    """port name -> (flax collection, flax path, permutation from the
    port's layout to flax's, or None)."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = ("params", tuple(name.split(".")),
                     _TO_FLAX if p.dim() == 4 else None)
    for name, _ in model.named_buffers():
        out[name] = ("batch_stats", tuple(name.split(".")), None)
    return out


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``model`` from ``{"params": ..., "batch_stats": ...}``.

    Every entry of the tree must land on a tensor of the same shape, and
    every parameter and buffer of the model must be filled, or this raises."""
    names = flax_names(model)
    target: Dict[str, torch.Tensor] = model.state_dict()
    missing = set(target)
    for coll in ("params", "batch_stats"):
        for name, arr in _flatten(variables.get(coll, {})):
            if name not in target or names[name][0] != coll:
                raise KeyError(f"{coll} entry {name!r} has no counterpart in "
                               f"{type(model).__name__}")
            t = torch.from_numpy(np.array(arr))  # copy_ casts to the model's
            if names[name][2] is not None:
                t = t.permute(_FROM_FLAX)  # HWIO -> OIHW
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


def to_jax_tree(model: nn.Module,
                tensors: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """A flax-shaped numpy tree of ``tensors`` (port name -> tensor; default:
    the model's state dict), in flax layouts. Gradients keyed by parameter
    name give a tree shaped like the flax ``params``."""
    names = flax_names(model)
    if tensors is None:
        tensors = model.state_dict()
    tree: dict = {}
    for name, t in tensors.items():
        coll, path, perm = names[name]
        arr = t.detach().cpu()
        if perm is not None:
            arr = arr.permute(perm)
        node = tree.setdefault(coll, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr.numpy()
    return tree
