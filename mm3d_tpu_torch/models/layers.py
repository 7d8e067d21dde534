"""Shared building blocks (counterpart of ``mm3d_tpu/models/layers.py``).

Eval-mode only in this slice. Parameter names follow the flax tree of the
JAX package (``kernel``/``bias``, ``scale``/``bias`` + ``mean``/``var``), so
``utils.jax_import.load_jax_variables`` is a near-identity mapping. As in the
JAX package, parameters and BN statistics stay f32 and a module's ``dtype``
(None or torch.bfloat16) is the compute dtype they are cast to at use.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (+-2 std), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init of every port layer in ``model`` (flax's defaults)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "init_"):
            m.init_(g)
    return model


class Dense(nn.Module):
    """x @ kernel + bias with kernel [in, out] (the flax layout)."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.init_(None)

    def init_(self, g):
        lecun_normal_(self.kernel, self.kernel.shape[0], g)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, b = self.kernel, self.bias
        if self.dtype is not None:
            x, k, b = x.to(self.dtype), k.to(self.dtype), b.to(self.dtype)
        return torch.matmul(x, k) + b


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm: (x - mean) * rsqrt(var + eps) * scale + bias.

    Torch semantics as in the JAX package (eps 1e-5); the statistics are
    f32 buffers. ``channels_first`` normalizes axis 1 (NCHW) instead of the
    last axis."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def init_(self, g):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor,
                channels_first: bool = False) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps)
        mean, scale, bias = self.mean, self.scale, self.bias
        if self.dtype is not None:
            x = x.to(self.dtype)
            mean, inv = mean.to(self.dtype), inv.to(self.dtype)
            scale, bias = scale.to(self.dtype), bias.to(self.dtype)
        if channels_first:
            shape = (-1,) + (1,) * (x.dim() - 2)
            mean, inv = mean.reshape(shape), inv.reshape(shape)
            scale, bias = scale.reshape(shape), bias.reshape(shape)
        return (x - mean) * inv * scale + bias

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The affine map (A, C) with BN(x) == x * A + C, computed in f32
        and cast to the compute dtype (``layers.py:122-131`` of the JAX
        package)."""
        A = self.scale * torch.rsqrt(self.var + self.eps)
        C = self.bias - self.mean * A
        if self.dtype is not None:
            A, C = A.to(self.dtype), C.to(self.dtype)
        return A, C


class SharedMLP(nn.Module):
    """Dense + BN + ReLU stack over the last axis (eval mode).

    Layers are ``dense_{i}`` / ``bn_{i}`` as in the flax tree."""

    def __init__(self, in_features: int, features: Sequence[int],
                 last_activation: bool = True, dtype=None):
        super().__init__()
        self.features = tuple(features)
        self.last_activation = last_activation
        self.dtype = dtype
        c = in_features
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(c, f, dtype))
            self.add_module(f"bn_{i}", BatchNorm(f, dtype=dtype))
            c = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.features)):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x))
            if self.last_activation or i + 1 < len(self.features):
                x = torch.relu(x)
        return x

    def fold(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(W_i', b_i')] with relu(x @ W' + b') == relu(BN(Dense(x))),
        in the compute dtype, rounded where the JAX package rounds."""
        folded = []
        for i in range(len(self.features)):
            d = getattr(self, f"dense_{i}")
            A, C = getattr(self, f"bn_{i}").fold()
            k, b = d.kernel, d.bias
            if self.dtype is not None:
                k, b = k.to(self.dtype), b.to(self.dtype)
            folded.append((k * A[None, :], b * A + C))
        return folded


def guarded_train_dtype(dtype, train: bool, guard: bool):
    """f32-numerics-island helper: None (f32 compute) while a bf16 TRAIN
    guard is active, else ``dtype`` unchanged."""
    if guard and train and dtype == torch.bfloat16:
        return None
    return dtype


def log_softmax_head(x: torch.Tensor) -> torch.Tensor:
    """The lineage returns log-probabilities from every model head."""
    return torch.log_softmax(x, dim=-1)
