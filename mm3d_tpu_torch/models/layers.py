"""Shared building blocks (counterpart of ``mm3d_tpu/models/layers.py``).

Parameter names follow the flax tree of the JAX package (``kernel``/``bias``,
``scale``/``bias`` + ``mean``/``var``), so ``utils.jax_import`` is a
near-identity mapping. As in the JAX package, parameters and BN statistics
stay f32 and a module's ``dtype`` (None or torch.bfloat16) is the compute
dtype they are cast to at use; ``f32=True`` at call time computes in f32
whatever the module's dtype (the bf16 training guards). Train or eval mode is
the module's ``training`` flag; BN momentum is a call-time argument, as in
the JAX package, so a schedule can anneal it per epoch.
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

    def forward(self, x: torch.Tensor, f32: bool = False) -> torch.Tensor:
        k, b = self.kernel, self.bias
        dt = None if f32 else self.dtype
        if dt is not None:
            x, k, b = x.to(dt), k.to(dt), b.to(dt)
        return torch.matmul(x, k) + b


class _BNTrain(torch.autograd.Function):
    """Train-mode BN with the closed-form backward of ``_bn_train_apply``
    (``mm3d_tpu/models/layers.py:27-95``), so gradients round as there:

        d_x = gamma*inv * (d_y - mean(d_y) - xhat*mean(d_y*xhat))

    Forward returns (y, mean, var); the statistics are f32 (f64 for f64
    input), from the shifted single pass: anchor on the first element,
    var = max(E[xs^2]-E[xs]^2, 0).
    ``dims`` are the reduced axes, ``shape`` broadcasts a per-channel vector
    against x. Only (x, gamma, mean, inv) are kept for the backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, dims, shape):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        anchor = tuple(slice(None) if d not in dims else 0
                       for d in range(x.dim()))
        shift = xf[anchor].reshape(shape)
        xs = xf - shift
        mean_s = xs.mean(dims)
        var = torch.clamp(xs.square().mean(dims) - mean_s.square(), min=0.0)
        mean = mean_s + shift.reshape(-1)
        inv = torch.rsqrt(var + eps)
        dt = x.dtype
        y = ((x - mean.to(dt).reshape(shape)) * inv.to(dt).reshape(shape)
             * gamma.reshape(shape) + beta.reshape(shape))
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.dims, ctx.shape = dims, shape
        ctx.count = x.numel() // mean.numel()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dims, shape, T = ctx.dims, ctx.shape, ctx.count
        dt = x.dtype
        inv_s = inv.to(dt).reshape(shape)
        xhat = (x - mean.to(dt).reshape(shape)) * inv_s
        # reductions in f32 (see the forward)
        acc = torch.promote_types(dt, torch.float32)
        m1 = dy.to(acc).mean(dims)
        m2 = (dy * xhat).to(acc).mean(dims)
        d_x = ((gamma.reshape(shape) * inv_s)
               * (dy - m1.to(dt).reshape(shape)
                  - xhat * m2.to(dt).reshape(shape)))
        d_gamma = (m2 * T).to(gamma.dtype)
        d_beta = (m1 * T).to(gamma.dtype)
        return d_x, d_gamma, d_beta, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (or axis 1 with ``channels_first``).

    Torch semantics as in the JAX package: eps 1e-5; in training mode the
    batch statistics normalise and the running statistics move by
    ``momentum`` (the new batch's weight) with the unbiased variance; in eval
    mode (x - mean) * rsqrt(var + eps) * scale + bias. Statistics are f32
    buffers whatever the compute dtype."""

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

    def forward(self, x: torch.Tensor, channels_first: bool = False,
                momentum: float = 0.1, f32: bool = False) -> torch.Tensor:
        dt = None if f32 else self.dtype
        scale, bias = self.scale, self.bias
        if dt is not None:
            x, scale, bias = x.to(dt), scale.to(dt), bias.to(dt)
        if self.training:
            if channels_first:
                dims = (0,) + tuple(range(2, x.dim()))
                shape = (-1,) + (1,) * (x.dim() - 2)
            else:
                dims, shape = tuple(range(x.dim() - 1)), (-1,)
            y, mean, var = _BNTrain.apply(x, scale, bias, self.eps, dims,
                                          shape)
            n = x.numel() // mean.numel()
            with torch.no_grad():  # torch tracks the unbiased variance
                unbiased = var * (n / max(n - 1, 1))
                self.mean.copy_((1 - momentum) * self.mean + momentum * mean)
                self.var.copy_((1 - momentum) * self.var
                               + momentum * unbiased)
            return y
        mean, inv = self.mean, torch.rsqrt(self.var + self.eps)
        if dt is not None:
            mean, inv = mean.to(dt), inv.to(dt)
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
    """Dense + BN + ReLU stack over the last axis.

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

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1,
                f32: bool = False) -> torch.Tensor:
        for i in range(len(self.features)):
            x = getattr(self, f"dense_{i}")(x, f32=f32)
            x = getattr(self, f"bn_{i}")(x, momentum=bn_momentum, f32=f32)
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


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The mask is drawn from the
    ``generator`` the caller passes (on the tensor's device)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def guarded_train_dtype(dtype, train: bool, guard: bool):
    """f32-numerics-island helper: None (f32 compute) while a bf16 TRAIN
    guard is active, else ``dtype`` unchanged."""
    if guard and train and dtype == torch.bfloat16:
        return None
    return dtype


def log_softmax_head(x: torch.Tensor) -> torch.Tensor:
    """The lineage returns log-probabilities from every model head."""
    return torch.log_softmax(x, dim=-1)
