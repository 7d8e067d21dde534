"""Wrappers of the hand-written Hopper kernels in ``csrc/``.

Each wrapper is the public op. For a CUDA tensor (modes 'auto' and 'cuda')
it checks its inputs, allocates the outputs, launches its kernel on the
current stream, raises if the launch returned an error, and adds one to its
``launches`` count. For a CPU tensor, or under ``use_impl("torch")``, it
returns its plain PyTorch twin instead. There is no other fallback.

=====================  ==============================  ========================
wrapper                kernel                          plain twin
=====================  ==============================  ========================
farthest_point_sample  csrc/fps.cu                     geometry.fps_torch
query_ball_point       csrc/ball_query.cu (+ .cuh)     geometry.ball_query_torch
fused_sa               csrc/fused_sa.cu                fused_sa_torch (here)
gather_backward        csrc/gather_bwd.cu              gather_backward_torch
=====================  ==============================  ========================
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from mm3d_tpu_torch.ops import _build, dispatch
from mm3d_tpu_torch.ops.geometry import (_start_vector, ball_query_torch,
                                         fps_torch, index_points)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mm3d_fps": ("fps", [_P, _P, _P, _I, _I, _I, _P]),
    "mm3d_fps_max_points": ("fps", []),
    "mm3d_ball_query": ("ball_query", [_P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "mm3d_fused_sa": ("fused_sa", [_I] + [_P] * 9 + [_I] * 10 + [_F, _P]),
    "mm3d_gather_bwd": ("gather_bwd", [_I] + [_P] * 5 + [_I] * 4 + [_P]),
    "mm3d_gather_bwd_max_rows": ("gather_bwd", []),
}


def _fn(symbol: str) -> Callable:
    lib_name, argtypes = _SIGNATURES[symbol]
    lib = _build.load(lib_name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, *args) -> None:
    err = _fn(symbol)(*args)
    if err != 0:
        lib = _build.load(_SIGNATURES[symbol][0])
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err} "
                           f"({lib.mm3d_error_string(err).decode()})")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _f32_points(name: str, t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name} must be [B,N,3], got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous()


def _r2(radius: float) -> float:
    """radius**2 rounded to f32, as the plain versions compare it."""
    return float(np.float32(radius * radius))


# ------------------------------------------------------------------- FPS


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start_idx=0) -> torch.Tensor:
    """Farthest point sampling, xyz [B,N,3] f32 -> [B,npoint] int32.

    ``start_idx`` is an int or a [B] tensor of indices in [0, N)."""
    if dispatch.resolve(xyz) == "torch":
        return fps_torch(xyz, npoint, start_idx)
    xyz = _f32_points("xyz", xyz, xyz.device)
    B, N, _ = xyz.shape
    limit = _fn("mm3d_fps_max_points")()
    if N > limit:
        raise ValueError(f"FPS kernel takes at most {limit} points, got {N}")
    start = _start_vector(start_idx, B, N, xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    _launch("mm3d_fps", _ptr(xyz), _ptr(start), _ptr(out), B, N, npoint,
            _stream(xyz))
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0


# ------------------------------------------------------------- ball query


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball query: xyz [B,N,3], new_xyz [B,S,3] f32 -> [B,S,nsample] int32."""
    if dispatch.resolve(xyz) == "torch":
        return ball_query_torch(radius, nsample, xyz, new_xyz)
    xyz = _f32_points("xyz", xyz, xyz.device)
    new_xyz = _f32_points("new_xyz", new_xyz, xyz.device)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if new_xyz.shape[0] != B:
        raise ValueError("xyz and new_xyz differ in batch size")
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    if B * S * nsample == 0:
        return out
    _launch("mm3d_ball_query", _ptr(xyz), _ptr(new_xyz), _ptr(out), B, N, S,
            nsample, _r2(radius), _stream(xyz))
    query_ball_point.launches += 1
    return out


query_ball_point.launches = 0


# ----------------------------------------------------------- fused SA tail


def fused_sa_torch(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor, pre: torch.Tensor,
                   cbias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fused SA kernel -> [B,S,C3] in pre's dtype.

    max_k relu(relu(relu(gather(pre)[.,k] + cbias) @ w1 + b1) @ w2 + b2)
    over the ball query's neighbours. Each product accumulates in f32 and
    is rounded to the dtype before its bias add, as in the TPU kernel."""
    dt = pre.dtype
    idx = ball_query_torch(radius, nsample, xyz, new_xyz)
    h = torch.relu(index_points(pre, idx) + cbias.to(dt)[:, :, None, :])
    h = torch.relu(torch.matmul(h, w1.to(dt)) + b1.to(dt))
    h = torch.relu(torch.matmul(h, w2.to(dt)) + b2.to(dt))
    return h.amax(dim=2)


def _round16(c: int) -> int:
    return (c + 15) // 16 * 16


def _padded(t: torch.Tensor, shape, dt) -> torch.Tensor:
    out = torch.zeros(shape, dtype=dt, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def fused_sa(radius: float, nsample: int, xyz: torch.Tensor,
             new_xyz: torch.Tensor, pre: torch.Tensor, cbias: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> torch.Tensor:
    """Fused SA tail (ball query + gather + folded 2-layer MLP + max over K).

    Args:
      xyz [B,N,3] f32, new_xyz [B,S,3] f32: points and FPS centroids.
      pre [B,N,C1] bf16 or f32: first-layer projection with the BN scale
        folded in. cbias [B,S,C1]: per-centroid additive term.
      w1 [C1,C2], b1 [C2], w2 [C2,C3], b2 [C3]: BN-folded rest layers,
        cast to pre's dtype.
    Returns [B,S,C3] in pre's dtype.
    """
    if dispatch.resolve(pre) == "torch":
        return fused_sa_torch(radius, nsample, xyz, new_xyz, pre, cbias,
                              w1, b1, w2, b2)
    dev = pre.device
    dt = pre.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_sa takes bf16 or f32 features, got {dt}")
    xyz = _f32_points("xyz", xyz, dev)
    new_xyz = _f32_points("new_xyz", new_xyz, dev)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    C1, C2, C3 = pre.shape[-1], w1.shape[-1], w2.shape[-1]
    if (pre.shape != (B, N, C1) or cbias.shape != (B, S, C1)
            or w1.shape != (C1, C2) or b1.shape != (C2,)
            or w2.shape != (C2, C3) or b2.shape != (C3,)):
        raise ValueError("fused_sa: inconsistent shapes")
    for name, t in (("cbias", cbias), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    C1p, C2p, C3p = _round16(C1), _round16(C2), _round16(C3)
    pre = pre.contiguous()
    cbias = cbias.to(dt).contiguous()
    w1p = _padded(w1.to(dt), (C1p, C2p), dt)
    w2p = _padded(w2.to(dt), (C2p, C3p), dt)
    b1p = _padded(b1.to(dt), (C2p,), dt)
    b2p = _padded(b2.to(dt), (C3p,), dt)
    # ~128 gathered rows per block: enough 16-row tiles for 8 warps
    St = max(1, min(S, 128 // nsample)) if nsample <= 128 else 1
    out = torch.empty((B, S, C3), dtype=dt, device=dev)
    if B * S * C3 == 0:
        return out
    _launch("mm3d_fused_sa", int(dt == torch.bfloat16), _ptr(xyz),
            _ptr(new_xyz), _ptr(pre), _ptr(cbias), _ptr(w1p), _ptr(b1p),
            _ptr(w2p), _ptr(b2p), _ptr(out), B, N, S, nsample, C1, C3, C1p,
            C2p, C3p, St, _r2(radius), _stream(pre))
    fused_sa.launches += 1
    return out


fused_sa.launches = 0


# ------------------------------------------- gather backward (scatter-add)


def gather_backward_torch(g: torch.Tensor, idx: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Plain twin of the gather-backward kernel -> [B,n,C] in g's dtype.

    d[b, idx[b,f]] += g[b,f], summed in f32 (f64 for f64 g) by one
    ``index_add_``."""
    B, C = g.shape[0], g.shape[-1]
    acc = torch.promote_types(g.dtype, torch.float32)
    offs = (torch.arange(B, device=idx.device, dtype=torch.int64) * n).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    flat = torch.zeros((B * n, C), dtype=acc, device=g.device)
    flat.index_add_(0, (idx.long() + offs).reshape(-1),
                    g.reshape(-1, C).to(acc))
    return flat.reshape(B, n, C).to(g.dtype)


def gather_backward(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Backward of ``index_points``: g [B,...,C], idx [B,...] -> [B,n,C].

    Duplicate indices accumulate; sums are taken in f32 and cast to g's
    dtype (f32 or bf16). Two launches on the same inputs give identical
    bits: each output row sums its contributors in ascending order."""
    if dispatch.resolve(g) == "torch":
        return gather_backward_torch(g, idx, n)
    dev, dt = g.device, g.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gather_backward takes bf16 or f32 g, got {dt}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, expected {dev}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    B, C = g.shape[0], g.shape[-1]
    if tuple(g.shape[:-1]) != tuple(idx.shape):
        raise ValueError(f"g {tuple(g.shape)} does not match idx "
                         f"{tuple(idx.shape)}")
    limit = _fn("mm3d_gather_bwd_max_rows")()
    if n > limit:
        raise ValueError(f"gather_backward takes at most {limit} rows, got {n}")
    F = idx[0].numel() if B else 0
    out = torch.empty((B, n, C), dtype=dt, device=dev)
    if B * n * C == 0:
        return out
    g = g.contiguous()
    idx = idx.contiguous()
    row_start = torch.empty((B, n + 1), dtype=torch.int32, device=dev)
    perm = torch.empty((B, F), dtype=torch.int32, device=dev)
    _launch("mm3d_gather_bwd", int(dt == torch.bfloat16), _ptr(g), _ptr(idx),
            _ptr(row_start), _ptr(perm), _ptr(out), B, F, n, C, _stream(g))
    gather_backward.launches += 1
    return out


gather_backward.launches = 0

KERNELS = (farthest_point_sample, query_ball_point, fused_sa, gather_backward)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
