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
fused_fp               csrc/fused_fp.cu (+ three_nn)   fused_fp_torch (here)
bilinear_sample        csrc/bilinear.cu                bilinear_sample_torch
three_nn               csrc/three_nn.cu (+ .cuh)       geometry.three_nn_torch
three_interpolate      csrc/three_interp.cu            three_interpolate_torch
=====================  ==============================  ========================

``bilinear_sample`` and its twin are also the public names of
``ops.projection``; with a gradient wanted it runs as ``_BilinearSample``,
whose backward (``bilinear_sample_backward``) scatters through the
gather-backward kernel. ``geometry.three_nn`` and
``geometry.three_interpolate`` are the public names of the last two.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from mm3d_tpu_torch.ops import _build, dispatch
from mm3d_tpu_torch.ops.geometry import (_gather, _start_vector,
                                         ball_query_torch, fps_torch,
                                         index_points,
                                         three_interpolate_torch,
                                         three_nn_torch)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mm3d_fps": ("fps", [_P, _P, _P, _I, _I, _I, _P]),
    "mm3d_fps_max_points": ("fps", []),
    "mm3d_ball_query": ("ball_query", [_P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "mm3d_fused_sa": ("fused_sa", [_I] + [_P] * 9 + [_I] * 10 + [_F, _P]),
    "mm3d_gather_bwd": ("gather_bwd", [_I] + [_P] * 5 + [_I] * 4 + [_P]),
    "mm3d_gather_bwd_max_rows": ("gather_bwd", []),
    "mm3d_fused_fp": ("fused_fp", [_I, _I] + [_P] * 5 + [_I] * 4 + [_P]),
    "mm3d_fused_fp_max_sparse": ("fused_fp", []),
    "mm3d_bilinear": ("bilinear", [_I, _I] + [_P] * 3 + [_I] * 5 + [_P]),
    "mm3d_three_nn": ("three_nn", [_P] * 4 + [_I] * 3 + [_P]),
    "mm3d_three_nn_max_sparse": ("three_nn", []),
    "mm3d_three_interp": ("three_interp", [_I, _I] + [_P] * 4 + [_I] * 4
                          + [_P]),
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

# ------------------------------------------------------ fused FP tail


def fused_fp_torch(xyz1: torch.Tensor, xyz2: torch.Tensor, pre: torch.Tensor,
                   skip: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fused FP kernel -> [B,N,C] in pre's dtype.

    relu(rnd(sum_k w_k pre[idx_k]) + skip) over the three nearest sparse
    points (``three_nn_torch``), with r_k = 1/(d_k + 1e-8) and
    w_k = rnd(r_k * (1 / sum r)): the TPU kernel's multiply by the
    reciprocal, not the composition's divide. rnd() rounds to pre's dtype:
    in bf16 the weights are rounded, the products summed in f32 and the sum
    rounded before the bf16 skip add, as in the TPU kernel."""
    dt = pre.dtype
    acc_dt = torch.promote_types(dt, torch.float32)
    d, idx = three_nn_torch(xyz1, xyz2)
    r = 1.0 / (d + 1e-8)
    inv = 1.0 / ((r[..., 0] + r[..., 1]) + r[..., 2])
    w = (r * inv[..., None]).to(dt).to(acc_dt)
    g = index_points(pre, idx).to(acc_dt)  # [B,N,3,C]
    acc = (w[..., 0:1] * g[:, :, 0] + w[..., 1:2] * g[:, :, 1]
           + w[..., 2:3] * g[:, :, 2])
    return torch.relu(acc.to(dt) + skip.to(dt))


def _vec_ok(C: int, *ts: torch.Tensor) -> int:
    """1 if C channels span whole 16-byte moves and every pointer is
    16-byte aligned (the kernels' vector path), else 0."""
    per = 16 // ts[0].element_size()
    return int(C % per == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def fused_fp(xyz1: torch.Tensor, xyz2: torch.Tensor, pre: torch.Tensor,
             skip: torch.Tensor) -> torch.Tensor:
    """Fused FP tail: relu(three_interpolate(pre) + skip) in one kernel.

    Args:
      xyz1 [B,N,3] f32 dense targets; xyz2 [B,M,3] f32 sparse sources,
        3 <= M.
      pre [B,M,C] bf16 or f32: projected sparse features, BN scale folded.
      skip [B,N,C]: the dense-side term (skip projection + bias, folded);
        cast to pre's dtype.
    Returns [B,N,C] in pre's dtype."""
    if dispatch.resolve(pre) == "torch":
        return fused_fp_torch(xyz1, xyz2, pre, skip)
    dev, dt = pre.device, pre.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_fp takes bf16 or f32 features, got {dt}")
    xyz1 = _f32_points("xyz1", xyz1, dev)
    xyz2 = _f32_points("xyz2", xyz2, dev)
    B, N, _ = xyz1.shape
    M, C = xyz2.shape[1], pre.shape[-1]
    if (xyz2.shape[0] != B or pre.shape != (B, M, C)
            or skip.shape != (B, N, C)):
        raise ValueError(
            f"fused_fp: inconsistent shapes xyz1 {tuple(xyz1.shape)}, xyz2 "
            f"{tuple(xyz2.shape)}, pre {tuple(pre.shape)}, skip "
            f"{tuple(skip.shape)}")
    if skip.device != dev:
        raise ValueError(f"skip is on {skip.device}, expected {dev}")
    if M < 3:
        raise ValueError(f"fused_fp needs at least 3 sparse points, got {M}")
    limit = _fn("mm3d_fused_fp_max_sparse")()
    if M > limit:
        raise ValueError(f"fused_fp takes at most {limit} sparse points, "
                         f"got {M}")
    pre = pre.contiguous()
    skip = skip.to(dt).contiguous()
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    if B * N * C == 0:
        return out
    _launch("mm3d_fused_fp", int(dt == torch.bfloat16),
            _vec_ok(C, pre, skip, out), _ptr(xyz1), _ptr(xyz2), _ptr(pre),
            _ptr(skip), _ptr(out), B, N, M, C, _stream(pre))
    fused_fp.launches += 1
    return out


fused_fp.launches = 0


# ------------------------------------------------ bilinear image sampling


def bilinear_sample_torch(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Plain twin of the bilinear kernel: feat [B,H,W,C], uv [B,N,2] pixel
    coordinates -> [B,N,C] in feat's dtype, zero outside the frame.

    f32 (and f64): ``projection._bilinear_sample_jax``'s lerp, top and
    bottom rows in u first, then v. bf16: the TPU kernel's rounding, each
    corner weight rounded to bf16, the products summed in f32 and the sum
    rounded to bf16. An outside corner reads the clamped in-frame pixel and
    is zeroed by its mask (f32) or weight (bf16), as in the JAX reference."""
    B, H, W, C = feat.shape
    dt = feat.dtype
    u, v = uv[..., 0], uv[..., 1]
    x0, y0 = torch.floor(u), torch.floor(v)
    du, dv = u - x0, v - y0
    flat = feat.reshape(B, H * W, C)
    vals, inside = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        x, y = x0 + dx, y0 + dy
        inside.append((x >= 0) & (x < W) & (y >= 0) & (y < H))
        idx = (y.clamp(0, H - 1).to(torch.int32) * W
               + x.clamp(0, W - 1).to(torch.int32))
        vals.append(index_points(flat, idx))  # [B,N,C]
    if dt == torch.bfloat16:
        omdu, omdv = 1 - du, 1 - dv
        acc = None
        for w, c, m in zip((omdu * omdv, du * omdv, omdu * dv, du * dv), vals,
                           inside):
            w = torch.where(m, w, torch.zeros_like(w)).to(dt).float()
            term = w[..., None] * c.float()
            acc = term if acc is None else acc + term
        return acc.to(dt)
    c00, c10, c01, c11 = (c * m[..., None].to(c.dtype)
                          for c, m in zip(vals, inside))
    du, dv = du[..., None], dv[..., None]
    top = c00 * (1 - du) + c10 * du
    bot = c01 * (1 - du) + c11 * du
    return (top * (1 - dv) + bot * dv).to(dt)


def _bilinear_forward(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The forward: the bilinear kernel for CUDA tensors, else the twin."""
    if dispatch.resolve(feat) == "torch":
        return bilinear_sample_torch(feat, uv)
    dev, dt = feat.device, feat.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bilinear_sample takes bf16 or f32 maps, got {dt}")
    if feat.dim() != 4:
        raise ValueError(f"feat must be [B,H,W,C], got {tuple(feat.shape)}")
    B, H, W, C = feat.shape
    if uv.device != dev:
        raise ValueError(f"uv is on {uv.device}, expected {dev}")
    if uv.dtype != torch.float32:
        raise TypeError(f"uv must be float32, got {uv.dtype}")
    if uv.dim() != 3 or uv.shape[0] != B or uv.shape[-1] != 2:
        raise ValueError(f"uv must be [{B},N,2], got {tuple(uv.shape)}")
    N = uv.shape[1]
    feat = feat.contiguous()
    uv = uv.contiguous()
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    if B * N * C == 0 or H * W == 0:
        return out.zero_()
    _launch("mm3d_bilinear", int(dt == torch.bfloat16),
            _vec_ok(C, feat, out), _ptr(feat), _ptr(uv), _ptr(out), B, H,
            W, N, C, _stream(feat))
    bilinear_sample.launches += 1
    return out


def bilinear_sample_backward(feat: torch.Tensor, uv: torch.Tensor,
                             g: torch.Tensor, want_feat: bool, want_uv: bool):
    """VJP of the sampling -> (d_feat [B,H,W,C] in feat's dtype or None,
    d_uv [B,N,2] in uv's dtype or None).

    The VJP of the f32 lerp of ``projection._bilinear_sample_jax``, as the
    JAX package's ``_bilinear_bwd`` takes it (``pallas_kernels.py:1507-1517``):
    g cast to f32 (f64 stays f64); the four corner cotangents
    (g (1-dv)) (1-du), (g (1-dv)) du, (g dv) (1-du), (g dv) du, each zeroed
    outside the frame; then ONE ``gather_backward`` of the [B,N,4,C] stack by
    the corner rows [B,N,4] into the H*W rows of the map (the hand-written
    deterministic kernel on the card, not ``index_add_``), cast to feat's
    dtype. d_uv (sum over channels of g times the lerp's slopes; floor()
    passes no gradient) only when ``want_uv``."""
    B, H, W, C = feat.shape
    acc_dt = torch.promote_types(g.dtype, torch.float32)
    g = g.to(acc_dt)
    u, v = uv[..., 0].to(acc_dt), uv[..., 1].to(acc_dt)
    x0, y0 = torch.floor(u), torch.floor(v)
    du, dv = (u - x0)[..., None], (v - y0)[..., None]
    rows, masks = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        x, y = x0 + dx, y0 + dy
        masks.append(((x >= 0) & (x < W) & (y >= 0) & (y < H))[..., None]
                     .to(acc_dt))
        rows.append(y.clamp(0, H - 1).to(torch.int32) * W
                    + x.clamp(0, W - 1).to(torch.int32))
    d_feat = d_uv = None
    d_top, d_bot = g * (1 - dv), g * dv
    if want_feat:
        corner_g = torch.stack([d_top * (1 - du) * masks[0],
                                d_top * du * masks[1],
                                d_bot * (1 - du) * masks[2],
                                d_bot * du * masks[3]], dim=2)  # [B,N,4,C]
        d_feat = gather_backward(corner_g, torch.stack(rows, dim=2), H * W)
        d_feat = d_feat.reshape(B, H, W, C).to(feat.dtype)
    if want_uv:
        flat = feat.reshape(B, H * W, C)
        c00, c10, c01, c11 = (_gather(flat, r).to(acc_dt) * m
                              for r, m in zip(rows, masks))
        top = c00 * (1 - du) + c10 * du
        bot = c01 * (1 - du) + c11 * du
        d_u = (d_top * (c10 - c00) + d_bot * (c11 - c01)).sum(-1)
        d_v = (g * (bot - top)).sum(-1)
        d_uv = torch.stack([d_u, d_v], dim=-1).to(uv.dtype)
    return d_feat, d_uv


class _BilinearSample(torch.autograd.Function):
    """The sampling with ``bilinear_sample_backward`` as its backward, run
    under the impl mode in force at the forward (autograd runs a CUDA
    backward on its own thread, as for ``geometry._IndexPoints``)."""

    @staticmethod
    def forward(ctx, feat, uv):
        ctx.save_for_backward(feat, uv)
        ctx.impl = dispatch.get_impl()
        return _bilinear_forward(feat, uv)

    @staticmethod
    def backward(ctx, g):
        feat, uv = ctx.saved_tensors
        with dispatch.use_impl(ctx.impl):
            return bilinear_sample_backward(feat, uv, g,
                                            ctx.needs_input_grad[0],
                                            ctx.needs_input_grad[1])


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of feat [B,H,W,C] (bf16 or f32) at uv [B,N,2] f32
    pixel coordinates -> [B,N,C] in feat's dtype, zero outside the frame.

    With a gradient wanted for feat or uv it runs as ``_BilinearSample``,
    whose backward scatters the corner cotangents through the
    gather-backward kernel."""
    if torch.is_grad_enabled() and (feat.requires_grad or uv.requires_grad):
        return _BilinearSample.apply(feat, uv)
    return _bilinear_forward(feat, uv)


bilinear_sample.launches = 0

# --------------------------------------------------------------- three_nn


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3 nearest sparse points: xyz1 [B,N,3] dense, xyz2 [B,M,3] sparse, f32,
    3 <= M -> (d2 [B,N,3] f32 ascending, idx [B,N,3] int32), ties to the
    lower index, d2 not clamped: ``three_nn_torch``'s contract, bit for
    bit."""
    if dispatch.resolve(xyz1) == "torch":
        return three_nn_torch(xyz1, xyz2)
    xyz1 = _f32_points("xyz1", xyz1, xyz1.device)
    xyz2 = _f32_points("xyz2", xyz2, xyz1.device)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if xyz2.shape[0] != B:
        raise ValueError("xyz1 and xyz2 differ in batch size")
    if M < 3:
        raise ValueError(f"three_nn needs at least 3 sparse points, got {M}")
    limit = _fn("mm3d_three_nn_max_sparse")()
    if M > limit:
        raise ValueError(f"three_nn takes at most {limit} sparse points, "
                         f"got {M}")
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=xyz1.device)
    if B * N == 0:
        return dist, idx
    _launch("mm3d_three_nn", _ptr(xyz1), _ptr(xyz2), _ptr(dist), _ptr(idx),
            B, N, M, _stream(xyz1))
    three_nn.launches += 1
    return dist, idx


three_nn.launches = 0

# ------------------------------------------------------ three_interpolate


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The forward of the interpolation: points [B,M,C] bf16 or f32, idx
    [B,N,3] int32 in [0, M), weight [B,N,3] -> [B,N,C] in points' dtype,
    ``three_interpolate_torch``'s contract bit for bit. The gradient is
    ``geometry.three_interpolate``'s."""
    if dispatch.resolve(points) == "torch":
        return three_interpolate_torch(points, idx, weight)
    dev, dt = points.device, points.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"three_interpolate takes bf16 or f32 points, "
                        f"got {dt}")
    if points.dim() != 3:
        raise ValueError(f"points must be [B,M,C], got {tuple(points.shape)}")
    B, M, C = points.shape
    for name, t in (("idx", idx), ("weight", weight)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dim() != 3 or t.shape[0] != B or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [{B},N,3], got "
                             f"{tuple(t.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if weight.shape != idx.shape:
        raise ValueError(f"weight {tuple(weight.shape)} does not match idx "
                         f"{tuple(idx.shape)}")
    N = idx.shape[1]
    points = points.contiguous()
    idx = idx.contiguous()
    # the twin's weights: rounded to the points' dtype, used in f32
    w = weight.to(dt).to(torch.float32).contiguous()
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    if B * N * C == 0:
        return out
    _launch("mm3d_three_interp", int(dt == torch.bfloat16),
            _vec_ok(C, points, out), _ptr(points), _ptr(idx), _ptr(w),
            _ptr(out), B, N, M, C, _stream(points))
    three_interpolate.launches += 1
    return out


three_interpolate.launches = 0

KERNELS = (farthest_point_sample, query_ball_point, fused_sa, gather_backward,
           fused_fp, bilinear_sample, three_nn, three_interpolate)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
