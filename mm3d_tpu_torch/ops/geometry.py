"""Plain PyTorch geometry ops (counterpart of ``mm3d_tpu/ops/geometry.py``).

These are the plain versions of the port's kernels: ``fps_torch`` of the FPS
kernel, ``ball_query_torch`` of the ball-query kernel, ``three_nn_torch`` of
the three_nn kernel (and of the 3-NN selection inside the fused FP kernel)
and ``three_interpolate_torch`` of the three_interpolate kernel. They run on
any device and are the semantic reference the kernels are held to,
bit-exactly for the index outputs. Their rounding is spelled out: dot
products over the three coordinates are summed left to right as separate
multiplies and adds, so no FMA contraction and no TF32 matmul can move a
boundary decision.

``knn_point`` is the kNN selection of the JAX package, which keeps it in
XLA: it is plain PyTorch on every device (its indices feed the given-index
fused SA kernel).

``three_nn`` and ``three_interpolate`` are the dispatching entry points of
the JAX package's names (``mm3d_tpu/ops/geometry.py:222-232,266-278``): the
kernel for CUDA tensors, the twin for CPU tensors (``ops.dispatch``).

Conventions as in the JAX package: points are channels-last ``[B, N, C]``,
indices are int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mm3d_tpu_torch.ops import dispatch


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], accumulated left to right."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distance: src [B,N,C], dst [B,M,C] -> [B,N,M].

    (|s|^2 - 2 s.d) + |d|^2, the formula and order of the JAX package."""
    s2 = _dot_last(src, src)[:, :, None]
    d2 = _dot_last(dst, dst)[:, None, :]
    cross = _dot_last(src[:, :, None, :], dst[:, None, :, :])
    return (s2 - 2.0 * cross) + d2


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, N, C = points.shape
    offs = (torch.arange(B, device=idx.device, dtype=idx.dtype) * N).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    out = points.reshape(B * N, C).index_select(0, (idx + offs).reshape(-1))
    return out.reshape(*idx.shape, C)


class _IndexPoints(torch.autograd.Function):
    """The gather with the scatter-add backward of the JAX custom VJP
    (``mm3d_tpu/ops/geometry.py:64-92``): ``cuda_kernels.gather_backward``,
    the hand-written kernel on the card, its plain twin on the CPU.

    The backward runs under the impl mode that was in force at the forward:
    autograd runs a CUDA backward on its own device thread, which does not
    see the caller's per-thread ``use_impl``."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        ctx.impl = dispatch.get_impl()
        return _gather(points, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        from mm3d_tpu_torch.ops import cuda_kernels  # imports this module
        (idx,) = ctx.saved_tensors
        with dispatch.use_impl(ctx.impl):
            return cuda_kernels.gather_backward(g, idx, ctx.n), None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B,N,C], idx [B,...] -> [B,...,C].

    One flat row gather over [B*N, C]. Its backward scatter-adds the
    cotangent through ``cuda_kernels.gather_backward``. With no gradient
    wanted for ``points`` (serving, the xyz gathers) the gather runs without
    the autograd Function, whose host cost showed in bf16 serving."""
    if not (points.requires_grad and torch.is_grad_enabled()):
        return _gather(points, idx)
    return _IndexPoints.apply(points, idx)


def _start_vector(start_idx, B: int, N: int, device) -> torch.Tensor:
    """int or [B] start indices -> int32 [B] tensor on ``device``."""
    if isinstance(start_idx, (int, np.integer)):
        if not 0 <= int(start_idx) < N:
            raise ValueError(f"FPS start index {start_idx} outside [0, {N})")
        return torch.full((B,), int(start_idx), dtype=torch.int32,
                          device=device)
    start = torch.as_tensor(start_idx, device=device).to(torch.int32)
    start = start.reshape(-1).expand(B).contiguous()
    # the kernel indexes the cloud with these: reject what would read
    # outside it
    if not bool(((start >= 0) & (start < N)).all()):
        raise ValueError(f"FPS start indices outside [0, {N})")
    return start


def fps_torch(xyz: torch.Tensor, npoint: int, start_idx=0) -> torch.Tensor:
    """Farthest point sampling, xyz [B,N,3] f32 -> [B,npoint] int32.

    Twin of ``mm3d_tpu.ops.geometry._fps_jax``: running min-distance from
    1e10, d = (dx*dx + dy*dy) + dz*dz, first index on argmax ties."""
    B, N, _ = xyz.shape
    far = _start_vector(start_idx, B, N, xyz.device).long()
    batch = torch.arange(B, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        idxs[:, i] = far
        c = xyz[batch, far]  # [B,3]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)  # first occurrence of the max
    return idxs


def ball_query_torch(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball query -> [B,S,nsample] int32 (twin of ``_query_ball_jax``).

    The first ``nsample`` point indices with d2 <= radius**2 (radius**2
    rounded to the points' dtype), in ascending order; empty slots repeat
    the first hit; a centroid with no hit gets all zeros; nsample > N pads
    the same way."""
    N = xyz.shape[1]
    r2 = torch.tensor(radius * radius, dtype=xyz.dtype).item()
    sqr = square_distance(new_xyz, xyz)  # [B,S,N]
    arange = torch.arange(N, dtype=torch.int32, device=xyz.device)
    cand = torch.where(sqr > r2, torch.full_like(arange, N), arange)
    k = min(nsample, N)
    idx = torch.topk(cand, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        pad = torch.full(idx.shape[:-1] + (nsample - k,), N,
                         dtype=idx.dtype, device=idx.device)
        idx = torch.cat([idx, pad], dim=-1)
    out = torch.where(idx == N, idx[..., :1], idx)
    return torch.where(out == N, torch.zeros_like(out), out)


def knn_point(nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest points of each centroid: xyz [B,N,3], new_xyz [B,S,3] ->
    [B,S,nsample] int32 in ascending distance, ties to the lower index
    (``mm3d_tpu/ops/geometry.py:208-213``, whose ``lax.top_k`` orders them
    so).

    The distances are ``square_distance``'s (ordered sums, no FMA, no TF32);
    a stable ascending sort then keeps equal distances in index order, which
    ``torch.topk`` does not promise. The JAX package keeps this selection in
    XLA, not in a Pallas kernel, so it stays PyTorch on the card as well: a
    faster selection is kernel work for later."""
    sqr = square_distance(new_xyz, xyz)  # [B,S,N]
    idx = torch.sort(sqr, dim=-1, stable=True).indices[..., :nsample]
    return idx.to(torch.int32)


def three_nn_torch(xyz1: torch.Tensor, xyz2: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest sparse points of each dense point (twin of ``_three_nn_jax``).

    xyz1 [B,N,3] dense, xyz2 [B,M,3] sparse, M >= 3 -> (d2 [B,N,3] ascending,
    idx [B,N,3] int32). d2 is ``square_distance(xyz1, xyz2)``, not clamped
    at 0; ties go to the lower index, as ``lax.top_k`` orders them (a stable
    sort)."""
    sqr = square_distance(xyz1, xyz2)  # [B,N,M]
    d, idx = torch.sort(sqr, dim=-1, stable=True)
    return d[..., :3], idx[..., :3].to(torch.int32)


def interpolation_weights(dists: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights from squared 3-NN distances (eps 1e-8)."""
    recip = 1.0 / (dists + 1e-8)
    return recip / recip.sum(dim=-1, keepdim=True)


def three_interpolate_torch(points: torch.Tensor, idx: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """Plain twin of the three_interpolate kernel: points [B,M,C], idx
    [B,N,3] int32, weight [B,N,3] -> [B,N,C] in points' dtype.

    (w0 p0 + w1 p1) + w2 p2 with p_k = points[idx_k], w_k the weight rounded
    to points' dtype, the products and sums in f32 (f64 for f64 points) and
    one rounding at the end: in bf16 the rounding of the TPU kernel
    (``_three_interp_kernel``, ``pallas_kernels.py:1342-1384``), in f32 and
    f64 exact products summed in this order. No autograd of its own: the
    gradient is ``_ThreeInterpolate``'s."""
    dt = points.dtype
    acc_dt = torch.promote_types(dt, torch.float32)
    w = weight.to(dt).to(acc_dt)
    g = _gather(points, idx).to(acc_dt)  # [B,N,3,C]
    acc = w[..., 0:1] * g[:, :, 0] + w[..., 1:2] * g[:, :, 1]
    return (acc + w[..., 2:3] * g[:, :, 2]).to(dt)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest sparse points of each dense point: xyz1 [B,N,3], xyz2
    [B,M,3] f32 -> (d2 [B,N,3] ascending, idx [B,N,3] int32), the contract
    of ``three_nn_torch``; the three_nn kernel for CUDA tensors."""
    from mm3d_tpu_torch.ops import cuda_kernels  # imports this module
    return cuda_kernels.three_nn(xyz1, xyz2)


class _ThreeInterpolate(torch.autograd.Function):
    """three_interpolate with the VJP of the JAX package's
    ``_three_interp_bwd`` (``pallas_kernels.py:1442-1453``): the cotangent,
    cast to the twin's output dtype, gives

        d_points = gather_backward(g, idx, M, w)   (d[idx_k] += g * w_k)
        d_weight = sum_c g * points[idx]      (only when wanted)

    with w the weight in points' dtype. The weighted ``gather_backward``
    rounds each product g * w_k to that dtype, as g[:, :, None, :] *
    w[..., None] does, without building that [B,N,3,C] stack; it is the
    hand-written kernel on the card. The forward and the backward run under
    the impl mode in force at the forward (autograd runs a CUDA backward on
    its own thread, as for ``_IndexPoints``)."""

    @staticmethod
    def forward(ctx, points, idx, weight):
        from mm3d_tpu_torch.ops import cuda_kernels
        ctx.save_for_backward(points, idx, weight)
        ctx.impl = dispatch.get_impl()
        return cuda_kernels.three_interpolate(points, idx, weight)

    @staticmethod
    def backward(ctx, g):
        from mm3d_tpu_torch.ops import cuda_kernels
        points, idx, weight = ctx.saved_tensors
        dt = points.dtype
        g = g.to(dt)
        d_points = d_weight = None
        with dispatch.use_impl(ctx.impl):
            if ctx.needs_input_grad[0]:
                d_points = cuda_kernels.gather_backward(
                    g, idx, points.shape[1], weight.to(dt))
        if ctx.needs_input_grad[2]:
            acc_dt = torch.promote_types(dt, torch.float32)
            d_weight = (g[:, :, None, :].to(acc_dt)
                        * _gather(points, idx).to(acc_dt)).sum(-1)
            d_weight = d_weight.to(weight.dtype)
        return d_points, None, d_weight


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN interpolation, points [B,M,C] (bf16 or f32 on the
    card), idx [B,N,3] int32, weight [B,N,3] -> [B,N,C] in points' dtype
    (the contract of ``three_interpolate_torch``); the three_interpolate
    kernel for CUDA tensors. With a gradient wanted it runs as
    ``_ThreeInterpolate``, whose d_points is the gather-backward kernel."""
    if torch.is_grad_enabled() and (points.requires_grad
                                    or weight.requires_grad):
        return _ThreeInterpolate.apply(points, idx, weight)
    from mm3d_tpu_torch.ops import cuda_kernels
    return cuda_kernels.three_interpolate(points, idx, weight)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     return_fps: bool = False, fps_start_idx=0):
    """FPS -> ball query -> gather -> recentre -> concat features
    (``mm3d_tpu/ops/geometry.py:281-314``).

    xyz [B,N,3] f32, points [B,N,D] or None -> new_xyz [B,npoint,3] and
    new_points [B,npoint,nsample,3+D] (the recentred xyz, then the
    features, promoted like ``jnp.concatenate``). With ``return_fps`` also
    the un-normalised grouped xyz [B,npoint,nsample,3] and the FPS indices
    [B,npoint], as the lineage returns them. FPS and the ball query are the
    kernels for CUDA tensors."""
    from mm3d_tpu_torch.ops import cuda_kernels  # imports this module
    fps_idx = cuda_kernels.farthest_point_sample(xyz, npoint, fps_start_idx)
    new_xyz = index_points(xyz, fps_idx)  # [B,S,3]
    idx = cuda_kernels.query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)  # [B,S,K,3]
    new_points = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        grouped = index_points(points, idx)
        dt = torch.promote_types(new_points.dtype, grouped.dtype)
        new_points = torch.cat([new_points.to(dt), grouped.to(dt)], dim=-1)
    if return_fps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-all: new_xyz [B,1,3] zeros, new_points [B,1,N,3+D].

    Concatenation promotes like ``jnp.concatenate`` (f32 xyz with bf16
    features gives f32)."""
    B = xyz.shape[0]
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        dt = torch.promote_types(xyz.dtype, points.dtype)
        grouped = torch.cat([grouped.to(dt), points[:, None].to(dt)], dim=-1)
    return new_xyz, grouped
