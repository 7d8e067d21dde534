"""Wrappers of the hand-written Hopper kernels in ``csrc/``.

Each wrapper is the public op. For a CUDA tensor (modes 'auto' and 'cuda')
it checks its inputs, allocates the outputs, launches its kernel on the
current stream, raises if the launch returned an error, and adds one to its
``launches`` count. For a CPU tensor, or under ``use_impl("torch")``, it
returns its plain PyTorch twin instead. There is no other fallback.

The six kernels of the serving paths run as PyTorch operators in the
namespace ``mm3d`` (``torch.library.custom_op``), so that ``torch.export``
records a launch as one graph node (``mm3d::fused_sa``, ...) and a served
artifact launches the same kernels (``training.inference.export_serving``):

=====================  =========================================
operator               wrapper
=====================  =========================================
farthest_point_sample  farthest_point_sample
query_ball_point       query_ball_point
fused_sa               fused_sa
fused_sa_idx           fused_sa_idx
fused_fp               fused_fp
bilinear_sample        the sampling's forward (``_bilinear_forward``)
=====================  =========================================

The wrapper keeps ``dispatch.resolve`` in front and calls
``torch.ops.mm3d.<name>`` on the kernel path. The operator's implementation
is the kernel branch: the checks, the allocation, the launch plan (worked
out from the real shapes at each call, so a traced graph holds no plan),
the launch and the count. It is registered for every device type: a CPU
tensor reaches it only where ``dispatch.resolve`` answers 'cuda' for it,
and then raises at the launch (the CPU tests fake the launch, see
``tests/test_torch_fused_sa.py::fake_kernels``). Its fake implementation
gives the output's shape, dtype and device, and nothing else. Registration
happens at import and builds nothing. The backward kernels (gather
backward, three_nn, three_interpolate) stay plain ``ctypes`` calls: export
is of the eval forward only.

=====================  ==============================  ========================
wrapper                kernel                          plain twin
=====================  ==============================  ========================
farthest_point_sample  csrc/fps.cu                     geometry.fps_torch
query_ball_point       csrc/ball_query.cu (+ .cuh)     geometry.ball_query_torch
fused_sa               csrc/fused_sa.cu                fused_sa_torch (here)
fused_sa_idx           csrc/fused_sa.cu (given idx)    fused_sa_idx_torch (here)
gather_backward        csrc/gather_bwd.cu              gather_backward_torch
fused_fp               csrc/fused_fp.cu (+ three_nn)   fused_fp_torch (here)
bilinear_sample        csrc/bilinear.cu                bilinear_sample_torch
three_nn               csrc/three_nn.cu (+ .cuh)       geometry.three_nn_torch
three_interpolate      csrc/three_interp.cu            three_interpolate_torch
=====================  ==============================  ========================

``bilinear_sample`` and its twin are also the public names of
``ops.projection``; with a gradient wanted it runs as ``_BilinearSample``,
whose backward (``bilinear_sample_backward``) scatters through the weighted
form of the gather-backward kernel. ``geometry.three_nn`` and
``geometry.three_interpolate`` are the public names of the last two.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

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
    "mm3d_fused_sa": ("fused_sa", [_I] + [_P] * 9 + [_I] * 14 + [_F, _P]),
    "mm3d_fused_sa_idx": ("fused_sa", [_I] + [_P] * 8 + [_I] * 13 + [_P]),
    "mm3d_gather_bwd": ("gather_bwd", [_I, _I] + [_P] * 7 + [_I] * 6
                        + [_P]),
    "mm3d_gather_bwd_max_rows": ("gather_bwd", []),
    "mm3d_gather_bwd_max_rows_per_block": ("gather_bwd", []),
    "mm3d_gather_bwd_max_contributions": ("gather_bwd", []),
    "mm3d_gather_bwd_max_buckets": ("gather_bwd", []),
    "mm3d_gather_bwd_tile": ("gather_bwd", []),
    "mm3d_fused_fp": ("fused_fp", [_I, _I] + [_P] * 5 + [_I] * 6 + [_P]),
    "mm3d_fused_fp_max_sparse": ("fused_fp", []),
    "mm3d_fused_fp_threads": ("fused_fp", []),
    "mm3d_bilinear": ("bilinear", [_I, _I] + [_P] * 3 + [_I] * 5 + [_P]),
    "mm3d_bilinear_max_batch": ("bilinear", []),
    "mm3d_three_nn": ("three_nn", [_P] * 4 + [_I] * 4 + [_P]),
    "mm3d_three_nn_max_sparse": ("three_nn", []),
    "mm3d_three_nn_threads": ("three_nn", []),
    "mm3d_three_interp": ("three_interp", [_I] * 3 + [_P] * 4 + [_I] * 4
                          + [_P]),
    "mm3d_three_interp_max_batch": ("three_interp", []),
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


def _sm_count(dev: torch.device) -> int:
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 132)


def _f32_points(name: str, t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name} must be [B,N,3], got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous()


def _indexable(name: str, B: int, symbol: str, **products: int) -> None:
    """Refuse a shape the kernel's grid cannot index: more clouds than the
    grid's y axis takes (``symbol``), or a product of extents (name ->
    value) that reaches 2^31, the 32-bit offsets inside a cloud."""
    limit = _fn(symbol)()
    if B > limit:
        raise ValueError(f"{name}: batch {B} is more than the kernel's grid "
                         f"takes ({limit})")
    for what, n in products.items():
        if n >= 2 ** 31:
            raise ValueError(f"{name}: {what} = {n} reaches 2^31, past the "
                             "kernel's 32-bit offsets")


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
    return torch.ops.mm3d.farthest_point_sample(
        xyz, npoint, _start_vector(start_idx, xyz.shape[0], xyz.shape[1],
                                   xyz.device))


@torch.library.custom_op("mm3d::farthest_point_sample", mutates_args=())
def _fps_op(xyz: torch.Tensor, npoint: int,
            start: torch.Tensor) -> torch.Tensor:
    """The FPS kernel: xyz [B,N,3] f32, start [B] int32 indices in [0, N)
    (``_start_vector`` checks them) -> [B,npoint] int32."""
    xyz = _f32_points("xyz", xyz, xyz.device)
    B, N, _ = xyz.shape
    limit = _fn("mm3d_fps_max_points")()
    if N > limit:
        raise ValueError(f"FPS kernel takes at most {limit} points, got {N}")
    if (start.shape != (B,) or start.dtype != torch.int32
            or start.device != xyz.device):
        raise ValueError(f"start must be [{B}] int32 on {xyz.device}, got "
                         f"{tuple(start.shape)} {start.dtype} on "
                         f"{start.device}")
    start = start.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    _launch("mm3d_fps", _ptr(xyz), _ptr(start), _ptr(out), B, N, npoint,
            _stream(xyz))
    farthest_point_sample.launches += 1
    return out


@_fps_op.register_fake
def _(xyz, npoint, start):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


farthest_point_sample.launches = 0


# ------------------------------------------------------------- ball query


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball query: xyz [B,N,3], new_xyz [B,S,3] f32 -> [B,S,nsample] int32."""
    if dispatch.resolve(xyz) == "torch":
        return ball_query_torch(radius, nsample, xyz, new_xyz)
    return torch.ops.mm3d.query_ball_point(radius, nsample, xyz, new_xyz)


@torch.library.custom_op("mm3d::query_ball_point", mutates_args=())
def _ball_query_op(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor) -> torch.Tensor:
    """The ball-query kernel -> [B,S,nsample] int32."""
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


@_ball_query_op.register_fake
def _(radius, nsample, xyz, new_xyz):
    return xyz.new_empty((xyz.shape[0], new_xyz.shape[1], nsample),
                         dtype=torch.int32)


query_ball_point.launches = 0


# ----------------------------------------------------------- fused SA tail


def fused_sa_idx_torch(nsample: int, idx: torch.Tensor, pre: torch.Tensor,
                       cbias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fused SA tail over given indices -> [B,S,C3] in
    pre's dtype.

    max_k relu(relu(relu(gather(pre)[.,k] + cbias) @ w1 + b1) @ w2 + b2)
    over the neighbours idx [B,S,nsample]. Each product accumulates in f32
    and is rounded to the dtype before its bias add, as in the TPU
    kernels."""
    if idx.shape[-1] != nsample:
        raise ValueError(f"idx has {idx.shape[-1]} neighbours, nsample is "
                         f"{nsample}")
    dt = pre.dtype
    h = torch.relu(index_points(pre, idx) + cbias.to(dt)[:, :, None, :])
    h = torch.relu(torch.matmul(h, w1.to(dt)) + b1.to(dt))
    h = torch.relu(torch.matmul(h, w2.to(dt)) + b2.to(dt))
    return h.amax(dim=2)


def fused_sa_torch(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor, pre: torch.Tensor,
                   cbias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fused SA kernel -> [B,S,C3] in pre's dtype: the
    ball query's neighbours (``ball_query_torch``), then the tail of
    ``fused_sa_idx_torch``."""
    idx = ball_query_torch(radius, nsample, xyz, new_xyz)
    return fused_sa_idx_torch(nsample, idx, pre, cbias, w1, b1, w2, b2)


# Shared memory a block can use on the H100 (sm_90): 227 KB.
SMEM_LIMIT = 232448


class SaPlan(NamedTuple):
    """How a fused SA launch cuts its work (``sa_plan``)."""
    rows: int       # gathered rows a tile, a multiple of 64 (bf16 loop:
                    # St*K); f32: rows a block, 128 or 64
    St: int         # centroids a tile
    KR: int         # rows a centroid: K rounded up to 16 (loop: K)
    resident: bool  # weights copied once a block (else streamed)
    xyz_smem: bool  # the cloud's points in shared memory (ball query)
    producers: int  # producer warpgroups (bf16: each with its own A stage;
                    # f32: two, a selecting and a gathering one); 0: the
                    # bf16 loop kernel
    stages: int     # A stages between gather and products (bf16: the
                    # producers; loop kernel 0)
    smem: int       # shared-memory bytes a block


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


# output columns a product chunk of the bf16 kernel (its wgmma N): layer 1
# and streamed panels; layer 2 takes SA_CHUNK2 with two producers
SA_CHUNK, SA_CHUNK2 = 64, 128


def _ws_smem(C1: int, C2: int, C3: int, rows: int, resident: bool,
             xyz_points: int = 0, producers: int = 1) -> int:
    """Shared-memory bytes of the bf16 kernel (``WsLayout`` in
    ``csrc/fused_sa.cu``): weights (resident w1 and w2, or two streamed
    panels of SA_CHUNK columns), an A stage a producer and H, all in
    128-byte swizzle atoms
    (K padded to 64, 1024-byte aligned), f32 biases, two tiles' indices and
    the cloud's ``xyz_points`` points for each producer, two chunks' f32
    slab maxima, mbarriers, and 1024 bytes of slack to align the base."""
    NC, NC2 = SA_CHUNK, SA_CHUNK2 if producers == 2 else SA_CHUNK
    C1q, K2q, N1p, N2p = _up(C1, 64), _up(C2, 64), _up(C2, NC), _up(C3, NC2)
    # H holds at most 128 rows (a larger tile is walked in blocks of 128),
    # and such a tile keeps every layer-2 chunk's slab maxima
    hrows = min(rows, 128)
    pbufs = max(2, N2p // NC2) if rows > 128 else 2

    def a(n, m=128):
        return _up(n, m)

    w = (a(C1q * N1p * 2, 1024) + a(K2q * N2p * 2, 1024) if resident
         else 2 * a(max(C1q, K2q) * NC * 2, 1024))
    return (w + producers * a(rows * C1q * 2, 1024) + a(hrows * N1p * 2, 1024)
            + a(N1p * 4) + a(N2p * 4) + a(2 * producers * rows * 4)
            + a(pbufs * (rows // 16) * NC2 * 4)
            + producers * a(xyz_points * 12) + 128 + 1024)


def _loop_smem(St: int, K: int, C1: int, C2: int) -> int:
    """Shared-memory bytes of the bf16 loop kernel (``Layout``): idx | A |
    H | an f32 staging tile of 64 columns."""
    R = St * K
    Rp = _up(R, 16)
    return (_up(R * 4, 128) + Rp * (_up(C1, 16) + 8) * 2
            + Rp * (_up(C2, 16) + 8) * 2 + Rp * 68 * 4)


# the f32 kernel: the k step its C1 and C2 are padded to; k rows a streamed
# weight panel
SA_F32_STEP, SA_F32_PANEL = 16, 32


def _f32_chunk(C: int) -> int:
    """Output columns a chunk of the f32 kernel: the least of 32, 64 and
    128 that holds C (``f32_nc``)."""
    return 32 if C <= 32 else 64 if C <= 64 else 128


def _f32_smem(C1: int, C2: int, C3: int, K: int, rows: int, resident: bool,
              xyz_points: int = 0, stages: int = 2) -> int:
    """Shared-memory bytes of the f32 kernel (``F32Layout`` in
    ``csrc/fused_sa.cu``), every part 128-byte aligned: weights (resident
    w1 and w2 chunk by chunk, [C1p][NC1] and [K2p][NC2] a chunk, or two
    panels of SA_F32_PANEL rows of the wider chunk), ``stages`` A stages
    and H, channel-major with ``rows`` + 4 floats a channel, f32 biases,
    two tiles' indices and cbias rows, two chunks' slab maxima, a running
    row where a centroid is walked in blocks, the cloud's ``xyz_points``
    points (16 bytes each, padded to the selection's rounds of 128),
    mbarriers. C1p and K2p: C1 and C2 rounded up to SA_F32_STEP; N1p and
    N2p: C2 and C3 rounded up to their chunk."""
    def a(n):
        return _up(n, 128)

    NC1, NC2 = _f32_chunk(C2), _f32_chunk(C3)
    C1p, K2p = _up(C1, SA_F32_STEP), _up(C2, SA_F32_STEP)
    N1p, N2p = _up(C2, NC1), _up(C3, NC2)
    KR = _up(K, 16)
    blocks, St = (1, rows // KR) if KR <= rows else (-(-KR // rows), 1)
    ld = rows + 4
    w = (a(C1p * N1p * 4) + a(K2p * N2p * 4) if resident
         else 2 * a(SA_F32_PANEL * max(NC1, NC2) * 4))
    return (w + stages * a(C1p * ld * 4) + a(K2p * ld * 4) + a(N1p * 4)
            + a(N2p * 4) + a(2 * blocks * rows * 4) + a(2 * St * C1p * 4)
            + a(2 * (rows // 16) * NC2 * 4)
            + (a(N2p * 4) if blocks > 1 else 0)
            + a(_up(xyz_points, 128) * 16) + 128)


def sa_plan(C1: int, C2: int, C3: int, K: int, S: int, dtype: torch.dtype,
            N: int = 0) -> SaPlan:
    """The tile plan of a fused SA launch, or a ValueError naming the
    shared-memory limit where none fits.

    bf16, the warp-specialised wgmma kernel: the first that fits of: weights
    resident, then streamed; 128 rows a tile (two consumer warpgroups), then
    64 (K > 128: K rounded up to 128 rows, one centroid, walked in blocks of
    128); with resident weights, producer warpgroups that take turns with an
    A stage each (three for the ball-query form, whose selection sets its
    pace; two, not past 128 rows), then one; the ball-query form's points (N > 0 a cloud) in shared memory, then
    not. A tile holds St = rows // KR centroids of KR = K rounded up to 16
    rows. Where none fits (a C2 of 512 and more; K past 128 at wide
    layers): the loop kernel (producers 0), the first design's layout, St =
    128 // K centroids a block (at least 1, at most S).

    f32, the CUDA-core kernel (two producer warpgroups): the first that fits
    of: weights resident, then streamed; blocks of 128 rows, then 64; two A
    stages, then one; the points in shared memory, then not. A block holds
    St = rows // KR centroids, or one centroid past ``rows`` rows, walked
    in blocks."""
    KR = _up(K, 16)
    if dtype == torch.float32:
        for resident in (True, False):
            for rows in (128, 64):
                for stages in (2, 1):
                    for xyz in (True, False):
                        if xyz and N == 0:
                            continue
                        smem = _f32_smem(C1, C2, C3, K, rows, resident,
                                         N if xyz else 0, stages)
                        if smem <= SMEM_LIMIT:
                            return SaPlan(rows, max(1, rows // KR), KR,
                                          resident, xyz, 2, stages, smem)
        raise ValueError(
            f"fused SA: no {dtype} tile plan for widths ({C1},{C2},{C3}) and "
            f"K={K} fits the {SMEM_LIMIT} bytes of shared memory a block can "
            f"use (blocks of 64 rows, one A stage, streamed weights need "
            f"{_f32_smem(C1, C2, C3, K, 64, False, 0, 1)})")
    if dtype == torch.bfloat16:
        row_options = (128, 64) if KR <= 128 else (_up(KR, 128),)
        for resident in (True, False):
            for rows in row_options:
                for pw in (3, 2, 1):
                    for xyz in (True, False):
                        if (rows < KR or (pw > 1 and not resident)
                                or (pw == 3 and N == 0) or (xyz and N == 0)
                                or (pw == 2 and rows > 128)):
                            continue
                        smem = _ws_smem(C1, C2, C3, rows, resident,
                                        N if xyz else 0, pw)
                        if smem <= SMEM_LIMIT:
                            return SaPlan(rows, rows // KR, KR, resident,
                                          xyz, pw, pw, smem)
    St = max(1, min(S, 128 // K)) if K <= 128 else 1
    smem = _loop_smem(St, K, C1, C2)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused SA: no {dtype} tile plan for widths ({C1},{C2},{C3}) and "
            f"K={K} fits the {SMEM_LIMIT} bytes of shared memory a block can "
            f"use (the loop kernel needs {smem})")
    return SaPlan(St * K, St, K, False, False, 0, 0, smem)


def _sa_tail(name: str, B: int, N: int, S: int, K: int, pre, cbias, w1, b1,
             w2, b2, ball: bool):
    """The checks and operands the two fused SA forms share: pre [B,N,C1]
    bf16 or f32, cbias [B,S,C1], the folded layers, cast to pre's dtype
    (unpadded: the kernel pads them in shared memory) -> (dims and plan,
    operands); ``ball``: the ball-query form, whose plan also says whether
    the points sit in shared memory."""
    dev, dt = pre.device, pre.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bf16 or f32 features, got {dt}")
    C1, C2, C3 = pre.shape[-1], w1.shape[-1], w2.shape[-1]
    if (pre.shape != (B, N, C1) or cbias.shape != (B, S, C1)
            or w1.shape != (C1, C2) or b1.shape != (C2,)
            or w2.shape != (C2, C3) or b2.shape != (C3,)):
        raise ValueError(f"{name}: inconsistent shapes")
    for n, t in (("cbias", cbias), ("w1", w1), ("b1", b1), ("w2", w2),
                 ("b2", b2)):
        if t.device != dev:
            raise ValueError(f"{n} is on {t.device}, expected {dev}")
    plan = sa_plan(C1, C2, C3, K, S, dt, N if ball else 0)
    dims = ((C1, C2, C3, plan.St, plan.rows, int(plan.resident))
            + ((int(plan.xyz_smem),) if ball else ())
            + (plan.producers, plan.stages, plan.smem))
    operands = tuple(t.to(dt).contiguous()
                     for t in (pre, cbias, w1, b1, w2, b2))
    return dims, operands


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
    return torch.ops.mm3d.fused_sa(radius, nsample, xyz, new_xyz, pre, cbias,
                                   w1, b1, w2, b2)


@torch.library.custom_op("mm3d::fused_sa", mutates_args=())
def _fused_sa_op(radius: float, nsample: int, xyz: torch.Tensor,
                 new_xyz: torch.Tensor, pre: torch.Tensor,
                 cbias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused SA kernel, ball-query form, under its ``sa_plan``."""
    dev = pre.device
    xyz = _f32_points("xyz", xyz, dev)
    new_xyz = _f32_points("new_xyz", new_xyz, dev)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    dims, operands = _sa_tail("fused_sa", B, N, S, nsample, pre, cbias, w1,
                              b1, w2, b2, ball=True)
    out = torch.empty((B, S, dims[2]), dtype=pre.dtype, device=dev)
    if out.numel() == 0:
        return out
    _launch("mm3d_fused_sa", int(pre.dtype == torch.bfloat16), _ptr(xyz),
            _ptr(new_xyz), *map(_ptr, operands), _ptr(out), B, N, S,
            nsample, *dims, _r2(radius), _stream(pre))
    fused_sa.launches += 1
    fused_sa.f32_launches += int(pre.dtype == torch.float32)
    return out


@_fused_sa_op.register_fake
def _(radius, nsample, xyz, new_xyz, pre, cbias, w1, b1, w2, b2):
    return pre.new_empty((xyz.shape[0], new_xyz.shape[1], w2.shape[-1]))


fused_sa.launches = 0
# the launches of its f32 form (sa_f32_kernel), counted in launches too
fused_sa.f32_launches = 0


def fused_sa_idx(nsample: int, idx: torch.Tensor, pre: torch.Tensor,
                 cbias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused SA tail over given neighbours (gather + folded 2-layer MLP + max
    over K), the kNN serving path.

    Args:
      idx [B,S,nsample] int32: each row nsample valid indices in [0, N)
        (repeats allowed), nsample <= 128 (the TPU kernel's contract).
      pre, cbias, w1, b1, w2, b2: as for ``fused_sa``.
    Returns [B,S,C3] in pre's dtype."""
    if dispatch.resolve(pre) == "torch":
        return fused_sa_idx_torch(nsample, idx, pre, cbias, w1, b1, w2, b2)
    return torch.ops.mm3d.fused_sa_idx(nsample, idx, pre, cbias, w1, b1, w2,
                                       b2)


@torch.library.custom_op("mm3d::fused_sa_idx", mutates_args=())
def _fused_sa_idx_op(nsample: int, idx: torch.Tensor, pre: torch.Tensor,
                     cbias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused SA kernel, given-index form, under its ``sa_plan``."""
    dev = pre.device
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, expected {dev}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 3 or idx.shape[-1] != nsample:
        raise ValueError(f"idx must be [B,S,{nsample}], got "
                         f"{tuple(idx.shape)}")
    if nsample > 128:
        raise ValueError(f"fused_sa_idx takes at most 128 neighbours, got "
                         f"{nsample}")
    B, S, _ = idx.shape
    N = pre.shape[1]
    dims, operands = _sa_tail("fused_sa_idx", B, N, S, nsample, pre, cbias,
                              w1, b1, w2, b2, ball=False)
    out = torch.empty((B, S, dims[2]), dtype=pre.dtype, device=dev)
    if out.numel() == 0:
        return out
    idx = idx.contiguous()
    _launch("mm3d_fused_sa_idx", int(pre.dtype == torch.bfloat16), _ptr(idx),
            *map(_ptr, operands), _ptr(out), B, N, S, nsample, *dims,
            _stream(pre))
    fused_sa_idx.launches += 1
    fused_sa_idx.f32_launches += int(pre.dtype == torch.float32)
    return out


@_fused_sa_idx_op.register_fake
def _(nsample, idx, pre, cbias, w1, b1, w2, b2):
    return pre.new_empty((idx.shape[0], idx.shape[1], w2.shape[-1]))


fused_sa_idx.launches = 0
fused_sa_idx.f32_launches = 0


# ------------------------------------------- gather backward (scatter-add)


def gather_backward_torch(g: torch.Tensor, idx: torch.Tensor, n: int,
                          weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain twin of the gather-backward kernel -> [B,n,C] in g's dtype.

    Unweighted: d[b, idx[b,f]] += g[b,f]. Weighted (g [B,R,C], idx and
    weight [B,R,k]): contribution f = r*k + j is g[b,r] * weight[b,r,j],
    taken in f32 (f64 for f64 g) and rounded to g's dtype. The sums run in
    f32 (f64) by one ``index_add_``, which on the host adds each row's
    contributions in ascending f, the kernel's order. An index outside
    [0, n) contributes nothing."""
    B, C = g.shape[0], g.shape[-1]
    acc = torch.promote_types(g.dtype, torch.float32)
    src = g.to(acc)
    if weight is not None:
        src = (src[:, :, None, :] * weight.to(acc)[..., None]).to(
            g.dtype).to(acc)
    offs = (torch.arange(B, device=idx.device, dtype=torch.int64) * n).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    rows = idx.long()
    # out-of-range contributions go to one spare row, dropped at the end
    rows = torch.where((rows >= 0) & (rows < n), rows + offs, B * n)
    flat = torch.zeros((B * n + 1, C), dtype=acc, device=g.device)
    flat.index_add_(0, rows.reshape(-1), src.reshape(-1, C))
    return flat[:B * n].reshape(B, n, C).to(g.dtype)


def _gather_rows_per_block(B: int, n: int, C: int, sms: int, limit: int,
                           buckets: int) -> int:
    """Output rows per bucket (and per block) of the gather backward: about
    six blocks (clouds x buckets x 32-channel slices) a multiprocessor,
    three waves of its two resident blocks, which measured best at the
    training shapes on the H100; at most ``limit`` rows and ``buckets``
    buckets."""
    slices = -(-C // 32)
    want = max(1, (6 * sms) // max(1, B * slices))
    rpb = max(1, min(limit, n, max(8, -(-n // want))))
    return max(rpb, -(-n // buckets))


def gather_backward(g: torch.Tensor, idx: torch.Tensor, n: int,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-add backward of the gathers -> [B,n,C] in g's dtype.

    Unweighted (``index_points``' backward): g [B,...,C], idx [B,...],
    d[b, idx[b,f]] += g[b,f]. Weighted (the backwards of three_interpolate
    and of the bilinear sampling): g [B,R,C], idx [B,R,k] int32, weight
    [B,R,k] in g's dtype; contribution f = r*k + j adds g[b,r] *
    weight[b,r,j], the product taken in f32 and rounded to g's dtype. Sums
    are taken in f32 in ascending f for each output row and cast to g's
    dtype (f32 or bf16); an index outside [0, n) contributes nothing. The
    result equals ``gather_backward_torch`` run on the host bit for bit, and
    two launches give identical bits."""
    if dispatch.resolve(g) == "torch":
        return gather_backward_torch(g, idx, n, weight)
    dev, dt = g.device, g.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gather_backward takes bf16 or f32 g, got {dt}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, expected {dev}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    B, C = g.shape[0], g.shape[-1]
    if weight is None:
        if tuple(g.shape[:-1]) != tuple(idx.shape):
            raise ValueError(f"g {tuple(g.shape)} does not match idx "
                             f"{tuple(idx.shape)}")
        R, k = (idx[0].numel() if B else 0), 1
    else:
        if weight.device != dev:
            raise ValueError(f"weight is on {weight.device}, expected {dev}")
        if weight.dtype != dt:
            raise TypeError(f"weight must be in g's dtype {dt}, got "
                            f"{weight.dtype}")
        if (g.dim() != 3 or idx.dim() != 3
                or tuple(idx.shape[:2]) != tuple(g.shape[:2])
                or weight.shape != idx.shape):
            raise ValueError(f"weighted gather_backward takes g [B,R,C], idx "
                             f"and weight [B,R,k]; got g {tuple(g.shape)}, "
                             f"idx {tuple(idx.shape)}, weight "
                             f"{tuple(weight.shape)}")
        R, k = g.shape[1], idx.shape[2]
    limit = _fn("mm3d_gather_bwd_max_rows")()
    if n > limit:
        raise ValueError(f"gather_backward takes at most {limit} rows, got {n}")
    most = _fn("mm3d_gather_bwd_max_contributions")()
    if R * k > most:
        raise ValueError(f"gather_backward takes at most {most} contributions "
                         f"a cloud, got {R * k}")
    out = torch.empty((B, n, C), dtype=dt, device=dev)
    if B * n * C == 0:
        return out
    g = g.contiguous()
    idx = idx.contiguous()
    if weight is not None:
        weight = weight.contiguous()
    # multiprocessors: the card's; the H100's 132 where the CPU tests fake
    # the kernel path
    rpb = _gather_rows_per_block(
        B, n, C, _sm_count(dev),
        _fn("mm3d_gather_bwd_max_rows_per_block")(),
        _fn("mm3d_gather_bwd_max_buckets")())
    # scratch: per tile and bucket counts, the bucketed list, bucket starts
    tiles = -(-R * k // _fn("mm3d_gather_bwd_tile")())
    nb = -(-n // rpb)
    cnt = torch.empty((B, max(tiles, 1), nb), dtype=torch.int32, device=dev)
    lst = torch.empty((B, max(R * k, 1)), dtype=torch.int32, device=dev)
    bstart = torch.empty((B, nb + 1), dtype=torch.int32, device=dev)
    _launch("mm3d_gather_bwd", int(dt == torch.bfloat16), _vec_ok(C, g),
            _ptr(g), _ptr(idx), None if weight is None else _ptr(weight),
            _ptr(out), _ptr(cnt), _ptr(lst), _ptr(bstart), B, R, k, n, C,
            rpb, _stream(g))
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


# the 3-NN kernels (csrc/three_nn.cu, csrc/fused_fp.cu): G lanes scan a
# dense point, G in NN_LANES; a block of `threads` threads takes
# threads / G dense points of one cloud
NN_LANES = (1, 2, 4, 8, 16)
# blocks a multiprocessor the lanes are raised to give the grid
NN_BLOCKS_PER_SM = 1
# the fused FP tail's shared memory: most bytes of a block's skip tile, and
# most bytes in all (sparse cloud, skip tile and the cloud's pre rows) for
# the pre rows to be staged too (two blocks a multiprocessor)
FP_SKIP_TILE_BYTES = 64 * 1024
FP_PRE_SMEM_BYTES = 100 * 1024


def nn_lanes(B: int, N: int, threads: int = 128, sms: int = 132) -> int:
    """Lanes a dense point: the fewest of NN_LANES whose grid has
    NN_BLOCKS_PER_SM blocks for each of the card's ``sms`` multiprocessors
    (the most where none has). Fewer lanes give each lane a longer scan and
    fewer merge rounds (three_nn.cuh)."""
    for G in NN_LANES:
        if B * -(-N * G // threads) >= NN_BLOCKS_PER_SM * sms:
            return G
    return NN_LANES[-1]


class FpPlan(NamedTuple):
    lanes: int  # lanes a dense point
    mode: int   # 0 scalar; 1 16-byte moves, skip tile in shared memory;
    #             2 as 1 with the cloud's pre rows in shared memory too
    smem: int   # dynamic shared-memory bytes of a block (the launcher
    #             refuses a count that differs from its layout)


def fp_plan(B: int, N: int, M: int, C: int, esize: int, aligned: int,
            threads: int = 256, sms: int = 132) -> FpPlan:
    """The fused FP tail's launch: ``nn_lanes``, raised where the block's
    skip tile (threads / G rows of C channels of ``esize`` bytes) would pass
    FP_SKIP_TILE_BYTES; the pre rows staged where everything fits in
    FP_PRE_SMEM_BYTES; the scalar path (no tile) where C is not a whole
    number of 16-byte moves, a pointer is not 16-byte aligned (``aligned``
    0) or even the most lanes leave the tile too large."""
    G = nn_lanes(B, N, threads, sms)
    if aligned and C * esize % 16 == 0:
        for lanes in NN_LANES:
            tile = threads // lanes * C * esize
            if lanes >= G and tile <= FP_SKIP_TILE_BYTES:
                smem, mode = M * 16 + tile, 1
                if smem + M * C * esize <= FP_PRE_SMEM_BYTES:
                    smem, mode = smem + M * C * esize, 2
                return FpPlan(lanes, mode, smem)
    return FpPlan(G, 0, M * 16)


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
    return torch.ops.mm3d.fused_fp(xyz1, xyz2, pre, skip)


@torch.library.custom_op("mm3d::fused_fp", mutates_args=())
def _fused_fp_op(xyz1: torch.Tensor, xyz2: torch.Tensor, pre: torch.Tensor,
                 skip: torch.Tensor) -> torch.Tensor:
    """The fused FP kernel under its ``fp_plan``."""
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
    plan = fp_plan(B, N, M, C, pre.element_size(),
                   _vec_ok(C, pre, skip, out),
                   _fn("mm3d_fused_fp_threads")(), _sm_count(dev))
    _launch("mm3d_fused_fp", int(dt == torch.bfloat16), plan.mode,
            _ptr(xyz1), _ptr(xyz2), _ptr(pre), _ptr(skip), _ptr(out), B, N,
            M, C, plan.lanes, plan.smem, _stream(pre))
    fused_fp.launches += 1
    return out


@_fused_fp_op.register_fake
def _(xyz1, xyz2, pre, skip):
    return pre.new_empty((xyz1.shape[0], xyz1.shape[1], pre.shape[-1]))


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
    return torch.ops.mm3d.bilinear_sample(feat, uv)


@torch.library.custom_op("mm3d::bilinear_sample", mutates_args=())
def _bilinear_op(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The bilinear kernel: feat [B,H,W,C], uv [B,N,2] f32 -> [B,N,C]."""
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
    _indexable("bilinear_sample", B, "mm3d_bilinear_max_batch",
               **{"H*W*C": H * W * C, "N*max(C,2)": N * max(C, 2)})
    # a no-op on the model's path: ImageEncoder's map is an NHWC view of a
    # channels-last tensor
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


@_bilinear_op.register_fake
def _(feat, uv):
    return feat.new_empty((feat.shape[0], uv.shape[1], feat.shape[-1]))


def bilinear_sample_backward(feat: torch.Tensor, uv: torch.Tensor,
                             g: torch.Tensor, want_feat: bool, want_uv: bool):
    """VJP of the sampling -> (d_feat [B,H,W,C] in feat's dtype or None,
    d_uv [B,N,2] in uv's dtype or None).

    The VJP of the f32 lerp of ``projection._bilinear_sample_jax``, as the
    JAX package's ``_bilinear_bwd`` takes it (``pallas_kernels.py:1507-1517``):
    g cast to f32 (f64 stays f64); the four corner weights
    ((1-dv)(1-du)) m00, ((1-dv) du) m10, (dv (1-du)) m01, (dv du) m11, each
    m zero outside the frame; then ONE weighted ``gather_backward`` of g by
    the corner rows [B,N,4] and those weights [B,N,4] into the H*W rows of
    the map (the hand-written deterministic kernel on the card, not
    ``index_add_``), cast to feat's dtype. A corner's contribution g * w is
    rounded once, where the JAX VJP's (g (1-dv)) (1-du) rounds twice, so
    d_feat differs from it (and from this function before the weighted
    form) in the last bits. d_uv (sum over channels of g times the lerp's
    slopes; floor() passes no gradient) only when ``want_uv``."""
    B, H, W, C = feat.shape
    acc_dt = torch.promote_types(g.dtype, torch.float32)
    g = g.to(acc_dt)
    u, v = uv[..., 0].to(acc_dt), uv[..., 1].to(acc_dt)
    x0, y0 = torch.floor(u), torch.floor(v)
    du, dv = u - x0, v - y0
    # the corners (0,0), (1,0), (0,1), (1,1) on a last axis of 4: a few
    # elementwise passes over [B,N,4] rather than four over [B,N] each
    x = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    y = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    xc, yc = x.clamp(0, W - 1), y.clamp(0, H - 1)
    # x and y are whole numbers: in the frame exactly where clamping keeps
    # them (NaN and +-inf are outside)
    inside = ((xc == x) & (yc == y)).to(acc_dt)
    rows = (yc * W + xc).to(torch.int32)  # [B,N,4], exact in floats
    d_feat = d_uv = None
    if want_feat:
        omdu, omdv = 1 - du, 1 - dv
        w = (torch.stack([omdv, omdv, dv, dv], dim=-1)
             * torch.stack([omdu, du, omdu, du], dim=-1)) * inside
        d_feat = gather_backward(g, rows, H * W, w)
        d_feat = d_feat.reshape(B, H, W, C).to(feat.dtype)
    if want_uv:
        du, dv = du[..., None], dv[..., None]
        d_top, d_bot = g * (1 - dv), g * dv
        flat = feat.reshape(B, H * W, C)
        c00, c10, c01, c11 = (
            _gather(flat, rows[..., i]).to(acc_dt) * inside[..., i, None]
            for i in range(4))
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
    lanes = nn_lanes(B, N, _fn("mm3d_three_nn_threads")(),
                     _sm_count(xyz1.device))
    _launch("mm3d_three_nn", _ptr(xyz1), _ptr(xyz2), _ptr(dist), _ptr(idx),
            B, N, M, lanes, _stream(xyz1))
    three_nn.launches += 1
    return dist, idx


three_nn.launches = 0

# ------------------------------------------------------ three_interpolate


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The forward of the interpolation: points [B,M,C] bf16 or f32, idx
    [B,N,3] int32 in [0, M), weight [B,N,3] bf16 or f32 -> [B,N,C] in
    points' dtype, ``three_interpolate_torch``'s contract bit for bit: the
    kernel reads the weights as they are and rounds them to the points'
    dtype itself, so a call is one launch. The gradient is
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
    if weight.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"three_interpolate takes bf16 or f32 weights, "
                        f"got {weight.dtype}")
    if weight.shape != idx.shape:
        raise ValueError(f"weight {tuple(weight.shape)} does not match idx "
                         f"{tuple(idx.shape)}")
    N = idx.shape[1]
    _indexable("three_interpolate", B, "mm3d_three_interp_max_batch",
               **{"M*C": M * C, "N*max(C,3)": N * max(C, 3)})
    points = points.contiguous()
    idx = idx.contiguous()
    weight = weight.contiguous()
    out = torch.empty((B, N, C), dtype=dt, device=dev)
    if B * N * C == 0:
        return out
    _launch("mm3d_three_interp", int(dt == torch.bfloat16),
            int(weight.dtype == torch.bfloat16), _vec_ok(C, points, out),
            _ptr(points), _ptr(idx), _ptr(weight), _ptr(out), B, N, M, C,
            _stream(points))
    three_interpolate.launches += 1
    return out


three_interpolate.launches = 0

KERNELS = (farthest_point_sample, query_ball_point, fused_sa, gather_backward,
           fused_fp, bilinear_sample, three_nn, three_interpolate,
           fused_sa_idx)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    fused_sa.f32_launches = fused_sa_idx.f32_launches = 0
