"""The fused SA tail's tile plan and kernel path, on the CPU.

``cuda_kernels.sa_plan`` cuts each fused SA launch for the H100 kernels
(``csrc/fused_sa.cu``): tile (bf16) or block (f32) rows, centroids a tile,
resident or streamed weights, producer warpgroups (0: the bf16 loop
kernel), A stages and the shared-memory bytes. It is checked here at every
(C1, C2, C3, K) that the JAX models route to the fused tail, in bf16 and in
f32 (the CUDA-core kernel, whose bytes are held to its layout written out
here), and at every width the first design took, whose tile fitted. The
wrappers' kernel path runs through ``fake_kernels`` (the plain twins in
place of the launches), also for a whole pointnet2_sem_seg forward on the
f32 form, held to JAX's eval (the only test here that imports JAX, inside
it). The twins themselves are held to the Pallas kernels in
tests/test_torch_ops.py and tests/test_torch_knn.py; the kernels run only
on the card, where chip_smoke.py holds them to the twins.
"""

import numpy as np
import pytest
import torch

from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.ops import cuda_kernels as ck
from mm3d_tpu_torch.ops import dispatch


def fake_kernels(monkeypatch):
    """The kernel path of the wrappers, on the CPU: ``dispatch.resolve``
    answers 'cuda', and each launch runs the kernel's plain twin into the
    outputs the wrapper allocated (``_ptr`` hands the tensors through). The
    wrappers' checks, allocations and launch counts run as on the card; the
    six serving kernels' run inside their ``mm3d::*`` operators, whose
    implementation takes CPU tensors too, so an exported graph runs here."""
    monkeypatch.setattr(dispatch, "resolve", lambda t: "cuda")
    monkeypatch.setattr(ck, "_ptr", lambda t: t)
    monkeypatch.setattr(ck, "_stream", lambda t: None)
    # limits: none, but for the grid's y axis; threads a block of the 3-NN
    # kernels: csrc's
    consts = {"mm3d_three_nn_threads": 128, "mm3d_fused_fp_threads": 256,
              "mm3d_three_interp_max_batch": 65535,
              "mm3d_bilinear_max_batch": 65535}
    monkeypatch.setattr(ck, "_fn", lambda symbol: (
        lambda: consts.get(symbol, 1 << 20)))

    def launch(symbol, *a):
        if symbol == "mm3d_fps":
            a[2].copy_(tops.fps_torch(a[0], a[5], a[1]))
        elif symbol == "mm3d_ball_query":
            a[2].copy_(tops.ball_query_torch(np.sqrt(a[7]), a[6], a[0], a[1]))
        elif symbol in ("mm3d_fused_sa", "mm3d_fused_sa_idx"):
            # the tail over the unpadded operands the kernel takes, under
            # a plan that fits the card's shared memory
            given = symbol == "mm3d_fused_sa_idx"
            pre, cbias, w1, b1, w2, b2, out = a[3 - given:10 - given]
            K, smem = a[13 - given], a[23 - 2 * given]
            assert smem <= ck.SMEM_LIMIT
            launch.producers.append(a[21 - 2 * given])
            launch.plans.append(a[17 - given:24 - 2 * given])
            idx = (a[1] if given else
                   tops.ball_query_torch(np.sqrt(a[-2]), K, a[1], a[2]))
            out.copy_(tops.fused_sa_idx_torch(K, idx, pre, cbias, w1, b1, w2,
                                              b2))
        elif symbol == "mm3d_three_nn":
            assert a[7] in ck.NN_LANES
            d, i = tops.three_nn_torch(a[0], a[1])
            a[2].copy_(d)
            a[3].copy_(i)
        elif symbol == "mm3d_fused_fp":
            # the wrapper's plan, within the card's shared memory
            B, N, M, C, lanes, smem = a[7:13]
            plan = ck.fp_plan(B, N, M, C, a[4].element_size(),
                              int(a[1] > 0))
            assert (lanes, a[1], smem) == plan and smem <= ck.SMEM_LIMIT
            a[6].copy_(ck.fused_fp_torch(a[2], a[3], a[4], a[5]))
        elif symbol == "mm3d_three_interp":
            # the weights as the caller gave them, their dtype flagged
            assert a[1] == int(a[5].dtype == torch.bfloat16)
            launch.weights.append(a[5])
            a[6].copy_(tops.three_interpolate_torch(a[3], a[4], a[5]))
        elif symbol == "mm3d_gather_bwd":
            a[5].copy_(tops.gather_backward_torch(a[2], a[3], a[12], a[4]))
        elif symbol == "mm3d_bilinear":
            a[4].copy_(tops.bilinear_sample_torch(a[2], a[3]))
        else:
            raise NotImplementedError(symbol)

    launch.producers = []  # each fused SA launch's plan: 0 the loop kernel
    # each fused SA launch's plan arguments, St to smem (``_plan_args``)
    launch.plans = []
    launch.weights = []  # each three_interp launch's weight operand
    monkeypatch.setattr(ck, "_launch", launch)
    ck.reset_launches()
    return ck


def _inputs(seed, B, N, S, C1, C2, C3, dtype=torch.bfloat16):
    """xyz, new_xyz (the first S points) in f32, then pre, cbias, w1, b1,
    w2, b2 in dtype."""
    r = np.random.RandomState(seed)
    xyz = (r.randn(B, N, 3) * 0.5).astype(np.float32)
    feats = (r.randn(B, N, C1), r.randn(B, S, C1), r.randn(C1, C2) * 0.3,
             r.randn(C2), r.randn(C2, C3) * 0.3, r.randn(C3))
    return ([torch.from_numpy(xyz), torch.from_numpy(xyz[:, :S].copy())]
            + [torch.from_numpy(a.astype(np.float32)).to(dtype)
               for a in feats])


# (C1, C2, C3, K) of every 3-layer SA block the JAX models send to the fused
# tail in bf16 eval, one scale each, with its place in the JAX package
ROUTED = {
    "pointnet2.py:535-539 ClsSSG sa1": (64, 64, 128, 32),
    "pointnet2.py:535-539 ClsSSG sa2": (128, 128, 256, 64),
    "pointnet2.py:570-577 ClsMSG sa1 s0": (32, 32, 64, 16),
    "pointnet2.py:570-577 ClsMSG sa1 s1": (64, 64, 128, 32),
    "pointnet2.py:570-577 ClsMSG sa1 s2": (64, 96, 128, 128),
    "pointnet2.py:570-577 ClsMSG sa2 s0": (64, 64, 128, 32),
    "pointnet2.py:570-577 ClsMSG sa2 s1": (128, 128, 256, 64),
    "pointnet2.py:570-577 ClsMSG sa2 s2": (128, 128, 256, 128),
    "pointnet2.py:610-616 PartSegSSG sa1": (64, 64, 128, 32),
    "pointnet2.py:610-616 PartSegSSG sa2": (128, 128, 256, 64),
    "pointnet2.py:651-658 PartSegMSG sa1 s0": (32, 32, 64, 32),
    "pointnet2.py:651-658 PartSegMSG sa1 s1": (64, 64, 128, 64),
    "pointnet2.py:651-658 PartSegMSG sa1 s2": (64, 96, 128, 128),
    "pointnet2.py:651-658 PartSegMSG sa2 s0": (128, 128, 256, 64),
    "pointnet2.py:651-658 PartSegMSG sa2 s1": (128, 196, 256, 128),
    "pointnet2.py:695-708 SemSeg sa1": (32, 32, 64, 32),
    "pointnet2.py:695-708 SemSeg sa2": (64, 64, 128, 32),
    "pointnet2.py:695-708 SemSeg sa3": (128, 128, 256, 32),
    "pointnet2.py:695-708 SemSeg sa4": (256, 256, 512, 32),
    "pointnet2.py:736-748 SemSegMSG sa1 s0": (16, 16, 32, 16),
    "pointnet2.py:736-748 SemSegMSG sa1 s1": (32, 32, 64, 32),
    "pointnet2.py:736-748 SemSegMSG sa2 s0": (64, 64, 128, 16),
    "pointnet2.py:736-748 SemSegMSG sa2 s1": (64, 96, 128, 32),
    "pointnet2.py:736-748 SemSegMSG sa3 s0": (128, 196, 256, 16),
    "pointnet2.py:736-748 SemSegMSG sa3 s1": (128, 196, 256, 32),
    "pointnet2.py:736-748 SemSegMSG sa4 s0": (256, 256, 512, 16),
    "pointnet2.py:736-748 SemSegMSG sa4 s1": (256, 384, 512, 32),
    "fusion.py:33-36 PointTrunkCls sa1": (64, 64, 128, 32),
    "fusion.py:33-36 PointTrunkCls sa2": (128, 128, 256, 64),
    "fusion.py:52-60 PointTrunkDense sa1": (64, 64, 128, 32),
    "fusion.py:52-60 PointTrunkDense sa2": (128, 128, 256, 64),
}


def _resident_fits(C1, C2, C3, K):
    """Whether any tile shape the planner tries holds the weights resident
    within the limit."""
    KR = -(-K // 16) * 16
    return any(ck._ws_smem(C1, C2, C3, rows, True) <= ck.SMEM_LIMIT
               for rows in (64, 128) if rows >= KR)


# the points a block of config 3 really groups from, where they are not
# 1,024: sa1 takes the registry's 2,048, sa2 sa1's 512 centroids
OWN_N = {"pointnet2.py:610-616 PartSegSSG sa1": 2048,
         "pointnet2.py:610-616 PartSegSSG sa2": 512,
         "pointnet2.py:651-658 PartSegMSG sa1 s0": 2048,
         "pointnet2.py:651-658 PartSegMSG sa1 s1": 2048,
         "pointnet2.py:651-658 PartSegMSG sa1 s2": 2048,
         "pointnet2.py:651-658 PartSegMSG sa2 s0": 512,
         "pointnet2.py:651-658 PartSegMSG sa2 s1": 512}


@pytest.mark.parametrize("where", sorted(ROUTED))
def test_sa_plan_fits_every_routed_width(where):
    """At N = 1,024 points and, for config 3's blocks, also at the N the
    block sees: the ball-query form's plan depends on N, whose points it
    stages in shared memory where they fit beside the tile."""
    C1, C2, C3, K = ROUTED[where]
    for N in sorted({1024, OWN_N.get(where, 1024)}):
        _check_routed_plan(C1, C2, C3, K, N)


def _check_routed_plan(C1, C2, C3, K, N):
    plan = ck.sa_plan(C1, C2, C3, K, 512, torch.bfloat16, N)
    assert plan.smem <= ck.SMEM_LIMIT == 232448
    assert plan.rows % 64 == 0 and plan.rows <= 128
    assert plan.KR % 16 == 0 and K <= plan.KR
    assert plan.St == plan.rows // plan.KR and plan.St * K <= plan.rows
    # every routed width takes the wgmma kernel; several producers take
    # turns, an A stage each, over resident weights
    assert plan.producers >= 1
    assert plan.producers == 1 or plan.resident
    # streamed exactly where resident weights do not fit
    assert plan.resident == _resident_fits(C1, C2, C3, K)
    if plan.resident:
        # w1 and w2 padded to the swizzle atoms (K to 64, N to 64)
        weights = 2 * (-(-C1 // 64) * 64 * -(-C2 // 64) * 64
                       + -(-C2 // 64) * 64 * -(-C3 // 64) * 64)
        assert weights < plan.smem
    # the given-index form keeps no points in shared memory
    assert not ck.sa_plan(C1, C2, C3, K, 512, torch.bfloat16).xyz_smem


def test_sa_plan_streams_the_sa4_widths():
    """The two sa4 widths' weights (384 KB and 576 KB in bf16) cannot be
    resident; the main path's stay resident."""
    for w in ((256, 256, 512, 32), (256, 384, 512, 32)):
        assert not ck.sa_plan(*w, 16, torch.bfloat16, 64).resident
    for w in ((64, 64, 128, 32), (128, 128, 256, 64)):
        assert ck.sa_plan(*w, 512, torch.bfloat16, 1024).resident


@pytest.mark.parametrize("K,rows", [(129, 256), (200, 256), (256, 256),
                                    (300, 384)])
def test_sa_plan_past_128_neighbours(K, rows):
    """The ball-query form takes any K, as the JAX kernel does: one centroid
    a tile of K rounded up to 128 rows, walked in blocks of 128."""
    plan = ck.sa_plan(64, 64, 128, K, 64, torch.bfloat16, 1024)
    assert (plan.rows, plan.St) == (rows, 1) and plan.KR >= K
    assert plan.smem <= ck.SMEM_LIMIT


@pytest.mark.parametrize("N", [1024, 0])
@pytest.mark.parametrize("K", [200, 256])
def test_sa_plan_streams_past_128_neighbours(K, N):
    """(64,128,512) past 128 neighbours: weights too large to stay resident
    beside a 256-row tile, so one producer streams the weight panels, once
    for each block of 128 rows the consumers walk."""
    plan = ck.sa_plan(64, 128, 512, K, 64, torch.bfloat16, N)
    assert (plan.rows, plan.St, plan.resident, plan.producers) == (
        256, 1, False, 1)
    assert plan.xyz_smem == (N > 0) and plan.smem <= ck.SMEM_LIMIT


def _first_design_smem(K, C1, C2, esize):
    """Shared-memory bytes of the first design's block (one per
    St = 128 // K centroids, S = 512), written out here as that design's
    Layout: idx | A | H | a 64-column f32 tile, rows padded to 16, widths
    to 16 plus a 16-byte skew."""
    St = max(1, min(512, 128 // K)) if K <= 128 else 1
    R = St * K
    Rp = -(-R // 16) * 16
    return (-(-R * 4 // 128) * 128
            + Rp * (-(-C1 // 16) * 16 + 16 // esize) * esize
            + Rp * (-(-C2 // 16) * 16 + 16 // esize) * esize + Rp * 68 * 4)


WIDTHS = (8, 16, 24, 32, 64, 96, 128, 196, 256, 384, 512, 640)


def _f32_layout_smem(C1, C2, C3, K, rows, resident, xyz_points, stages):
    """Shared-memory bytes of the f32 kernel's block, written out here as
    its layout (``F32Layout``): weights (resident, or two 32-row panels of
    the wider chunk), A stages and H channel-major with rows + 4 floats a
    channel, biases, two tiles' indices and cbias rows, two chunks' slab
    maxima, the running row of a centroid walked in blocks, the points
    (x, y, z, |p|^2; whole rounds of 128), mbarriers; each part 128-byte
    aligned."""
    def al(n):
        return -(-n // 128) * 128

    def up(x, m):
        return -(-x // m) * m

    nc1, nc2 = (32 if c <= 32 else 64 if c <= 64 else 128 for c in (C2, C3))
    C1p, K2p, N1p, N2p = up(C1, 16), up(C2, 16), up(C2, nc1), up(C3, nc2)
    KR = up(K, 16)
    blocks = 1 if KR <= rows else -(-KR // rows)
    St = rows // KR if blocks == 1 else 1
    weights = (al(4 * C1p * N1p) + al(4 * K2p * N2p) if resident
               else 2 * al(4 * 32 * max(nc1, nc2)))
    return (weights + stages * al(4 * C1p * (rows + 4))
            + al(4 * K2p * (rows + 4)) + al(4 * N1p) + al(4 * N2p)
            + al(8 * blocks * rows) + al(8 * St * C1p)
            + al(8 * (rows // 16) * nc2)
            + (al(4 * N2p) if blocks > 1 else 0)
            + al(16 * up(xyz_points, 128)) + 128)


def _check_f32_plan(plan, C1, C2, C3, K, N):
    """An f32 plan: the CUDA-core kernel (two producer warpgroups), blocks of
    128 or 64 rows holding St whole centroids (or one centroid walked in
    blocks), one or two A stages, the layout's bytes within the limit."""
    KR = -(-K // 16) * 16
    assert plan.producers == 2 and plan.stages in (1, 2)
    assert plan.rows in (128, 64) and plan.KR == KR
    assert plan.St == (plan.rows // KR if KR <= plan.rows else 1)
    assert not plan.xyz_smem or N > 0
    assert plan.smem == _f32_layout_smem(
        C1, C2, C3, K, plan.rows, plan.resident,
        N if plan.xyz_smem else 0, plan.stages)
    assert plan.smem <= ck.SMEM_LIMIT == 232448


@pytest.mark.parametrize("where", sorted(ROUTED))
def test_f32_sa_plan_fits_every_routed_width(where):
    """The f32 form (fp32 serving with the kernels forced, bf16 serving
    under ``MM3D_BF16_DEBUG=sa_bn``) has a plan at every routed width, the
    segmentation models' sa4 blocks included, in both forms and at the N
    the block sees; weights stay resident at the classifiers' sa1."""
    C1, C2, C3, K = ROUTED[where]
    for N in sorted({1024, OWN_N.get(where, 1024), 0}):
        _check_f32_plan(ck.sa_plan(C1, C2, C3, K, 512, torch.float32, N),
                        C1, C2, C3, K, N)
    if (C1, C2, C3, K) == (64, 64, 128, 32):
        plan = ck.sa_plan(C1, C2, C3, K, 512, torch.float32, 1024)
        assert (plan.rows, plan.resident, plan.stages, plan.xyz_smem) == (
            128, True, 2, True)


def _first_design_smem(K, C1, C2, esize):
    """Shared-memory bytes of the first design's block (one per
    St = 128 // K centroids, S = 512), written out here as that design's
    Layout: idx | A | H | a 64-column f32 tile, rows padded to 16, widths
    to 16 plus a 16-byte skew."""
    St = max(1, min(512, 128 // K)) if K <= 128 else 1
    R = St * K
    Rp = -(-R // 16) * 16
    return (-(-R * 4 // 128) * 128
            + Rp * (-(-C1 // 16) * 16 + 16 // esize) * esize
            + Rp * (-(-C2 // 16) * 16 + 16 // esize) * esize + Rp * 68 * 4)


WIDTHS = (8, 16, 24, 32, 64, 96, 128, 196, 256, 384, 512, 640)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [1, 16, 20, 32, 48, 64, 96, 128, 129, 200,
                               256, 300, 512])
def test_sa_plan_takes_what_the_first_design_took(K, dtype):
    """Every width the first design ran (its block within the limit) still
    has a plan, in both forms: bf16, the wgmma kernel's where it fits, else
    the loop kernel, whose bytes are the first design's; f32, the CUDA-core
    kernel, whose bytes are its layout's."""
    dt = getattr(torch, dtype)
    taken = 0
    for C1 in WIDTHS:
        for C2 in WIDTHS:
            if _first_design_smem(K, C1, C2, dt.itemsize) > ck.SMEM_LIMIT:
                continue
            for C3 in WIDTHS:
                for N in (1024, 0):
                    plan = ck.sa_plan(C1, C2, C3, K, 512, dt, N)
                    assert plan.smem <= ck.SMEM_LIMIT
                    if dt == torch.float32:
                        _check_f32_plan(plan, C1, C2, C3, K, N)
                    elif plan.producers == 0:
                        assert plan.smem == _first_design_smem(K, C1, C2, 2)
                    else:
                        assert plan.St * K <= plan.rows
                taken += 1
    assert taken > 0


@pytest.mark.parametrize("fits,widths", [
    (True, (128, 196, 256, 128)), (True, (16, 16, 32, 16)),
    (True, (256, 256, 512, 32)), (True, (256, 384, 512, 32)),
    (False, (1024, 1024, 64, 32))])
def test_f32_plan_and_refusal(monkeypatch, fits, widths):
    """f32 at config 3's (128,196,256) and the sem-seg MSG sa1 (16,16,32),
    and at the sa4 blocks, whose first-design tile did not fit: a plan
    within the limit, and both wrappers launch once under it with the
    twin's result. A width no plan holds ((1024,1024,64): one A stage of
    64 rows alone is 278 KB) is refused by both wrappers with a ValueError
    naming the limit, before any launch."""
    C1, C2, C3, K = widths
    targs = _inputs(3, 1, 256, 16, C1, C2, C3, torch.float32)
    idx = tops.knn_point(K, targs[0], targs[1])
    k = fake_kernels(monkeypatch)
    if not fits:
        with pytest.raises(ValueError, match="232448"):
            ck.sa_plan(C1, C2, C3, K, 16, torch.float32)
        with pytest.raises(ValueError, match="232448"):
            tops.fused_sa(0.8, K, *targs)
        with pytest.raises(ValueError, match="232448"):
            tops.fused_sa_idx(K, idx, *targs[2:])
        assert k.fused_sa.launches == 0 and k.fused_sa_idx.launches == 0
        return
    got = (tops.fused_sa(0.8, K, *targs),
           tops.fused_sa_idx(K, idx, *targs[2:]))
    assert k.fused_sa.launches == 1 and k.fused_sa_idx.launches == 1
    assert k.fused_sa.f32_launches == 1 and k.fused_sa_idx.f32_launches == 1
    for n, args in zip((256, 0), k._launch.plans):
        plan = ck.sa_plan(C1, C2, C3, K, 16, torch.float32, n)
        _check_f32_plan(plan, C1, C2, C3, K, n)
        assert tuple(args) == _plan_args(plan, ball=n > 0)
    want = (tops.fused_sa_torch(0.8, K, *targs),
            tops.fused_sa_idx_torch(K, idx, *targs[2:]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def _plan_args(plan, ball):
    """A plan's launch arguments: St, rows, resident, (the ball-query
    form) xyz_smem, producers, stages, smem."""
    return ((plan.St, plan.rows, int(plan.resident))
            + ((int(plan.xyz_smem),) if ball else ())
            + (plan.producers, plan.stages, plan.smem))


@pytest.mark.parametrize("C1,C2,C3,K,radius,loop", [
    (128, 196, 256, 128, 1.5, False),  # config 3's sa2
    (256, 384, 512, 32, 0.8, False),   # PointNet2SemSegMSG's sa4, streamed
    (32, 640, 64, 32, 0.8, True),      # C2 too wide for the wgmma kernel
])
def test_kernel_path_at_wide_widths(monkeypatch, C1, C2, C3, K, radius,
                                    loop):
    """The wrappers' kernel path (``fake_kernels``) in bf16: one launch
    each, unpadded operands, a plan within the limit on the kernel the
    planner names, the twin's result."""
    targs = _inputs(5, 1, 256, 8, C1, C2, C3)
    idx = tops.knn_point(K, targs[0], targs[1])
    want = (tops.fused_sa_torch(radius, K, *targs),
            tops.fused_sa_idx_torch(K, idx, *targs[2:]))
    k = fake_kernels(monkeypatch)
    got = (tops.fused_sa(radius, K, *targs),
           tops.fused_sa_idx(K, idx, *targs[2:]))
    assert k.fused_sa.launches == 1 and k.fused_sa_idx.launches == 1
    assert k.fused_sa.f32_launches == 0 == k.fused_sa_idx.f32_launches
    assert [p == 0 for p in k._launch.producers] == [loop, loop]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------ a whole model, f32 form


@pytest.mark.parametrize("mode", ["fp32-forced", "bf16-sa_bn"])
def test_semseg_serves_through_the_f32_form(mode, monkeypatch):
    """pointnet2_sem_seg served on the kernel path (``fake_kernels``) with
    every SA block on the fused kernel's f32 form, sa4's (256,256,512)
    included: fp32 with the kernels forced (``use_impl("cuda")``), and
    bf16 under ``MM3D_BF16_DEBUG=sa_bn`` (set before the model is built),
    where ``pre * A`` promotes to f32. Both raised a ValueError at sa4 while
    the f32 form kept the first design's layout. Four fused SA launches a
    forward, all f32 (flag 0), under f32 plans. fp32: within 1e-4 of the
    port's plain path (unfused) and of JAX's eval (pure mode) on the same
    weights. bf16: the port's plain path (the twins) within 1e-5, and JAX's
    bf16 model under the same knob in its Pallas mode (interpret), whose
    fused tail keys its form on pre's dtype too: argmax agreement 1.0 and
    log-probs within 2^-4, the gates of ``test_torch_bf16_debug``."""
    from test_torch_fusion_semseg import _apply, _init, _np_tree
    import jax.numpy as jnp
    from mm3d_tpu.models import get_model as jax_get_model
    from mm3d_tpu_torch.models import get_model
    from mm3d_tpu_torch.training import make_predictor
    from mm3d_tpu_torch.utils import load_jax_variables

    name, ncls = "pointnet2_sem_seg", 13
    r = np.random.RandomState(21)
    xyz = r.rand(2, 512, 3).astype(np.float32)
    args = (np.concatenate([xyz, r.rand(2, 512, 3).astype(np.float32),
                            xyz / xyz.max(1, keepdims=True)], -1),)
    v = _init(jax_get_model(name).builder(num_class=ncls), args)
    state = load_jax_variables(get_model(name).builder(num_class=ncls),
                               _np_tree(v)).state_dict()
    fp32 = mode == "fp32-forced"
    if not fp32:
        monkeypatch.setenv("MM3D_BF16_DEBUG", "sa_bn")
    dtype = None if fp32 else torch.bfloat16
    pred = make_predictor(name, state, dtype=dtype, device="cpu",
                          num_class=ncls)
    x = torch.from_numpy(args[0])
    with dispatch.use_impl("torch"):
        plain = pred(x)
    k = fake_kernels(monkeypatch)
    launch, flags = ck._launch, []

    def record(symbol, *a):
        flags.append((symbol, a[0]))
        return launch(symbol, *a)

    monkeypatch.setattr(ck, "_launch", record)
    with dispatch.use_impl("cuda" if fp32 else "auto"):
        got = pred(x)
    assert k.fused_sa.launches == 4 == k.fused_sa.f32_launches
    assert k.fused_fp.launches == 4
    assert {f for s, f in flags if s == "mm3d_fused_sa"} == {0}
    # f32 plans: two producer warpgroups, sa4's 64-row blocks
    assert launch.producers == [2] * 4
    assert [args[1] for args in launch.plans] == [128, 128, 128, 64]
    got, plain = got.numpy(), plain.numpy()
    if fp32:
        want, _ = _apply(jax_get_model(name).builder(num_class=ncls), v,
                         args, "jax")
        assert np.abs(got - plain).max() <= 1e-4
        assert np.abs(got - want).max() <= 1e-4
        return
    want, _ = _apply(jax_get_model(name).builder(
        num_class=ncls, dtype=jnp.bfloat16), v, args, "pallas")
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).mean() == 1.0
    assert np.abs(got - want).max() <= 2.0 ** -4
