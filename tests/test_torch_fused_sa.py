"""The fused SA tail's tile plan and kernel path, on the CPU, without JAX.

``cuda_kernels.sa_plan`` cuts each fused SA launch for the H100 kernels
(``csrc/fused_sa.cu``): tile rows, centroids a tile, resident or streamed
weights, producer warpgroups (0: the loop kernel) and the
shared-memory bytes. It is checked here at every (C1, C2, C3, K) that the
JAX models route to the fused tail in bf16 eval, and against the loop
layout of the first design, which took every width whose tile fitted. The
wrappers' kernel path runs through ``fake_kernels`` (the plain twins in
place of the launches). The twins themselves are held to the Pallas kernels
in tests/test_torch_ops.py and tests/test_torch_knn.py; the kernels run
only on the card, where chip_smoke.py holds them to the twins.
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
            K, smem = a[13 - given], a[22 - 2 * given]
            assert smem <= ck.SMEM_LIMIT
            launch.producers.append(a[21 - 2 * given])
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [1, 16, 20, 32, 48, 64, 96, 128, 129, 200,
                               256, 300, 512])
def test_sa_plan_takes_what_the_first_design_took(K, dtype):
    """Every width the first design ran (its block within the limit) still
    has a plan, in both forms: the wgmma kernel's where it fits, else the
    loop kernel, whose bytes are the first design's."""
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
                    if dt == torch.float32 or plan.producers == 0:
                        assert plan.producers == 0 and plan.smem == (
                            _first_design_smem(K, C1, C2, dt.itemsize))
                    else:
                        assert plan.St * K <= plan.rows
                taken += 1
    assert taken > 0


@pytest.mark.parametrize("fits,widths", [
    (True, (128, 196, 256, 128)), (True, (16, 16, 32, 16)),
    (False, (256, 256, 512, 32)), (False, (256, 384, 512, 32))])
def test_f32_plan_and_refusal(monkeypatch, fits, widths):
    """f32 keeps the first design's layout: the (128,196,256) and
    (16,16,32) blocks fit; the sa4 blocks do not, and both wrappers refuse
    them with a ValueError naming the limit, before any launch."""
    C1, C2, C3, K = widths
    if fits:
        assert ck.sa_plan(C1, C2, C3, K, 64, torch.float32).smem <= 232448
        return
    with pytest.raises(ValueError, match="232448"):
        ck.sa_plan(C1, C2, C3, K, 64, torch.float32)
    targs = _inputs(3, 1, 64, 4, C1, C2, C3, torch.float32)
    idx = torch.zeros(1, 4, K, dtype=torch.int32)
    k = fake_kernels(monkeypatch)
    with pytest.raises(ValueError, match="232448"):
        tops.fused_sa(0.8, K, *targs)
    with pytest.raises(ValueError, match="232448"):
        tops.fused_sa_idx(K, idx, *targs[2:])
    assert k.fused_sa.launches == 0 and k.fused_sa_idx.launches == 0


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
    assert [p == 0 for p in k._launch.producers] == [loop, loop]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
