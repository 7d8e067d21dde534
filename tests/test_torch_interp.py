"""The wrappers of the two byte-bound forwards, three_interpolate
(``csrc/three_interp.cu``) and the bilinear sampling (``csrc/bilinear.cu``),
on the CPU, without JAX.

Their kernel path runs through ``test_torch_fused_sa.fake_kernels`` (the
plain twins in place of the launches): the weights reach the launch in the
dtype the caller gave, and a shape the kernels' grid cannot index (a batch
past the grid's y axis, 32-bit offsets inside a cloud or map) is refused
before anything is allocated. The twins are held to the Pallas kernels in
tests/test_torch_ops.py; the kernels run only on the card, where
chip_smoke.py holds them to the twins bit for bit.
"""

import numpy as np
import pytest
import torch

from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.utils import sample_phases
from tests.test_torch_fused_sa import fake_kernels


def _interp_operands(seed, B=2, M=7, N=33, C=24):
    r = np.random.RandomState(seed)
    pts = torch.from_numpy(r.randn(B, M, C).astype(np.float32))
    idx = torch.from_numpy(r.randint(0, M, (B, N, 3)).astype(np.int32))
    w = r.rand(B, N, 3) + 1e-3
    w = torch.from_numpy((w / w.sum(-1, keepdims=True)).astype(np.float32))
    return pts, idx, w


@pytest.mark.parametrize("points_dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weight_dt", [torch.bfloat16, torch.float32])
def test_three_interpolate_takes_the_weights_uncast(monkeypatch, points_dt,
                                                    weight_dt):
    """The weight tensor reaches the one launch as the caller gave it (no
    cast ahead of the kernel, its dtype flagged), with the twin's result;
    and f32 weights give the result of the same weights rounded to the
    points' dtype first (the twin, and the kernel, round them itself)."""
    pts, idx, w = _interp_operands(3)
    pts, wt = pts.to(points_dt), w.to(weight_dt)
    want = tops.three_interpolate_torch(pts, idx, wt)
    ck = fake_kernels(monkeypatch)
    got = tops.three_interpolate(pts, idx, wt)
    assert ck.three_interpolate.launches == 1
    assert len(ck._launch.weights) == 1 and ck._launch.weights[0] is wt
    assert got.dtype == points_dt and torch.equal(got, want)
    if weight_dt == torch.float32:
        assert torch.equal(got, tops.three_interpolate_torch(
            pts, idx, w.to(points_dt)))


def test_three_interpolate_refuses_weights_it_does_not_take(monkeypatch):
    pts, idx, w = _interp_operands(4)
    ck = fake_kernels(monkeypatch)
    for bad in (w.double(), w.half(), (w * 100).to(torch.int32)):
        with pytest.raises(TypeError, match="bf16 or f32 weights"):
            tops.three_interpolate(pts, idx, bad)
    assert ck.three_interpolate.launches == 0


def _stride0(dtype, *shape):
    """A tensor of ``shape`` that holds one element (every stride 0)."""
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


@pytest.mark.parametrize("B,M,N,C,what", [
    (65536, 4, 2, 8, "batch 65536"), (2, 2 ** 24, 4, 128, "M\\*C"),
    (2, 4, 2 ** 24, 128, "N\\*max"), (2, 4, 2 ** 30, 1, "N\\*max")])
def test_three_interpolate_refuses_unindexable_shapes(monkeypatch, B, M, N,
                                                      C, what):
    """More clouds than the grid's y axis takes (65,535) or a product of
    extents that reaches 2^31 (the kernel's 32-bit offsets in a cloud: M*C
    of the sparse rows, N*C of the output, 3N of the indices) raises before
    any allocation."""
    ck = fake_kernels(monkeypatch)
    pts = _stride0(torch.bfloat16, B, M, C)
    idx = _stride0(torch.int32, B, N, 3)
    w = _stride0(torch.float32, B, N, 3)
    with pytest.raises(ValueError, match=what):
        tops.three_interpolate(pts, idx, w)
    assert ck.three_interpolate.launches == 0


@pytest.mark.parametrize("B,H,W,N,C,what", [
    (65536, 2, 2, 3, 8, "batch 65536"), (2, 4096, 4096, 3, 128, "H\\*W\\*C"),
    (2, 2, 2, 2 ** 24, 128, "N\\*max"), (2, 2, 2, 2 ** 30, 2, "N\\*max")])
def test_bilinear_sample_refuses_unindexable_shapes(monkeypatch, B, H, W, N,
                                                    C, what):
    """The sampling's grid: the same batch limit, and H*W*C (offsets in a
    map), N*C (the output) and 2N (the coordinates) below 2^31."""
    ck = fake_kernels(monkeypatch)
    feat = _stride0(torch.float32, B, H, W, C)
    uv = _stride0(torch.float32, B, N, 2)
    with pytest.raises(ValueError, match=what):
        tops.bilinear_sample(feat, uv)
    assert ck.bilinear_sample.launches == 0


def test_bilinear_sample_kernel_path_at_the_grid_limit(monkeypatch):
    """A batch of exactly the grid's y limit is taken (stride-0 operands:
    the twin runs in the fake launch on a small map)."""
    ck = fake_kernels(monkeypatch)
    feat = _stride0(torch.float32, 65535, 2, 2, 4)
    uv = torch.full((65535, 1, 2), 0.5)
    out = tops.bilinear_sample(feat, uv)
    assert out.shape == (65535, 1, 4) and ck.bilinear_sample.launches == 1


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119three_interp_kernelIfLi4EEEvPKT_PKiPKfPS1_i
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x0 */
                                                             /* 0x0 */
        /*0010*/                   S2R R0, SR_TID.X ;         /* 0x0 */
        /*0020*/              @P0 EXIT ;                      /* 0x0 */
        /*0030*/                   CALL.REL.NOINC 0x60 ;      /* 0x0 */
        /*0040*/                   EXIT ;                     /* 0x0 */
        /*0050*/                   BRA 0x50;                  /* 0x0 */
        /*0060*/                   IADD3 R0, R0, 0x1, RZ ;    /* 0x0 */
        /*0070*/                   RET.REL.NODEC R2 0x0 ;     /* 0x0 */
        /*0080*/                   NOP;                       /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_115bilinear_kernelIfLi4EEEvPKT_i
        /*0000*/                   S2R R0, SR_TID.X ;         /* 0x0 */
        /*0010*/                   EXIT ;                     /* 0x0 */
        /*0020*/                   BRA 0x20;                  /* 0x0 */
"""


def test_sample_phases_counts_sass_by_kernel(monkeypatch):
    """``sass_counts`` splits each kernel function of ``cuobjdump -sass``
    into its instructions up to the last EXIT (NOPs left out), those after
    it but the closing branch (the subroutines it calls) and its CALLs."""
    from types import SimpleNamespace

    monkeypatch.setattr(sample_phases.shutil, "which", lambda exe: __file__)
    monkeypatch.setattr(sample_phases.subprocess, "run",
                        lambda *a, **k: SimpleNamespace(stdout=SASS))
    counts = sample_phases.sass_counts("lib.so")
    assert counts == {
        "_ZN12_GLOBAL__N_119three_interp_kernelIfLi4EEEvPKT_PKiPKfPS1_i":
            {"body": 5, "after": 2, "calls": 1},
        "_ZN12_GLOBAL__N_115bilinear_kernelIfLi4EEEvPKT_i":
            {"body": 2, "after": 0, "calls": 0}}

