"""The 3-NN twins against the JAX package, on CPU, at the cases that
``chip_smoke.py`` phase 2 holds the H100 kernels to, and the kernels'
launch plan.

``three_nn_torch`` and ``fused_fp_torch`` are what the three_nn and fused FP
kernels (``csrc/three_nn.cu``, ``csrc/fused_fp.cu`` and the selection they
share, ``csrc/three_nn.cuh``) are held to on the card: three_nn bit for bit,
the fused tail within its bounds. Here the same numpy inputs go through the
JAX package's pure function (``_three_nn_jax``) and its Pallas kernels in
interpret mode (``three_nn_pallas``, ``fused_fp_pallas``), and through the
port's twins and entry points, at the edges of the kernels' design: M = 3,
M one either side of multiples of the lanes a point times the eight
candidates a lane computes ahead, ragged N, ties whose equal distances fall
in different lanes, a third and fourth neighbour at equal distance, every
sparse point the same point, and widths off the 16-byte path. Coordinates
are on the 1/16 grid, where every distance is exact in f32 whatever the
order of its sums, so indices and distances must be equal.
"""

import os
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3d_tpu.ops import geometry as G
from mm3d_tpu.ops import pallas_kernels as pk
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.ops import _build
from mm3d_tpu_torch.ops import cuda_kernels as ck

from test_torch_fused_sa import fake_kernels


def _grid(r, B, N, lo=-32, hi=33):
    return (r.randint(lo, hi, (B, N, 3)) / 16).astype(np.float32)


def _case(name):
    """(xyz1, xyz2) of a named edge case, on the 1/16 grid."""
    r = np.random.RandomState(zlib.crc32(name.encode()))
    kind, _, arg = name.partition("=")
    if kind == "M":  # M sparse points, N = 40 dense
        return _grid(r, 2, 40), _grid(r, 2, int(arg))
    if kind == "N":  # ragged N dense points, M = 37
        return _grid(r, 2, int(arg)), _grid(r, 2, 37)
    if kind == "dup":  # a sparse point at indices j, j + 1, a dense point on it
        j = int(arg)
        x1, x2 = _grid(r, 2, 50), _grid(r, 2, 64)
        x2[:, j + 1] = x2[:, j]
        x1[:, 0] = x2[:, j]
        return x1, x2
    if kind == "third_fourth":
        # dense point 0 at the origin: neighbours 4 (d2 1/16), 9 (1/4), then
        # 13 and 14 both at 9/16; every other sparse point >= 1.5 out
        x2 = (r.randint(24, 33, (2, 64, 3)) * r.choice([-1, 1], (2, 64, 3))
              / 16).astype(np.float32)
        x2[:, 4], x2[:, 9] = (0.25, 0, 0), (0, 0.5, 0)
        x2[:, 13], x2[:, 14] = (0.75, 0, 0), (0, -0.75, 0)
        x1 = _grid(r, 2, 50)
        x1[:, 0] = 0
        return x1, x2
    if kind == "one_point":  # every sparse point the same point
        return _grid(r, 2, 50), np.repeat(_grid(r, 2, 1), int(arg), axis=1)
    raise ValueError(name)


# M around multiples of G x 8 (G = 1, 2, 4, 8, 16 lanes a point, 8
# candidates a step), every remainder at G = 1, M = 3 the fewest and 2,048
# the most; N ragged against the point tiles
CASES = (["M=3", "M=4", "M=5", "M=6", "M=7", "M=9", "M=10", "M=11", "M=15",
          "M=17", "M=31", "M=33", "M=63", "M=65", "M=127", "M=129", "M=2047",
          "M=2048", "N=33", "N=47", "N=130", "dup=3", "dup=10", "dup=31",
          "third_fourth", "one_point=3", "one_point=64"])


def _three_nn_all(x1, x2):
    """(d, idx) of the JAX function, the Pallas kernel and the port's twin
    and entry point, as numpy."""
    jd, ji = G._three_nn_jax(jnp.asarray(x1), jnp.asarray(x2))
    pd, pi = pk.three_nn_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                interpret=True)
    td, ti = tops.three_nn_torch(torch.from_numpy(x1), torch.from_numpy(x2))
    wd, wi = tops.three_nn(torch.from_numpy(x1), torch.from_numpy(x2))
    return [(np.asarray(d), np.asarray(i)) for d, i in
            ((jd, ji), (pd, pi), (td, ti), (wd, wi))]


@pytest.mark.parametrize("case", CASES)
def test_three_nn_edges_exact(case):
    x1, x2 = _case(case)
    (jd, ji), *rest = _three_nn_all(x1, x2)
    assert ji.shape == (x1.shape[0], x1.shape[1], 3)
    for d, i in rest:
        assert i.dtype == np.int32
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(d, jd)
    if case.startswith("one_point"):
        np.testing.assert_array_equal(ji, np.broadcast_to([0, 1, 2],
                                                          ji.shape))
    if case == "third_fourth":
        np.testing.assert_array_equal(ji[:, 0], [[4, 9, 13]] * 2)
    if case.startswith("dup"):
        j = int(case.partition("=")[2])
        np.testing.assert_array_equal(ji[:, 0, :2], [[j, j + 1]] * 2)


def _fp_args(x1, x2, C, seed=0):
    r = np.random.RandomState(seed)
    return (x1, x2, r.randn(x1.shape[0], x2.shape[1], C).astype(np.float32),
            r.randn(x1.shape[0], x1.shape[1], C).astype(np.float32))


def _fused_check(args, dt, tol):
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    x1, x2, pre, skip = args
    want = np.asarray(pk.fused_fp_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(pre).astype(jdt),
        jnp.asarray(skip).astype(jdt), interpret=True), np.float32)
    targs = (torch.from_numpy(x1), torch.from_numpy(x2),
             torch.from_numpy(pre).to(dt), torch.from_numpy(skip).to(dt))
    got = tops.fused_fp_torch(*targs)
    wrapped = tops.fused_fp(*targs)
    assert got.dtype == dt and got.shape == want.shape
    assert torch.equal(wrapped, got)
    scale = max(np.abs(want).max(), 1e-9)
    err = np.abs(got.float().numpy() - want).max() / scale
    assert err < tol, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,C", [(c, 128) for c in CASES if c not in (
    "M=2047", "M=2048")] + [("M=2048", 24), ("N=33", 24), ("M=9", 18),
                           ("dup=31", 18), ("N=130", 18)])
def test_fused_fp_edges(case, C, dtype):
    """The fused tail on the grid: 1e-6 of max|ref| in f32 (exact distances
    on both sides, tests/test_fused_fp.py's bound), 2e-2 in bf16
    (tests/test_fused_fp.py:71). C = 24 takes three or six 16-byte moves a
    row, C = 18 is not a whole number of them (the scalar path)."""
    dt = getattr(torch, dtype)
    _fused_check(_fp_args(*_case(case), C), dt,
                 1e-6 if dt == torch.float32 else 2e-2)


@pytest.mark.parametrize("B,N,M,C", [(2, 200, 64, 64), (1, 130, 96, 24)])
def test_fused_fp_random_f32(B, N, M, C):
    """Random coordinates: XLA's dot and the port's ordered sums round d2 a
    few ulps of |x|^2 apart, which 1/(d2 + 1e-8) turns into ~1e-5 of a
    weight at the smallest distances (tests/test_torch_ops.py's bound)."""
    r = np.random.RandomState(B * N + M)
    x1, x2 = (r.randn(B, n, 3).astype(np.float32) for n in (N, M))
    _fused_check(_fp_args(x1, x2, C, seed=1), torch.float32, 1e-5)


# ------------------------------------------------------------ launch plan

# (B, N, M, C) of the paths that run each kernel: three_nn in the
# fusion_sem_seg train step (B=24); the fused tail in serving (B=16) and in
# the trainer's eval forward (B=24)
THREE_NN_SHAPES = [(24, 256, 64), (24, 2048, 256)]
FUSED_FP_SHAPES = [(16, 256, 64, 256), (16, 2048, 256, 128),
                   (24, 256, 64, 256), (24, 2048, 256, 128)]


def _max_sparse(name):
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        return int(re.search(r"kMaxSparse = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("B,N,M", THREE_NN_SHAPES)
def test_three_nn_plan_fills_the_card(B, N, M):
    lanes = ck.nn_lanes(B, N, threads=128)
    assert lanes in ck.NN_LANES
    assert B * -(-N // (128 // lanes)) >= 132
    assert M * 16 <= 48 * 1024  # the sparse cloud, static launch limit


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,M,C", FUSED_FP_SHAPES)
def test_fused_fp_plan_fills_the_card(B, N, M, C, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    plan = ck.fp_plan(B, N, M, C, es, 1, threads=256)
    assert plan.lanes in ck.NN_LANES and plan.mode in (1, 2)
    assert B * -(-N // (256 // plan.lanes)) >= 132
    tile = 256 // plan.lanes * C * es
    assert tile <= ck.FP_SKIP_TILE_BYTES
    assert plan.smem == (M * 16 + tile
                         + (M * C * es if plan.mode == 2 else 0))
    assert plan.smem <= ck.SMEM_LIMIT
    # the largest cloud the kernel takes still fits beside the tile
    big = ck.fp_plan(B, N, _max_sparse("fused_fp"), C, es, 1, threads=256)
    assert big.mode == 1 and big.smem <= ck.SMEM_LIMIT


def test_fused_fp_plan_modes():
    """The pre rows go to shared memory where sparse cloud, skip tile and
    pre fit in FP_PRE_SMEM_BYTES (bf16 FP1, both FP2s); unaligned operands or C off the 16-byte grid take the scalar
    path (no tile); a tile too wide for FP_SKIP_TILE_BYTES raises the
    lanes, and past 16 lanes the scalar path takes it."""
    assert ck.fp_plan(16, 2048, 256, 128, 2, 1) == (2, 2, 102400)
    assert ck.fp_plan(16, 2048, 256, 128, 4, 1) == (2, 1, 69632)
    assert ck.fp_plan(16, 256, 64, 256, 4, 1) == (16, 2, 1024 + 16384 + 65536)
    assert ck.fp_plan(16, 256, 64, 256, 2, 1).mode == 2
    assert ck.fp_plan(16, 2048, 256, 128, 2, 0) == (2, 0, 256 * 16)
    assert ck.fp_plan(16, 2048, 256, 18, 4, 1).mode == 0
    wide = ck.fp_plan(16, 2048, 256, 512, 4, 1)
    assert wide.mode == 1 and wide.lanes == 8
    assert 256 // wide.lanes * 512 * 4 <= ck.FP_SKIP_TILE_BYTES
    assert ck.fp_plan(16, 2048, 256, 8192, 4, 1).mode == 0


def test_nn_lanes_smallest_filling_grid():
    assert [ck.nn_lanes(24, n) for n in (2048, 1024, 600, 300, 256, 33)] == [
        1, 1, 2, 4, 4, 16]
    assert ck.nn_lanes(2, 33) == 16 and ck.nn_lanes(1, 10 ** 6) == 1
    assert ck.nn_lanes(24, 600, threads=64) == 1
    assert ck.nn_lanes(16, 256, threads=256) == 16


@pytest.mark.parametrize("kernel", ["three_nn", "fused_fp"])
def test_wrappers_take_max_sparse_refuse_more(kernel, monkeypatch):
    """Both kernels take up to kMaxSparse >= 2,048 sparse points (the
    wrapper reads the limit from the library) and refuse more with a
    ValueError before any launch."""
    limit = _max_sparse(kernel)
    assert limit >= 2048
    fake_kernels(monkeypatch)
    threads = {"mm3d_three_nn_threads": 128, "mm3d_fused_fp_threads": 256}
    monkeypatch.setattr(ck, "_fn", lambda symbol: (
        lambda: threads.get(symbol, limit)))
    r = np.random.RandomState(0)
    x1 = torch.from_numpy(_grid(r, 1, 20))

    def call(M):
        x2 = torch.from_numpy(_grid(r, 1, M))
        if kernel == "three_nn":
            return (tops.three_nn(x1, x2),
                    tops.three_nn_torch(x1, x2))
        pre = torch.from_numpy(r.randn(1, M, 16).astype(np.float32))
        skip = torch.zeros(1, 20, 16)
        return (tops.fused_fp(x1, x2, pre, skip),
                ck.fused_fp_torch(x1, x2, pre, skip))

    got, want = call(limit)
    assert getattr(ck, kernel).launches == 1
    for a, b in zip(got if kernel == "three_nn" else [got],
                    want if kernel == "three_nn" else [want]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=f"at most {limit}"):
        call(limit + 1)
    assert getattr(ck, kernel).launches == 1


# ------------------------------------------- the 7-operation distance

def _dot3(a, b):
    f = np.float32
    return f(f(f(a[0] * b[0]) + f(a[1] * b[1])) + f(a[2] * b[2]))


def _dist8(x, s):
    """square_distance's rounding: (|x|^2 - 2 x.s) + |s|^2."""
    f = np.float32
    return f(f(_dot3(x, x) - f(f(2) * _dot3(x, s))) + _dot3(s, s))


def _dist7(x, s):
    """three_nn.cuh's mm3d_nn_dist_neg2: (|x|^2 + (-2 x).s) + |s|^2."""
    f = np.float32
    xn = [f(f(-2) * v) for v in x]
    return f(f(_dot3(x, x) + _dot3(xn, s)) + _dot3(s, s))


def _in_range(v):
    """three_nn.cuh's mm3d_nn_in_range: 0 or |v| in [2^-63, 2^62)."""
    u = int(np.float32(v).view(np.uint32)) & 0x7FFFFFFF
    return u == 0 or (u - 0x20000000) % 2 ** 32 < 0x3E800000


@pytest.mark.parametrize("kind", ["randn", "grid", "wide", "top", "bottom",
                                  "zeros"])
def test_seven_operation_distance_is_exact_in_range(kind):
    """Where every coordinate is in range, (-2x).s is -2 (x.s) exactly (no
    product subnormal, nothing overflows), so the kernels' 7-operation
    distance equals the twin's rounding bit for bit; the range test is
    exact at its edges."""
    r = np.random.RandomState(len(kind))
    f = np.float32
    assert _in_range(0.0) and _in_range(-0.0) and _in_range(2.0 ** -63)
    assert not _in_range(np.nextafter(f(2.0 ** -63), f(0)))
    assert _in_range(np.nextafter(f(2.0 ** 62), f(0)))
    assert not _in_range(2.0 ** 62)
    assert not (_in_range(np.inf) or _in_range(np.nan))
    n = 0
    with np.errstate(all="ignore"):
        for _ in range(3000):
            if kind == "randn":
                x, s = (r.randn(3).astype(f) for _ in range(2))
            elif kind == "grid":
                x, s = ((r.randint(-32, 33, 3) / 16).astype(f)
                        for _ in range(2))
            elif kind == "wide":
                x, s = ((r.randn(3) * 2.0 ** r.randint(-60, 60, 3)).astype(f)
                        for _ in range(2))
            elif kind == "top":
                x, s = ((r.choice([-1, 1], 3) * r.uniform(3e18, 4.6e18, 3))
                        .astype(f) for _ in range(2))
            elif kind == "bottom":
                x, s = ((r.choice([-1, 1], 3) * r.uniform(1.1e-19, 4e-19, 3))
                        .astype(f) for _ in range(2))
            else:
                x, s = (r.randint(-1, 2, 3).astype(f) for _ in range(2))
            if not all(_in_range(v) for v in (*x, *s)):
                continue
            n += 1
            assert _dist7(x, s).tobytes() == _dist8(x, s).tobytes(), (x, s)
    assert n > 1000


def test_seven_operation_distance_needs_the_range():
    """Outside the range the two roundings can differ: a product in the
    subnormal range rounds differently once doubled."""
    f = np.float32
    x = np.array([1.5 * 2.0 ** -75, 0, 0], f)
    s = np.array([2.0 ** -74, 0, 0], f)
    assert not _in_range(x[0])
    assert _dist7(x, s).tobytes() != _dist8(x, s).tobytes()
