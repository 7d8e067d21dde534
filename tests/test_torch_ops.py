"""The port's geometry ops and kernel twins against the JAX package, on CPU.

The same numpy inputs go through the JAX function (pure JAX, and the Pallas
kernel in interpret mode) and through its mm3d_tpu_torch counterpart. Index
outputs must be bit-exact; the fused SA tail must match within the tolerance
tests/test_fused_sa.py holds the Pallas kernel to. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
same plain twins there).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3d_tpu.ops import geometry as G
from mm3d_tpu.ops import pallas_kernels as pk
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.ops import _build, dispatch


def _cloud(seed, B, N, scale=1.0):
    return (np.random.RandomState(seed).randn(B, N, 3) * scale).astype(
        np.float32)


def fake_kernels(monkeypatch):
    """The kernel path of the wrappers, on the CPU: ``dispatch.resolve``
    answers 'cuda', and each launch runs the kernel's plain twin into the
    outputs the wrapper allocated (``_ptr`` hands the tensors through). The
    wrappers' checks, allocations and launch counts run as on the card."""
    from mm3d_tpu_torch.ops import cuda_kernels as ck
    monkeypatch.setattr(dispatch, "resolve", lambda t: "cuda")
    monkeypatch.setattr(ck, "_ptr", lambda t: t)
    monkeypatch.setattr(ck, "_stream", lambda t: None)
    monkeypatch.setattr(ck, "_fn", lambda symbol: (lambda: 1 << 20))

    def launch(symbol, *a):
        if symbol == "mm3d_three_nn":
            d, i = tops.three_nn_torch(a[0], a[1])
            a[2].copy_(d)
            a[3].copy_(i)
        elif symbol == "mm3d_three_interp":
            a[5].copy_(tops.three_interpolate_torch(a[2], a[3], a[4]))
        elif symbol == "mm3d_gather_bwd":
            a[5].copy_(tops.gather_backward_torch(a[1], a[2], a[8]))
        elif symbol == "mm3d_bilinear":
            a[4].copy_(tops.bilinear_sample_torch(a[2], a[3]))
        else:
            raise NotImplementedError(symbol)

    monkeypatch.setattr(ck, "_launch", launch)
    ck.reset_launches()
    return ck


# ------------------------------------------------------------------ FPS


@pytest.mark.parametrize("case", ["int_start", "batch_start", "ties", "n96"])
def test_fps_bit_exact(case):
    B, N, npoint, start = 3, 160, 48, 0
    xyz = _cloud(1, B, N)
    if case == "int_start":
        start = 7
    elif case == "batch_start":
        start = np.array([0, 55, 159], np.int32)
    elif case == "ties":
        # duplicated points: equal distances, first index must win
        xyz = np.concatenate([xyz[:, :40]] * 4, axis=1)
    else:
        N = 96
        xyz = xyz[:, :N].copy()
    want = np.asarray(G._fps_jax(jnp.asarray(xyz), npoint,
                                 start if isinstance(start, int)
                                 else jnp.asarray(start)))
    pal = np.asarray(pk.fps_pallas(jnp.asarray(xyz), npoint,
                                   start if isinstance(start, int)
                                   else jnp.asarray(start), interpret=True))
    t_start = start if isinstance(start, int) else torch.from_numpy(start)
    got = tops.fps_torch(torch.from_numpy(xyz), npoint, t_start)
    wrapped = tops.farthest_point_sample(torch.from_numpy(xyz), npoint,
                                         t_start)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pal)
    np.testing.assert_array_equal(wrapped.numpy(), want)


def test_fps_npoint_above_n():
    """npoint > N keeps going on the exhausted set (tests/test_logits_parity
    drives SA1 with N=128 and npoint=512)."""
    xyz = _cloud(2, 2, 128)
    want = np.asarray(G._fps_jax(jnp.asarray(xyz), 512))
    got = tops.fps_torch(torch.from_numpy(xyz), 512)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", [64, -1, torch.tensor([0, 64])])
def test_fps_rejects_start_outside_cloud(start):
    with pytest.raises(ValueError, match="outside"):
        tops.farthest_point_sample(torch.from_numpy(_cloud(2, 2, 64)), 8,
                                   start)


# ----------------------------------------------------------- ball query


@pytest.mark.parametrize("case", ["zero_hit", "k_above_n", "n_ragged"])
def test_ball_query_bit_exact(case):
    B, N, S, K, radius = 2, 128, 24, 16, 0.6
    xyz = _cloud(3, B, N)
    new_xyz = xyz[:, ::5][:, :S].copy()
    if case == "zero_hit":
        new_xyz[:, :3] = 50.0
    elif case == "k_above_n":
        N, K, radius = 40, 64, 1.5
        xyz = xyz[:, :N].copy()
    else:
        N = 100
        xyz = xyz[:, :N].copy()
    want = np.asarray(G._query_ball_jax(radius, K, jnp.asarray(xyz),
                                        jnp.asarray(new_xyz)))
    pal = np.asarray(pk.ball_query_v2_pallas(
        radius, K, jnp.asarray(xyz), jnp.asarray(new_xyz), interpret=True))
    got = tops.ball_query_torch(radius, K, torch.from_numpy(xyz),
                                torch.from_numpy(new_xyz))
    wrapped = tops.query_ball_point(radius, K, torch.from_numpy(xyz),
                                    torch.from_numpy(new_xyz))
    assert got.dtype == torch.int32 and got.shape == (B, S, K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pal)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    if case == "zero_hit":
        assert (got.numpy()[:, :3] == 0).all()


def test_square_distance_and_index_points():
    src, dst = _cloud(4, 2, 64), _cloud(5, 2, 48)
    want = np.asarray(G.square_distance(jnp.asarray(src), jnp.asarray(dst)))
    got = tops.square_distance(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    idx = np.random.RandomState(6).randint(0, 64, (2, 10, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.index_points(torch.from_numpy(src), torch.from_numpy(idx)).numpy(),
        np.asarray(G.index_points(jnp.asarray(src), jnp.asarray(idx))))


# ------------------------------------------------------------ fused SA


def _sa_inputs(seed, B, N, S, C1, C2, C3):
    """tests/test_fused_sa.py::_mk, as numpy."""
    r = np.random.RandomState(seed)
    xyz = (r.randn(B, N, 3) * 0.5).astype(np.float32)
    fidx = np.asarray(G._fps_jax(jnp.asarray(xyz), S))
    new_xyz = np.take_along_axis(xyz, fidx[..., None], axis=1)
    return (xyz, new_xyz,
            r.randn(B, N, C1).astype(np.float32),
            r.randn(B, S, C1).astype(np.float32),
            (r.randn(C1, C2) * 0.3).astype(np.float32),
            r.randn(C2).astype(np.float32),
            (r.randn(C2, C3) * 0.3).astype(np.float32),
            r.randn(C3).astype(np.float32))


@pytest.mark.parametrize("B,N,S,K,radius", [
    (2, 96, 24, 16, 0.4),
    (1, 128, 8, 8, 0.15),
    (2, 160, 40, 48, 1.5),
])
def test_fused_sa_torch_matches_pallas_fp32(B, N, S, K, radius):
    args = _sa_inputs(0, B, N, S, 24, 16, 40)
    want = np.asarray(pk.fused_sa_pallas(radius, K,
                                         *map(jnp.asarray, args),
                                         interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    got = tops.fused_sa_torch(radius, K, *targs)
    wrapped = tops.fused_sa(radius, K, *targs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_fused_sa_torch_zero_hit_centroid():
    """tests/test_fused_sa.py's zero-hit case: the empty row reads index 0."""
    args = list(_sa_inputs(1, 2, 96, 16, 12, 16, 24))
    args[1] = args[1].copy()
    args[1][:, 0] = 100.0
    want = np.asarray(pk.fused_sa_pallas(0.4, 8, *map(jnp.asarray, args),
                                         interpret=True))
    got = tops.fused_sa_torch(0.4, 8, *[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_sa_torch_bf16_close():
    args = _sa_inputs(2, 2, 128, 32, 24, 24, 32)
    want = np.asarray(pk.fused_sa_pallas(
        0.4, 16, *[jnp.asarray(a) if i < 2 else
                   jnp.asarray(a).astype(jnp.bfloat16)
                   for i, a in enumerate(args)], interpret=True), np.float32)
    targs = [torch.from_numpy(a) if i < 2 else
             torch.from_numpy(a).to(torch.bfloat16)
             for i, a in enumerate(args)]
    got = tops.fused_sa_torch(0.4, 16, *targs)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # the bound tests/test_fused_sa.py:75 holds the bf16 Pallas kernel to
    assert np.max(np.abs(got - want) / (np.abs(want) + 1)) < 0.05


# ------------------------------------------------------------- dispatch


def test_dispatch_modes():
    x = torch.zeros(1, 8, 3)
    assert dispatch.resolve(x) == "torch"  # auto on a CPU tensor
    with dispatch.use_impl("cuda"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tops.farthest_point_sample(x, 4)
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tops.query_ball_point(0.1, 4, x, x)
    with pytest.raises(ValueError):
        dispatch.set_impl("pallas")
    with pytest.raises(ValueError):
        with dispatch.use_impl("jax"):
            pass


def test_build_raises_without_nvcc(monkeypatch):
    """A missing compiler raises; nothing falls back to the plain twins."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_lib_path_tracks_sources(tmp_path, monkeypatch):
    """The built library's name changes when a source or header changes."""
    (tmp_path / "k.cu").write_text("// v1\n")
    (tmp_path / "h.cuh").write_text("// h1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build.lib_path("k")
    assert first == _build.lib_path("k")
    (tmp_path / "h.cuh").write_text("// h2\n")
    second = _build.lib_path("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    assert len({first, second, _build.lib_path("k")}) == 3


def test_dispatch_thread_override_and_global_default():
    seen = {}
    try:
        dispatch.set_impl("torch")
        with dispatch.use_impl("cuda"):
            t = threading.Thread(
                target=lambda: seen.setdefault("worker", dispatch.get_impl()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            assert dispatch.get_impl() == "cuda"
        assert dispatch.get_impl() == "torch"
    finally:
        dispatch.set_impl("auto")
    assert seen["worker"] == "torch"  # the process-wide default, not 'auto'


# ------------------------------------------------------ gather backward


@pytest.mark.parametrize("B,n,F,C,dtype", [
    (2, 100, (30, 4), 24, "float32"),   # n, C unaligned; duplicate idx
    (1, 256, (512,), 3, "float32"),     # xyz-style gather, many duplicates
    (2, 100, (30, 4), 24, "bfloat16"),
])
def test_gather_backward_torch_matches_pallas(B, n, F, C, dtype):
    """tests/test_gather_bwd.py's shapes plus bf16 g: the plain twin
    against gather_bwd_pallas in interpret mode."""
    r = np.random.RandomState(0)
    g = r.randn(B, *F, C).astype(np.float32)
    idx = r.randint(0, n, (B, *F)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pk.gather_bwd_pallas(jnp.asarray(g).astype(jdt), jnp.asarray(idx),
                                n, interpret=True)
    assert want.dtype == jdt
    tg = torch.from_numpy(g).to(tdt)
    got = tops.gather_backward_torch(tg, torch.from_numpy(idx), n)
    wrapped = tops.gather_backward(tg, torch.from_numpy(idx), n)
    assert got.dtype == tdt and got.shape == (B, n, C)
    # f32 sums in another order: test_gather_bwd.py's bound; bf16: both
    # round the same f32 sums, so they differ by at most one bf16 ulp
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(wrapped.float().numpy(),
                                  got.float().numpy())


def test_index_points_grad_matches_jax():
    """Gradients through the port's gather (backward: gather_backward) and
    through the JAX custom VJP, on the same cotangent."""
    r = np.random.RandomState(1)
    pts = r.randn(2, 64, 8).astype(np.float32)
    idx = r.randint(0, 64, (2, 16, 4)).astype(np.int32)
    co = r.randn(2, 16, 4, 8).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(G.index_points(p, jnp.asarray(idx))
                                      * jnp.asarray(co)))(jnp.asarray(pts))
    tp = torch.from_numpy(pts).requires_grad_(True)
    (tops.index_points(tp, torch.from_numpy(idx))
     * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_index_points_records_nothing_without_grad():
    """The xyz gathers (no gradient wanted) build no backward node."""
    pts = torch.zeros(1, 8, 3)
    idx = torch.zeros(1, 4, dtype=torch.int32)
    assert tops.index_points(pts, idx).grad_fn is None
    out = tops.index_points(pts.requires_grad_(True), idx)
    assert out.grad_fn is not None


def test_index_points_backward_keeps_the_forward_impl_mode():
    """autograd runs a CUDA backward on its own thread, which does not see
    the caller's use_impl: the backward takes the forward's mode."""
    pts = torch.zeros(1, 8, 3, requires_grad=True)
    idx = torch.zeros(1, 4, dtype=torch.int32)
    with dispatch.use_impl("cuda"):
        out = tops.index_points(pts, idx)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        out.sum().backward()


def test_gather_backward_rejects_bad_inputs():
    with dispatch.use_impl("cuda"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tops.gather_backward(torch.zeros(1, 4, 3),
                                 torch.zeros(1, 4, dtype=torch.int32), 8)


# -------------------------------------------------- three_nn / fused FP


def _fp_inputs(seed, B, N, M, C1, dup=False, grid=False):
    """tests/test_fused_fp.py's inputs, as numpy. ``dup``: its duplicate
    case (a sparse point repeated, a dense point exactly on it, zero skip);
    ``grid``: coordinates on the 1/16 grid, where (|s|^2 - 2 s.d) + |d|^2
    is exact in f32 whatever the order of its sums."""
    r = np.random.RandomState(seed)
    if grid:
        xyz1, xyz2 = (r.randint(-32, 33, (B, n, 3)).astype(np.float32) / 16
                      for n in (N, M))
    else:
        xyz1, xyz2 = (r.randn(B, n, 3).astype(np.float32) for n in (N, M))
    pre = r.randn(B, M, C1).astype(np.float32)
    skip = r.randn(B, N, C1).astype(np.float32)
    if dup:
        xyz2[0, 10] = xyz2[0, 3]
        xyz1[0, 0] = xyz2[0, 3]
        skip[:] = 0.0
    return xyz1, xyz2, pre, skip


@pytest.mark.parametrize("case", ["random", "duplicates", "grid_ties",
                                  "grid16"])
def test_three_nn_bit_exact(case):
    """The plain twin and the dispatching entry point (the kernel's
    contract) against _three_nn_jax and three_nn_pallas (interpret)."""
    if case == "random":
        xyz1, xyz2 = _cloud(7, 2, 96), _cloud(8, 2, 40)
    elif case == "duplicates":
        xyz1, xyz2, _, _ = _fp_inputs(1, 1, 64, 32, 4, dup=True)
    elif case == "grid16":
        # the 1/16 grid: exact distances, full of ties
        xyz1, xyz2, _, _ = _fp_inputs(4, 2, 80, 40, 4, grid=True)
    else:
        # integer lattice: many exactly equal distances, ties to the lower
        # index
        g = np.random.RandomState(9)
        xyz2 = g.randint(-2, 3, (2, 48, 3)).astype(np.float32)
        xyz1 = g.randint(-2, 3, (2, 64, 3)).astype(np.float32)
    wd, wi = map(np.asarray, G._three_nn_jax(jnp.asarray(xyz1),
                                             jnp.asarray(xyz2)))
    pd, pi = map(np.asarray, pk.three_nn_pallas(
        jnp.asarray(xyz1), jnp.asarray(xyz2), interpret=True))
    d, idx = tops.three_nn_torch(torch.from_numpy(xyz1),
                                 torch.from_numpy(xyz2))
    wd2, wi2 = tops.three_nn(torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    np.testing.assert_array_equal(wi2.numpy(), idx.numpy())
    np.testing.assert_array_equal(wd2.numpy(), d.numpy())
    assert idx.dtype == torch.int32 and idx.shape == xyz1.shape
    np.testing.assert_array_equal(idx.numpy(), wi)
    np.testing.assert_array_equal(idx.numpy(), pi)
    np.testing.assert_allclose(d.numpy(), wd, rtol=0, atol=1e-6)
    # the Pallas kernel's distances come from one MXU product, which rounds
    # the cross term differently (tests/test_pallas_kernels.py's bound)
    np.testing.assert_allclose(d.numpy(), pd, rtol=1e-5, atol=1e-5)


def test_interpolation_weights_and_three_interpolate_match_jax():
    xyz1, xyz2, pre, _ = _fp_inputs(2, 2, 80, 24, 12)
    d, idx = G._three_nn_jax(jnp.asarray(xyz1), jnp.asarray(xyz2))
    w = G.interpolation_weights(d)
    want = np.asarray(G._three_interpolate_jax(jnp.asarray(pre), idx, w))
    tw = tops.interpolation_weights(torch.from_numpy(np.array(d)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=1e-6)
    got = tops.three_interpolate_torch(
        torch.from_numpy(pre), torch.from_numpy(np.array(idx)), tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _interp_inputs(seed, B=2, N=90, M=24, C=20, dup=False):
    """Features, 3-NN indices and weights of random clouds; ``dup`` repeats
    a sparse point so one dense point has two equal neighbours."""
    xyz1, xyz2, pre, _ = _fp_inputs(seed, B, N, M, C, dup=dup)
    d, idx = G._three_nn_jax(jnp.asarray(xyz1), jnp.asarray(xyz2))
    w = np.array(G.interpolation_weights(d))
    return pre, np.array(idx), w


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dup", [False, True])
def test_three_interpolate_matches_pallas(dtype, dup):
    """The twin and the dispatching entry point against
    three_interpolate_pallas_raw (interpret): f32 within 1e-6 of max|ref|
    (its 3-term bf16 split is ~1e-7 relative), bf16 within one bf16 ulp
    (both round bf16 products summed in f32 once; only the order of the f32
    sum differs)."""
    pre, idx, w = _interp_inputs(5, dup=dup)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(pk.three_interpolate_pallas_raw(
        jnp.asarray(pre).astype(jdt), jnp.asarray(idx),
        jnp.asarray(w).astype(jdt), interpret=True).astype(jnp.float32))
    tp = torch.from_numpy(pre).to(tdt)
    args = (tp, torch.from_numpy(idx), torch.from_numpy(w).to(tdt))
    got = tops.three_interpolate_torch(*args)
    assert got.dtype == tdt and got.shape == (2, 90, 20)
    np.testing.assert_array_equal(tops.three_interpolate(*args).float().numpy(),
                                  got.float().numpy())
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_interpolate_vjp_matches_jax(dtype):
    """d_points (through gather_backward) and d_weight of the port's
    autograd Function against jax.vjp of three_interpolate_pallas, on the
    same cotangent. f32: 1e-5 of each cotangent's max (sums in other
    orders); bf16: 2e-2 (JAX rounds every product and scatter-add to bf16,
    the port sums in f32 and rounds once)."""
    pre, idx, w = _interp_inputs(6, dup=True)
    co = np.random.RandomState(7).randn(2, 90, 20).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda p, ww: pk.three_interpolate_pallas(
        p, jnp.asarray(idx), ww), jnp.asarray(pre).astype(jdt),
        jnp.asarray(w).astype(jdt))
    wp, ww = vjp(jnp.asarray(co).astype(jdt))
    tp = torch.from_numpy(pre).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    out = tops.three_interpolate(tp, torch.from_numpy(idx), tw)
    assert out.dtype == tdt and out.grad_fn is not None
    out.backward(torch.from_numpy(co).to(tdt))
    rel = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((tp.grad, wp), (tw.grad, ww)):
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= rel * np.abs(want).max(), err


def test_three_interpolate_kernel_path_launches(monkeypatch):
    """On the kernel path the forward launches the three_interpolate kernel
    once and the backward the gather-backward kernel once (no d_weight
    wanted, as in the model); the result equals the plain path's."""
    pre, idx, w = _interp_inputs(8)
    co = torch.from_numpy(np.random.RandomState(9).randn(2, 90, 20)
                          .astype(np.float32))
    plain_p = torch.from_numpy(pre).requires_grad_(True)
    with dispatch.use_impl("torch"):
        want = tops.three_interpolate(plain_p, torch.from_numpy(idx),
                                      torch.from_numpy(w))
        want.backward(co)
    ck = fake_kernels(monkeypatch)
    tp = torch.from_numpy(pre).requires_grad_(True)
    got = tops.three_interpolate(tp, torch.from_numpy(idx),
                                 torch.from_numpy(w))
    got.backward(co)
    assert (ck.three_interpolate.launches, ck.gather_backward.launches) == (
        1, 1)
    assert torch.equal(got, want) and torch.equal(tp.grad, plain_p.grad)
    with pytest.raises(TypeError, match="int32"):
        tops.three_interpolate(tp, torch.from_numpy(idx).long(),
                               torch.from_numpy(w))
    with pytest.raises(TypeError, match="bf16 or f32"):
        tops.three_interpolate(tp.double(), torch.from_numpy(idx),
                               torch.from_numpy(w))


def test_three_nn_kernel_path_checks(monkeypatch):
    """On the kernel path three_nn launches its kernel once per call and
    refuses fewer than 3 sparse points, another batch size or f64."""
    ck = fake_kernels(monkeypatch)
    xyz1, xyz2 = map(torch.from_numpy, (_cloud(1, 2, 50), _cloud(2, 2, 9)))
    d, idx = tops.three_nn(xyz1, xyz2)
    assert ck.three_nn.launches == 1 and d.shape == idx.shape == (2, 50, 3)
    wd, wi = tops.three_nn_torch(xyz1, xyz2)
    assert torch.equal(d, wd) and torch.equal(idx, wi)
    with pytest.raises(ValueError, match="at least 3"):
        tops.three_nn(xyz1, xyz2[:, :2])
    with pytest.raises(ValueError, match="batch size"):
        tops.three_nn(xyz1, xyz2[:1])
    with pytest.raises(TypeError, match="float32"):
        tops.three_nn(xyz1.double(), xyz2)


@pytest.mark.parametrize("inputs", ["grid", "randn"])
@pytest.mark.parametrize("N,M,C1,dup", [(256, 64, 128, False),
                                        (130, 96, 32, False),
                                        (64, 32, 64, True)])
def test_fused_fp_torch_matches_pallas_fp32(N, M, C1, dup, inputs):
    grid = inputs == "grid"
    args = _fp_inputs(0, 2 if not dup else 1, N, M, C1, dup, grid)
    want = np.asarray(pk.fused_fp_pallas(*map(jnp.asarray, args),
                                         interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    got = tops.fused_fp_torch(*targs)
    wrapped = tops.fused_fp(*targs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    _, idx = tops.three_nn_torch(*targs[:2])
    _, want_idx = pk.three_nn_pallas(*map(jnp.asarray, args[:2]),
                                     interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    scale = max(np.abs(want).max(), 1e-9)
    err = np.abs(got.numpy() - want).max() / scale
    if grid:
        # exact distances on both sides: the bound tests/test_fused_fp.py
        # holds the Pallas kernel to
        assert err < 1e-6, err
    else:
        # XLA's dot and the port's ordered sums round d2 = (|s|^2 - 2 s.d)
        # + |d|^2 a few ulps of |x|^2 (~2e-7) apart; 1/(d2 + 1e-8) turns
        # that into ~1e-5 of a weight at the smallest neighbour distances
        assert err < 1e-5, err


def test_fused_fp_torch_bf16_close():
    xyz1, xyz2, pre, skip = _fp_inputs(2, 2, 128, 64, 64)
    want = np.asarray(pk.fused_fp_pallas(
        jnp.asarray(xyz1), jnp.asarray(xyz2),
        jnp.asarray(pre).astype(jnp.bfloat16),
        jnp.asarray(skip).astype(jnp.bfloat16), interpret=True), np.float32)
    got = tops.fused_fp_torch(torch.from_numpy(xyz1), torch.from_numpy(xyz2),
                              torch.from_numpy(pre).to(torch.bfloat16),
                              torch.from_numpy(skip).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    scale = max(np.abs(want).max(), 1e-9)
    # tests/test_fused_fp.py:71's bf16 bound
    assert np.abs(got.float().numpy() - want).max() / scale < 2e-2


def test_fused_fp_rejects_bad_inputs(monkeypatch):
    """On the kernel path the wrapper checks before it builds or launches."""
    monkeypatch.setattr(dispatch, "resolve", lambda t: "cuda")
    xyz1, xyz2, pre, skip = map(torch.from_numpy,
                                _fp_inputs(3, 1, 16, 8, 4))
    with pytest.raises(ValueError, match="at least 3"):
        tops.fused_fp(xyz1, xyz2[:, :2], pre[:, :2], skip)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        tops.fused_fp(xyz1, xyz2, pre, skip[:, :5])
    with pytest.raises(TypeError, match="bf16 or f32"):
        tops.fused_fp(xyz1, xyz2, pre.double(), skip)


# ------------------------------------------------- projection / bilinear


def _bilinear_inputs(seed, B, H, W, C, N, spread=1.4):
    """tests/test_bilinear_kernel.py::_mk, as numpy."""
    r = np.random.RandomState(seed)
    feat = r.randn(B, H, W, C).astype(np.float32)
    uv = ((r.rand(B, N, 2) * spread - 0.2 * (spread - 1)).astype(np.float32)
          * np.array([W - 1, H - 1], np.float32))
    return feat, uv


@pytest.mark.parametrize("case", ["fractional", "integer", "far_outside"])
def test_bilinear_sample_torch_matches_jax_and_pallas(case):
    from mm3d_tpu.ops import projection as jproj
    feat, uv = _bilinear_inputs(0, 2, 16, 12, 24, 100)
    if case == "integer":
        uv = np.floor(uv)
    elif case == "far_outside":
        uv = uv + np.array([100.0, -50.0], np.float32)
    want = np.asarray(jproj._bilinear_sample_jax(jnp.asarray(feat),
                                                 jnp.asarray(uv)))
    pal = np.asarray(pk.bilinear_sample_pallas_raw(
        jnp.asarray(feat), jnp.asarray(uv), interpret=True))
    got = tops.bilinear_sample_torch(torch.from_numpy(feat),
                                     torch.from_numpy(uv))
    wrapped = tops.projection.bilinear_sample(torch.from_numpy(feat),
                                              torch.from_numpy(uv))
    assert got.dtype == torch.float32 and got.shape == (2, 100, 24)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    if case == "far_outside":
        assert (got.numpy() == 0).all() and (want == 0).all()
    elif case == "integer":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), pal)
        # in-frame integer points read their pixel exactly
        inside = ((uv[..., 0] <= 11) & (uv[..., 1] <= 15)
                  & (uv[..., 0] >= 0) & (uv[..., 1] >= 0))
        b, n = np.nonzero(inside)
        np.testing.assert_array_equal(
            got.numpy()[b, n],
            feat[b, uv[b, n, 1].astype(int), uv[b, n, 0].astype(int)])
    else:
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() / scale < 1e-6
        assert np.abs(got.numpy() - pal).max() / scale < 1e-6


def test_bilinear_sample_torch_bf16_matches_pallas():
    """bf16: the TPU kernel's rounding (bf16 corner weights, f32 sums, one
    rounding of the output); the two differ at most by the f32 summation
    order, one bf16 ulp."""
    feat, uv = _bilinear_inputs(1, 2, 16, 16, 32, 128)
    want = np.asarray(pk.bilinear_sample_pallas_raw(
        jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(uv),
        interpret=True).astype(jnp.float32))
    got = tops.bilinear_sample_torch(torch.from_numpy(feat).to(torch.bfloat16),
                                     torch.from_numpy(uv))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_project_points_and_sample_image_features_match_jax():
    from mm3d_tpu.data import synthetic as jsyn
    from mm3d_tpu.ops import projection as jproj
    r = np.random.RandomState(4)
    B, N, hw = 2, 200, (32, 32)
    xyz = (r.randn(B, N, 3) * 1.5).astype(np.float32)
    K = np.stack([jsyn.default_intrinsics(hw)] * B)
    Rt = [jsyn.random_viewpoint_extrinsics(r) for _ in range(B)]
    R = np.stack([a for a, _ in Rt])
    t = np.stack([b for _, b in Rt])
    fmap = r.randn(B, 8, 8, 16).astype(np.float32)
    j = list(map(jnp.asarray, (xyz, K, R, t)))
    uv_w, z_w = map(np.asarray, jproj.project_points(*j))
    tt = list(map(torch.from_numpy, (xyz, K, R, t)))
    uv, z = tops.projection.project_points(*tt)
    np.testing.assert_allclose(uv.numpy(), uv_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), z_w, rtol=1e-5, atol=1e-5)
    want, valid_w = map(np.asarray, jproj.sample_image_features(
        jnp.asarray(fmap), *j, hw, stride=4))
    got, valid = tops.projection.sample_image_features(
        torch.from_numpy(fmap), *tt, hw, stride=4)
    np.testing.assert_array_equal(valid.numpy(), valid_w)
    assert 0.1 < valid_w.mean() < 1.0  # some points in frame, some not
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bilinear_sample_raises_when_a_gradient_is_wanted(monkeypatch):
    """The kernel has a backward now: on the kernel path a wanted gradient
    runs the sampling as _BilinearSample, whose forward launches the
    bilinear kernel and whose backward launches the gather-backward kernel
    once, with the plain path's results; what the kernel does not take
    still raises, gradient or not."""
    feat, uv = _bilinear_inputs(3, 2, 6, 5, 8, 40)
    co = torch.from_numpy(np.random.RandomState(4).randn(2, 40, 8)
                          .astype(np.float32))
    pf = torch.from_numpy(feat).requires_grad_(True)
    with dispatch.use_impl("torch"):
        want = tops.bilinear_sample(pf, torch.from_numpy(uv))
        want.backward(co)
    ck = fake_kernels(monkeypatch)
    tf = torch.from_numpy(feat).requires_grad_(True)
    got = tops.bilinear_sample(tf, torch.from_numpy(uv))
    got.backward(co)
    assert (ck.bilinear_sample.launches, ck.gather_backward.launches) == (1, 1)
    assert torch.equal(got, want) and torch.equal(tf.grad, pf.grad)
    for f, u in ((tf, torch.from_numpy(uv).double()),
                 (tf.detach(), torch.from_numpy(uv).double()
                  .requires_grad_(True))):
        with pytest.raises(TypeError, match="float32"):
            tops.bilinear_sample(f, u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_sample_vjp_matches_jax(dtype):
    """d_feat and d_uv of the port's _BilinearSample against jax.vjp of
    bilinear_sample_pallas (its VJP is that of the f32 lerp), with points
    inside, across the edges and far outside the frame (zero gradient).
    f32: 1e-5 of each cotangent's max; bf16 d_feat: 2e-2 (JAX rounds the
    corner cotangents and its scatter-add to bf16, the port sums in f32 and
    rounds once); d_uv in f32 in both dtypes (bf16: 2e-2)."""
    feat, uv = _bilinear_inputs(5, 2, 8, 8, 16, 96)
    uv[:, :10] += np.array([100.0, -50.0], np.float32)  # far outside
    co = np.random.RandomState(6).randn(2, 96, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(pk.bilinear_sample_pallas, jnp.asarray(feat).astype(jdt),
                     jnp.asarray(uv))
    wf, wu = vjp(jnp.asarray(co).astype(jdt))
    tf = torch.from_numpy(feat).to(tdt).requires_grad_(True)
    tu = torch.from_numpy(uv).requires_grad_(True)
    out = tops.bilinear_sample(tf, tu)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(co).to(tdt))
    assert tf.grad.dtype == tdt and tu.grad.dtype == torch.float32
    assert (tu.grad[:, :10] == 0).all()  # outside: no gradient
    rel = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((tf.grad, wf), (tu.grad, wu)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= rel * np.abs(want).max(), err


def test_bilinear_sample_torch_is_differentiable_on_cpu():
    """The plain twin carries gradients to the map and to uv, as the JAX
    reference's VJP does."""
    from mm3d_tpu.ops import projection as jproj
    feat, uv = _bilinear_inputs(2, 1, 8, 8, 8, 32)
    gf_j, gu_j = jax.grad(
        lambda f, u: jnp.sum(jproj._bilinear_sample_jax(f, u) ** 2),
        argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(uv))
    tf = torch.from_numpy(feat).requires_grad_(True)
    tu = torch.from_numpy(uv).requires_grad_(True)
    (tops.bilinear_sample(tf, tu) ** 2).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu_j), rtol=1e-4,
                               atol=1e-5)
