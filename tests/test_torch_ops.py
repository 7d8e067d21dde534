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
