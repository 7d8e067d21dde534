"""The sampling twins against the JAX package, on CPU, at the cases that
``chip_smoke.py`` phase 2 holds the H100 kernels to.

``fps_torch`` and ``ball_query_torch`` are what the FPS and ball-query
kernels (``csrc/fps.cu``, ``csrc/ball_query.cu`` and ``ball_query.cuh``)
are held to bit for bit on the card. Here the same numpy inputs go through
the JAX package's pure functions (``_fps_jax``, ``_query_ball_jax``) and, at
small N, its Pallas kernels in interpret mode, and every output must be
equal: ties whose equal distances fall in different warps of the kernel,
cloud sizes one below and one above each of its launcher's thread-count
boundaries, ``npoint > N``, per-cloud starts; the K-th hit at the edges of
the selection's rounds (32, 128 and 256 points), K = 128, clouds where every
point hits, d² == r² exactly, ragged N.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3d_tpu.ops import geometry as G
from mm3d_tpu.ops import pallas_kernels as pk
from mm3d_tpu_torch import ops as tops

PALLAS_MAX_N = 320  # the interpret-mode kernels run at these sizes only


def _unit(seed, B, N):
    pts = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True).max(
        1, keepdims=True)


def _check_fps(xyz, npoint, start):
    want = np.asarray(G._fps_jax(jnp.asarray(xyz), npoint, jnp.asarray(start)))
    got = tops.fps_torch(torch.from_numpy(xyz), npoint,
                         torch.from_numpy(start))
    wrapped = tops.farthest_point_sample(torch.from_numpy(xyz), npoint,
                                         torch.from_numpy(start))
    assert got.dtype == torch.int32 and got.shape == (xyz.shape[0], npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    if xyz.shape[1] <= PALLAS_MAX_N:
        pal = np.asarray(pk.fps_pallas(jnp.asarray(xyz), npoint,
                                       jnp.asarray(start), interpret=True))
        np.testing.assert_array_equal(got.numpy(), pal)
    return got.numpy()


# the FPS launcher's boundaries (csrc/fps.cu): 1, 2, 4 and 8 points a thread
# up to 128 threads, 8 up to 256 threads, 16, then shared memory past 4,096
@pytest.mark.parametrize("N", [127, 129, 255, 257, 511, 513, 1023, 1025,
                               2047, 2049, 4095, 4097])
def test_fps_at_launcher_boundaries(N):
    start = np.random.RandomState(N).randint(0, N, 2).astype(np.int32)
    _check_fps(_unit(N, 2, N), 24, start)


@pytest.mark.parametrize("unique,N", [(48, 320), (40, 1000), (64, 256),
                                      (33, 297)])
def test_fps_ties_across_warps(unique, N):
    """Duplicated points at offsets that are not multiples of 32: equal
    running distances in different lanes and warps, the first index must
    win everywhere."""
    base = _unit(unique, 2, unique)
    xyz = np.tile(base, (1, -(-N // unique), 1))[:, :N].copy()
    start = np.array([0, unique + 5], np.int32)
    idx = _check_fps(xyz, 2 * unique + 8, start)
    # once every distinct point is taken every distance is 0: index 0 wins
    assert (idx[:, unique:] == 0).all()


@pytest.mark.parametrize("N,npoint", [(40, 100), (200, 256)])
def test_fps_npoint_above_n_per_cloud_start(N, npoint):
    start = np.array([N - 1, 3, N // 2], np.int32)
    _check_fps(_unit(N + 1, 3, N), npoint, start)


def test_fps_grid_ties_per_cloud_start():
    """A cloud on the 1/4 grid: many exactly equal distances."""
    r = np.random.RandomState(7)
    xyz = (r.randint(-4, 5, (3, 300, 3)) / 4).astype(np.float32)
    _check_fps(xyz, 120, np.array([0, 150, 299], np.int32))


# ------------------------------------------------------------ ball query


def _check_bq(radius, K, xyz, new_xyz):
    want = np.asarray(G._query_ball_jax(radius, K, jnp.asarray(xyz),
                                        jnp.asarray(new_xyz)))
    got = tops.ball_query_torch(radius, K, torch.from_numpy(xyz),
                                torch.from_numpy(new_xyz))
    wrapped = tops.query_ball_point(radius, K, torch.from_numpy(xyz),
                                    torch.from_numpy(new_xyz))
    assert got.dtype == torch.int32
    assert got.shape == (xyz.shape[0], new_xyz.shape[1], K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    if xyz.shape[1] <= PALLAS_MAX_N:
        pal = np.asarray(pk.ball_query_v2_pallas(
            radius, K, jnp.asarray(xyz), jnp.asarray(new_xyz),
            interpret=True))
        np.testing.assert_array_equal(got.numpy(), pal)
    return got.numpy()


@pytest.mark.parametrize("h", [31, 32, 63, 64, 127, 128, 255, 256])
def test_ball_query_kth_hit_at_round_edges(h):
    """The 32nd hit at index h, more hits after it: the walk must stop with
    exactly the first 32, wherever its round ends (a ballot's 32 points; 4
    points a lane in the fused kernel, 8 in the standalone one)."""
    r = np.random.RandomState(h)
    xyz = (3.0 + r.rand(2, 300, 3)).astype(np.float32)  # far: no hit
    xyz[:, h - 31:h + 1] = r.rand(2, 32, 3) * 0.1  # hits 1..32
    xyz[:, h + 1:h + 40] = r.rand(2, 39, 3) * 0.1  # later hits
    cents = np.zeros((2, 3, 3), np.float32)
    cents[:, 1] = 0.05
    idx = _check_bq(0.5, 32, xyz, cents)
    np.testing.assert_array_equal(idx[:, :, -1], h)


@pytest.mark.parametrize("K,N", [(128, 300), (128, 97), (64, 200)])
def test_ball_query_wide_k_ragged_n(K, N):
    xyz = _unit(K + N, 2, N)
    _check_bq(0.6, K, xyz, xyz[:, ::7].copy())


def test_ball_query_every_point_hits():
    xyz = _unit(3, 2, 300) * 0.01
    idx = _check_bq(0.5, 32, xyz, xyz[:, :9].copy())
    np.testing.assert_array_equal(idx, np.broadcast_to(np.arange(32),
                                                       idx.shape))


def test_ball_query_d2_equal_r2():
    """Points on the sphere of radius r exactly (grid coordinates: every
    product and sum exact) are hits; one ulp farther are not."""
    xyz = np.array([[[0.75, 0, 0], [0.5, 0, 0], [0.25, 0.5, 0],
                     [np.nextafter(np.float32(0.75), np.float32(1)), 0, 0],
                     [0.25, 0, -0.5], [0, 0, 0]]], np.float32)
    cents = np.array([[[0.25, 0, 0], [0, 0, 0], [0.25, 0, 0.5]]], np.float32)
    idx = _check_bq(0.5, 4, xyz, cents)
    np.testing.assert_array_equal(idx[0, 0], [0, 1, 2, 4])


# --------------------------------------------------- measurement builds


def test_build_variant_digest_and_command(tmp_path, monkeypatch):
    """``_build.build_variant`` (``utils/sample_phases.py --src``, the phase
    builds) names a library by its source, the headers beside it and in
    ``csrc/``, and its defines; it compiles with ``-I csrc/`` after the
    source's own directory, and a failed compile raises."""
    import ctypes
    import subprocess
    from types import SimpleNamespace

    from mm3d_tpu_torch.ops import _build

    csrc, old = tmp_path / "csrc", tmp_path / "old"
    csrc.mkdir()
    old.mkdir()
    (csrc / "common.cuh").write_text("// c1\n")
    (old / "fps.cu").write_text("// old fps\n")
    (old / "common.cuh").write_text("// c0\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    calls = []

    class Done:
        def __init__(self, rc):
            self.returncode, self.stdout = rc, "ptxas info: Used 32 registers"

    def run(cmd, **kw):
        calls.append(cmd)
        if "-DFAIL" not in cmd:
            open(cmd[cmd.index("-o") + 1], "w").close()
        return Done(1 if "-DFAIL" in cmd else 0)

    def lib(path):
        return SimpleNamespace(path=path, mm3d_error_string=SimpleNamespace())

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(ctypes, "CDLL", lib)
    src = str(old / "fps.cu")
    a = _build.build_variant(src, "fps").path
    assert a == _build.build_variant(src, "fps").path and len(calls) == 1
    assert f"-I{csrc}" in calls[0] and calls[0][-1] == src
    assert _build.BUILD_LOGS[a].startswith("ptxas")
    b = _build.build_variant(src, "fps", ["-DSAMPLE_PHASE_CLOCKS"]).path
    (old / "common.cuh").write_text("// c0'\n")
    c = _build.build_variant(src, "fps").path
    (csrc / "common.cuh").write_text("// c2\n")
    d = _build.build_variant(src, "fps").path
    assert len({a, b, c, d}) == 4
    assert all(p.startswith(str(tmp_path / "build" / "libfps-v"))
               for p in (a, b, c, d))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_variant(src, "fps", ["-DFAIL"])


@pytest.mark.parametrize("name,kernel", [
    ("three_nn.cu", "three_nn"), ("fused_fp.cu", "fused_fp"),
    ("fps.cu", "fps"), ("ball_query.cu", "ball_query"),
    ("fused_sa.cu", "fused_sa"), ("three_interp.cu", "three_interp"),
    ("three_nn.cuh", None), ("bilinear.cu", "bilinear"),
    ("common.cuh", None)])
def test_sample_phases_src_kernels(name, kernel):
    """``sample_phases --src`` maps a copy to its kernel by file name, the
    3-NN kernels and the two byte-bound forwards (three_interp, bilinear)
    included, and refuses any other name (a header) before it looks for a
    card."""
    from mm3d_tpu_torch.utils import sample_phases

    path = f"build/old/mm3d_tpu_torch/csrc/{name}"
    if kernel is None:
        with pytest.raises(SystemExit, match="not one of"):
            sample_phases.src_kernel(path)
        with pytest.raises(SystemExit, match="not one of"):
            sample_phases.main(["--src", path])
    else:
        assert sample_phases.src_kernel(path) == kernel


def test_sample_phases_calls_old_3nn_copies_without_lanes():
    """A three_nn / fused_fp library from before the launch plan has no
    ``*_threads`` and no lanes argument: the race calls it through the
    checkout's wrapper with the lanes argument dropped."""
    from types import SimpleNamespace

    from mm3d_tpu_torch.utils import sample_phases

    calls = []

    def raw(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(mm3d_three_nn=raw, mm3d_three_nn_max_sparse=None)
    shim = sample_phases._NoLanes(lib, "three_nn")
    assert shim.mm3d_three_nn_threads() == 128
    assert shim.mm3d_three_nn("x1", "x2", "d", "i", 2, 40, 8, 4, "st") == 0
    assert calls == [("x1", "x2", "d", "i", 2, 40, 8, "st")]
    assert shim.mm3d_three_nn_max_sparse is None  # the rest is the library's


def test_sample_phases_calls_old_fused_fp_copies_without_plan():
    """A fused_fp library from before the launch plan takes neither the
    lanes nor the shared-memory bytes: the race drops both."""
    from types import SimpleNamespace

    from mm3d_tpu_torch.utils import sample_phases

    calls = []

    def raw(*args):
        calls.append(args)
        return 0

    shim = sample_phases._NoLanes(SimpleNamespace(mm3d_fused_fp=raw),
                                  "fused_fp")
    args = (1, 2, "x1", "x2", "pre", "skip", "out", 16, 2048, 256, 128)
    assert shim.mm3d_fused_fp(*args, 2, 102400, "st") == 0
    assert calls == [args + ("st",)]
