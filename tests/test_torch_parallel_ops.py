"""The port's point-sharded ops (``mm3d_tpu_torch.parallel``) against the
JAX package's single-device ops, on the CPU over ``gloo`` at world sizes 2
and 4.

The ranks are spawned processes (``parallel.launch.run_ranks``: a
``file://`` rendezvous under ``tmp_path``, a time limit a test, two torch
threads a rank); their bodies are in ``tests/_torch_parallel_ranks.py``.
No JAX ``shard_map`` program runs here: the JAX package's own tests hold
its sharded ops equal to the single-device ones these tests compare with
(and its point-sharded programs abort in XLA:CPU's collectives when they
load from the persistent compile cache).

Indices (FPS, ball query, kNN) bit for bit, zero-hit centroids, ties
across shards (grid coordinates, duplicated points in different tiles),
an odd batch and tiles smaller than the samples; the SA tails and the FP
tail within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu.ops import geometry as G
from mm3d_tpu_torch.parallel import mesh as pmesh
from mm3d_tpu_torch.parallel.launch import run_ranks
from mm3d_tpu_torch.parallel.mesh import Mesh, make_mesh
from mm3d_tpu_torch.parallel.sharded_fps import sharded_fps
from mm3d_tpu_torch.parallel import sharded_group as sg

# a test's ranks, spawn to result: a hang fails in this many seconds
RANK_TIMEOUT = 90.0


def _case(seed=0, B=3, N=64, S=12, K=8):
    """B=3 clouds of N points (an odd batch), S centroids of which the last
    two are far outside every cloud (zero hits), K neighbours; a grid cloud
    whose every point appears twice, the copies N/2 apart (so in different
    tiles at world sizes 2 and 4), for ties."""
    r = np.random.RandomState(seed)
    xyz = (r.randn(B, N, 3) * 0.5).astype(np.float32)
    cents = xyz[:, r.choice(N, S, replace=False)].copy()
    cents[:, -2:] = 10.0 + r.rand(B, 2, 3).astype(np.float32)
    half = (r.randint(0, 4, (B, N // 2, 3)) * 0.25).astype(np.float32)
    grid = np.concatenate([half, half], axis=1)
    return {"xyz": xyz, "centroids": cents, "npoint": 24, "radius": 0.4,
            "K": K,
            "pre": r.randn(B, N, 8).astype(np.float32),
            "cbias": r.randn(B, S, 8).astype(np.float32),
            "w1": (r.randn(8, 8) * 0.3).astype(np.float32),
            "b1": r.randn(8).astype(np.float32),
            "w2": (r.randn(8, 16) * 0.3).astype(np.float32),
            "b2": r.randn(16).astype(np.float32),
            "fp_pre": r.randn(B, S, 8).astype(np.float32),
            "fp_skip": r.randn(B, N, 8).astype(np.float32),
            "grid": grid, "grid_centroids": grid[:, ::5].copy()}


def _jax_refs(c):
    """The JAX package's single-device results (its 'jax' mode, f32 at
    HIGHEST precision as its tests run)."""
    j = {k: jnp.asarray(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}

    def mlp(g):
        h = jax.nn.relu(g + j["cbias"][:, :, None, :])
        h = jax.nn.relu(h @ j["w1"] + j["b1"])
        return jnp.max(jax.nn.relu(h @ j["w2"] + j["b2"]), axis=2)

    with jdispatch.use_impl("jax"), jax.default_matmul_precision("float32"):
        bq = G.query_ball_point(c["radius"], c["K"], j["xyz"],
                                j["centroids"])
        kn = G.knn_point(c["K"], j["xyz"], j["centroids"])
        d, idx = G._three_nn_jax(j["xyz"], j["centroids"])
        w = G.interpolation_weights(d)
        fp = jax.nn.relu(G._three_interpolate_jax(j["fp_pre"], idx, w)
                         + j["fp_skip"])
        out = {"fps": G._fps_jax(j["xyz"], c["npoint"]),
               "ball_query": bq, "knn": kn,
               "sa_tail": mlp(G.index_points(j["pre"], bq)),
               "idx_tail": mlp(G.index_points(j["pre"], kn)),
               "fp": fp,
               "knn_ties": G.knn_point(c["K"], j["grid"],
                                       j["grid_centroids"]),
               "fps_ties": G._fps_jax(j["grid"], c["npoint"])}
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ops_match_jax_single_device(world, tmp_path):
    """Every rank's result equals the JAX single-device op's: indices bit
    for bit (zero-hit rows all zeros, ties to the lower global index, FPS
    past a tile's size), tails within 1e-5 of max|ref|."""
    case = _case()
    want = _jax_refs(case)
    assert (want["ball_query"][:, -2:] == 0).all()  # the zero-hit rows
    got = run_ranks(ranks.sharded_ops, world, (case,),
                    timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    for rank, out in enumerate(got):
        for k in ("fps", "ball_query", "knn", "knn_ties", "fps_ties"):
            np.testing.assert_array_equal(out[k], want[k],
                                          err_msg=f"rank {rank} {k}")
        for k in ("sa_tail", "idx_tail", "fp"):
            err = np.abs(out[k] - want[k]).max()
            print(f"world {world} rank {rank} {k}: max|d| {err:.3g}")
            assert err <= 1e-5 * max(np.abs(want[k]).max(), 1.0), k


def test_make_mesh_without_a_process_group():
    """No group: world size 1, collectives return their input; the mesh
    sizes must match the world, as JAX's ``make_mesh`` raises."""
    m = make_mesh()
    assert (m.group, m.rank, m.world_size) == (None, 0, 1)
    assert m.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="mesh 2x1 != 1"):
        make_mesh(data_parallel=2)
    t = torch.arange(6.0)
    assert pmesh.all_reduce(t, m, "max") is t
    assert pmesh.all_gather(t, m).shape == (1, 6)
    assert pmesh.broadcast(t, m) is t
    assert pmesh.batch_slice(Mesh(None, 1, 4), 8) == slice(2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.batch_slice(Mesh(None, 0, 4), 6)


def test_single_process_sharded_ops_equal_the_ops():
    """At world size 1 every sharded op is the port's single-process op,
    bit for bit (fps_torch, ball_query_torch, knn_point, the twins)."""
    from mm3d_tpu_torch import ops
    c = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in _case(seed=3).items()}
    m = make_mesh()
    w = [c[k] for k in ("w1", "b1", "w2", "b2")]
    assert torch.equal(sharded_fps(c["xyz"], 24, m),
                       ops.fps_torch(c["xyz"], 24))
    bq = ops.ball_query_torch(0.4, 8, c["xyz"], c["centroids"])
    assert torch.equal(sg.sharded_ball_query(0.4, 8, c["xyz"],
                                             c["centroids"], m), bq)
    kn = ops.knn_point(8, c["xyz"], c["centroids"])
    assert torch.equal(sg.sharded_knn_point(8, c["xyz"], c["centroids"], m),
                       kn)
    assert torch.equal(
        sg.sharded_sa_group_max(0.4, 8, c["xyz"], c["centroids"], c["pre"],
                                c["cbias"], *w, m),
        ops.fused_sa_torch(0.4, 8, c["xyz"], c["centroids"], c["pre"],
                           c["cbias"], *w))
    assert torch.equal(
        sg.sharded_idx_group_max(kn, c["pre"], c["cbias"], *w, m),
        ops.fused_sa_idx_torch(8, kn, c["pre"], c["cbias"], *w))
    assert torch.equal(
        sg.sharded_fp(c["xyz"], c["centroids"], c["fp_pre"], c["fp_skip"],
                      m),
        ops.fused_fp_torch(c["xyz"], c["centroids"], c["fp_pre"],
                           c["fp_skip"]))


def test_sharded_ops_refuse_what_jax_refuses():
    """N not divisible by the axis (ValueError, as JAX's sharded_fps), and
    a kNN tile smaller than K (JAX's precondition, sharded_group.py:205)."""
    xyz = torch.zeros(1, 30, 3)
    four = Mesh(None, 0, 4)
    with pytest.raises(ValueError, match="N=30 not divisible"):
        sharded_fps(xyz, 4, four)
    with pytest.raises(ValueError, match="not divisible"):
        sg.sharded_ball_query(0.1, 4, xyz, xyz[:, :2], four)
    with pytest.raises(ValueError, match="tile 7 < nsample 8"):
        sg.sharded_knn_point(8, torch.zeros(1, 28, 3), xyz[:, :2], four)
