"""Point-sharded model forwards of the port (``parallel.point_shard``)
against the JAX package's single-device forwards, on the CPU over ``gloo``.

Each model gets the weights of one flax init (``load_jax_variables``); its
ranks (``tests/_torch_parallel_ranks.py``) run the eval forward under
``point_shard`` and record which blocks sharded. The JAX side runs without
the context (its point-sharded programs are not run here; its own tests
hold them equal to these). Gate: fp32 log-probs within 1e-4 of JAX's, the
whole-model gate; the blocks that shard are the ones the JAX gates pick
(``mm3d_tpu/models/pointnet2.py:183-193,324-328,474-476``): not below
``min_points``, not where N does not divide by the world size, not a kNN
block whose tile holds fewer than K points.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from test_torch_fusion_semseg import _apply, _init, _np_tree
from test_torch_knn import _cloud_batch
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu_torch.models import get_model
from mm3d_tpu_torch.models.pointnet2 import _point_shard
from mm3d_tpu_torch.parallel import point_shard
from mm3d_tpu_torch.parallel.launch import run_ranks
from mm3d_tpu_torch.parallel.mesh import Mesh
from mm3d_tpu_torch.utils import load_jax_variables

NUM_CLASS = 13
RANK_TIMEOUT = 120.0


def _blocks(B, N, seed):
    r = np.random.RandomState(seed)
    xyz = _cloud_batch(B, N, seed) * 1.5
    return np.concatenate([xyz, r.rand(B, N, 3), r.rand(B, N, 3)],
                          -1).astype(np.float32)


# name: (world size, min_points, [(input, the (kind, N) of each block that
# shards)]). sa: an SA block's sharded FPS at its input N; fp: an FP
# block's sharded tail at its dense N.
_SEG = [("sa", 512), ("sa", 1024), ("sa", 256),
        ("fp", 256), ("fp", 1024), ("fp", 512)]
CASES = {
    # sa4 / fp4 (64 points) stay below min_points; the second input's 257
    # points do not divide by 2, so sa1 and fp1 stay whole
    "pointnet2_sem_seg": (2, 256, [(_blocks(2, 512, 1), _SEG),
                                   (_blocks(1, 257, 2), _SEG[1:-1])]),
    "pointnet2_sem_seg_msg": (2, 256, [(_blocks(1, 512, 3), _SEG)]),
    "pointnet2_cls_ssg": (4, 128, [(_cloud_batch(2, 256, 4),
                                    [("sa", 256), ("sa", 512)])]),
    # 96 points over 4 ranks leave sa1 (K=32) tiles of 24: sa1 stays whole
    "pointnet2_cls_knn": (4, 64, [(_cloud_batch(2, 256, 5),
                                   [("sa", 256), ("sa", 512)]),
                                  (_cloud_batch(2, 96, 6), [("sa", 512)])]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_point_sharded_forward_matches_jax(name, tmp_path):
    world, min_points, inputs = CASES[name]
    jax_model = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _init(jax_model, (inputs[0][0],))
    state = load_jax_variables(
        get_model(name).builder(num_class=NUM_CLASS), _np_tree(v)
    ).state_dict()
    state = {k: t.numpy() for k, t in state.items()}
    got = run_ranks(ranks.point_sharded_forward, world,
                    (name, state, NUM_CLASS, [(x,) for x, _ in inputs],
                     min_points), timeout=RANK_TIMEOUT, threads=1,
                    workdir=str(tmp_path))
    for i, (x, sharded) in enumerate(inputs):
        want = _apply(jax_model, v, (x,), "jax")[0]
        for rank, outs in enumerate(got):
            logp, seen = outs[i]
            err = float(np.abs(logp - want).max())
            print(f"{name} input {i} rank {rank}: max|d logp| {err:.3g}")
            assert err <= 1e-4
            assert seen == sharded, (rank, seen)


def test_point_shard_gates_follow_jax():
    """``_point_shard``: eval only; every scale's MLP 3 layers; N at least
    ``min_points`` and divisible by the axis; a kNN block's tile at least
    K; no context, no sharding."""
    four = Mesh(None, 0, 4)
    three = [(32, 32, 64)]
    assert _point_shard(False, 4096, three) is None
    with point_shard(four, min_points=2048) as ps:
        assert _point_shard(False, 4096, three) is ps
        assert _point_shard(False, 2048, three) is ps
        assert _point_shard(True, 4096, three) is None
        assert _point_shard(False, 1024, three) is None
        assert _point_shard(False, 4098, three) is None
        assert _point_shard(False, 4096, [(32, 64)]) is None
        assert _point_shard(False, 4096, [(32, 32, 64), (16, 32)]) is None
        assert _point_shard(False, 8192, three, knn_nsample=32) is ps
        assert _point_shard(False, 2048, three, knn_nsample=513) is None
        assert _point_shard(False, 4096, ()) is ps  # an FP block
    assert _point_shard(False, 4096, three) is None


def test_point_shard_context_is_per_thread():
    """The context is thread-local, as the JAX one (trace-time state)."""
    import threading
    seen = []
    with point_shard(Mesh(None, 0, 1), min_points=8):
        t = threading.Thread(target=lambda: seen.append(
            _point_shard(False, 64, ())))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert _point_shard(False, 64, ()) is not None
    assert seen == [None]


def test_point_shard_splits_the_data_axis_only():
    """The point axis splits over the mesh's ``data`` axis, the only one
    with more than one rank; contexts nest and the innermost is read."""
    four, two = Mesh(None, 0, 4), Mesh(None, 0, 2)
    with pytest.raises(ValueError, match="'data' axis"):
        with point_shard(four, axis="model"):
            pass
    with point_shard(four, axis="data", min_points=4096) as outer:
        assert _point_shard(False, 2048, ()) is None
        with point_shard(two, min_points=1024) as inner:
            assert _point_shard(False, 2048, ()) is inner
        assert _point_shard(False, 4096, ()) is outer
    assert _point_shard(False, 4096, ()) is None


def test_single_process_point_shard_forward_equals_plain():
    """At world size 1 the sharded branches compute the fused forms'
    function: log-probs within 1e-5 of the forward without the context
    (the fp32 unfused SA path, as in the JAX package)."""
    from mm3d_tpu_torch.models import init_params
    model = init_params(get_model("pointnet2_sem_seg").builder(
        num_class=NUM_CLASS), 0).eval()
    x = torch.from_numpy(_blocks(1, 256, 7))
    with torch.no_grad():
        want = model(x)[0]
        with point_shard(Mesh(None, 0, 1), min_points=64):
            got = model(x)[0]
    assert float((got - want).abs().max()) <= 1e-5
