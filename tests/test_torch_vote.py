"""The port's four vote-eval steps against the JAX package's, on the CPU.

Each step runs on the same weights (flax init with drawn BN statistics,
moved into the port by ``load_jax_variables``) and the same inputs, and is
given the very draws the JAX step makes from its key (vote i's angles or
permutations from ``fold_in(key, i)``). The JAX side runs in its pure-JAX
mode with f32 matmuls. fp32 predictions must be equal; the summed
probabilities, where the test composes them from the JAX model's own
forwards, agree within 1e-4. The bf16 case runs the wrappers' kernel path
(``fake_kernels``): a vote step launches each kernel V times a forward's
count, as ``chip_smoke.py`` checks on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_sa import fake_kernels
from test_torch_fusion_semseg import _init, _np_tree
from test_torch_knn import _cloud_batch
from mm3d_tpu.data import augment as jaug
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu.training import steps as jax_steps
from mm3d_tpu.training.state import TrainState
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.models import get_model
from mm3d_tpu_torch.ops import cuda_kernels as ck
from mm3d_tpu_torch.training import steps
from mm3d_tpu_torch.utils import load_jax_variables, metrics

V = 3
NUM_CLASS = 6
PROBS = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads, restored after (see test_torch_partseg.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_state(v):
    return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                      batch_stats=v["batch_stats"], opt_state=None)


def _jax_run(fn, *args):
    """``fn(*args)`` jitted, in JAX's pure-JAX mode with f32 matmuls."""
    with jdispatch.use_impl("jax"), jax.default_matmul_precision("float32"):
        return jax.tree_util.tree_map(np.array, jax.jit(fn)(*args))


def _jax_angles(key, B):
    """The angles of votes 1 .. V-1 as the JAX steps draw them."""
    return _jax_run(lambda k: jnp.stack([
        jax.random.uniform(jax.random.fold_in(k, i), (B,)) * 2.0 * jnp.pi
        for i in range(1, V)]), key)


def _jax_perms(key, B, N):
    """The point orders of votes 1 .. V-1 as ``_shuffle_vote_probs`` draws
    them."""
    return _jax_run(lambda k: jnp.stack([
        jax.vmap(lambda kk: jax.random.permutation(kk, N))(
            jax.random.split(jax.random.fold_in(k, i), B))
        for i in range(1, V)]), key)


def _port(name, v, **kw):
    return load_jax_variables(get_model(name).builder(**kw), _np_tree(v))


def _assert_votes(got, want_pred, want_probs=None):
    pred, probs = got
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), want_pred)
    if want_probs is not None:
        np.testing.assert_allclose(probs.numpy(), want_probs, **PROBS)


class _Recorder(torch.nn.Module):
    """The model, recording the extrinsics of each forward."""

    def __init__(self, model):
        super().__init__()
        self.model, self.Rs = model, []

    def forward(self, points, image, K, R, t):
        self.Rs.append(R.clone())
        return self.model(points, image, K, R, t)


# ---------------------------------------------------------------- draws


def test_vote_draws_come_from_the_generator():
    a = steps.draw_vote_angles(torch.Generator().manual_seed(1), V, 5)
    b = steps.draw_vote_angles(torch.Generator().manual_seed(1), V, 5)
    assert a.shape == (V - 1, 5) and torch.equal(a, b)
    assert bool(((a >= 0) & (a <= 2 * np.pi)).all())
    p = steps.draw_vote_perms(torch.Generator().manual_seed(2), V, 3, 40)
    assert p.shape == (V - 1, 3, 40) and p.dtype == torch.int64
    assert torch.equal(p.sort(-1).values,
                       torch.arange(40).expand(V - 1, 3, 40))
    step = steps.make_vote_eval_step(None, num_votes=V)
    with pytest.raises(ValueError, match="take 2 draws"):
        step(torch.zeros(1, 8, 3), a[:1])


# ---------------------------------------------------------------- steps


def test_vote_eval_step_matches_jax():
    """pointnet2_cls_ssg with normals: Y-rotated votes (normals turned with
    the xyz), vote 0 the cloud as it is."""
    name, B, N = "pointnet2_cls_ssg", 4, 256
    r = np.random.RandomState(3)
    nrm = r.randn(B, N, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pts = np.concatenate([_cloud_batch(B, N, 4), nrm], -1)
    jmodel = jax_get_model(name).builder(num_class=NUM_CLASS,
                                         normal_channel=True)
    v = _init(jmodel, (pts,))
    key = jax.random.PRNGKey(9)
    want = _jax_run(lambda p: jax_steps.make_vote_eval_step(jmodel, V)(
        _jax_state(v), p, key), pts)
    angles = _jax_angles(key, B)

    def probs_of(p):
        return np.exp(_jax_run(lambda q: jmodel.apply(v, q, train=False)[0],
                               p))

    want_probs = probs_of(pts) + sum(
        probs_of(_jax_run(lambda p, k: jaug.rotate_point_cloud(
            k, p, rotate_normals=True), pts, jax.random.fold_in(key, i)))
        for i in range(1, V))
    model = _port(name, v, num_class=NUM_CLASS, normal_channel=True)
    got = steps.make_vote_eval_step(model, V)(
        torch.from_numpy(pts), torch.from_numpy(angles), return_probs=True)
    assert not model.training
    _assert_votes(got, want, want_probs)
    np.testing.assert_array_equal(want_probs.argmax(-1), want)


def test_vote_fusion_cls_step_matches_jax():
    """fusion_cls: Y-rotated votes with the extrinsics R' = R rot^T, which
    the model receives as JAX's step computes them."""
    B, N = 2, 128
    r = np.random.RandomState(5)
    pts = r.randn(B, N, 3).astype(np.float32)
    img = r.rand(B, 32, 32, 3).astype(np.float32)
    K = np.stack([np.eye(3, dtype=np.float32) * 16] * B)
    R = np.stack([syn.random_viewpoint_extrinsics(r)[0] for _ in range(B)]
                 ).astype(np.float32)
    t = np.array([[0, 0, 3.0]] * B, np.float32)
    args = (pts, img, K, R, t)
    jmodel = jax_get_model("fusion_cls").builder(num_class=NUM_CLASS)
    v = _init(jmodel, args)
    key = jax.random.PRNGKey(11)
    want = _jax_run(lambda *a: jax_steps.make_vote_fusion_cls_step(
        jmodel, V)(_jax_state(v), *a, key), *args)
    angles = _jax_angles(key, B)
    want_R = [R] + [_jax_run(lambda R_, a: jnp.einsum(
        "bij,bkj->bik", R_, jaug._rot_y(a),
        precision=jax.lax.Precision.HIGHEST), R, angles[i])
        for i in range(V - 1)]
    model = _Recorder(_port("fusion_cls", v, num_class=NUM_CLASS))
    got = steps.make_vote_fusion_cls_step(model, V)(
        *map(torch.from_numpy, args), torch.from_numpy(angles),
        return_probs=True)
    _assert_votes(got, want)
    assert len(model.Rs) == V
    for g, w in zip(model.Rs, want_R):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_vote_partseg_step_matches_jax():
    """pointnet2_part_seg_ssg: shuffle votes, the category-masked argmax
    over the summed probabilities."""
    name, B, N = "pointnet2_part_seg_ssg", 2, 256
    pts, onehot, cat, _ = syn.partseg_request(B, N, seed=6)
    jmodel = jax_get_model(name).builder()
    v = _init(jmodel, (pts, onehot))
    ranges = syn.shapenet_part_ranges()
    start = np.array([ranges[c][0] for c in range(16)], np.int32)
    count = np.array([ranges[c][1] - ranges[c][0] for c in range(16)],
                     np.int32)
    key = jax.random.PRNGKey(13)
    want = _jax_run(lambda p, c: jax_steps.make_vote_partseg_step(
        jmodel, V, 16, jnp.asarray(start), jnp.asarray(count))(
        _jax_state(v), p, c, key), pts, cat)
    perms = _jax_perms(key, B, N)

    def probs_of(p):
        return np.exp(_jax_run(lambda q: jmodel.apply(
            v, q, jnp.asarray(onehot), train=False)[0], p))

    want_probs = probs_of(pts)
    for perm in perms:
        p = probs_of(np.take_along_axis(pts, perm[..., None], 1))
        want_probs = want_probs + np.take_along_axis(
            p, np.argsort(perm, 1)[..., None], 1)
    model = _port(name, v)
    ts, tc = metrics.part_ranges(ranges)
    got = steps.make_vote_partseg_step(model, V, 16, ts, tc)(
        torch.from_numpy(pts), torch.from_numpy(cat), torch.from_numpy(perms),
        return_probs=True)
    _assert_votes(got, want, want_probs)
    assert got[0].shape == (B, N)


def test_vote_fusion_semseg_step_matches_jax():
    """fusion_sem_seg: shuffle votes over the points, the camera kept."""
    B, N = 2, 256
    args = tuple(syn.semseg_request(B, N, (32, 32), 7))
    jmodel = jax_get_model("fusion_sem_seg").builder(num_class=NUM_CLASS)
    v = _init(jmodel, args)
    key = jax.random.PRNGKey(15)
    want = _jax_run(lambda *a: jax_steps.make_vote_fusion_semseg_step(
        jmodel, V)(_jax_state(v), *a, key), *args)
    perms = _jax_perms(key, B, N)
    model = _port("fusion_sem_seg", v, num_class=NUM_CLASS)
    got = steps.make_vote_fusion_semseg_step(model, V)(
        *map(torch.from_numpy, args), torch.from_numpy(perms),
        return_probs=True)
    _assert_votes(got, want)
    assert got[1].shape == (B, N, NUM_CLASS)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), V, rtol=1e-5)


def test_vote_step_launches_v_forwards(monkeypatch):
    """bf16 pointnet2_cls_ssg on the wrappers' kernel path: a vote step
    launches FPS and the fused SA tail V times a forward's count, and its
    predictions are those of the plain path."""
    name, B, N = "pointnet2_cls_ssg", 2, 128
    pts = torch.from_numpy(_cloud_batch(B, N, 8))
    model = get_model(name).builder(num_class=NUM_CLASS,
                                    dtype=torch.bfloat16)
    angles = steps.draw_vote_angles(torch.Generator().manual_seed(0), V, B)
    plain = steps.make_vote_eval_step(model, V)(pts, angles)
    fake_kernels(monkeypatch)
    ck.reset_launches()
    with torch.no_grad():
        model.eval()(pts)
    one = {k: getattr(ck, k).launches for k in ("farthest_point_sample",
                                                "fused_sa")}
    assert one == {"farthest_point_sample": 2, "fused_sa": 2}
    ck.reset_launches()
    got = steps.make_vote_eval_step(model, V)(pts, angles)
    assert {k: getattr(ck, k).launches for k in one} == {
        k: V * n for k, n in one.items()}
    assert torch.equal(got, plain)
