"""The port's whole-room evaluation (``training/scene_eval.py``) and
``synthetic_room`` against the JAX package's, on the CPU.

The host tiling must be JAX's bit for bit on the same room and seed; the
vote accumulation must give JAX's votes and metrics for one numpy oracle
predictor wrapped for both sides; and ``pointnet2_sem_seg`` and
``fusion_sem_seg`` (one flax init, given to the port through
``load_jax_variables``) must give JAX's fp32 room votes within 1e-5 of the
largest vote, and the same predictions wherever the top-two margin exceeds
1e-4. The JAX models run in their pure-JAX mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion_semseg import _init
from tests.test_scene_eval import _room
from mm3d_tpu.data import synthetic as jsyn
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu.training import scene_eval as jscene
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.models import get_model
from mm3d_tpu_torch.training import make_predictor
from mm3d_tpu_torch.training import scene_eval as scene
from mm3d_tpu_torch.utils import load_jax_variables

NUM_CLASS = 13
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (several
    test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _oracle_weights():
    r = np.random.RandomState(21)
    return r.randn(9, NUM_CLASS).astype(np.float32) * 2.0


def _oracle(points):
    """A numpy predictor: log-softmax of a fixed linear map of the 9
    features, [B, N, 9] -> [B, N, 13] f32."""
    logits = points.astype(np.float32) @ _oracle_weights()
    logits = logits - logits.max(-1, keepdims=True)
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
        np.float32)


def _port_oracle(*args):
    return torch.from_numpy(_oracle(args[0].numpy()))


def _jax_oracle(*args):
    return jnp.asarray(_oracle(np.asarray(args[0])))


def _assert_votes(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _assert_preds(got, want_votes):
    """Predictions equal JAX's wherever its top-two margin exceeds
    MARGIN."""
    top2 = np.sort(want_votes, -1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], want_votes.argmax(-1)[sure])


def test_synthetic_room_matches_jax():
    for n, seed in ((5000, 0), (20000, 3)):
        got = syn.synthetic_room(n, seed=seed)
        want = jsyn.synthetic_room(n, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bs,st", [(1.0, 0.5), (2.0, 1.5), (1.3, 0.7)])
def test_block_point_lists_and_tile_scene_match_jax(bs, st):
    xyz, rgb, _ = _room(2000, seed=4)
    xyz[:, 0] -= 1.5  # negative coordinates
    got = scene.block_point_lists(xyz, bs, st)
    want = jscene.block_point_lists(xyz, bs, st)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for colours in (rgb, rgb * 255.0, None):
        for seed in (0, 5):
            gf, gi = scene.tile_scene(xyz, colours, 128, bs, st, seed,
                                      block_lists=got)
            wf, wi = jscene.tile_scene(xyz, colours, 128, bs, st, seed)
            assert gf.dtype == wf.dtype and gi.dtype == wi.dtype
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gi, wi)


def test_render_block_views_match_jax():
    xyz, rgb, _ = _room(800)
    feats, _ = scene.tile_scene(xyz, rgb, 64, 2.0, 1.5, 1)
    for g, w in zip(scene.render_block_views(feats, (32, 32), seed=2),
                    jscene.render_block_views(feats, (32, 32), seed=2)):
        np.testing.assert_array_equal(g, w)


def test_evaluate_scene_with_oracle_matches_jax():
    xyz, rgb, labels = _room(3000)
    feats, pidx = scene.tile_scene(xyz, rgb, 512, 2.0, 1.0, 0)
    # 3 batches of 4, the last one padded with live = 0
    assert feats.shape[0] % 4
    got = scene._vote_loop(_port_oracle, [feats], pidx, feats.shape[0], 4,
                           len(xyz), NUM_CLASS)
    want = jscene._vote_loop(_jax_oracle, [feats], pidx, feats.shape[0], 4,
                             len(xyz), NUM_CLASS)
    _assert_votes(got, want)
    kw = dict(labels=labels, rgb=rgb, num_classes=NUM_CLASS, npoints=512,
              block_size=2.0, stride=1.0, batch_size=4, seed=3,
              num_votes=2)
    gp, gm = scene.evaluate_scene(_port_oracle, xyz, **kw)
    wp, wm = jscene.evaluate_scene(_jax_oracle, xyz, **kw)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gm.pop("_cm"), wm.pop("_cm"))
    assert gm == pytest.approx(wm, abs=1e-12)
    assert set(gm) == {"coverage", "point_acc", "miou"}
    # no labels: coverage only
    gp2, gm2 = scene.evaluate_scene(_port_oracle, xyz, **{**kw,
                                                          "labels": None})
    np.testing.assert_array_equal(gp2, gp)
    assert set(gm2) == {"coverage"}


def test_vote_buffer_lives_on_the_predictor_device():
    """The predictor's output device holds the buffer: a predictor that
    returns f64 log-probs on the CPU still gets f32 votes."""
    xyz, rgb, _ = _room(600)
    feats, pidx = scene.tile_scene(xyz, rgb, 64, 2.0, 2.0, 0)
    calls = []

    def predict(points):
        calls.append(points.device)
        return torch.from_numpy(_oracle(points.numpy())).double()

    votes = scene._vote_loop(predict, [feats], pidx, feats.shape[0], 3,
                             len(xyz), NUM_CLASS)
    assert votes.dtype == np.float32 and votes.shape == (len(xyz),
                                                         NUM_CLASS)
    assert all(d.type == "cpu" for d in calls)
    # each point's votes sum to the number of its tile rows
    rows = np.bincount(pidx.reshape(-1), minlength=len(xyz))
    np.testing.assert_allclose(votes.sum(-1), rows, rtol=1e-5)


def test_metrics_from_confusion_match_jax():
    r = np.random.RandomState(2)
    pred = r.randint(0, NUM_CLASS, 500)
    labels = r.randint(0, NUM_CLASS - 3, 500)
    cm = scene.room_confusion(pred, labels, NUM_CLASS)
    np.testing.assert_array_equal(cm, jscene.room_confusion(pred, labels,
                                                            NUM_CLASS))
    assert scene.metrics_from_confusion(cm) == jscene.metrics_from_confusion(
        cm)


def test_room_confusion_ignores_out_of_range_labels():
    pred = np.array([0, 1, 2, 1, 0], np.int32)
    labels = np.array([0, 1, 255, -1, 13], np.int64)
    cm = scene.room_confusion(pred, labels, NUM_CLASS)
    assert cm.shape == (NUM_CLASS, NUM_CLASS) and cm.sum() == 2
    assert cm[0, 0] == 1 and cm[1, 1] == 1
    np.testing.assert_array_equal(cm, jscene.room_confusion(pred, labels,
                                                            NUM_CLASS))


def _jax_predictor(model, v):
    fn = jax.jit(lambda *a: model.apply(v, *a, train=False)[0])

    def predict(*args):
        # the mode and precision are read when the forward is traced
        with jdispatch.use_impl("jax"), jax.default_matmul_precision(
                "float32"):
            return fn(*(jnp.asarray(a) for a in args))

    return predict


@pytest.mark.parametrize("name", ["pointnet2_sem_seg", "fusion_sem_seg"])
def test_room_votes_of_the_models_match_jax(name):
    hw = (32, 32)
    xyz, rgb, labels = _room(1200, seed=6)
    feats, pidx = scene.tile_scene(xyz, rgb, 256, 2.0, 1.5, 0)
    arrays = [feats]
    if name == "fusion_sem_seg":
        arrays += list(scene.render_block_views(feats, hw, seed=0))
    jmodel = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _init(jmodel, [a[:2] for a in arrays], seed=3)
    model = get_model(name).builder(num_class=NUM_CLASS)
    load_jax_variables(model, v)
    port = make_predictor(name, model.state_dict(), device="cpu",
                          num_class=NUM_CLASS)
    jax_predict = _jax_predictor(jmodel, v)
    n = feats.shape[0]
    got = scene._vote_loop(port, arrays, pidx, n, 4, len(xyz), NUM_CLASS)
    want = jscene._vote_loop(jax_predict, arrays, pidx, n, 4, len(xyz),
                             NUM_CLASS)
    assert np.abs(want).max() > 0
    _assert_votes(got, want)
    _assert_preds(got.argmax(-1), want)
    # the whole protocol, room metrics included
    kw = dict(labels=labels, rgb=rgb, num_classes=NUM_CLASS, npoints=256,
              block_size=2.0, stride=1.5, batch_size=4)
    if name == "fusion_sem_seg":
        gp, gm = scene.evaluate_scene_multimodal(port, xyz, hw=hw, **kw)
    else:
        gp, gm = scene.evaluate_scene(port, xyz, **kw)
    _assert_preds(gp, want)
    assert gm["coverage"] == pytest.approx(
        float((np.bincount(pidx.reshape(-1), minlength=len(xyz)) > 0).mean()))
