"""PointNet++ part segmentation (config 3, ``pointnet2_part_seg_msg``, and
``pointnet2_part_seg_ssg``) in the port against the JAX package, on the CPU.

``sample_and_group``, ``SetAbstractionMsg``, both part-seg models' eval
forward, the ``partseg`` train step, its metrics, its synthetic data and a
tiny ``Trainer.fit``. Inputs are made with numpy from a seed; flax weights
move into the port with ``load_jax_variables``. The JAX side runs in its
pure-JAX mode and, where a Pallas kernel is on its path, in its Pallas mode
(kernels in interpret mode). The CUDA kernels run only on the card
(``chip_smoke.py`` holds them to the same plain twins there); here
``test_torch_fused_sa.fake_kernels`` runs the wrappers' kernel path, whose
launch counts are those chip_smoke.py checks on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion_semseg import _apply, _init, _np_tree
from test_torch_fused_sa import fake_kernels
from test_torch_knn import _NoDropout, _cloud_batch, _f64
from test_torch_training import _assert_trees, _assert_trees_scaled, _grads
from mm3d_tpu.data import augment as jaug
from mm3d_tpu.data import synthetic as jsyn
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models.pointnet import pointnet_loss as jax_pointnet_loss
from mm3d_tpu.models.pointnet2 import SetAbstractionMsg as JaxMSG
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu.ops import geometry as G
from mm3d_tpu.training import steps as jax_steps
from mm3d_tpu.training.state import TrainState
from mm3d_tpu.training.state import make_optimizer as jax_make_optimizer
from mm3d_tpu.utils import metrics as JM
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.data.pipeline import _collate
from mm3d_tpu_torch.models import get_model, init_params, pointnet2
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.training import TrainConfig, Trainer, make_predictor, steps
from mm3d_tpu_torch.training.state import make_optimizer
from mm3d_tpu_torch.utils import load_jax_variables, metrics, to_jax_tree

MODELS = ("pointnet2_part_seg_msg", "pointnet2_part_seg_ssg")
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after: with
    several test workers on one host, torch's default of a thread a core
    in every worker oversubscribes the cores, and the part-seg forwards ran
    up to 70x slower than in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _partseg_batch(B, N, seed, normals=False):
    """Unit-sphere clouds (with unit normals), their categories one-hot and
    per-point part labels in each category's range."""
    r = np.random.RandomState(seed)
    pts = _cloud_batch(B, N, seed)
    if normals:
        nrm = r.randn(B, N, 3).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        pts = np.concatenate([pts, nrm], -1)
    cat = r.randint(0, 16, B).astype(np.int32)
    ranges = syn.shapenet_part_ranges()
    seg = np.stack([r.randint(*ranges[c], N) for c in cat]).astype(np.int32)
    return pts, np.eye(16, dtype=np.float32)[cat], cat, seg


# ------------------------------------------------------ sample_and_group


# (B, N, npoint, radius, nsample, feature channels or 0, return_fps); the
# last case is the JAX package's own partseg test size, N = 256 points
# through sa1's npoint = 512: FPS indices past N repeat as JAX's do
SAG_CASES = {"no features": (2, 200, 64, 0.3, 16, 0, False),
             "features, return_fps": (2, 200, 64, 0.3, 16, 5, True),
             "npoint > N": (2, 256, 512, 0.2, 32, 3, True)}


@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("case", sorted(SAG_CASES))
def test_sample_and_group_bit_exact(case, path, monkeypatch):
    B, N, S, radius, K, D, ret = SAG_CASES[case]
    r = np.random.RandomState(len(case))
    xyz = (r.randn(B, N, 3) * 0.5).astype(np.float32)
    feats = r.randn(B, N, D).astype(np.float32) if D else None
    want = G.sample_and_group(S, radius, K, jnp.asarray(xyz),
                              None if feats is None else jnp.asarray(feats),
                              return_fps=ret)
    if path == "kernel":
        ck = fake_kernels(monkeypatch)
    got = tops.sample_and_group(S, radius, K, torch.from_numpy(xyz),
                                None if feats is None
                                else torch.from_numpy(feats), return_fps=ret)
    assert len(got) == len(want) == (4 if ret else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].shape == (B, S, K, 3 + D)
    if ret:
        # the lineage's third value: the un-normalised grouped xyz
        assert not np.array_equal(got[2].numpy(), got[1][..., :3].numpy())
    if path == "kernel":
        assert (ck.farthest_point_sample.launches,
                ck.query_ball_point.launches) == (1, 1)


# ------------------------------------------------------ SetAbstractionMsg


@pytest.fixture(scope="module")
def msg_case():
    """B=2 clouds of 128 points with 5 feature channels, 32 centroids, two
    scales ((0.2, 8), (0.4, 16)), drawn BN statistics."""
    r = np.random.RandomState(41)
    args = ((r.randn(2, 128, 3) * 0.5).astype(np.float32),
            r.randn(2, 128, 5).astype(np.float32))
    sa = JaxMSG(32, (0.2, 0.4), (8, 16), ((16, 16, 32), (16, 24, 32)))
    return args, sa, _init(sa, args)


@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("jax_mode", ["jax", "pallas"])
def test_set_abstraction_msg_matches_jax(msg_case, jax_mode, path,
                                         monkeypatch):
    """Eval of SetAbstractionMsg in fp32 within 1e-6: the port's plain path
    (the unfused scale tail) and its kernel path under impl 'cuda' (one
    fused SA launch a scale, the twins run by ``fake_kernels``) against the
    JAX block's pure path and its Pallas path (fused_sa_pallas,
    interpret)."""
    args, sa, v = msg_case
    want_xyz, want = _apply(sa, v, args, jax_mode)
    port = pointnet2.SetAbstractionMsg(32, (0.2, 0.4), (8, 16),
                                       ((16, 16, 32), (16, 24, 32)),
                                       5).eval()
    load_jax_variables(port, _np_tree(v))
    if path == "kernel":
        ck = fake_kernels(monkeypatch)
        monkeypatch.setattr(dispatch, "get_impl", lambda: "cuda")
    with torch.no_grad():
        nx, got = port(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(nx.numpy(), want_xyz)
    assert got.shape == (2, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if path == "kernel":
        assert (ck.farthest_point_sample.launches, ck.fused_sa.launches,
                ck.query_ball_point.launches) == (1, 2, 0)


# ------------------------------------------------------ the models


@pytest.fixture(scope="module", params=[(m, nc) for m in MODELS
                                        for nc in (False, True)],
                ids=lambda p: f"{p[0]}-normals{int(p[1])}")
def model_case(request):
    """B=2 clouds of 512 points (N >= sa1's 512 centroids), drawn BN
    statistics and affines, one flax init filling the port's model."""
    name, normals = request.param
    pts, onehot, _, _ = _partseg_batch(2, 512, 3, normals)
    model = jax_get_model(name).builder(normal_channel=normals)
    v = _init(model, (pts, onehot))
    port = load_jax_variables(
        get_model(name).builder(normal_channel=normals), _np_tree(v))
    return name, normals, (pts, onehot), v, port.state_dict()


def test_partseg_fp32_logprobs_match_jax(model_case):
    """fp32 per-point log-probs of make_predictor within 1e-4 of the JAX
    model (measured ~1e-6), normalised, aux as in JAX."""
    name, normals, args, v, state = model_case
    want, aux = _apply(jax_get_model(name).builder(normal_channel=normals),
                       v, args, "jax")
    pred = make_predictor(name, state, device="cpu", normal_channel=normals)
    got = pred(*map(torch.from_numpy, args))
    assert got.shape == (2, 512, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, atol=1e-5)
    assert aux["trans_feat"] is None
    # every entry of the flax tree, and nothing else, back out of the port
    back = to_jax_tree(pred.model)
    _assert_trees(back, _np_tree(v), rtol=0, atol=0)


def test_partseg_bf16_argmax_matches_jax(model_case):
    """bf16 serving (the fused SA and FP tails' twins) against JAX's bf16
    model and the port's fp32: per-point argmax agreement >= 0.95."""
    name, normals, args, v, state = model_case
    want, _ = _apply(jax_get_model(name).builder(normal_channel=normals,
                                                 dtype=jnp.bfloat16),
                     v, args, "jax")
    targs = list(map(torch.from_numpy, args))
    p16 = make_predictor(name, state, dtype=torch.bfloat16, device="cpu",
                         normal_channel=normals)
    p32 = make_predictor(name, state, device="cpu", normal_channel=normals)
    got = p16(*targs).numpy()
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    drift = float(np.mean(got.argmax(-1)
                          == p32(*targs).numpy().argmax(-1)))
    print(f"{name}: bf16 port vs bf16 JAX {agree}, vs fp32 port {drift}")
    assert agree >= 0.95 and drift >= 0.95


# (model, dtype) -> the launches of one forward or step on the card
LAUNCHES = {
    ("pointnet2_part_seg_msg", "bfloat16"): {
        "farthest_point_sample": 2, "fused_sa": 5, "fused_fp": 2},
    ("pointnet2_part_seg_msg", "float32"): {
        "farthest_point_sample": 2, "query_ball_point": 5, "fused_fp": 2},
    ("pointnet2_part_seg_msg", "train"): {
        "farthest_point_sample": 2, "query_ball_point": 5, "three_nn": 2,
        "three_interpolate": 2, "gather_backward": 7},
    ("pointnet2_part_seg_ssg", "bfloat16"): {
        "farthest_point_sample": 2, "fused_sa": 2, "fused_fp": 2},
    ("pointnet2_part_seg_ssg", "float32"): {
        "farthest_point_sample": 2, "query_ball_point": 2, "fused_fp": 2},
}


@pytest.mark.parametrize("name,mode", sorted(LAUNCHES))
def test_partseg_launches(name, mode, monkeypatch):
    """The kernel path on the CPU: a serving forward's launches (and its
    log-probs, the plain path's), or one train step's (five ball queries
    and their gather backwards, the 3-NN and interpolation of FP2 and FP1
    and the two interpolation backwards; FP3 broadcasts sa3's one point)."""
    spec = get_model(name)
    pts, onehot, cat, seg = _partseg_batch(2, 512, 6)
    model = init_params(spec.builder())
    if mode == "train":
        ck = fake_kernels(monkeypatch)
        step = steps.make_train_step(
            model, spec.loss, make_optimizer(model.parameters(), "adam",
                                             1e-4), "partseg",
            augment_names=aug.TASK_PIPELINES["partseg"],
            generator=torch.Generator().manual_seed(0))
        m = step({"points": torch.from_numpy(pts),
                  "cat": torch.from_numpy(cat),
                  "seg": torch.from_numpy(seg)}, LR, 0.1)
        assert np.isfinite(float(m["loss"]))
    else:
        dtype = torch.bfloat16 if mode == "bfloat16" else None
        pred = make_predictor(name, model.state_dict(), dtype=dtype,
                              device="cpu")
        args = (torch.from_numpy(pts), torch.from_numpy(onehot))
        plain = pred(*args)
        ck = fake_kernels(monkeypatch)
        got = pred(*args)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert {k.__name__: k.launches for k in ck.KERNELS
            if k.launches} == LAUNCHES[name, mode]


# ------------------------------------------------------ train step


def _partseg_step():
    """One partseg train step of pointnet2_part_seg_msg in f64 (B=2 clouds
    of 512 points, no augmentation, dropout off): the JAX package's
    make_train_step (loss, metrics, BN statistics) and value_and_grad of the
    same loss (the gradients), against the port's make_train_step."""
    name = "pointnet2_part_seg_msg"
    pts, onehot, cat, seg = _partseg_batch(2, 512, 8)
    model = jax_get_model(name).builder()
    v = _f64(_init(model, (pts, onehot)))
    pts, onehot = pts.astype(np.float64), onehot.astype(np.float64)

    def loss_of(params, bs):
        (logp, aux), mut = model.apply(
            {"params": params, "batch_stats": bs}, jnp.asarray(pts),
            jnp.asarray(onehot), train=True, bn_momentum=0.1,
            deterministic=True, mutable=["batch_stats"])
        return jax_pointnet_loss(logp, jnp.asarray(seg), aux), logp

    _, grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        v["params"], v["batch_stats"])
    tx = jax_make_optimizer("adam", 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(_NoDropout(model), jax_pointnet_loss,
                                      tx, "partseg", donate=False)
    new_state, jm = jstep(state, tuple(map(jnp.asarray, (pts, cat, seg))),
                          LR, 0.1, jax.random.PRNGKey(0))
    want = {"loss": float(jm["loss"]), "accuracy": float(jm["accuracy"]),
            "grads": _np_tree(grads),
            "batch_stats": _np_tree(new_state.batch_stats)}

    spec = get_model(name)
    port = load_jax_variables(spec.builder().double(), v)
    opt = make_optimizer(port.parameters(), "adam", 1e-4)
    step = steps.make_train_step(port, spec.loss, opt, "partseg",
                                 deterministic=True)
    inputs = []
    hook = port.register_forward_pre_hook(
        lambda m, a: inputs.append([t.dtype for t in a]))
    m = step({"points": torch.from_numpy(pts), "cat": torch.from_numpy(cat),
              "seg": torch.from_numpy(seg)}, LR, 0.1)
    hook.remove()
    tree = to_jax_tree(port)
    got = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
           "grads": _grads(port), "batch_stats": tree["batch_stats"],
           "input_dtypes": inputs[0]}
    return got, want


@pytest.fixture(scope="module")
def partseg_step_f64():
    import mm3d_tpu.models.layers as jax_layers

    class _Wide:  # jnp with float32 -> float64, for the BN statistics
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _Wide())
        return _partseg_step()


def test_partseg_train_step_matches_jax(partseg_step_f64):
    """In f64, held as the classification step is: the loss and the BN
    statistics rtol 1e-6 (atol 1e-9), each gradient within 1e-6 of its
    largest element (the head's log-softmax runs in f32 on both sides). A
    gradient that is zero in
    exact arithmetic (a bias ahead of a train-mode BN) is f64 rounding
    residue of a sum over the BN's rows, 32,768 at sa1's first scale (2 x
    512 x 32, against 1,024 in the classification step): measured up to
    2.2e-13 of the model's largest gradient element on either side, so the
    bound adds 1e-12 of that element. The one-hot reaches the model in the
    points' dtype, as JAX builds it."""
    got, want = partseg_step_f64
    assert got["input_dtypes"] == [torch.float64, torch.float64]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["accuracy"] == want["accuracy"]
    top = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(
        want["grads"]))
    _assert_trees_scaled(got["grads"], want["grads"], 1e-6,
                         atol=1e-12 * top)
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=1e-6,
                  atol=1e-9)


def test_partseg_eval_step_matches_jax(model_case):
    """The partseg eval step on a padded batch (the last row invalid): the
    category-masked argmax, the loss over the valid rows, correct and
    count, the shape IoUs, categories and mask of the JAX eval step."""
    name, normals, (pts, onehot), v, state = model_case
    cat = onehot.argmax(-1).astype(np.int32)
    ranges = syn.shapenet_part_ranges()
    r = np.random.RandomState(9)
    seg = np.stack([r.randint(*ranges[c], 512) for c in cat]).astype(
        np.int32)
    start = np.array([ranges[c][0] for c in range(16)], np.int32)
    count = np.array([ranges[c][1] - ranges[c][0] for c in range(16)],
                     np.int32)
    valid = np.array([True, False])
    model = jax_get_model(name).builder(normal_channel=normals)
    state0 = TrainState(step=0, params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=None)
    with jdispatch.use_impl("jax"), jax.default_matmul_precision("float32"):
        want = jax_steps.make_eval_step(
            model, jax_pointnet_loss, "partseg", 50,
            part_start=jnp.asarray(start), part_count=jnp.asarray(count),
            max_parts=6)(state0, tuple(map(jnp.asarray, (pts, cat, seg))),
                         jnp.asarray(valid))
    port = get_model(name).builder(normal_channel=normals)
    port.load_state_dict(state)
    got = steps.make_eval_step(
        port, get_model(name).loss, "partseg", 50,
        part_start=torch.from_numpy(start),
        part_count=torch.from_numpy(count), max_parts=6)(
            {"points": torch.from_numpy(pts), "cat": torch.from_numpy(cat),
             "seg": torch.from_numpy(seg)}, torch.from_numpy(valid))
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("correct", "count", "cats", "valid"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["ious"].numpy(), np.asarray(want["ious"]),
                               rtol=1e-6)


# ------------------------------------------------------ metrics and data


def _metric_case():
    """Log-probs with exact ties and -inf entries, and labels where some
    parts of a shape are absent from both prediction and target (their
    IoU counts 1)."""
    r = np.random.RandomState(12)
    B, N, P = 4, 40, 50
    lp = np.round(r.randn(B, N, P), 1).astype(np.float32)  # many ties
    lp[0, :5, 2:4] = 9.0  # a tie inside category 0's range (0..3)
    lp[1, 3, :] = -np.inf  # category 1's parts are 4 and 5
    lp[1, 3, 5] = 0.0
    cat = np.array([0, 1, 10, 10], np.int32)
    ranges = syn.shapenet_part_ranges()
    start = np.array([ranges[c][0] for c in cat], np.int32)
    count = np.array([ranges[c][1] - ranges[c][0] for c in cat], np.int32)
    seg = np.stack([r.randint(s, s + 2, N) for s in start]).astype(np.int32)
    return lp, cat, start, count, seg


def test_partseg_metrics_match_jax():
    """masked_part_argmax (first index on ties, -inf outside the range),
    shape_ious and partseg_metrics_host: exactly JAX's."""
    lp, cat, start, count, seg = _metric_case()
    want_pred = np.asarray(JM.masked_part_argmax(
        jnp.asarray(lp), jnp.asarray(start), jnp.asarray(count)))
    pred = metrics.masked_part_argmax(torch.from_numpy(lp),
                                      torch.from_numpy(start),
                                      torch.from_numpy(count))
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), want_pred)
    assert (pred[0, :5] == 2).all()  # the first of the tied parts
    assert pred[1, 3] == 5
    want_ious = np.asarray(JM.shape_ious(
        jnp.asarray(want_pred), jnp.asarray(seg), jnp.asarray(start),
        jnp.asarray(count), 6))
    ious = metrics.shape_ious(pred, torch.from_numpy(seg),
                              torch.from_numpy(start),
                              torch.from_numpy(count), 6)
    np.testing.assert_array_equal(ious.numpy(), want_ious)
    # a perfect prediction scores 1 though only 2 of category 10's 6 parts
    # appear: the 4 absent from both sides (empty union) count 1 each
    perfect = metrics.shape_ious(torch.from_numpy(seg), torch.from_numpy(seg),
                                 torch.from_numpy(start),
                                 torch.from_numpy(count), 6)
    assert perfect.tolist() == [1.0] * 4
    host = metrics.partseg_metrics_host(ious.numpy(), cat, 16)
    assert host == JM.partseg_metrics_host(want_ious, cat, 16)
    assert metrics.partseg_metrics_host(np.zeros(0), np.zeros(0, np.int32),
                                        16) == {"instance_miou": 0.0,
                                                "class_miou": 0.0}


@pytest.mark.parametrize("split,normals", [("train", False), ("test", True)])
def test_synthetic_shapenet_part_matches_jax(split, normals):
    """Part ranges and samples array for array, and the batch the pipeline
    makes of them ({"points", "cat", "seg"}, int32 labels)."""
    assert syn.shapenet_part_ranges() == jsyn.shapenet_part_ranges()
    kw = dict(npoints=300, normals=normals, size=20, seed=4, split=split)
    ds, jds = syn.SyntheticShapeNetPart(**kw), jsyn.SyntheticShapeNetPart(**kw)
    for i in (0, 7, 19):
        got, want = ds[i], jds[i]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    batch = _collate([ds[0], ds[5]])
    assert set(batch) == {"points", "cat", "seg"}
    assert batch["cat"].dtype == batch["seg"].dtype == torch.int32
    assert batch["points"].shape == (2, 300, 6 if normals else 3)
    assert aug.TASK_PIPELINES["partseg"] == jaug.TASK_PIPELINES["partseg"]


def test_partseg_request_is_the_test_split():
    pts, onehot, cat, seg = syn.partseg_request(3, 256, seed=2)
    ds = jsyn.SyntheticShapeNetPart(npoints=256, size=3, seed=2,
                                    split="test")
    for i in range(3):
        np.testing.assert_array_equal(pts[i], ds[i][0])
        np.testing.assert_array_equal(seg[i], ds[i][2])
        assert cat[i] == ds[i][1] and onehot[i].argmax() == cat[i]
    assert onehot.dtype == np.float32 and onehot.sum() == 3


# ------------------------------------------------------ Trainer


def test_trainer_fit_partseg_on_cpu(monkeypatch, tmp_path):
    """One epoch of pointnet2_part_seg_msg at the registry's 2,048 points on
    the CPU: finite loss, point accuracy, instance and class mIoU; the
    default device is the card, and without one the Trainer raises."""
    cfg = TrainConfig(model="pointnet2_part_seg_msg", epochs=1, batch_size=2,
                      npoint=2048, train_size=2, test_size=3, device="cpu",
                      log_dir=str(tmp_path))
    tr = Trainer(cfg)
    assert tr.spec.task == "partseg" and tr.num_classes == 50
    out = tr.fit()
    assert np.isfinite(tr.history[0]["train"]["loss"])
    assert np.isfinite(out["eval_loss"]) and 0.0 <= out["point_acc"] <= 1.0
    for k in ("instance_miou", "class_miou"):
        assert 0.0 <= out[k] <= 1.0, (k, out)
    assert out["best_instance_miou"] == out["instance_miou"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(model="pointnet2_part_seg_msg", npoint=2048,
                            train_size=2, test_size=2))
