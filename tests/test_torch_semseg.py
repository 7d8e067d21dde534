"""The last PointNet++ tops (``pointnet2_cls_msg``, ``pointnet2_sem_seg``,
``pointnet2_sem_seg_msg``) and the ``semseg`` task in the port against the
JAX package, on the CPU.

The three models' eval forward (fp32 log-probs, bf16 argmax, every index of
the path: each SA block's FPS centroids, each scale's ball query and each FP
block's 3-NN), the ``semseg`` train step in f64, its eval step (confusion
matrix), its data and augmentation, and a tiny ``Trainer.fit``. Weights
come from one flax init (BN statistics, affines and biases drawn with
numpy) through ``load_jax_variables``; inputs from numpy seeds. The inputs
hold fewer points than sa1's centroids (512 against 1,024; 256 against
512 for the classifier), so FPS runs past N as in the JAX package. The JAX
side runs in its pure-JAX mode. ``test_torch_fused_sa.fake_kernels`` runs
the wrappers' kernel path on the CPU: its launch counts are those
chip_smoke.py checks on the card.
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
from mm3d_tpu.models.pointnet2 import SetAbstraction as JaxSA
from mm3d_tpu.models.pointnet2 import SetAbstractionMsg as JaxMSG
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu.ops import geometry as G
from mm3d_tpu.training import steps as jax_steps
from mm3d_tpu.training.state import TrainState
from mm3d_tpu.training.state import make_optimizer as jax_make_optimizer
from mm3d_tpu.utils import metrics as JM
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.data.pipeline import DataPipeline, _collate
from mm3d_tpu_torch.models import get_model, init_params
from mm3d_tpu_torch.training import TrainConfig, Trainer, make_predictor, steps
from mm3d_tpu_torch.training.loop import build_datasets
from mm3d_tpu_torch.training.state import make_optimizer
from mm3d_tpu_torch.utils import load_jax_variables, to_jax_tree

MODELS = ("pointnet2_cls_msg", "pointnet2_sem_seg", "pointnet2_sem_seg_msg")
NUM_CLASS = 13
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (several
    test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blocks(B, N, seed):
    """9-dim indoor-block features: xyz in a 1.5-radius ball, rgb and the
    normalised room coordinates in [0, 1); per-point labels of 13
    classes."""
    r = np.random.RandomState(seed)
    xyz = _cloud_batch(B, N, seed) * 1.5
    pts = np.concatenate([xyz, r.rand(B, N, 3), r.rand(B, N, 3)], -1)
    return (pts.astype(np.float32),
            r.randint(0, NUM_CLASS, (B, N)).astype(np.int32))


def _inputs(name):
    """B=2 inputs with fewer points than sa1's centroids."""
    if name == "pointnet2_cls_msg":
        return (_cloud_batch(2, 256, 3),), np.array([1, 4], np.int32)
    pts, seg = _blocks(2, 512, 3)
    return (pts,), seg


@pytest.fixture(scope="module", params=MODELS)
def model_case(request):
    name = request.param
    args, target = _inputs(name)
    model = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _init(model, args)
    port = load_jax_variables(get_model(name).builder(num_class=NUM_CLASS),
                              _np_tree(v))
    return name, args, target, v, port.state_dict()


def test_fp32_logprobs_match_jax(model_case):
    """fp32 log-probs of make_predictor within 1e-4 of the JAX model's
    (measured ~1e-6), normalised; the flax tree back out unchanged."""
    name, args, _, v, state = model_case
    want, aux = _apply(jax_get_model(name).builder(num_class=NUM_CLASS), v,
                       args, "jax")
    pred = make_predictor(name, state, device="cpu", num_class=NUM_CLASS)
    got = pred(*map(torch.from_numpy, args))
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    print(f"{name}: fp32 max|d logp| {err}")
    assert err <= 1e-4
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, atol=1e-5)
    assert aux["trans_feat"] is None
    _assert_trees(to_jax_tree(pred.model), _np_tree(v), rtol=0, atol=0)


def test_indices_bit_exact(model_case):
    """Every index of the eval path equals JAX's: each SA block's centroids
    (FPS past N included), each scale's ball query over the JAX levels and
    each FP block's 3-NN between them."""
    name, args, _, v, state = model_case
    jmodel = jax_get_model(name).builder(num_class=NUM_CLASS)
    with jdispatch.use_impl("jax"), jax.default_matmul_precision("float32"):
        _, inter = jax.jit(lambda v: jmodel.apply(
            v, *map(jnp.asarray, args), train=False,
            capture_intermediates=lambda m, _: isinstance(
                m, (JaxSA, JaxMSG)),
            mutable=["intermediates"]))(v)
    inter = inter["intermediates"]
    port = get_model(name).builder(num_class=NUM_CLASS).eval()
    port.load_state_dict(state)
    blocks = [n for n in ("sa1", "sa2", "sa3", "sa4") if n in inter]
    got = {}

    def keep(name):
        def hook(module, inputs, out):
            got[name] = out[0]
        return hook

    hooks = [getattr(port, n).register_forward_hook(keep(n)) for n in blocks]
    with torch.no_grad():
        port(*map(torch.from_numpy, args))
    for h in hooks:
        h.remove()
    levels = [args[0][..., :3]]
    for n in blocks:
        want_xyz = np.array(inter[n]["__call__"][0][0])  # writable copy
        np.testing.assert_array_equal(got[n].numpy(), want_xyz, err_msg=n)
        levels.append(want_xyz)
    for n, (x, c) in zip(blocks, zip(levels, levels[1:])):
        blk = getattr(port, n)
        if getattr(blk, "group_all", False):
            continue
        scales = (zip(blk.radius_list, blk.nsample_list)
                  if hasattr(blk, "radius_list")
                  else [(blk.radius, blk.nsample)])
        for radius, K in scales:
            with jdispatch.use_impl("jax"):
                want = G.query_ball_point(radius, K, jnp.asarray(x),
                                          jnp.asarray(c))
            np.testing.assert_array_equal(
                tops.query_ball_point(radius, K, torch.from_numpy(x),
                                      torch.from_numpy(c)).numpy(),
                np.asarray(want), err_msg=f"{n} r={radius} K={K}")
    if name != "pointnet2_cls_msg":  # the FP blocks' 3-NN, dense <- sparse
        for dense, sparse in zip(levels, levels[1:]):
            with jdispatch.use_impl("jax"):
                _, want = G.three_nn(jnp.asarray(dense), jnp.asarray(sparse))
            _, idx = tops.three_nn(torch.from_numpy(dense),
                                   torch.from_numpy(sparse))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


def test_bf16_argmax_matches_jax(model_case):
    """bf16 serving (the fused SA and FP tails' twins) against JAX's bf16
    model and the port's fp32: argmax agreement >= 0.95."""
    name, args, _, v, state = model_case
    want, _ = _apply(jax_get_model(name).builder(num_class=NUM_CLASS,
                                                 dtype=jnp.bfloat16),
                     v, args, "jax")
    targs = list(map(torch.from_numpy, args))
    got = make_predictor(name, state, dtype=torch.bfloat16, device="cpu",
                         num_class=NUM_CLASS)(*targs).numpy()
    p32 = make_predictor(name, state, device="cpu",
                         num_class=NUM_CLASS)(*targs).numpy()
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    drift = float(np.mean(got.argmax(-1) == p32.argmax(-1)))
    print(f"{name}: bf16 port vs bf16 JAX {agree}, vs fp32 port {drift}")
    assert agree >= 0.95 and drift >= 0.95


@pytest.mark.parametrize("model_case", MODELS[1:], indirect=True)
def test_semseg_eval_step_matches_jax(model_case):
    """The semseg eval step on a padded batch (the last row invalid): the
    confusion matrix, correct and count exactly JAX's, the loss over the
    valid row within 1e-5."""
    name, args, seg, v, state = model_case
    valid = np.array([True, False])
    state0 = TrainState(step=0, params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=None)
    model = jax_get_model(name).builder(num_class=NUM_CLASS)
    with jdispatch.use_impl("jax"), jax.default_matmul_precision("float32"):
        want = jax_steps.make_eval_step(model, jax_pointnet_loss, "semseg",
                                        NUM_CLASS)(
            state0, (jnp.asarray(args[0]), jnp.asarray(seg)),
            jnp.asarray(valid))
    port = get_model(name).builder(num_class=NUM_CLASS)
    port.load_state_dict(state)
    got = steps.make_eval_step(port, get_model(name).loss, "semseg",
                               NUM_CLASS)(
        {"points": torch.from_numpy(args[0]), "seg": torch.from_numpy(seg)},
        torch.from_numpy(valid))
    assert set(got) == set(want)
    for k in ("correct", "count", "cm"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert int(got["count"]) == seg.shape[1]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)


# (model, dtype) -> the launches of one forward or step on the card
LAUNCHES = {
    ("pointnet2_cls_msg", "bfloat16"): {
        "farthest_point_sample": 2, "fused_sa": 6},
    ("pointnet2_cls_msg", "float32"): {
        "farthest_point_sample": 2, "query_ball_point": 6},
    ("pointnet2_cls_msg", "train"): {
        "farthest_point_sample": 2, "query_ball_point": 6,
        "gather_backward": 6},
    ("pointnet2_sem_seg", "bfloat16"): {
        "farthest_point_sample": 4, "fused_sa": 4, "fused_fp": 4},
    ("pointnet2_sem_seg", "float32"): {
        "farthest_point_sample": 4, "query_ball_point": 4, "fused_fp": 4},
    ("pointnet2_sem_seg", "train"): {
        "farthest_point_sample": 4, "query_ball_point": 4, "three_nn": 4,
        "three_interpolate": 4, "gather_backward": 8},
    ("pointnet2_sem_seg_msg", "bfloat16"): {
        "farthest_point_sample": 4, "fused_sa": 8, "fused_fp": 4},
    ("pointnet2_sem_seg_msg", "float32"): {
        "farthest_point_sample": 4, "query_ball_point": 8, "fused_fp": 4},
    ("pointnet2_sem_seg_msg", "train"): {
        "farthest_point_sample": 4, "query_ball_point": 8, "three_nn": 4,
        "three_interpolate": 4, "gather_backward": 12},
}


@pytest.mark.parametrize("name,mode", sorted(LAUNCHES))
def test_launches(name, mode, monkeypatch):
    """The kernel path on the CPU: a serving forward's launches (and its
    log-probs, the plain path's), or one train step's (each ball query's
    gather backward; each FP block's 3-NN, interpolation and weighted
    gather backward)."""
    spec = get_model(name)
    args, target = _inputs(name)
    targs = list(map(torch.from_numpy, args))
    model = init_params(spec.builder(num_class=NUM_CLASS))
    if mode == "train":
        ck = fake_kernels(monkeypatch)
        step = steps.make_train_step(
            model, spec.loss, make_optimizer(model.parameters(), "adam",
                                             1e-4), spec.task,
            augment_names=aug.TASK_PIPELINES[spec.task],
            generator=torch.Generator().manual_seed(0))
        key = "seg" if spec.task == "semseg" else "label"
        m = step({"points": targs[0], key: torch.from_numpy(target)}, LR,
                 0.1)
        assert np.isfinite(float(m["loss"]))
    else:
        dtype = torch.bfloat16 if mode == "bfloat16" else None
        pred = make_predictor(name, model.state_dict(), dtype=dtype,
                              device="cpu", num_class=NUM_CLASS)
        plain = pred(*targs)
        ck = fake_kernels(monkeypatch)
        got = pred(*targs)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert {k.__name__: k.launches for k in ck.KERNELS
            if k.launches} == LAUNCHES[name, mode]


# ------------------------------------------------------ train step


def _semseg_step():
    """One semseg train step of pointnet2_sem_seg in f64 (B=2 blocks of 512
    points, no augmentation, dropout off): the JAX package's
    make_train_step (loss, metrics, BN statistics) and value_and_grad of
    the same loss (the gradients), against the port's make_train_step."""
    name = "pointnet2_sem_seg"
    pts, seg = _blocks(2, 512, 8)
    model = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _f64(_init(model, (pts,)))
    pts = pts.astype(np.float64)

    def loss_of(params, bs):
        (logp, aux), mut = model.apply(
            {"params": params, "batch_stats": bs}, jnp.asarray(pts),
            train=True, bn_momentum=0.1, deterministic=True,
            mutable=["batch_stats"])
        return jax_pointnet_loss(logp, jnp.asarray(seg), aux), logp

    _, grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        v["params"], v["batch_stats"])
    tx = jax_make_optimizer("adam", 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(_NoDropout(model), jax_pointnet_loss,
                                      tx, "semseg", donate=False)
    new_state, jm = jstep(state, (jnp.asarray(pts), jnp.asarray(seg)), LR,
                          0.1, jax.random.PRNGKey(0))
    want = {"loss": float(jm["loss"]), "accuracy": float(jm["accuracy"]),
            "grads": _np_tree(grads),
            "batch_stats": _np_tree(new_state.batch_stats)}

    spec = get_model(name)
    port = load_jax_variables(spec.builder(num_class=NUM_CLASS).double(), v)
    opt = make_optimizer(port.parameters(), "adam", 1e-4)
    step = steps.make_train_step(port, spec.loss, opt, "semseg",
                                 deterministic=True)
    m = step({"points": torch.from_numpy(pts), "seg": torch.from_numpy(seg)},
             LR, 0.1)
    tree = to_jax_tree(port)
    got = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
           "grads": _grads(port), "batch_stats": tree["batch_stats"]}
    return got, want


@pytest.fixture(scope="module")
def semseg_step_f64():
    import mm3d_tpu.models.layers as jax_layers

    class _Wide:  # jnp with float32 -> float64, for the BN statistics
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _Wide())
        return _semseg_step()


def test_semseg_train_step_matches_jax(semseg_step_f64):
    """In f64, held as the partseg step is: the loss and the BN statistics
    rtol 1e-6 (atol 1e-9), the per-point accuracy exactly, each gradient
    within 1e-6 of its largest element (the head's log-softmax runs in f32
    on both sides), plus 1e-12 of the model's largest gradient element for
    the f64 rounding residue of a bias ahead of a train-mode BN."""
    got, want = semseg_step_f64
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["accuracy"] == want["accuracy"]
    top = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(
        want["grads"]))
    _assert_trees_scaled(got["grads"], want["grads"], 1e-6,
                         atol=1e-12 * top)
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=1e-6,
                  atol=1e-9)


# ------------------------------------------------------ data and Trainer


def test_semseg_data_and_augmentation_match_jax():
    """``build_datasets`` gives the semseg task the plain
    SyntheticIndoorScene (JAX's samples array for array), the pipeline
    batches it as {"points", "seg"} (int32 labels), and the task's
    augmentation is JAX's: a rotation about Z of xyz alone."""
    cfg = TrainConfig(model="pointnet2_sem_seg", npoint=300, train_size=6,
                      test_size=4, device="cpu")
    train_ds, test_ds = build_datasets(cfg, "semseg")
    jds = jsyn.SyntheticIndoorScene(npoints=300, size=6, seed=0,
                                    split="train")
    for i in (0, 5):
        np.testing.assert_array_equal(train_ds[i][0], jds[i][0])
        np.testing.assert_array_equal(train_ds[i][1], jds[i][1])
    assert len(test_ds) == 4 and test_ds.split == "test"
    batch = _collate([train_ds[0], train_ds[1]])
    assert set(batch) == {"points", "seg"}
    assert batch["seg"].dtype == torch.int32
    assert batch["points"].shape == (2, 300, 9)
    assert next(iter(DataPipeline(train_ds, 2).epoch(0)))["seg"].shape == (
        2, 300)
    assert aug.TASK_PIPELINES["semseg"] == jaug.TASK_PIPELINES["semseg"]
    out = aug.augment_batch(torch.Generator().manual_seed(0),
                            batch["points"], aug.TASK_PIPELINES["semseg"])
    np.testing.assert_array_equal(out[..., 3:].numpy(),
                                  batch["points"][..., 3:].numpy())
    np.testing.assert_allclose(out[..., 2].numpy(),
                               batch["points"][..., 2].numpy())
    assert not np.allclose(out[..., :2].numpy(),
                           batch["points"][..., :2].numpy())


def test_semseg_eval_reduction_matches_jax_metrics(tmp_path):
    """The Trainer's semseg eval reduction: point accuracy and mIoU from the
    summed confusion matrix, as JAX's ``iou_from_confusion``."""
    cfg = TrainConfig(model="pointnet_sem_seg", epochs=1, batch_size=2,
                      npoint=128, train_size=2, test_size=3, device="cpu",
                      log_dir=str(tmp_path))
    tr = Trainer(cfg)
    cms = []
    step = tr.eval_step
    tr.eval_step = lambda b, v: cms.append(step(b, v)) or cms[-1]
    out = tr.evaluate()
    cm = sum(m["cm"] for m in cms).numpy()
    assert cm.sum() == 3 * 128  # the padded row counts nowhere
    _, miou = JM.iou_from_confusion(jnp.asarray(cm))
    assert out["miou"] == pytest.approx(float(miou), rel=1e-6)
    assert out["point_acc"] == pytest.approx(np.trace(cm) / cm.sum())


@pytest.mark.parametrize("name,dtype", [("pointnet2_sem_seg", "bfloat16"),
                                        ("pointnet2_sem_seg_msg", "float32"),
                                        ("pointnet2_cls_msg", "bfloat16")])
def test_trainer_fit_on_cpu(name, dtype, tmp_path):
    """One tiny epoch: finite loss and the task's headline metric (mIoU for
    semseg) in [0, 1]."""
    task = get_model(name).task
    cfg = TrainConfig(model=name, epochs=1, batch_size=2,
                      npoint=256 if task == "semseg" else 128, num_class=4,
                      train_size=4, test_size=3, device="cpu", dtype=dtype,
                      bn_refresh_steps=1, log_dir=str(tmp_path))
    tr = Trainer(cfg)
    out = tr.fit()
    assert tr.num_classes == (cfg.seg_classes if task == "semseg" else 4)
    assert np.isfinite(tr.history[0]["train"]["loss"])
    assert np.isfinite(out["eval_loss"])
    key = "miou" if task == "semseg" else "instance_acc"
    assert 0.0 <= out[key] <= 1.0 and out[f"best_{key}"] == out[key]
    if task == "semseg":
        assert 0.0 <= out["point_acc"] <= 1.0
