"""The kNN PointNet++ classifier (``pointnet2_cls_knn``) and config 2
(``pointnet2_cls_ssg``) in the port against the JAX package, on the CPU.

``knn_point``, the given-index fused SA tail (``fused_sa_idx`` and its plain
twin), the kNN ``SetAbstraction`` and its routing, the whole
``PointNet2ClsSSG`` eval forward with kNN grouping on and off, the
``classification`` train step and a tiny ``Trainer.fit``. Inputs are made
with numpy from a seed; flax weights move into the port with
``load_jax_variables``. The JAX side runs in its pure-JAX mode and, where a
Pallas kernel is on its path, in its Pallas mode (kernels in interpret
mode), as the JAX package's own tests run it. The CUDA kernel runs only on
the card (``chip_smoke.py`` holds it against the same plain twin there);
here ``test_torch_ops.fake_kernels`` runs its wrapper's kernel path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion_semseg import _apply, _init, _np_tree
from test_torch_ops import _sa_inputs, fake_kernels
from test_torch_training import _assert_trees, _assert_trees_scaled, _grads
from mm3d_tpu.data import augment as jaug
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models.pointnet import pointnet_loss as jax_pointnet_loss
from mm3d_tpu.models.pointnet2 import SetAbstraction as JaxSA
from mm3d_tpu.models.pointnet2 import _want_fused_sa_idx as jax_want_idx
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu.ops import geometry as G
from mm3d_tpu.ops import pallas_kernels as pk
from mm3d_tpu.training import steps as jax_steps
from mm3d_tpu.training.state import TrainState
from mm3d_tpu.training.state import make_optimizer as jax_make_optimizer
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.data.pipeline import _collate
from mm3d_tpu_torch.models import get_model, init_params, pointnet2
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.training import TrainConfig, Trainer, make_predictor, steps
from mm3d_tpu_torch.training.state import make_optimizer
from mm3d_tpu_torch.utils import load_jax_variables, to_jax_tree

NUM_CLASS = 6
LR = 1e-3


# ------------------------------------------------------------- knn_point


def _knn_clouds(case):
    r = np.random.RandomState(21)
    if case == "random":
        xyz = r.randn(2, 160, 3).astype(np.float32)
    elif case == "grid16":
        # the 1/16 grid: exact distances, full of ties
        xyz = r.randint(-16, 17, (2, 160, 3)).astype(np.float32) / 16
    else:
        # duplicated points: every point three times, equal distances
        xyz = np.concatenate([r.randn(2, 60, 3).astype(np.float32)] * 3, 1)
    new_xyz = xyz[:, ::4][:, :40].copy()
    return xyz, new_xyz


@pytest.mark.parametrize("K", [16, 48])
@pytest.mark.parametrize("case", ["random", "grid16", "duplicates"])
def test_knn_point_bit_exact(case, K):
    """Indices bit for bit against G.knn_point (lax.top_k: ascending
    distance, ties to the lower index)."""
    xyz, new_xyz = _knn_clouds(case)
    want = np.asarray(G.knn_point(K, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    got = tops.knn_point(K, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    assert got.dtype == torch.int32 and got.shape == (2, 40, K)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------- given-index fused SA tail


def _idx_case(case):
    """tests/test_fused_sa.py:202-228's cases, and the wide widths (config
    3's sa2, PointNet2SemSegMSG's sa4) in both dtypes -> (K, dtype, inputs,
    idx)."""
    if case == "bf16":
        args = _sa_inputs(32, 2, 128, 32, 24, 24, 32)
        K, dt = 16, "bfloat16"
    elif len(case) == 6:
        B, N, S, K, widths, dt = case
        args = _sa_inputs(4, B, N, S, *widths)
    else:
        (B, N, S, K), dt = case, "float32"
        args = _sa_inputs(31, B, N, S, 24, 16, 40)
    idx = np.array(G.knn_point(K, jnp.asarray(args[0]),
                                 jnp.asarray(args[1])))
    return K, dt, args[2:], idx


@pytest.mark.parametrize("case", [
    (2, 96, 24, 16),    # N not a multiple of 128
    (1, 1024, 32, 32),  # SA1-like shape
    (2, 160, 40, 48),   # K not a power of two
    "bf16",
] + [(1, 256, 8, K, widths, dt) for K, widths in (
    (128, (128, 196, 256)), (32, (256, 384, 512)))
    for dt in ("float32", "bfloat16")])
def test_fused_sa_idx_torch_matches_pallas(case):
    """The plain twin and the dispatching wrapper against
    fused_sa_idx_pallas (interpret), on the same kNN indices: f32 within
    1e-5 (the Pallas kernel's own bound against the composition,
    tests/test_fused_sa.py:224), bf16 max|d| / (|ref| + 1) < 0.05
    (tests/test_fused_sa.py:228)."""
    K, dt, args, idx = _idx_case(case)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = np.asarray(pk.fused_sa_idx_pallas(
        K, jnp.asarray(idx), *[jnp.asarray(a).astype(jdt) for a in args],
        interpret=True).astype(jnp.float32))
    targs = [torch.from_numpy(idx)] + [torch.from_numpy(a).to(tdt)
                                       for a in args]
    got = tops.fused_sa_idx_torch(K, *targs)
    assert got.dtype == tdt and got.shape == want.shape
    assert torch.equal(tops.fused_sa_idx(K, *targs), got)
    got = got.float().numpy()
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.max(np.abs(got - want) / (np.abs(want) + 1)) < 0.05


def test_fused_sa_idx_kernel_path(monkeypatch):
    """The wrapper's kernel path on the CPU: one launch per call, the
    unpadded operands give the twin (repeated indices in a row and K=48,
    not a power of two), and the contract's refusals."""
    _, _, args, idx = _idx_case((2, 160, 40, 48))
    idx = np.array(idx)
    idx[:, 3] = idx[:, 3, :1]  # a row of one repeated neighbour
    targs = [torch.from_numpy(idx)] + list(map(torch.from_numpy, args))
    want = tops.fused_sa_idx_torch(48, *targs)
    ck = fake_kernels(monkeypatch)
    got = tops.fused_sa_idx(48, *targs)
    assert ck.fused_sa_idx.launches == 1 and got.shape == (2, 40, 40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(TypeError, match="int32"):
        tops.fused_sa_idx(48, targs[0].long(), *targs[1:])
    with pytest.raises(TypeError, match="bf16 or f32"):
        tops.fused_sa_idx(48, targs[0], *[t.double() for t in targs[1:]])
    with pytest.raises(ValueError, match=r"\[B,S,16\]"):
        tops.fused_sa_idx(16, *targs)
    big = torch.zeros(2, 1, 160, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 128"):
        tops.fused_sa_idx(160, big, targs[1], targs[2][:, :1], *targs[3:])
    with pytest.raises(ValueError, match="inconsistent"):
        tops.fused_sa_idx(48, targs[0], targs[1], targs[2][:, :5],
                          *targs[3:])
    assert ck.fused_sa_idx.launches == 1


# ------------------------------------------------------- SetAbstraction


@pytest.fixture(scope="module")
def knn_sa_case():
    """tests/test_fused_sa.py:231-254's case, with drawn BN statistics."""
    r = np.random.RandomState(33)
    args = ((r.randn(2, 128, 3) * 0.5).astype(np.float32),
            r.randn(2, 128, 5).astype(np.float32))
    sa = JaxSA(32, 0.4, 16, (24, 24, 48), knn=True)
    return args, sa, _init(sa, args)


@pytest.mark.parametrize("branch,jax_mode", [("unfused", "jax"),
                                             ("fused", "jax"),
                                             ("fused", "pallas")])
def test_knn_set_abstraction_matches_jax(knn_sa_case, branch, jax_mode,
                                         monkeypatch):
    """Eval of SetAbstraction(knn=True): the port's unfused branch and its
    fused one (forced in f32 on the CPU, where ops.fused_sa_idx runs its
    twin) against the JAX module's pure path and its Pallas path
    (fused_sa_idx_pallas, interpret), within 1e-5."""
    args, sa, v = knn_sa_case
    want_xyz, want = _apply(sa, v, args, jax_mode)
    port = pointnet2.SetAbstraction(32, 0.4, 16, 5, (24, 24, 48),
                                    knn=True).eval()
    load_jax_variables(port, _np_tree(v))
    if branch == "fused":
        monkeypatch.setattr(pointnet2, "_want_fused_sa", lambda *a: True)
    with torch.no_grad():
        nx, got = port(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(nx.numpy(), want_xyz)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_want_fused_sa_idx_routing():
    """The routing table of tests/test_fused_sa.py:257-283 against the JAX
    predicate. One row differs on purpose: the JAX package's N <= 16*K gate
    (its one-hot selection grows with N) is dropped, so bf16 serving takes
    the kernel at SA1 (N/K = 32) too."""
    mlp = (64, 64, 128)
    bf, tbf = jnp.bfloat16, torch.bfloat16
    rows = [  # (train, JAX dtype, knn, K, N), port dtype
        ((False, bf, True, 64, 512), tbf),      # SA2-like: routed
        ((False, bf, True, 32, 512), tbf),      # N/K == 16: routed
        ((False, None, True, 64, 512), None),   # fp32 auto: unfused
        ((True, bf, True, 64, 512), tbf),       # train: unfused
        ((False, bf, False, 64, 512), tbf),     # not kNN: unfused
        ((False, bf, True, 192, 512), tbf)]     # K > 128: unfused
    with jdispatch.use_impl("auto"), dispatch.use_impl("auto"):
        for (train, jdt, knn, K, N), tdt in rows:
            assert pointnet2._want_fused_sa_idx(train, mlp, tdt, knn, K) == \
                jax_want_idx(train, mlp, jdt, knn, K, N), (train, jdt, K, N)
        # the dropped gate: SA1-like N/K = 32
        assert not jax_want_idx(False, mlp, bf, True, 32, 1024)
        assert pointnet2._want_fused_sa_idx(False, mlp, tbf, True, 32)
        assert not pointnet2._want_fused_sa_idx(False, (64, 128), tbf, True,
                                                32)
    with jdispatch.use_impl("pallas"), dispatch.use_impl("cuda"):
        # a forced kernel mode routes fp32 as well
        assert jax_want_idx(False, mlp, None, True, 32, 1024)
        assert pointnet2._want_fused_sa_idx(False, mlp, None, True, 32)


# ------------------------------------------------------ whole classifier


def _cloud_batch(B, N, seed):
    pts = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    pts -= pts.mean(1, keepdims=True)
    return pts / np.linalg.norm(pts, axis=-1).max(1)[:, None, None]


@pytest.fixture(scope="module", params=["pointnet2_cls_knn",
                                        "pointnet2_cls_ssg"])
def cls_case(request):
    """B=4 unit-sphere clouds of 256 points, 6 classes, drawn BN
    statistics and affines."""
    name = request.param
    pts = _cloud_batch(4, 256, 5)
    model = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _init(model, (pts,))
    state = load_jax_variables(get_model(name).builder(num_class=NUM_CLASS),
                               _np_tree(v)).state_dict()
    return name, pts, v, state


def test_pointnet2_cls_fp32_logprobs_match_jax(cls_case):
    """fp32 log-probs of make_predictor within 1e-4 of the JAX module."""
    name, pts, v, state = cls_case
    want, aux = _apply(jax_get_model(name).builder(num_class=NUM_CLASS), v,
                       (pts,), "jax")
    pred = make_predictor(name, state, device="cpu", num_class=NUM_CLASS)
    got = pred(torch.from_numpy(pts))
    assert got.shape == (4, NUM_CLASS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert aux["trans_feat"] is None
    assert pred.model(torch.from_numpy(pts))[1] == {"trans_feat": None}


def test_pointnet2_cls_bf16_argmax_matches_jax(cls_case):
    """bf16 serving (the fused kernels' twins) against JAX's bf16 model:
    the same argmax, which is also the port's fp32 argmax."""
    name, pts, v, state = cls_case
    want = _apply(jax_get_model(name).builder(num_class=NUM_CLASS,
                                              dtype=jnp.bfloat16), v,
                  (pts,), "jax")[0]
    p16 = make_predictor(name, state, dtype=torch.bfloat16, device="cpu",
                         num_class=NUM_CLASS)
    p32 = make_predictor(name, state, device="cpu", num_class=NUM_CLASS)
    got = p16(torch.from_numpy(pts)).numpy()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    a16, a32 = got.argmax(-1), p32(torch.from_numpy(pts)).numpy().argmax(-1)
    assert np.array_equal(a16, a32)


@pytest.mark.parametrize("name,dtype,want", [
    ("pointnet2_cls_knn", torch.bfloat16, {"farthest_point_sample": 2,
                                           "fused_sa_idx": 2}),
    ("pointnet2_cls_knn", None, {"farthest_point_sample": 2}),
    ("pointnet2_cls_ssg", torch.bfloat16, {"farthest_point_sample": 2,
                                           "fused_sa": 2}),
    ("pointnet2_cls_ssg", None, {"farthest_point_sample": 2,
                                 "query_ball_point": 2}),
])
def test_pointnet2_cls_serving_launches(name, dtype, want, monkeypatch):
    """The kernel path of a serving forward on the CPU: the launches
    chip_smoke.py checks on the card, and the plain path's log-probs."""
    model = init_params(get_model(name).builder(num_class=NUM_CLASS))
    pts = torch.from_numpy(_cloud_batch(2, 256, 6))
    pred = make_predictor(name, model.state_dict(), dtype=dtype,
                          device="cpu", num_class=NUM_CLASS)
    with dispatch.use_impl("torch"):
        plain = pred(pts)
    ck = fake_kernels(monkeypatch)
    got = pred(pts)
    assert {k.__name__: k.launches for k in ck.KERNELS if k.launches} == want
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pointnet2_cls_flax_tree_round_trip(cls_case):
    """load_jax_variables and to_jax_tree carry a PointNet2ClsSSG flax tree
    both ways, with no entry missing or extra."""
    name, _, v, state = cls_case
    port = get_model(name).builder(num_class=NUM_CLASS)
    port.load_state_dict(state)
    back = to_jax_tree(port)
    _assert_trees(back, _np_tree(v), rtol=0, atol=0)


# ------------------------------------------------------ training


def test_augment_batch_matches_jax_and_refuses_calib():
    """augment_batch's pipeline is the JAX package's classification
    pipeline; a calib-aware name raises as there."""
    assert aug.TASK_PIPELINES["classification"] == \
        jaug.TASK_PIPELINES["classification"]
    pts = torch.from_numpy(_cloud_batch(2, 64, 1))
    out = aug.augment_batch(torch.Generator().manual_seed(0), pts,
                            aug.TASK_PIPELINES["classification"])
    assert out.shape == pts.shape and not torch.equal(out, pts)
    with pytest.raises(ValueError, match="calib"):
        aug.augment_batch(None, pts, ("rotate_point_cloud_z_with_calib",))
    batch = _collate([(pts[0].numpy(), 3), (pts[1].numpy(), 1)])
    assert set(batch) == {"points", "label"}
    assert batch["label"].dtype == torch.int32
    assert batch["label"].tolist() == [3, 1]


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


class _NoDropout:
    """A flax model whose train forward runs without dropout, so that the
    JAX step and the port's see the same network."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kw):
        return self.model.apply(*args, deterministic=True, **kw)


def _cls_step():
    """One classification train step of pointnet2_cls_knn in f64 (B=2
    clouds of 128 points, 6 classes, no augmentation, dropout off): the
    JAX package's make_train_step (loss, metrics, BN statistics, the
    parameters after Adam) and value_and_grad of the same loss (the
    gradients), against the port's make_train_step."""
    name = "pointnet2_cls_knn"
    pts = _cloud_batch(2, 128, 7)
    label = np.array([1, 4], np.int32)
    model = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _f64(_init(model, (pts,)))
    pts = pts.astype(np.float64)
    lr = LR

    def loss_of(params, bs):
        (logp, aux), mut = model.apply(
            {"params": params, "batch_stats": bs}, jnp.asarray(pts),
            train=True, bn_momentum=0.1, deterministic=True,
            mutable=["batch_stats"])
        return jax_pointnet_loss(logp, jnp.asarray(label), aux), logp

    _, grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        v["params"], v["batch_stats"])
    tx = jax_make_optimizer("adam", 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(_NoDropout(model), jax_pointnet_loss,
                                      tx, "classification", donate=False)
    new_state, jm = jstep(state, (jnp.asarray(pts), jnp.asarray(label)), lr,
                          0.1, jax.random.PRNGKey(0))
    want = {"loss": float(jm["loss"]), "accuracy": float(jm["accuracy"]),
            "grads": _np_tree(grads),
            "batch_stats": _np_tree(new_state.batch_stats),
            "params": _np_tree(new_state.params)}

    spec = get_model(name)
    port = load_jax_variables(spec.builder(num_class=NUM_CLASS).double(), v)
    opt = make_optimizer(port.parameters(), "adam", 1e-4)
    step = steps.make_train_step(port, spec.loss, opt, "classification",
                                 deterministic=True)
    m = step({"points": torch.from_numpy(pts),
              "label": torch.from_numpy(label)}, lr, 0.1)
    tree = to_jax_tree(port)
    got = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
           "grads": _grads(port), "batch_stats": tree["batch_stats"],
           "params": tree["params"]}
    return got, want


@pytest.fixture(scope="module")
def cls_step_f64():
    import mm3d_tpu.models.layers as jax_layers

    class _Wide:  # jnp with float32 -> float64, for the BN statistics
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _Wide())
        return _cls_step()


def test_classification_train_step_matches_jax(cls_step_f64):
    """In f64, bounded as the fusion_sem_seg step is: the loss and the BN
    statistics rtol 1e-6 (atol 1e-9); each gradient within 1e-6 of its
    largest element, because the head's log-softmax runs in f32 on both
    sides (measured: 1.4e-7 at worst). A gradient that is zero in exact
    arithmetic (a bias ahead of a train-mode BN) is f64 rounding residue of
    sums of terms the size of the model's largest gradient element, 320
    here: measured up to 1.7e-11 on either side, so the bound adds 1e-13 of
    that element. The parameters after one Adam step, which moves each
    element by lr * g / (|g| + eps): where the gradient lies above its bound
    the two steps agree to 1e-3 of lr (measured 8.8e-5 of lr, where |g| is
    small against its tensor's largest element); where it lies below (its
    sign is rounding) they are at most 2 lr apart."""
    got, want = cls_step_f64
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["accuracy"] == want["accuracy"]
    top = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(
        want["grads"]))
    _assert_trees_scaled(got["grads"], want["grads"], 1e-6,
                         atol=1e-13 * top)
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=1e-6,
                  atol=1e-9)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(want["grads"])[0])
    got_p = dict(jax.tree_util.tree_flatten_with_path(got["params"])[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want["params"])[0]:
        g = np.abs(flat_g[path])
        undetermined = g <= 1e-6 * g.max() + 1e-13 * top
        diff = np.abs(got_p[path] - w)
        assert np.all(diff[undetermined] <= 2 * LR * (1 + 1e-6)), path
        assert np.all(diff[~undetermined] <= 1e-3 * LR), (
            jax.tree_util.keystr(path), diff[~undetermined].max())


@pytest.mark.parametrize("name,dtype", [("pointnet2_cls_knn", "bfloat16"),
                                        ("pointnet2_cls_ssg", "float32")])
def test_trainer_fit_pointnet2_cls_on_cpu(name, dtype, tmp_path):
    """One tiny epoch of the classification task: plain SyntheticModelNet
    clouds (no image), the cls augmentations, finite metrics."""
    cfg = TrainConfig(model=name, epochs=1, batch_size=4, npoint=128,
                      num_class=4, train_size=8, test_size=6, device="cpu",
                      dtype=dtype, bn_refresh_steps=1, log_dir=str(tmp_path))
    tr = Trainer(cfg)
    assert tr.spec.task == "classification"
    out = tr.fit()
    assert np.isfinite(tr.history[0]["train"]["loss"])
    assert 0.0 <= out["instance_acc"] <= 1.0 and np.isfinite(out["eval_loss"])
    assert out["best_instance_acc"] == out["instance_acc"]
