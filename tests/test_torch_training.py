"""The port's training path against the JAX package, on the CPU.

Train-mode BatchNorm, SetAbstraction, the image CNN, the whole
``fusion_cls`` train step (loss, every gradient, the new BN statistics and
the parameters after one Adam step) and the whole ``fusion_sem_seg`` train
step (loss, every gradient, the new BN statistics) go through the JAX
module and its
mm3d_tpu_torch counterpart on the same numpy inputs and flax weights. The
gradients and parameters are paired leaf by leaf through
``utils.jax_import.to_jax_tree``. On CPU tensors the kernel wrappers take
their plain twins; ``chip_smoke.py`` holds the kernels to the same twins on
the card. The JAX side runs with float32 matmuls.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _helpers import jit_init
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models.image import ImageEncoder as JaxImageEncoder
from mm3d_tpu.models.layers import BatchNorm as JaxBN
from mm3d_tpu.models.pointnet import pointnet_loss as jax_pointnet_loss
from mm3d_tpu.models.pointnet2 import SetAbstraction as JaxSA
from mm3d_tpu.training import schedules as jax_schedules
from mm3d_tpu.training.state import (TrainState, apply_updates,
                                     make_optimizer as jax_make_optimizer)
from mm3d_tpu.utils import metrics as JM
from mm3d_tpu_torch.models import get_model, pointnet2
from mm3d_tpu_torch.models.image import ImageEncoder
from mm3d_tpu_torch.models.layers import BatchNorm
from mm3d_tpu_torch.models.pointnet import nll_loss
from mm3d_tpu_torch.training import TrainConfig, Trainer, schedules, steps
from mm3d_tpu_torch.training.state import make_optimizer, set_lr
from mm3d_tpu_torch.utils import load_jax_variables, metrics, to_jax_tree

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)  # tests/test_grad_parity.py's bound


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _trained(module, args, nsteps=1, rngs=None):
    """flax init + a few train passes (BN statistics move off 0/1)."""
    rngs = rngs or {"params": jax.random.PRNGKey(0),
                    "dropout": jax.random.PRNGKey(1)}
    v = jit_init(module, rngs, *args, train=True)
    params, bs = v["params"], v["batch_stats"]
    step = jax.jit(lambda p, b, i: module.apply(
        {"params": p, "batch_stats": b}, *args, train=True,
        rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(2), i)},
        mutable=["batch_stats"]))
    for i in range(nsteps):
        _, mut = step(params, bs, i)
        bs = mut["batch_stats"]
    return {"params": params, "batch_stats": bs}


def _assert_trees(got, want, **tol):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _assert_trees_scaled(got, want, rel, atol=0.0):
    """Per leaf, max|got - want| <= rel * max|want| + atol: a bound on the
    error relative to the tensor's scale, for sums whose elements cancel."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        w = np.asarray(w)
        err = np.abs(flat_g[path] - w).max()
        assert err <= rel * np.abs(w).max() + atol, (
            jax.tree_util.keystr(path), err)


def _grads(model):
    return to_jax_tree(model, {n: p.grad for n, p in model.named_parameters()
                               })["params"]


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("offset", [0.0, 300.0])
def test_batchnorm_train_matches_jax(offset):
    """y, the new running statistics and the x/scale/bias gradients;
    offset 300 with std ~0.5 is the |mean| >> std case the shifted single
    pass exists for."""
    r = np.random.RandomState(0)
    x = (r.randn(4, 6, 16) * 0.5 + offset).astype(np.float32)
    dy = r.randn(4, 6, 16).astype(np.float32)
    scale = (1 + 0.1 * r.randn(16)).astype(np.float32)
    bias = (0.1 * r.randn(16)).astype(np.float32)
    stats = {"mean": (0.1 * r.randn(16)).astype(np.float32),
             "var": r.uniform(0.5, 1.5, 16).astype(np.float32)}
    bn = JaxBN()

    def fwd(x, p):
        return bn.apply({"params": p, "batch_stats": stats}, x,
                        use_running_average=False, momentum=0.3,
                        mutable=["batch_stats"])

    p = {"scale": scale, "bias": bias}
    y, vjp, mut = jax.vjp(fwd, jnp.asarray(x), p, has_aux=True)
    dx, dp = vjp(jnp.asarray(dy))

    port = BatchNorm(16)
    load_jax_variables(port, {"params": p, "batch_stats": stats})
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = port(tx, momentum=0.3)
    ty.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **F32)
    np.testing.assert_allclose(port.mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), **F32)
    np.testing.assert_allclose(port.var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), **F32)
    np.testing.assert_allclose(port.scale.grad.numpy(),
                               np.asarray(dp["scale"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(),
                               np.asarray(dp["bias"]), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------- SetAbstraction


@pytest.fixture(scope="module")
def sa_train_case():
    r = np.random.RandomState(3)
    xyz = (r.randn(2, 128, 3) * 0.5).astype(np.float32)
    feats = r.randn(2, 128, 5).astype(np.float32)
    co = r.randn(2, 32, 48).astype(np.float32)
    v = _trained(JaxSA(32, 0.4, 16, (24, 24, 48)),
                 (jnp.asarray(xyz), jnp.asarray(feats)))
    return xyz, feats, co, v


def _jax_sa_train(v, xyz, feats, co, dtype=None):
    sa = JaxSA(32, 0.4, 16, (24, 24, 48), dtype=dtype)

    def loss(params, feats):
        (nx, out), mut = sa.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(xyz), feats, train=True, bn_momentum=0.2,
            mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(co)), (out, mut)

    with jax.default_matmul_precision("float32"):
        (_, (out, mut)), (gp, gf) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(v["params"],
                                                 jnp.asarray(feats))
    return out, mut["batch_stats"], gp, gf


def _port_sa_train(v, xyz, feats, co, dtype=None):
    port = pointnet2.SetAbstraction(32, 0.4, 16, 5, (24, 24, 48), dtype=dtype)
    load_jax_variables(port, _np_tree(v))
    tf = torch.from_numpy(feats).requires_grad_(True)
    _, out = port(torch.from_numpy(xyz), tf, bn_momentum=0.2)
    (out.float() * torch.from_numpy(co)).sum().backward()
    return port, out, tf.grad


def test_set_abstraction_train_fp32_matches_jax(sa_train_case):
    """Output, new BN statistics, parameter and input gradients (the input
    gradient flows through the gather backward) at 1e-4."""
    xyz, feats, co, v = sa_train_case
    out, bs, gp, gf = _jax_sa_train(v, xyz, feats, co)
    port, tout, tgf = _port_sa_train(v, xyz, feats, co)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **tol)
    _assert_trees(to_jax_tree(port)["batch_stats"], bs, **tol)
    _assert_trees(_grads(port), gp, **tol)
    np.testing.assert_allclose(tgf.numpy(), np.asarray(gf), **tol)


def test_set_abstraction_train_bf16_close_to_jax(sa_train_case):
    """bf16 training takes the f32-recentering branch: close to JAX's bf16
    train (both round to bf16 at the same places, in other orders)."""
    xyz, feats, co, v = sa_train_case
    out, bs, gp, _ = _jax_sa_train(v, xyz, feats, co, jnp.bfloat16)
    port, tout, _ = _port_sa_train(v, xyz, feats, co, torch.bfloat16)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(out.astype(jnp.float32))
    got = tout.detach().float().numpy()
    assert np.max(np.abs(got - want) / (np.abs(want) + 1)) < 0.05
    _assert_trees(to_jax_tree(port)["batch_stats"], bs, rtol=2e-2, atol=2e-2)
    # proj_kernel: through the f32 recentering and the gather backward
    # (proj_bias feeds a train-mode BN, so its exact gradient is 0)
    g, w = _grads(port), _np_tree(gp)
    for k in ("proj_kernel",):
        rel = np.abs(g[k] - w[k]).max() / (np.abs(w[k]).max() + 1e-6)
        assert rel < 0.05, (k, rel)


def test_group_all_guard_computes_f32_in_bf16_training():
    """SA3's group_all stack runs in f32 in bf16 training, bf16 serving."""
    sa = pointnet2.SetAbstraction(in_channels=4, mlp=(8, 16),
                                  group_all=True, dtype=torch.bfloat16)
    xyz, f = torch.randn(2, 10, 3), torch.randn(2, 10, 4)
    assert sa(xyz, f)[1].dtype == torch.float32
    assert sa.eval()(xyz, f)[1].dtype == torch.bfloat16


def test_fps_random_start_draws_from_the_generator():
    xyz = torch.from_numpy(np.random.RandomState(4).randn(3, 64, 3)
                           .astype(np.float32))
    assert pointnet2._fps_start(True, xyz, None) == 0
    assert pointnet2._fps_start(False, xyz, torch.Generator()) == 0
    a = pointnet2._fps_start(True, xyz, torch.Generator().manual_seed(5))
    b = pointnet2._fps_start(True, xyz, torch.Generator().manual_seed(5))
    assert a.shape == (3,) and torch.equal(a, b)
    assert bool(((a >= 0) & (a < 64)).all())


# ------------------------------------------------------------- image CNN


def test_image_encoder_train_matches_jax():
    r = np.random.RandomState(7)
    img = r.rand(2, 16, 16, 3).astype(np.float32)
    co_map = r.randn(2, 4, 4, 128).astype(np.float32)
    co_glob = r.randn(2, 512).astype(np.float32)
    enc = JaxImageEncoder()
    v = _trained(enc, (jnp.asarray(img),), rngs={"params":
                                                 jax.random.PRNGKey(0)})

    def fwd(params):
        (fmap, glob), mut = enc.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(img), train=True, bn_momentum=0.2,
            mutable=["batch_stats"])
        return (jnp.sum(glob * co_glob) + jnp.sum(fmap * co_map),
                (fmap, glob, mut))

    with jax.default_matmul_precision("float32"):
        (_, (fmap, glob, mut)), gp = jax.jit(jax.value_and_grad(
            fwd, has_aux=True))(v["params"])
    port = load_jax_variables(ImageEncoder(), _np_tree(v))
    pf, pg = port(torch.from_numpy(img), bn_momentum=0.2)
    ((pg * torch.from_numpy(co_glob)).sum()
     + (pf * torch.from_numpy(co_map)).sum()).backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pf.detach().numpy(), np.asarray(fmap), **tol)
    np.testing.assert_allclose(pg.detach().numpy(), np.asarray(glob), **tol)
    _assert_trees(to_jax_tree(port)["batch_stats"],
                  mut["batch_stats"], **tol)
    # a conv-kernel gradient sums B*H*W products of both signs, so its
    # small elements carry the rounding of the large ones: scaled bound
    _assert_trees_scaled(_grads(port), gp, 1e-4)


# ------------------------------------------------ whole fusion_cls step
#
# B=2, N=128, 32x32 images, 6 classes (tests/test_logits_parity.py's
# setup); one train step of each side from the same flax variables (BN
# statistics moved by two train passes), dropout off, Adam at lr 1e-3 with
# weight decay 1e-4.
#
# Exactness is checked in float64: JAX with x64 on and its BN statistics
# widened from f32 to f64 for the test (the port widens them, and the plain
# scatter-add, for f64 input), so both sides compute the same function.
# Every quantity agrees to ~1e-12 there, with one exception: a gradient that
# is zero in exact arithmetic (a bias ahead of a train-mode BN, which
# subtracts the batch mean) comes out as rounding residue, up to ~2e-5 where
# that BN has a channel of tiny variance. Those are held to 1e-4, and where
# such a residue meets Adam (which maps g to about lr * g / (|g| + 1e-8))
# the new parameter is held to the size of one step.
#
# In float32 elementwise parity is out of reach: the frameworks' convolutions
# and reductions round differently, a ReLU whose input lies within that of
# zero flips and moves every gradient upstream of it by a few percent, and a
# train-mode BN over B=2 rows computes its input gradient as a difference of
# two nearly equal terms (the exact value is O(eps/var)). The float32 case
# is held to the loss, the BN statistics and the gradient as a whole.

F64_GRAD = dict(rtol=1e-3, atol=1e-4)
LR = 1e-3


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _fusion_step(dtype):
    rng = np.random.RandomState(5)
    pts = rng.randn(2, 128, 3).astype(np.float32)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    K = np.stack([np.eye(3, dtype=np.float32) * 16] * 2)
    R = np.stack([np.eye(3, dtype=np.float32)] * 2)
    t = np.array([[0, 0, 3.0]] * 2, np.float32)
    label = np.array([1, 4], np.int32)
    model = jax_get_model("fusion_cls").builder(num_class=6)
    v = _np_tree(_trained(model, tuple(map(jnp.asarray,
                                           (pts, img, K, R, t))), nsteps=2))
    inputs = (pts, img, K, R, t)
    if dtype == "float64":
        v, inputs = _f64(v), tuple(a.astype(np.float64) for a in inputs)
    lr = LR

    def loss_of(params, bs):
        (logp, aux), mut = model.apply(
            {"params": params, "batch_stats": bs},
            *map(jnp.asarray, inputs), train=True, bn_momentum=0.1,
            deterministic=True, mutable=["batch_stats"])
        return (jax_pointnet_loss(logp, jnp.asarray(label), aux),
                mut["batch_stats"])

    tx = jax_make_optimizer("adam", 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(params))
    (loss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params, v["batch_stats"])
    new_params = apply_updates(state, grads, tx, lr).params
    want = {"loss": float(loss), "grads": _np_tree(grads),
            "batch_stats": _np_tree(new_bs), "params": _np_tree(new_params)}

    port = get_model("fusion_cls").builder(num_class=6)
    if dtype == "float64":
        port = port.double()
    load_jax_variables(port, v)
    opt = make_optimizer(port.parameters(), "adam", 1e-4)
    step = steps.make_train_step(port, get_model("fusion_cls").loss, opt,
                                 "fusion_cls", deterministic=True)
    batch = dict(zip(("points", "image", "K", "R", "t"), inputs),
                 label=label)
    m = step({k: torch.from_numpy(a) for k, a in batch.items()}, lr, 0.1)
    tree = to_jax_tree(port)
    got = {"loss": float(m["loss"]), "grads": _grads(port),
           "batch_stats": tree["batch_stats"], "params": tree["params"]}
    return got, want


@pytest.fixture(scope="module")
def fusion_step_f64():
    import mm3d_tpu.models.layers as jax_layers

    class _Wide:  # jnp with float32 -> float64, for the BN statistics
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _Wide())
        return _fusion_step("float64")


@pytest.fixture(scope="module")
def fusion_step_f32():
    with jax.default_matmul_precision("float32"):
        return _fusion_step("float32")


def test_fusion_cls_train_step_loss_and_grads_match_jax(fusion_step_f64):
    got, want = fusion_step_f64
    np.testing.assert_allclose(got["loss"], want["loss"], **GRAD)
    _assert_trees(got["grads"], want["grads"], **F64_GRAD)


def test_fusion_cls_train_step_state_matches_jax(fusion_step_f64):
    """The new BN statistics and the parameters after one Adam step."""
    got, want = fusion_step_f64
    _assert_trees(got["batch_stats"], want["batch_stats"], **GRAD)
    flat_g = jax.tree_util.tree_leaves(want["grads"])
    flat_p = jax.tree_util.tree_flatten_with_path(want["params"])[0]
    got_p = dict(jax.tree_util.tree_flatten_with_path(got["params"])[0])
    for (path, w), g in zip(flat_p, flat_g):
        residue = np.abs(g) <= F64_GRAD["atol"]  # Adam on rounding residue
        diff = np.abs(got_p[path] - w)
        assert np.all(diff[residue] <= 2 * LR * (1 + 1e-6)), path
        np.testing.assert_allclose(got_p[path][~residue], w[~residue],
                                   err_msg=jax.tree_util.keystr(path), **GRAD)


def test_fusion_cls_train_step_fp32_close_to_jax(fusion_step_f32):
    got, want = fusion_step_f32
    np.testing.assert_allclose(got["loss"], want["loss"], **GRAD)
    _assert_trees(got["batch_stats"], want["batch_stats"], **GRAD)
    flat = lambda t: np.concatenate(  # noqa: E731
        [np.ravel(x) for x in jax.tree_util.tree_leaves(t)])
    g, w = flat(got["grads"]), flat(want["grads"])
    # measured 0.021 on this case: the B=2 head BNs and the ReLU flips
    assert np.linalg.norm(g - w) <= 0.05 * np.linalg.norm(w)


# --------------------------------------------- whole fusion_sem_seg step
#
# B=2 S3DIS-style blocks of N=256 points with 32x32 views (the port's own
# generator), 13 classes, random per-point labels; one train step of each
# side from the same flax variables (BN statistics moved by two train
# passes), dropout off, no augmentation. In float64 (as for fusion_cls) the
# loss, every gradient and the new BN statistics agree to rtol 1e-6. Both
# models take the head's log-softmax in f32 (``h.float()``, as the JAX
# module's ``h.astype(jnp.float32)``), so every gradient carries the f32
# rounding of the head's cotangent: measured 4.1e-8 of the tensor's largest
# element at worst, while an element far below that largest one can be off
# by more than 1e-6 of itself. So each gradient is held to 1e-6 of its
# largest element; one that is zero in exact arithmetic (a bias ahead of a
# train-mode BN) is rounding residue below 1e-15 on both sides (+1e-12).
# The loss (both sides give the same f32 value), the BN statistics and the
# log-probs are held elementwise to rtol 1e-6 (atol 1e-9).


def _semseg_step(dtype):
    from mm3d_tpu_torch.data.synthetic import semseg_request
    inputs = tuple(semseg_request(2, 256, (32, 32), seed=3))
    seg = np.random.RandomState(6).randint(0, 13, (2, 256)).astype(np.int32)
    model = jax_get_model("fusion_sem_seg").builder(num_class=13)
    v = _np_tree(_trained(model, tuple(map(jnp.asarray, inputs)), nsteps=2))
    if dtype == "float64":
        v, inputs = _f64(v), tuple(a.astype(np.float64) for a in inputs)

    def loss_of(params, bs):
        (logp, aux), mut = model.apply(
            {"params": params, "batch_stats": bs},
            *map(jnp.asarray, inputs), train=True, bn_momentum=0.1,
            deterministic=True, mutable=["batch_stats"])
        return (jax_pointnet_loss(logp, jnp.asarray(seg), aux),
                (mut["batch_stats"], logp))

    (loss, (new_bs, logp)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(v["params"], v["batch_stats"])
    want = {"loss": float(loss), "grads": _np_tree(grads),
            "batch_stats": _np_tree(new_bs), "log_probs": np.asarray(logp)}

    def port_step(dt):
        spec = get_model("fusion_sem_seg")
        port = spec.builder(num_class=13, dtype=dt)
        if dtype == "float64":
            port = port.double()
        load_jax_variables(port, v)
        opt = make_optimizer(port.parameters(), "adam", 1e-4)
        step = steps.make_train_step(port, spec.loss, opt, "fusion_semseg",
                                     deterministic=True)
        batch = {k: torch.from_numpy(a) for k, a in zip(
            ("points", "image", "K", "R", "t"), inputs)}
        batch["seg"] = torch.from_numpy(seg)
        # the step's forward, kept by a hook
        out = []
        hook = port.register_forward_hook(
            lambda m, a, o: out.append(o[0].detach()))
        m = step(batch, LR, 0.1)
        hook.remove()
        return {"loss": float(m["loss"]), "grads": _grads(port),
                "batch_stats": to_jax_tree(port)["batch_stats"],
                "log_probs": out[0].float().numpy()}

    got = port_step(None)
    if dtype == "float32":
        got["bf16"] = port_step(torch.bfloat16)
    return got, want


@pytest.fixture(scope="module")
def semseg_step_f64():
    import mm3d_tpu.models.layers as jax_layers

    class _Wide:  # jnp with float32 -> float64, for the BN statistics
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _Wide())
        return _semseg_step("float64")


@pytest.fixture(scope="module")
def semseg_step_f32():
    with jax.default_matmul_precision("float32"):
        return _semseg_step("float32")


def test_fusion_sem_seg_train_step_loss_and_grads_match_jax(semseg_step_f64):
    got, want = semseg_step_f64
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    _assert_trees_scaled(got["grads"], want["grads"], 1e-6, atol=1e-12)


def test_fusion_sem_seg_train_step_bn_statistics_match_jax(semseg_step_f64):
    got, want = semseg_step_f64
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=1e-6,
                  atol=1e-9)
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               rtol=1e-6, atol=1e-9)


def test_fusion_sem_seg_train_step_fp32_close_and_bf16_finite(
        semseg_step_f32):
    """fp32: the loss and BN statistics close, the gradient as a whole
    (measured relative L2 0.002 on this case: the frameworks' convolutions
    and reductions round differently). bf16 mixed precision: finite, and
    its per-point argmax agrees with JAX's fp32 train forward."""
    got, want = semseg_step_f32
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=1e-4,
                  atol=1e-5)
    flat = lambda t: np.concatenate(  # noqa: E731
        [np.ravel(x) for x in jax.tree_util.tree_leaves(t)])
    g, w = flat(got["grads"]), flat(want["grads"])
    assert np.linalg.norm(g - w) <= 0.02 * np.linalg.norm(w)
    b16 = got["bf16"]
    assert np.isfinite(b16["loss"]) and np.isfinite(flat(b16["grads"])).all()
    assert abs(b16["loss"] - want["loss"]) <= 0.05 * want["loss"]
    agree = float(np.mean(b16["log_probs"].argmax(-1)
                          == want["log_probs"].argmax(-1)))
    print(f"bf16 port train step vs fp32 JAX: per-point argmax agreement "
          f"{agree}")
    assert agree >= 0.9, agree


# ------------------------------------------------- schedules, metrics


@pytest.mark.parametrize("epoch", [0, 19, 20, 45, 200])
def test_schedules_match_jax(epoch):
    assert schedules.step_lr(1e-3, epoch) == jax_schedules.step_lr(1e-3,
                                                                   epoch)
    assert (schedules.bn_momentum_schedule(epoch)
            == jax_schedules.bn_momentum_schedule(epoch))


def test_metrics_match_jax():
    r = np.random.RandomState(9)
    logp = r.randn(40, 7).astype(np.float32)
    target = r.randint(0, 7, 40).astype(np.int32)
    target[target == 5] = 6  # a class with no support
    w = (r.rand(40) > 0.3).astype(np.int32)
    pred = logp.argmax(-1).astype(np.int32)
    assert float(metrics.accuracy(torch.from_numpy(logp),
                                  torch.from_numpy(target))) == float(
        JM.accuracy(jnp.asarray(logp), jnp.asarray(target)))
    cm = metrics.confusion_matrix(torch.from_numpy(pred),
                                  torch.from_numpy(target), 7,
                                  weights=torch.from_numpy(w))
    jcm = JM.confusion_matrix(jnp.asarray(pred), jnp.asarray(target), 7,
                              weights=jnp.asarray(w))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert float(metrics.per_class_accuracy(cm)) == float(
        JM.per_class_accuracy(jcm))


def test_iou_from_confusion_matches_jax():
    """Per-class IoU and mIoU, with a class absent from targets and
    predictions (no union: left out of the mean)."""
    r = np.random.RandomState(12)
    target = r.randint(0, 6, 300).astype(np.int32)
    pred = np.where(r.rand(300) < 0.6, target,
                    r.randint(0, 6, 300)).astype(np.int32)
    target[target == 4] = 3
    pred[pred == 4] = 5
    cm = metrics.confusion_matrix(torch.from_numpy(pred),
                                  torch.from_numpy(target), 7)
    iou, miou = metrics.iou_from_confusion(cm)
    jiou, jmiou = JM.iou_from_confusion(jnp.asarray(cm.numpy()))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)
    assert float(iou[4]) == 0.0 and float(iou[6]) == 0.0
    np.testing.assert_allclose(float(miou), float(jmiou), rtol=1e-6)


def test_nll_loss_weight_and_row_mask_match_jax():
    from mm3d_tpu.models.pointnet import nll_loss as jax_nll
    r = np.random.RandomState(10)
    logp = np.log(r.dirichlet(np.ones(5), 6)).astype(np.float32)
    target = r.randint(0, 5, 6).astype(np.int32)
    weight = r.rand(5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.int32)
    for kw in ({}, {"weight": weight}, {"row_mask": mask},
               {"weight": weight, "row_mask": mask}):
        want = jax_nll(jnp.asarray(logp), jnp.asarray(target),
                       **{k: jnp.asarray(a) for k, a in kw.items()})
        got = nll_loss(torch.from_numpy(logp), torch.from_numpy(target),
                       **{k: torch.from_numpy(a) for k, a in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_optimizer_matches_optax_adam_and_sgd():
    """make_optimizer on the same gradients as the JAX optimizer chain,
    two steps at a per-step lr."""
    r = np.random.RandomState(11)
    p0 = r.randn(6).astype(np.float32)
    gs = [r.randn(6).astype(np.float32) for _ in range(2)]
    for name in ("adam", "sgd"):
        tx = jax_make_optimizer(name, 1e-2)
        params, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        topt = make_optimizer([tp], name, 1e-2)
        for lr, g in zip((1e-2, 5e-3), gs):
            upd, opt = tx.update(jnp.asarray(g), opt, params)
            params = optax.apply_updates(params, -lr * upd)
            tp.grad = torch.from_numpy(g)
            set_lr(topt, lr)
            topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- Trainer


def test_trainer_fit_one_tiny_epoch_on_cpu(tmp_path):
    cfg = TrainConfig(model="fusion_cls", epochs=1, batch_size=4,
                      npoint=64, num_class=4, train_size=8, test_size=6,
                      image_hw=(16, 16),
                      device="cpu", dtype="bfloat16", bn_refresh_steps=1,
                      fps_random_start=True, log_dir=str(tmp_path))
    tr = Trainer(cfg)
    out = tr.fit()
    assert np.isfinite(tr.history[0]["train"]["loss"])
    assert 0.0 <= out["instance_acc"] <= 1.0
    assert np.isfinite(out["eval_loss"])
    # the f32 eval model carries the trained (bf16-mode) weights
    for (n, a), b in zip(tr.model.state_dict().items(),
                         tr.eval_model.state_dict().values()):
        assert torch.equal(a, b), n


def test_trainer_fit_fusion_sem_seg_on_cpu(tmp_path):
    """One tiny epoch of fusion_sem_seg (bf16 mixed precision, the
    calib-aware rotation): finite loss, point accuracy and mIoU."""
    cfg = TrainConfig(model="fusion_sem_seg", epochs=1, batch_size=2,
                      npoint=128, seg_classes=13, train_size=4, test_size=3,
                      image_hw=(32, 32), device="cpu", dtype="bfloat16",
                      bn_refresh_steps=1, log_dir=str(tmp_path))
    tr = Trainer(cfg)
    out = tr.fit()
    assert tr.spec.task == "fusion_semseg"
    assert np.isfinite(tr.history[0]["train"]["loss"])
    assert 0.0 <= out["point_acc"] <= 1.0 and np.isfinite(out["eval_loss"])
    assert 0.0 <= out["miou"] <= 1.0 and out["best_miou"] == out["miou"]


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TrainConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(train_size=4, test_size=4))


def test_trainer_refuses_what_is_not_ported():
    """Every task of the registry is ported, so an unknown task name is
    refused as unknown (checkpointing, resume and the run directory, once
    refused here, are ported: see the test below)."""
    with pytest.raises(ValueError, match="unknown task"):
        steps.make_train_step(None, None, None, "vote_partseg")


def test_trainer_run_fields_keep_jax_defaults(tmp_path):
    """log_dir, run_name, checkpoint and resume exist with JAX's defaults,
    and a Trainer makes its run directory under log_dir, with JAX's
    layout, and its two checkpoint managers."""
    from mm3d_tpu.training.loop import TrainConfig as JaxConfig

    for field in ("log_dir", "run_name", "checkpoint", "resume"):
        assert getattr(TrainConfig(), field) == getattr(JaxConfig(), field)
    tr = Trainer(TrainConfig(model="pointnet_cls", npoint=32, batch_size=2,
                             train_size=2, test_size=2, device="cpu",
                             log_dir=str(tmp_path), run_name="run"))
    assert tr.run_dir == str(tmp_path / "classification" / "run")
    assert sorted(os.listdir(tr.run_dir)) == ["checkpoints",
                                              "checkpoints_latest", "logs"]
    assert tr.ckpt.best_metric == "instance_acc"
    assert tr.ckpt_latest.max_to_keep == 1 and tr.start_epoch == 0
    tr.close()
