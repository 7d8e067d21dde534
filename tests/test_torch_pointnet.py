"""Plain PointNet (config 1, ``pointnet_cls``, and its part-seg and sem-seg
tops) in the port against the JAX package, on the CPU; and the registry,
which now holds every model of the JAX package.

``STN``, ``PointNetEncoder`` (global and per point, the bf16 training guard
on and off), the four PointNet models' eval forward, the losses with the
feature-transform regulariser, the f64 classification train step of
``pointnet_cls`` and a tiny ``Trainer.fit``. Weights come from one flax init
(BN statistics, affines and biases drawn with numpy, and the STNs'
zero-initialised ``fc_out`` kernels drawn too, so the alignment is not the
identity); they move into the port with ``load_jax_variables``. No geometry
kernel runs on these models: under ``fake_kernels`` (the wrappers' kernel
path on the CPU) a forward and a train step launch nothing.
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
from mm3d_tpu.models import available as jax_available
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models import pointnet as jpn
from mm3d_tpu.training import steps as jax_steps
from mm3d_tpu.training.state import TrainState
from mm3d_tpu.training.state import make_optimizer as jax_make_optimizer
from mm3d_tpu_torch.models import available, get_model, init_params, pointnet
from mm3d_tpu_torch.training import TrainConfig, Trainer, make_predictor, steps
from mm3d_tpu_torch.training.state import make_optimizer
from mm3d_tpu_torch.utils import load_jax_variables, to_jax_tree

MODELS = ("pointnet_cls", "pointnet_part_seg", "pointnet_part_seg_lineage",
          "pointnet_sem_seg")
NUM_CLASS = 6
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (several
    test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stn_out(v, seed):
    """The flax tree with every STN ``fc_out`` kernel drawn (N(0, 0.05)),
    so the alignments are not the identity they start at."""
    r = np.random.RandomState(seed)

    def leaf(path, x):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-2:] == ["fc_out", "kernel"]:
            return (r.randn(*x.shape) * 0.05).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, v)


def _inputs(name, B, N, seed):
    """The model's inputs as numpy: unit-sphere clouds (cls), with the
    category one-hot (part-seg), or 9-dim indoor-block features (sem-seg),
    and a target of the task's shape."""
    r = np.random.RandomState(seed)
    task = get_model(name).task
    if task == "semseg":
        xyz = _cloud_batch(B, N, seed) * 1.5
        pts = np.concatenate([xyz, r.rand(B, N, 3), r.rand(B, N, 3)],
                             -1).astype(np.float32)
        return (pts,), r.randint(0, 13, (B, N)).astype(np.int32)
    pts = _cloud_batch(B, N, seed)
    if task == "partseg":
        cat = r.randint(0, 16, B)
        return ((pts, np.eye(16, dtype=np.float32)[cat]),
                r.randint(0, 50, (B, N)).astype(np.int32))
    return (pts,), r.randint(0, NUM_CLASS, B).astype(np.int32)


def _kwargs(name):
    task = get_model(name).task
    return ({"num_class": NUM_CLASS} if task == "classification"
            else {"num_class": 13} if task == "semseg" else {})


# ------------------------------------------------------ registry


def test_registry_matches_jax():
    """The port registers the JAX registry's fifteen names, each with its
    task, default point count and BASELINE config id (config 1 is
    pointnet_cls)."""
    want, got = jax_available(), available()
    assert sorted(got) == sorted(want) and len(got) == 15
    for name, spec in got.items():
        assert (spec.task, spec.default_npoint, spec.config_id) == (
            want[name].task, want[name].default_npoint,
            want[name].config_id), name
    assert get_model("pointnet_cls").config_id == 1


@pytest.mark.parametrize("name", sorted(jax_available()))
def test_trainer_builds_every_model(name, tmp_path):
    """Trainer(TrainConfig(model=name, device="cpu")) builds each registry
    entry: its task is one of the ported steps' and its model has
    parameters."""
    tr = Trainer(TrainConfig(model=name, device="cpu", log_dir=str(tmp_path)))
    assert tr.task == jax_get_model(name).task and tr.task in steps.TASKS
    assert sum(p.numel() for p in tr.model.parameters()) > 0


# ------------------------------------------------------ STN and encoder


@pytest.mark.parametrize("k,channels", [(3, 3), (3, 9), (64, 64)])
def test_stn_matches_jax(k, channels):
    """STN (k x k, f32 matrix) in fp32 eval within 1e-5 of JAX's, and in
    bf16 its matrix stays f32 on both sides."""
    r = np.random.RandomState(k + channels)
    x = r.randn(2, 64, channels).astype(np.float32)
    stn = jpn.STN(k=k)
    v = _stn_out(_init(stn, (x,)), 5)
    want = _apply(stn, v, (x,), "jax")
    port = load_jax_variables(pointnet.STN(channels, k), _np_tree(v)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, k, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(want, np.eye(k), atol=1e-3)  # not the identity
    p16 = pointnet.STN(channels, k, torch.bfloat16).eval()
    p16.load_state_dict(port.state_dict())
    with torch.no_grad():
        got16 = p16(torch.from_numpy(x))
    want16 = _apply(jpn.STN(k=k, dtype=jnp.bfloat16), v, (x,), "jax")
    assert got16.dtype == torch.float32 and want16.dtype == np.float32
    np.testing.assert_allclose(got16.numpy(), want16, atol=2e-2)


def test_stn_align_is_f32_products():
    """_stn_align: the xyz channels times the matrix in f32 (the other
    channels passed through, then the cast), equal to JAX's HIGHEST
    einsum to f32 rounding (products and sums, no matmul: no TF32)."""
    r = np.random.RandomState(3)
    x = r.randn(2, 50, 9).astype(np.float32) * 4
    t = (np.eye(3) + r.randn(2, 3, 3) * 0.3).astype(np.float32)
    want = np.asarray(jpn._stn_align(jnp.asarray(x), jnp.asarray(t), None))
    got = pointnet._stn_align(torch.from_numpy(x), torch.from_numpy(t), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3:].numpy(), x[..., 3:])
    ref = np.einsum("bnc,bcd->bnd", x[..., :3].astype(np.float64), t)
    np.testing.assert_allclose(got[..., :3].numpy(), ref, rtol=1e-6,
                               atol=1e-5)
    got16 = pointnet._stn_align(torch.from_numpy(x), torch.from_numpy(t),
                                torch.bfloat16)
    want16 = np.asarray(jpn._stn_align(jnp.asarray(x), jnp.asarray(t),
                                       jnp.bfloat16).astype(jnp.float32))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want16)


ENCODER_CASES = {"global": (True, 3, False), "per-point": (False, 3, False),
                 "per-point guard": (False, 9, True),
                 "global guard": (True, 9, True)}


@pytest.fixture(scope="module", params=sorted(ENCODER_CASES))
def encoder_case(request):
    global_feat, channel, guard = ENCODER_CASES[request.param]
    r = np.random.RandomState(len(request.param))
    x = (r.randn(2, 128, channel) * 0.6).astype(np.float32)
    kw = dict(global_feat=global_feat, feature_transform=True,
              channel=channel, f32_train_guard=guard)
    v = _stn_out(_init(jpn.PointNetEncoder(**kw), (x,)), 7)
    return kw, x, v


def test_encoder_fp32_matches_jax(encoder_case):
    """PointNetEncoder eval in fp32: features, trans and trans_feat within
    1e-5 of JAX's."""
    kw, x, v = encoder_case
    want = _apply(jpn.PointNetEncoder(**kw), v, (x,), "jax")
    port = load_jax_variables(pointnet.PointNetEncoder(**kw),
                              _np_tree(v)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    B, N = x.shape[:2]
    assert got[0].shape == ((B, 1024) if kw["global_feat"]
                            else (B, N, 64 + 1024))
    assert got[1].shape == (B, 3, 3) and got[2].shape == (B, 64, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_encoder_bf16_train_islands_match_jax(encoder_case):
    """bf16 training forward (B=8, train-mode BN over the batch): each
    output in JAX's dtype (the matrices f32; with the guard and per-point
    output the features f32, since the input STN and mlp1 compute in f32
    and fstn at the block dtype). With the guard the input STN's matrix is
    the fp32 forward's bit for bit, and within 1e-4 of JAX's. Each output
    is no further from JAX's bf16 one than 1.25x the port's own bf16-vs-fp32
    drift (measured: at most 1.01x)."""
    kw, _, v = encoder_case
    x = (np.random.RandomState(1).randn(8, 128, kw["channel"]) * 0.6
         ).astype(np.float32)

    def jax_train(dtype):
        enc = jpn.PointNetEncoder(dtype=dtype, **kw)
        return jax.jit(lambda v: enc.apply(v, jnp.asarray(x), train=True,
                                           mutable=["batch_stats"])[0])(v)

    def port_train(dtype):
        port = load_jax_variables(pointnet.PointNetEncoder(dtype=dtype, **kw),
                                  _np_tree(v)).train()
        with torch.no_grad():
            return port(torch.from_numpy(x))

    want, got, got32 = (jax_train(jnp.bfloat16), port_train(torch.bfloat16),
                        port_train(None))
    for g, w, g32 in zip(got, want, got32):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        w = np.asarray(w.astype(jnp.float32))
        drift = float((g.float() - g32).abs().max())
        assert np.abs(g.float().numpy() - w).max() <= 1.25 * drift + 1e-5
    feat_dt = (torch.float32 if kw["f32_train_guard"]
               and not kw["global_feat"] else torch.bfloat16)
    assert got[0].dtype == feat_dt
    if kw["f32_train_guard"]:
        assert torch.equal(got[1], got32[1])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ the models


@pytest.fixture(scope="module", params=MODELS)
def model_case(request):
    """B=2 inputs of 256 points, drawn BN statistics and STN outputs, one
    flax init filling the port's model."""
    name = request.param
    args, target = _inputs(name, 2, 256, 11)
    model = jax_get_model(name).builder(**_kwargs(name))
    v = _stn_out(_init(model, args), 13)
    port = load_jax_variables(get_model(name).builder(**_kwargs(name)),
                              _np_tree(v))
    return name, args, target, v, port.state_dict()


def test_pointnet_fp32_logprobs_match_jax(model_case):
    """fp32 log-probs of make_predictor within 1e-4 of the JAX model's
    (measured ~1e-6), normalised; trans_feat within 1e-5; every entry of
    the flax tree back out of the port unchanged."""
    name, args, _, v, state = model_case
    want, aux = _apply(jax_get_model(name).builder(**_kwargs(name)), v,
                       args, "jax")
    pred = make_predictor(name, state, device="cpu", **_kwargs(name))
    targs = list(map(torch.from_numpy, args))
    got = pred(*targs)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    print(f"{name}: fp32 max|d logp| {err}")
    assert err <= 1e-4
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, atol=1e-5)
    with torch.no_grad():
        _, paux = pred.model(*targs)
    np.testing.assert_allclose(paux["trans_feat"].numpy(), aux["trans_feat"],
                               rtol=1e-5, atol=1e-5)
    _assert_trees(to_jax_tree(pred.model), _np_tree(v), rtol=0, atol=0)


def test_pointnet_bf16_argmax_matches_jax(model_case):
    """bf16 serving against JAX's bf16 model and the port's fp32: argmax
    agreement >= 0.95 (per cloud, or per point)."""
    name, args, _, v, state = model_case
    want, _ = _apply(jax_get_model(name).builder(dtype=jnp.bfloat16,
                                                 **_kwargs(name)),
                     v, args, "jax")
    targs = list(map(torch.from_numpy, args))
    got = make_predictor(name, state, dtype=torch.bfloat16, device="cpu",
                         **_kwargs(name))(*targs).numpy()
    p32 = make_predictor(name, state, device="cpu", **_kwargs(name))(*targs)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    drift = float(np.mean(got.argmax(-1) == p32.numpy().argmax(-1)))
    print(f"{name}: bf16 port vs bf16 JAX {agree}, vs fp32 port {drift}")
    assert agree >= 0.95 and drift >= 0.95


@pytest.mark.parametrize("masked", [False, True])
def test_pointnet_loss_matches_jax(model_case, masked):
    """The regulariser and pointnet_loss (NLL + 0.001 x regulariser) on the
    model's own log-probs and trans_feat, with and without a row mask,
    within 1e-6 of JAX's."""
    name, args, target, v, state = model_case
    lp, aux = _apply(jax_get_model(name).builder(**_kwargs(name)), v, args,
                     "jax")
    lp, tf = np.array(lp), np.array(aux["trans_feat"])  # writable copies
    rm = np.array([1, 0], np.int32) if masked else None
    jrm = None if rm is None else jnp.asarray(rm)
    trm = None if rm is None else torch.from_numpy(rm)
    want_reg = float(jpn.feature_transform_regularizer(jnp.asarray(tf), jrm))
    got_reg = float(pointnet.feature_transform_regularizer(
        torch.from_numpy(tf), trm))
    np.testing.assert_allclose(got_reg, want_reg, rtol=1e-6, atol=1e-6)
    want = float(jpn.pointnet_loss(jnp.asarray(lp), jnp.asarray(target),
                                   {"trans_feat": jnp.asarray(tf)},
                                   row_mask=jrm))
    got = float(pointnet.pointnet_loss(
        torch.from_numpy(lp), torch.from_numpy(target),
        {"trans_feat": torch.from_numpy(tf)}, row_mask=trm))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the regulariser's term is there, at its scale
    nll = float(pointnet.nll_loss(torch.from_numpy(lp),
                                  torch.from_numpy(target), row_mask=trm))
    np.testing.assert_allclose(got - nll, 0.001 * got_reg, rtol=1e-4)


def test_regularizer_at_the_identity():
    """At the identity (the STN's start) the regulariser is sqrt(1e-12) and
    its gradient finite, as in JAX."""
    eye = torch.eye(64).expand(3, 64, 64).clone().requires_grad_(True)
    val = pointnet.feature_transform_regularizer(eye)
    val.backward()
    assert float(val.detach()) == pytest.approx(1e-6, rel=1e-6)
    assert bool(torch.isfinite(eye.grad).all())
    want = float(jpn.feature_transform_regularizer(jnp.eye(64)[None].repeat(
        3, 0)))
    assert float(val.detach()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("mode", ["bfloat16", "float32", "train"])
def test_pointnet_launches_no_kernel(name, mode, monkeypatch):
    """The kernel path on the CPU (``fake_kernels``): a serving forward and
    a train step of each PointNet model launch no kernel; the forward equals
    the plain path's."""
    spec = get_model(name)
    args, target = _inputs(name, 2, 128, 17)
    targs = list(map(torch.from_numpy, args))
    model = init_params(spec.builder(**_kwargs(name)))
    if mode == "train":
        ck = fake_kernels(monkeypatch)
        batch = {"points": targs[0],
                 ("label" if spec.task == "classification" else "seg"):
                     torch.from_numpy(target)}
        if spec.task == "partseg":
            batch["cat"] = torch.from_numpy(args[1].argmax(-1).astype(
                np.int32))
        step = steps.make_train_step(
            model, spec.loss, make_optimizer(model.parameters(), "adam",
                                             1e-4), spec.task,
            generator=torch.Generator().manual_seed(0))
        assert np.isfinite(float(step(batch, LR, 0.1)["loss"]))
    else:
        dtype = torch.bfloat16 if mode == "bfloat16" else None
        pred = make_predictor(name, model.state_dict(), dtype=dtype,
                              device="cpu", **_kwargs(name))
        plain = pred(*targs)
        ck = fake_kernels(monkeypatch)
        np.testing.assert_array_equal(pred(*targs).numpy(), plain.numpy())
    assert {k.__name__: k.launches for k in ck.KERNELS if k.launches} == {}


# ------------------------------------------------------ train step


def _cls_step():
    """One classification train step of pointnet_cls in f64 (B=4 clouds of
    128 points, 6 classes, no augmentation, dropout off, the regulariser
    on): the JAX package's make_train_step (loss, metrics, BN statistics,
    the parameters after Adam) and value_and_grad of the same loss (the
    gradients), against the port's make_train_step."""
    name = "pointnet_cls"
    (pts,), label = _inputs(name, 4, 128, 19)
    model = jax_get_model(name).builder(num_class=NUM_CLASS)
    v = _f64(_stn_out(_init(model, (pts,)), 23))
    pts = pts.astype(np.float64)

    def loss_of(params, bs):
        (logp, aux), mut = model.apply(
            {"params": params, "batch_stats": bs}, jnp.asarray(pts),
            train=True, bn_momentum=0.1, deterministic=True,
            mutable=["batch_stats"])
        return jpn.pointnet_loss(logp, jnp.asarray(label), aux), (logp, aux)

    (_, (_, aux)), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        v["params"], v["batch_stats"])
    tx = jax_make_optimizer("adam", 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(_NoDropout(model), jpn.pointnet_loss,
                                      tx, "classification", donate=False)
    new_state, jm = jstep(state, (jnp.asarray(pts), jnp.asarray(label)), LR,
                          0.1, jax.random.PRNGKey(0))
    want = {"loss": float(jm["loss"]), "accuracy": float(jm["accuracy"]),
            "grads": _np_tree(grads),
            "batch_stats": _np_tree(new_state.batch_stats),
            "reg": float(jpn.feature_transform_regularizer(
                aux["trans_feat"]))}

    spec = get_model(name)
    port = load_jax_variables(spec.builder(num_class=NUM_CLASS).double(), v)
    opt = make_optimizer(port.parameters(), "adam", 1e-4)
    step = steps.make_train_step(port, spec.loss, opt, "classification",
                                 deterministic=True)
    m = step({"points": torch.from_numpy(pts),
              "label": torch.from_numpy(label)}, LR, 0.1)
    tree = to_jax_tree(port)
    got = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
           "grads": _grads(port), "batch_stats": tree["batch_stats"]}
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


def test_pointnet_cls_train_step_matches_jax(cls_step_f64):
    """In f64, held as the other classification step is: the loss and the
    BN statistics rtol 1e-6 (atol 1e-9), each gradient within 1e-6 of its
    largest element (the log-softmax, the STN's fc_out input and the
    regulariser run in f32 on both sides), plus 1e-12 of the model's
    largest gradient element for the f64 rounding residue of a bias ahead
    of a train-mode BN. The regulariser's term is in the loss (finite, and
    the matrices are not orthogonal)."""
    got, want = cls_step_f64
    assert np.isfinite(want["reg"]) and want["reg"] > 1e-3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["accuracy"] == want["accuracy"]
    top = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(
        want["grads"]))
    _assert_trees_scaled(got["grads"], want["grads"], 1e-6,
                         atol=1e-12 * top)
    _assert_trees(got["batch_stats"], want["batch_stats"], rtol=1e-6,
                  atol=1e-9)


# ------------------------------------------------------ Trainer


@pytest.mark.parametrize("name,dtype", [("pointnet_cls", "bfloat16"),
                                        ("pointnet_part_seg", "float32"),
                                        ("pointnet_sem_seg", "bfloat16")])
def test_trainer_fit_pointnet_on_cpu(name, dtype, tmp_path):
    """One tiny epoch of a PointNet model on its task's synthetic data:
    finite loss and the task's headline metric in [0, 1]."""
    task = get_model(name).task
    npoint = {"classification": 128, "partseg": 128, "semseg": 256}[task]
    cfg = TrainConfig(model=name, epochs=1, batch_size=2, npoint=npoint,
                      num_class=4, train_size=4, test_size=3, device="cpu",
                      dtype=dtype, bn_refresh_steps=1, log_dir=str(tmp_path))
    tr = Trainer(cfg)
    out = tr.fit()
    assert np.isfinite(tr.history[0]["train"]["loss"])
    assert np.isfinite(out["eval_loss"])
    key = {"classification": "instance_acc", "partseg": "instance_miou",
           "semseg": "miou"}[task]
    assert 0.0 <= out[key] <= 1.0 and out[f"best_{key}"] == out[key]
