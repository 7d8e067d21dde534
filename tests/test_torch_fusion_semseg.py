"""fusion_sem_seg (config 5) and its parts in the port against the JAX package.

Weights come from one flax init whose BN statistics, BN affines and biases
are then drawn from a numpy seed (so the eval folds matter), and move into
the port with ``load_jax_variables``; the inputs are shared numpy arrays
from the port's synthetic S3DIS-style blocks and camera poses. All on CPU:
the port's kernel wrappers take their plain twins for CPU tensors. The JAX
side runs in its pure-JAX mode and in its Pallas mode (kernels in interpret
mode), as the JAX package's own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import jit_init
from test_torch_ops import fake_kernels
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models.pointnet2 import FeaturePropagation as JaxFP
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.models import get_model, init_params, pointnet2
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.training import agreement, make_predictor
from mm3d_tpu_torch.utils import load_jax_variables, to_jax_tree

NUM_CLASS = 13


def _np_tree(v):
    return jax.tree_util.tree_map(np.array, v)


def _randomize(v, seed):
    """Non-trivial BN statistics, BN affines and biases, drawn with numpy."""
    r = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.array(x)
        if name == "mean":
            return (r.randn(*x.shape) * 0.1).astype(x.dtype)
        if name == "var":
            return r.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        if name == "scale":
            return r.uniform(0.8, 1.2, x.shape).astype(x.dtype)
        if name == "bias":
            return (r.randn(*x.shape) * 0.05).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, v)


def _init(model, args, seed=0):
    v = jit_init(model, {"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed + 1)},
                 *map(jnp.asarray, args), train=True)
    return _randomize({"params": v["params"],
                       "batch_stats": v["batch_stats"]}, seed + 2)


def _apply(model, v, args, mode, **kw):
    """Eval forward of a flax model under a JAX impl mode (a fresh jit per
    mode: the mode is read at trace time)."""
    with jdispatch.use_impl(mode), jax.default_matmul_precision("float32"):
        out = jax.jit(lambda v: model.apply(
            v, *map(jnp.asarray, args), train=False, **kw))(v)
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------- FeaturePropagation


@pytest.fixture(scope="module")
def fp_case():
    r = np.random.RandomState(11)
    B, N, M = 2, 96, 24
    args = ((r.randn(B, N, 3) * 0.5).astype(np.float32),
            (r.randn(B, M, 3) * 0.5).astype(np.float32),
            r.randn(B, N, 5).astype(np.float32),
            r.randn(B, M, 12).astype(np.float32))
    fp = JaxFP((24, 16))
    return args, fp, _init(fp, args)


@pytest.mark.parametrize("branch,jax_mode", [("fused", "jax"),
                                             ("fused", "pallas"),
                                             ("unfused", "jax")])
def test_feature_propagation_matches_jax(fp_case, branch, jax_mode,
                                         monkeypatch):
    args, fp, v = fp_case
    want = _apply(fp, v, args, jax_mode, bn_momentum=0.1)
    port = pointnet2.FeaturePropagation(5, 12, (24, 16)).eval()
    load_jax_variables(port, _np_tree(v))
    if branch == "unfused":
        monkeypatch.setattr(pointnet2, "_want_fused_fp", lambda train: False)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    assert got.shape == (2, 96, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_feature_propagation_single_sparse_point_and_no_skip():
    """M == 1 broadcasts the single sparse row; feats1=None leaves only the
    bias on the dense side."""
    r = np.random.RandomState(12)
    args = ((r.randn(2, 40, 3)).astype(np.float32),
            np.zeros((2, 1, 3), np.float32),
            None,
            r.randn(2, 1, 10).astype(np.float32))
    fp = JaxFP((8,))
    v = jit_init(fp, {"params": jax.random.PRNGKey(0)},
                 *[None if a is None else jnp.asarray(a) for a in args],
                 train=True)
    v = _randomize({"params": v["params"], "batch_stats": v["batch_stats"]},
                   3)
    want = np.asarray(jax.jit(lambda v: fp.apply(
        v, *[None if a is None else jnp.asarray(a) for a in args],
        train=False))(v))
    port = pointnet2.FeaturePropagation(0, 10, (8,)).eval()
    load_jax_variables(port, _np_tree(v))
    with torch.no_grad():
        got = port(*[None if a is None else torch.from_numpy(a)
                     for a in args])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.allclose(got.numpy(), got.numpy()[:, :1])  # one row, broadcast


def test_feature_propagation_unfused_raises_on_the_kernel_path(
        fp_case, monkeypatch):
    """Training's unfused branch runs on the kernel path now (it raised
    until the three_nn kernel): one train forward and backward launches
    three_nn, three_interpolate and the gather backward (d of the sparse
    rows) once each and gives the plain path's output and gradients."""
    args, _, v = fp_case
    port = pointnet2.FeaturePropagation(5, 12, (24, 16))  # train mode
    load_jax_variables(port, _np_tree(v))
    co = torch.from_numpy(np.random.RandomState(3).randn(2, 96, 16)
                          .astype(np.float32))

    def run():
        port.zero_grad()
        f2 = torch.from_numpy(args[3]).requires_grad_(True)
        out = port(*map(torch.from_numpy, args[:3]), f2)
        out.backward(co)
        return out.detach(), f2.grad, port.proj_kernel.grad.clone()

    with dispatch.use_impl("torch"):
        want = run()
    ck = fake_kernels(monkeypatch)
    got = run()
    assert {k.__name__: k.launches for k in ck.KERNELS if k.launches} == {
        "three_nn": 1, "three_interpolate": 1, "gather_backward": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == (2, 96, 16) and bool(torch.isfinite(got[0]).all())


def test_feature_propagation_train_matches_jax(fp_case):
    """Train mode in fp32 (the unfused branch): output, the new BN
    statistics, every parameter gradient and the input gradients (through
    three_interpolate's d_points and the gather backward) against the JAX
    module's, at 1e-4."""
    args, fp, v = fp_case
    co = np.random.RandomState(4).randn(2, 96, 16).astype(np.float32)

    def loss(params, f1, f2):
        out, mut = fp.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(args[0]), jnp.asarray(args[1]), f1,
                            f2, train=True, bn_momentum=0.2,
                            mutable=["batch_stats"])
        return jnp.sum(out * co), (out, mut["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (out, bs)), (gp, g1, g2) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                v["params"], jnp.asarray(args[2]), jnp.asarray(args[3]))
    port = pointnet2.FeaturePropagation(5, 12, (24, 16))
    load_jax_variables(port, _np_tree(v))
    t1, t2 = (torch.from_numpy(a).requires_grad_(True) for a in args[2:])
    tout = port(*map(torch.from_numpy, args[:2]), t1, t2, bn_momentum=0.2)
    (tout * torch.from_numpy(co)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **tol)
    got = to_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})
    for tree, want in ((got["params"], gp),
                       (to_jax_tree(port)["batch_stats"], bs)):
        flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            np.testing.assert_allclose(flat[path], np.asarray(w),
                                       err_msg=jax.tree_util.keystr(path),
                                       **tol)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), **tol)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(g2), **tol)


# ------------------------------------------------------- fusion_sem_seg


def _semseg_inputs(B=2, N=256, hw=(32, 32), seed=2):
    """Blocks, rendered views and cameras from the port's own generators."""
    return tuple(syn.semseg_request(B, N, hw, seed))


@pytest.fixture(scope="module")
def semseg_case():
    inputs = _semseg_inputs()
    model = jax_get_model("fusion_sem_seg").builder(num_class=NUM_CLASS)
    v = _init(model, inputs)
    port = load_jax_variables(
        get_model("fusion_sem_seg").builder(num_class=NUM_CLASS),
        _np_tree(v))
    return inputs, model, v, port.state_dict()


@pytest.mark.parametrize("jax_mode", ["jax", "pallas"])
def test_fusion_sem_seg_fp32_logprobs_match_jax(semseg_case, jax_mode):
    inputs, model, v, state = semseg_case
    want, aux = _apply(model, v, inputs, jax_mode)
    pred = make_predictor("fusion_sem_seg", state, device="cpu",
                          num_class=NUM_CLASS)
    targs = list(map(torch.from_numpy, inputs))
    got = pred(*targs)
    assert got.shape == (2, 256, NUM_CLASS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        _, paux = pred.model(*targs)
    np.testing.assert_array_equal(paux["proj_valid"].numpy(),
                                  aux["proj_valid"])
    share = float(aux["proj_valid"].mean())
    assert 0.05 < share < 1.0, share  # the camera sees part of the block


def test_fusion_sem_seg_bf16_argmax_matches_jax(semseg_case):
    inputs, _, v, state = semseg_case
    model = jax_get_model("fusion_sem_seg").builder(num_class=NUM_CLASS,
                                                    dtype=jnp.bfloat16)
    want, _ = _apply(model, v, inputs, "jax")
    targs = list(map(torch.from_numpy, inputs))
    p16 = make_predictor("fusion_sem_seg", state, dtype=torch.bfloat16,
                         device="cpu", num_class=NUM_CLASS)
    got = p16(*targs).numpy()
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    print(f"bf16 port vs bf16 JAX: per-point argmax agreement {agree}")
    assert agree >= 0.95
    p32 = make_predictor("fusion_sem_seg", state, device="cpu",
                         num_class=NUM_CLASS)
    drift = agreement(p32, p16, *targs)
    print(f"port bf16 vs fp32: {drift}")
    assert drift["argmax_agreement"] >= 0.95


def test_fusion_sem_seg_image_stride_guard():
    model = init_params(get_model("fusion_sem_seg").builder(
        num_class=4, image_stride=2)).eval()
    inputs = _semseg_inputs(B=1, N=64)
    with torch.no_grad(), pytest.raises(ValueError, match="image_stride"):
        model(*map(torch.from_numpy, inputs))


@pytest.mark.parametrize("name", ["fusion_sem_seg_attention",
                                  "fusion_cls_attention"])
def test_attention_heads_match_jax(name):
    if name.startswith("fusion_sem_seg"):
        inputs = _semseg_inputs(B=2, N=128, seed=5)
        ncls, shape = NUM_CLASS, (2, 128, NUM_CLASS)
    else:
        r = np.random.RandomState(5)
        inputs = (r.randn(2, 128, 3).astype(np.float32),
                  r.rand(2, 32, 32, 3).astype(np.float32),
                  np.stack([np.eye(3, dtype=np.float32) * 16] * 2),
                  np.stack([np.eye(3, dtype=np.float32)] * 2),
                  np.array([[0, 0, 3.0]] * 2, np.float32))
        ncls, shape = 6, (2, 6)
    model = jax_get_model(name).builder(num_class=ncls)
    v = _init(model, inputs, seed=7)
    want, aux = _apply(model, v, inputs, "jax")
    port = load_jax_variables(get_model(name).builder(num_class=ncls),
                              _np_tree(v)).eval()
    assert any(n.startswith("fuse.proj_1.") for n, _ in
               port.named_parameters())
    with torch.no_grad():
        got, paux = port(*map(torch.from_numpy, inputs))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(paux["fusion_alpha"].numpy(),
                               aux["fusion_alpha"], rtol=1e-4, atol=1e-5)
