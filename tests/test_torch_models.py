"""The port's modules and the fusion_cls forward against the JAX package.

Weights come from one flax init (with a few train passes so BN statistics
are non-trivial, as tests/test_logits_parity.py makes them) and are moved
into the port with ``load_jax_variables``; inputs are shared numpy arrays.
All on CPU: the port's kernel wrappers take their plain twins for CPU
tensors.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import jit_init
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models.image import ImageEncoder as JaxImageEncoder
from mm3d_tpu.models.pointnet2 import SetAbstraction as JaxSA
from mm3d_tpu_torch.models import get_model, init_params, pointnet2
from mm3d_tpu_torch.models.image import ImageEncoder
from mm3d_tpu_torch.models.layers import BatchNorm
from mm3d_tpu_torch.training import agreement, make_predictor
from mm3d_tpu_torch.utils import load_jax_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _trained(module, args, nsteps=2, rngs=None):
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


# ------------------------------------------------------- SetAbstraction


@pytest.fixture(scope="module")
def sa_case():
    r = np.random.RandomState(3)
    xyz = (r.randn(2, 128, 3) * 0.5).astype(np.float32)
    feats = r.randn(2, 128, 5).astype(np.float32)
    sa = JaxSA(32, 0.4, 16, (24, 24, 48))
    v = _trained(sa, (jnp.asarray(xyz), jnp.asarray(feats)), nsteps=1)
    with jax.default_matmul_precision("float32"):
        nx, f = jax.jit(lambda v: sa.apply(v, jnp.asarray(xyz),
                                           jnp.asarray(feats),
                                           train=False))(v)
    port = pointnet2.SetAbstraction(32, 0.4, 16, 5, (24, 24, 48)).eval()
    load_jax_variables(port, _np_tree(v))
    return xyz, feats, np.asarray(nx), np.asarray(f), v, port


@pytest.mark.parametrize("branch", ["unfused", "fused"])
def test_set_abstraction_matches_jax(sa_case, branch, monkeypatch):
    xyz, feats, want_xyz, want, _, port = sa_case
    if branch == "fused":
        # fp32 takes the fused tail only under impl 'cuda'; force the
        # branch on CPU, where ops.fused_sa runs fused_sa_torch
        monkeypatch.setattr(pointnet2, "_want_fused_sa", lambda *a: True)
    with torch.no_grad():
        nx, f = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(nx.numpy(), want_xyz)
    np.testing.assert_allclose(f.numpy(), want, rtol=1e-4, atol=1e-4)


def test_set_abstraction_bf16_fused_close(sa_case):
    """bf16 serving takes the fused branch; compare with JAX's bf16 SA."""
    xyz, feats, _, _, v, _ = sa_case
    sa = JaxSA(32, 0.4, 16, (24, 24, 48), dtype=jnp.bfloat16)
    _, want = jax.jit(lambda v: sa.apply(
        v, jnp.asarray(xyz), jnp.asarray(feats), train=False))(v)
    want = np.asarray(want.astype(jnp.float32))
    port = pointnet2.SetAbstraction(32, 0.4, 16, 5, (24, 24, 48),
                                    dtype=torch.bfloat16).eval()
    load_jax_variables(port, _np_tree(v))
    assert pointnet2._want_fused_sa(False, (24, 24, 48), torch.bfloat16)
    with torch.no_grad():
        _, got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.max(np.abs(got - want) / (np.abs(want) + 1)) < 0.05


@pytest.mark.parametrize("train,guard", [(True, True), (True, False),
                                         (False, True)])
def test_guarded_train_dtype_matches_jax(train, guard):
    from mm3d_tpu.models.layers import guarded_train_dtype as jax_guard
    from mm3d_tpu_torch.models.layers import guarded_train_dtype
    want = jax_guard(jnp.bfloat16, train, guard)
    got = guarded_train_dtype(torch.bfloat16, train, guard)
    assert (got is None) == (want is None)
    assert guarded_train_dtype(None, train, guard) is None


# ---------------------------------------------------------- image CNN


@pytest.mark.parametrize("hw", [(32, 32), (17, 22)])
def test_image_encoder_matches_jax(hw):
    """Includes odd sizes, where flax SAME pads stride-2 convs symmetrically."""
    img = np.random.RandomState(7).rand(2, *hw, 3).astype(np.float32)
    enc = JaxImageEncoder()
    v = _trained(enc, (jnp.asarray(img),), nsteps=1,
                 rngs={"params": jax.random.PRNGKey(0)})
    with jax.default_matmul_precision("float32"):
        fmap, glob = jax.jit(lambda v: enc.apply(v, jnp.asarray(img),
                                                 train=False))(v)
    port = load_jax_variables(ImageEncoder().eval(), _np_tree(v))
    with torch.no_grad():
        pf, pg = port(torch.from_numpy(img))
    np.testing.assert_allclose(pf.numpy(), np.asarray(fmap), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pg.numpy(), np.asarray(glob), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------- whole fusion_cls


@pytest.fixture(scope="module")
def fusion_case():
    """test_logits_parity.py:86-108's setup: B=2, N=128, 32x32, 6 classes."""
    rng = np.random.RandomState(5)
    pts = rng.randn(2, 128, 3).astype(np.float32)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    K = np.stack([np.eye(3, dtype=np.float32) * 16] * 2)
    R = np.stack([np.eye(3, dtype=np.float32)] * 2)
    t = np.array([[0, 0, 3.0]] * 2, np.float32)
    inputs = (pts, img, K, R, t)
    model = jax_get_model("fusion_cls").builder(num_class=6)
    v = _trained(model, tuple(map(jnp.asarray, inputs)))
    port = load_jax_variables(
        get_model("fusion_cls").builder(num_class=6), _np_tree(v))
    return inputs, v, port.state_dict()


def test_fusion_cls_fp32_logits_match_jax(fusion_case):
    inputs, v, state = fusion_case
    model = jax_get_model("fusion_cls").builder(num_class=6)
    with jax.default_matmul_precision("float32"):
        want, _ = jax.jit(lambda v: model.apply(
            v, *map(jnp.asarray, inputs), train=False))(v)
    pred = make_predictor("fusion_cls", state, device="cpu", num_class=6)
    got = pred(*map(torch.from_numpy, inputs))
    assert got.shape == (2, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fusion_cls_bf16_argmax_matches_jax(fusion_case):
    inputs, v, state = fusion_case
    model = jax_get_model("fusion_cls").builder(num_class=6,
                                                dtype=jnp.bfloat16)
    want, _ = jax.jit(lambda v: model.apply(
        v, *map(jnp.asarray, inputs), train=False))(v)
    want = np.asarray(want)
    targs = list(map(torch.from_numpy, inputs))
    p16 = make_predictor("fusion_cls", state, dtype=torch.bfloat16,
                         device="cpu", num_class=6)
    got = p16(*targs).numpy()
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    delta = float(np.abs(got - want).max())
    print(f"bf16 port vs bf16 JAX: argmax agreement {agree}, "
          f"max|dlogp| {delta:.3g}")
    assert agree == 1.0
    p32 = make_predictor("fusion_cls", state, device="cpu", num_class=6)
    drift = agreement(p32, p16, *targs)
    assert drift["argmax_agreement"] == 1.0
    assert drift["max_logp_delta"] < 0.1


# ------------------------------------------------------- entry points


def test_make_predictor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = init_params(get_model("fusion_cls").builder(num_class=3)
                        ).state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_predictor("fusion_cls", state, num_class=3)


def test_train_mode_forward_updates_bn_buffers():
    """A model in training mode runs its train forward (no eval-only
    guard) and moves every BN running statistic; eval mode moves none."""
    model = init_params(get_model("fusion_cls").builder(num_class=3))
    r = np.random.RandomState(8)
    pts = torch.from_numpy(r.randn(2, 64, 3).astype(np.float32))
    img = torch.from_numpy(r.rand(2, 16, 16, 3).astype(np.float32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logp, _ = model(pts, img, generator=torch.Generator().manual_seed(0))
    assert logp.shape == (2, 3) and bool(torch.isfinite(logp).all())
    after = {k: v.clone() for k, v in model.state_dict().items()}
    stats = [k for k in after if k.endswith((".mean", ".var"))]
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert n_bn > 20 and len(stats) == 2 * n_bn
    assert all(not torch.equal(before[k], after[k]) for k in stats)
    model.eval()
    with torch.no_grad():
        model(pts, img)
    assert all(torch.equal(after[k], v)
               for k, v in model.state_dict().items())


def test_load_jax_variables_rejects_mismatches(fusion_case):
    _, v, _ = fusion_case
    tree = _np_tree(v)
    port = get_model("fusion_cls").builder(num_class=6)
    bad = {"params": {**tree["params"], "extra": np.zeros(3, np.float32)},
           "batch_stats": tree["batch_stats"]}
    with pytest.raises(KeyError, match="extra"):
        load_jax_variables(port, bad)
    with pytest.raises(KeyError, match="not filled"):
        load_jax_variables(port, {"params": tree["params"]})
    wrong = get_model("fusion_cls").builder(num_class=7)
    with pytest.raises(ValueError, match="fc3"):
        load_jax_variables(wrong, tree)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    """No result line and a non-zero exit without a card, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    script = os.path.join(_REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_port_imports_no_jax_flax_or_reference_package():
    """Import every module of mm3d_tpu_torch, and chip_smoke.py, with jax,
    flax, mm3d_tpu and oracle blocked."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "mm3d_tpu", "oracle")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
sys.meta_path.insert(0, Block())
import mm3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mm3d_tpu_torch.__path__,
                                               "mm3d_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
