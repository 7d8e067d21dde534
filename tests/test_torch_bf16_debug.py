"""The ``MM3D_BF16_DEBUG`` knob (``mm3d_tpu/models/pointnet2.py``
``_dbg_dtype``) in the port against the JAX package, on the CPU.

The knob is a comma list of components that a bf16 model computes in f32.
Both sides read the same environment variable (set with
``monkeypatch.setenv`` before the port's model is built: the port reads the
model-level components at build time, the block-level ones at each call).
The parse against JAX's; for each of its ten components, on the model where
it acts (``pointnet2_cls_ssg``, ``pointnet2_sem_seg``, a bf16
``SetAbstraction``), each block's output dtype equal to JAX's and the bf16
argmax agreement with JAX's; ``sa,head`` against JAX and against the port's
fp32 model; the kernel routing under ``test_torch_fused_sa.fake_kernels``.

The JAX side runs in its pure-JAX mode, which has no fused kernel, so the
model comparisons take the port's unfused blocks too (``_want_fused_sa`` and
``_want_fused_fp`` off); the bare block is also held, in eval, against
JAX's Pallas mode (interpret) with the port's fused twin, where a forced
``sa_bn`` gives the fused tail f32 operands on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_sa import fake_kernels
from test_torch_fusion_semseg import _init, _np_tree
from test_torch_knn import _cloud_batch
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.models import pointnet2 as jp2
from mm3d_tpu.ops import dispatch as jdispatch
from mm3d_tpu_torch.models import get_model, pointnet2
from mm3d_tpu_torch.ops import cuda_kernels as ck
from mm3d_tpu_torch.utils import load_jax_variables

KNOB = "MM3D_BF16_DEBUG"
COMPONENTS = ("sa", "sa1", "sa2", "sa3", "sa4", "fp", "head", "sa_bn",
              "sa_rest", "sa_h")
NUM_CLASS = 13


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (see
    ``test_torch_partseg``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _knob(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(KNOB, raising=False)
    else:
        monkeypatch.setenv(KNOB, value)


@pytest.mark.parametrize("value", [None, "", "sa", "sa1", "sa,head", " sa",
                                   "sa_bn,fp"],
                         ids=["unset", "empty", "sa", "sa1", "sa,head",
                              "space-sa", "sa_bn,fp"])
def test_dbg_dtype_parses_as_jax(value, monkeypatch):
    """The comma list, exact names (``sa`` forces neither ``sa1`` nor
    ``sa_bn``; `` sa`` forces nothing), unset or empty: the dtype
    unchanged. f32 (None) stays None."""
    _knob(monkeypatch, value)
    forced = []
    for c in COMPONENTS + ("", " sa", "sa,"):
        j = jp2._dbg_dtype(c, jnp.bfloat16)
        t = pointnet2._dbg_dtype(c, torch.bfloat16)
        assert (j is None) == (t is None), c
        assert t in (None, torch.bfloat16)
        assert pointnet2._dbg_dtype(c, None) is None
        if t is None:
            forced.append(c)
    want = [c for c in (value or "").split(",") if c]
    assert forced == [c for c in COMPONENTS + ("", " sa", "sa,")
                      if c in want]


# ------------------------------------------------------------ the models


def _semseg_points(B, N, seed):
    """9-dim indoor-block points: xyz in a unit block, colours, normalised
    xyz."""
    r = np.random.RandomState(seed)
    xyz = r.rand(B, N, 3).astype(np.float32)
    return np.concatenate([xyz, r.rand(B, N, 3).astype(np.float32),
                           xyz / xyz.max(1, keepdims=True)], -1)


# model -> (B, N, inputs)
MODELS = {"pointnet2_cls_ssg": lambda: (_cloud_batch(2, 256, 3),),
          "pointnet2_sem_seg": lambda: (_semseg_points(2, 256, 4),)}
_CASES = {}


def _case(name):
    """The model's inputs and one flax init with drawn BN statistics,
    affines and biases (cached: the tests only read them)."""
    if name not in _CASES:
        args = MODELS[name]()
        _CASES[name] = args, _init(jax_get_model(name).builder(
            num_class=NUM_CLASS), args)
    return _CASES[name]


def _jax_run(name, dtype, v, args, train):
    """JAX's forward in its pure mode with the knob as set: log-probs and
    each top-level block's output dtype (flax ``capture_intermediates``)."""
    model = jax_get_model(name).builder(num_class=NUM_CLASS, dtype=dtype)

    def f(v):
        (logp, _), st = model.apply(
            v, *map(jnp.asarray, args), train=train, deterministic=True,
            capture_intermediates=True,
            mutable=["intermediates"] + (["batch_stats"] if train else []))
        return logp, st["intermediates"]

    with jdispatch.use_impl("jax"), jax.default_matmul_precision("float32"):
        logp, inter = jax.jit(f)(v)
    outs = {k: jax.tree_util.tree_leaves(o["__call__"])[-1]
            for k, o in inter.items() if k != "__call__"}
    return (np.asarray(logp), {k: str(o.dtype) for k, o in outs.items()},
            {k: np.asarray(o, np.float32) for k, o in outs.items()})


def _port_run(name, dtype, v, args, train, unfused=True):
    """The port's forward (built after the knob is set): log-probs, each
    top-level block's output dtype and output (forward hooks)."""
    model = load_jax_variables(get_model(name).builder(
        num_class=NUM_CLASS, dtype=dtype), _np_tree(v)).train(train)
    outs = {}
    for n, m in model.named_children():
        m.register_forward_hook(lambda mod, i, o, n=n: outs.__setitem__(
            n, o[-1] if isinstance(o, tuple) else o))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        if unfused:  # the structure of JAX's pure mode
            mp.setattr(pointnet2, "_want_fused_sa", lambda *a: False)
            mp.setattr(pointnet2, "_want_fused_fp", lambda *a: False)
        logp, _ = model(*map(torch.from_numpy, args), deterministic=True)
    return (logp.numpy(),
            {k: str(o.dtype).split(".")[-1] for k, o in outs.items()},
            {k: o.float().numpy() for k, o in outs.items()})


# each component on a model where it acts; sa_bn, sa_rest and sa_h also in
# training (sa_h acts only there: the recentred rows of bf16 training)
MODEL_CASES = [("pointnet2_cls_ssg", c, False)
               for c in ("sa", "sa3", "head", "sa_bn", "sa_rest")]
MODEL_CASES += [("pointnet2_cls_ssg", c, True)
                for c in ("sa_bn", "sa_rest", "sa_h")]
MODEL_CASES += [("pointnet2_sem_seg", c, False)
                for c in ("sa1", "sa2", "sa4", "fp", "head")]


@pytest.mark.parametrize(
    "name,component,train", MODEL_CASES,
    ids=[f"{n.split('_', 1)[1]}-{c}-{'train' if t else 'eval'}"
         for n, c, t in MODEL_CASES])
def test_component_acts_as_in_jax(name, component, train, monkeypatch):
    """A bf16 model with one component forced: every top-level block's
    output dtype equal to JAX's (the forced block's f32, and some block
    left in bf16). In eval the bf16 argmax equals JAX's on every cloud or
    point (agreement 1.0) and the log-probs lie within 2^-4 (bf16 on both
    sides, rounding at the same places). A train forward is held at the SA
    blocks, where the components act: their outputs within 2^-5 of the
    largest element, as the bare block's are below. Its log-probs are not
    held: the head's train-mode BN over a few bf16 rows turns a rounding
    flip into another class (with the knob unset, bf16 argmax agreement
    with JAX 0.69-0.75 at B=8 and 16)."""
    args, v = _case(name)
    _knob(monkeypatch, component)
    want, wdt, wout = _jax_run(name, jnp.bfloat16, v, args, train)
    got, gdt, gout = _port_run(name, torch.bfloat16, v, args, train)
    assert gdt == wdt
    if component in ("sa", "sa1", "sa2", "sa3", "sa4", "fp", "head"):
        forced = {"sa": "sa1", "fp": "fp1", "head": "head_out" if
                  "head_out" in wdt else "fc3"}.get(component, component)
        assert wdt[forced] == "float32"
    assert "bfloat16" in wdt.values()
    if train:
        for block in ("sa1", "sa2"):
            w = wout[block]
            assert np.abs(gout[block] - w).max() <= 2.0 ** -5 * np.abs(
                w).max(), block
        return
    assert (got.argmax(-1) == want.argmax(-1)).mean() == 1.0
    assert np.abs(got - want).max() <= 2.0 ** -4


def test_unset_knob_keeps_bf16(monkeypatch):
    """Unset, every block of the bf16 models keeps bf16 (the SA blocks'
    features, the heads), as in JAX."""
    _knob(monkeypatch, None)
    for name in MODELS:
        args, v = _case(name)
        _, wdt, _ = _jax_run(name, jnp.bfloat16, v, args, False)
        _, gdt, _ = _port_run(name, torch.bfloat16, v, args, False)
        assert gdt == wdt
        assert all(d == "bfloat16" for k, d in wdt.items()
                   if not k.startswith("drop"))


def test_sa_head_gives_the_fp32_model(monkeypatch):
    """``sa,head`` forces every block of pointnet2_cls_ssg back to f32
    (``sa3`` follows ``sa``): the bf16 model's log-probs are bit-identical
    with the port's fp32 model and within 1e-4 of JAX's bf16 model under
    the same knob."""
    name = "pointnet2_cls_ssg"
    args, v = _case(name)
    _knob(monkeypatch, "sa,head")
    want, wdt, _ = _jax_run(name, jnp.bfloat16, v, args, False)
    got, gdt, _ = _port_run(name, torch.bfloat16, v, args, False,
                            unfused=False)
    f32 = _port_run(name, None, v, args, False, unfused=False)[0]
    assert gdt == wdt and set(wdt.values()) == {"float32"}
    np.testing.assert_array_equal(got, f32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ the block

SA = dict(npoint=64, radius=0.4, nsample=16, mlp=(16, 16, 32))


@pytest.fixture(scope="module")
def sa_case():
    """A bf16 project-first SetAbstraction (5 feature channels): B=2 clouds
    of 256 points (bf16 features, as from a bf16 block), one flax init."""
    r = np.random.RandomState(9)
    xyz = (r.randn(2, 256, 3) * 0.5).astype(np.float32)
    feats = r.randn(2, 256, 5).astype(np.float32)
    v = _init(jp2.SetAbstraction(**SA), (xyz, feats))
    return xyz, feats, v


def _sa_jax(v, xyz, feats, train, mode):
    model = jp2.SetAbstraction(**SA, dtype=jnp.bfloat16)

    def f(v):
        return model.apply(v, jnp.asarray(xyz),
                           jnp.asarray(feats, jnp.bfloat16), train=train,
                           mutable=["batch_stats"] if train else False)

    with jdispatch.use_impl(mode), jax.default_matmul_precision("float32"):
        out = jax.jit(f)(v)
    return np.asarray((out[0] if train else out)[1])


def _sa_port(v, xyz, feats, train, unfused):
    port = load_jax_variables(pointnet2.SetAbstraction(
        SA["npoint"], SA["radius"], SA["nsample"], 5, SA["mlp"],
        dtype=torch.bfloat16), _np_tree(v)).train(train)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        if unfused:
            mp.setattr(pointnet2, "_want_fused_sa", lambda *a: False)
        return port(torch.from_numpy(xyz),
                    torch.from_numpy(feats).to(torch.bfloat16))[1]


# (train, JAX's impl mode, the port's fused gate off): eval in JAX's pure
# mode against the port's unfused tail, eval in JAX's Pallas mode against
# the port's fused twin, train (unfused on both sides)
SA_MODES = {"eval-unfused": (False, "jax", True),
            "eval-fused": (False, "pallas", False),
            "train": (True, "jax", True)}


@pytest.mark.parametrize("mode", sorted(SA_MODES))
@pytest.mark.parametrize("component", [None, "sa_bn", "sa_rest", "sa_h",
                                       "sa_bn,sa_h"],
                         ids=["unset", "sa_bn", "sa_rest", "sa_h",
                              "sa_bn+sa_h"])
def test_block_components_act_as_in_jax(sa_case, component, mode,
                                        monkeypatch):
    """The block-level components, read at the call: the bf16 block's
    output dtype equal to JAX's (f32 where a forced ``sa_bn`` folds BN in
    f32 into the fused tail, or a forced ``sa_rest`` computes the unfused
    tail's last layers in f32), values within 2^-5 of the largest (bf16 on both sides;
    a train-mode BN renormalises, as in ``test_torch_project_first``)."""
    xyz, feats, v = sa_case
    train, jmode, unfused = SA_MODES[mode]
    _knob(monkeypatch, component)
    want = _sa_jax(v, xyz, feats, train, jmode)
    got = _sa_port(v, xyz, feats, train, unfused)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    forced = (component or "").split(",")
    f32 = ("sa_bn" in forced) if mode == "eval-fused" else (
        "sa_rest" in forced)
    assert (want.dtype == np.float32) == f32
    g, w = got.float().numpy(), want.astype(np.float32)
    assert np.abs(g - w).max() <= 2.0 ** -5 * np.abs(w).max()


# ------------------------------------------------------------ routing


def _flags(monkeypatch):
    """Fake the kernels and record each launch's symbol and bf16 flag."""
    fake_kernels(monkeypatch)
    launch, seen = ck._launch, []

    def record(symbol, *a):
        seen.append((symbol, a[0]))
        return launch(symbol, *a)

    monkeypatch.setattr(ck, "_launch", record)
    return seen


def _serve_launches(name, dtype, v, args):
    ck.reset_launches()
    model = load_jax_variables(get_model(name).builder(
        num_class=NUM_CLASS, dtype=dtype), _np_tree(v)).eval()
    with torch.no_grad():
        model(*map(torch.from_numpy, args))
    return {k.__name__: k.launches for k in ck.KERNELS if k.launches}


def test_knob_routes_kernels(monkeypatch):
    """bf16 serving on the kernel path: pointnet2_cls_ssg runs the fused SA
    kernel twice with bf16 operands; under ``sa`` none, with the fp32
    model's launches (FPS and the ball query twice); under ``sa_bn`` twice
    with f32 operands (its f32 form, as JAX's ``fused_sa_pallas`` keys its
    form on pre's dtype). pointnet2_sem_seg runs the fused FP kernel four
    times in bf16, and under ``fp`` four times in f32."""
    seen = _flags(monkeypatch)
    cls, seg = "pointnet2_cls_ssg", "pointnet2_sem_seg"

    def run(value, name, dtype=torch.bfloat16):
        _knob(monkeypatch, value)
        seen.clear()
        args, v = _case(name)
        counts = _serve_launches(name, dtype, v, args)
        return counts, sorted({(s, f) for s, f in seen
                               if s in ("mm3d_fused_sa", "mm3d_fused_fp")})

    fp32, _ = run(None, cls, None)
    assert fp32 == {"farthest_point_sample": 2, "query_ball_point": 2}
    assert run(None, cls) == ({"farthest_point_sample": 2, "fused_sa": 2},
                              [("mm3d_fused_sa", 1)])
    assert run("sa", cls) == (fp32, [])
    assert run("sa_bn", cls) == ({"farthest_point_sample": 2,
                                  "fused_sa": 2}, [("mm3d_fused_sa", 0)])
    unset, flags = run(None, seg)
    assert unset["fused_fp"] == 4 and ("mm3d_fused_fp", 1) in flags
    forced, flags = run("fp", seg)
    assert forced == unset
    assert ("mm3d_fused_fp", 0) in flags and ("mm3d_fused_fp", 1) not in flags
