"""The group-then-MLP form of the PointNet++ blocks (``project_first=False``
of ``SetAbstraction``, ``SetAbstractionMsg`` and ``FeaturePropagation``) in
the port against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; one flax init per block moves into
the port with ``load_jax_variables``. Each plain block in eval and train
(fp32 within 1e-5, f64 gradients within 1e-6 of each tensor's largest
element), in bf16 (the output dtype JAX gives, and the values), its
centroids bit for bit, JAX's quirks (the SSG block ignores ``knn`` and
``f32_train_guard``; the MSG scales compute in f32 in a bf16 block; the FP
block interpolates in f32), its launches under
``test_torch_fused_sa.fake_kernels`` (no fused kernel), no sharded call
under a point-shard context, the flax tree round trip, and the port's plain
blocks against its project-first blocks carrying the same weights (the
property ``tests/test_project_first.py`` holds in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import jit_init
from test_project_first import _transfer_plain_to_proj
from test_torch_fused_sa import fake_kernels
from test_torch_fusion_semseg import _np_tree, _randomize
from test_torch_training import _assert_trees, _assert_trees_scaled
from mm3d_tpu.models import pointnet2 as jp2
from mm3d_tpu.ops import geometry as G
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.models import pointnet2
from mm3d_tpu_torch.ops import cuda_kernels as ck
from mm3d_tpu_torch.ops import dispatch
from mm3d_tpu_torch.parallel import point_shard
from mm3d_tpu_torch.parallel.mesh import Mesh
from mm3d_tpu_torch.utils import load_jax_variables, to_jax_tree


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (see
    ``test_torch_partseg``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, N = 2, 256
SSG = dict(npoint=64, radius=0.4, nsample=16, mlp=(16, 16, 32))
MSG = dict(npoint=32, radius_list=(0.2, 0.4), nsample_list=(8, 16),
           mlp_list=((16, 16, 32), (16, 24, 32)))
FP_MLP, FP_SPARSE = (24, 16), 12

# name -> (block, feature channels (SA) or (skip channels, M) (FP), the
# JAX attributes the plain branch ignores)
CASES = {"ssg": ("ssg", 0, {}), "ssg-features": ("ssg", 5, {}),
         "ssg-knn": ("ssg", 5, {"knn": True}),
         "ssg-guard": ("ssg", 5, {"f32_train_guard": True}),
         "msg": ("msg", 0, {}), "msg-features": ("msg", 5, {}),
         "fp": ("fp", (5, 24), {}), "fp-noskip": ("fp", (0, 24), {}),
         "fp-m1": ("fp", (5, 1), {}), "fp-m1-noskip": ("fp", (0, 1), {})}
KINDS = ("ssg-features", "msg-features", "fp")


def _j(a, dtype=None):
    if a is None:
        return None
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _args(name):
    """The block's inputs: unit-scale clouds of N points (features of D
    channels); for FP, N dense and M sparse points, the skip features (or
    None) and FP_SPARSE sparse channels."""
    kind, d, _ = CASES[name]
    r = np.random.RandomState(sorted(CASES).index(name))
    xyz = (r.randn(B, N, 3) * 0.5).astype(np.float32)
    if kind != "fp":
        return (xyz, r.randn(B, N, d).astype(np.float32) if d else None)
    skip, m = d
    return (xyz, (r.randn(B, m, 3) * 0.5).astype(np.float32),
            r.randn(B, N, skip).astype(np.float32) if skip else None,
            r.randn(B, m, FP_SPARSE).astype(np.float32))


def _jax_block(name, dtype=None, project_first=False):
    kind, _, extra = CASES[name]
    if kind == "ssg":
        return jp2.SetAbstraction(**SSG, project_first=project_first,
                                  dtype=dtype, **extra)
    if kind == "msg":
        return jp2.SetAbstractionMsg(**MSG, project_first=project_first,
                                     dtype=dtype)
    return jp2.FeaturePropagation(FP_MLP, project_first=project_first,
                                  dtype=dtype)


def _port_block(name, dtype=None, project_first=False):
    kind, d, extra = CASES[name]
    if kind == "ssg":
        return pointnet2.SetAbstraction(
            SSG["npoint"], SSG["radius"], SSG["nsample"], d, SSG["mlp"],
            dtype=dtype, project_first=project_first, **extra)
    if kind == "msg":
        return pointnet2.SetAbstractionMsg(
            MSG["npoint"], MSG["radius_list"], MSG["nsample_list"],
            MSG["mlp_list"], d, dtype=dtype, project_first=project_first)
    return pointnet2.FeaturePropagation(d[0], FP_SPARSE, FP_MLP, dtype=dtype,
                                        project_first=project_first)


_VARS = {}


def _vars(name):
    """One flax init of the plain block, with drawn BN statistics, affines
    and biases (cached: the tests only read it)."""
    if name not in _VARS:
        v = jit_init(_jax_block(name), {"params": jax.random.PRNGKey(0)},
                     *map(_j, _args(name)), train=True)
        _VARS[name] = _randomize({"params": v["params"],
                                  "batch_stats": v["batch_stats"]}, 3)
    return _VARS[name]


_JAX_OUT = {}


def _jax_outputs(name, bf16=False):
    """JAX's block on the case's inputs (bf16: a bf16 block fed bf16
    features, as from a bf16 block before it), eval and train forward
    (batch statistics, momentum 0.2) in one compiled call: {"eval": out,
    "train": out, "stats": the new BN statistics} (cached: the tests only
    read it)."""
    key = (name, bf16)
    if key not in _JAX_OUT:
        model = _jax_block(name, jnp.bfloat16 if bf16 else None)
        feat_at = (1,) if CASES[name][0] != "fp" else (2, 3)
        args = tuple(_j(a, jnp.bfloat16 if bf16 and i in feat_at else None)
                     for i, a in enumerate(_args(name)))

        def f(v, a):
            ev = model.apply(v, *a, train=False)
            tr, mut = model.apply(v, *a, train=True, bn_momentum=0.2,
                                  mutable=["batch_stats"])
            return ev, tr, mut["batch_stats"]

        with jax.default_matmul_precision("float32"):
            ev, tr, st = jax.jit(f)(_vars(name), args)
        _JAX_OUT[key] = {"eval": jax.tree_util.tree_map(np.asarray, ev),
                         "train": jax.tree_util.tree_map(np.asarray, tr),
                         "stats": _np_tree(st)}
    return _JAX_OUT[key]


def _port(name, dtype=None, train=False):
    port = _port_block(name, dtype)
    load_jax_variables(port, _np_tree(_vars(name)))
    return port.train(train)


def _close(got, want, rel=1e-5):
    """max|got - want| <= rel * max|want|: a bound on the error relative to
    the output's scale (a train-mode BN divides each channel by its batch
    spread, which magnifies an f32 ulp of a small-spread channel)."""
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _out(o):
    """The block's features: (centroids, features) for SA, features for
    FP."""
    return o[1] if isinstance(o, tuple) else o


# ------------------------------------------------------------ fp32, f64


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_block_eval_matches_jax(name):
    """fp32 eval within 1e-5 of the JAX block's largest output element; SA
    centroids bit for bit.
    ``knn`` and ``f32_train_guard`` change nothing here, as in JAX: the
    plain SSG block always groups by the ball query."""
    args = _args(name)
    want = _jax_outputs(name)["eval"]
    with torch.no_grad():
        got = _port(name)(*map(_t, args))
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert _out(got).dtype == torch.float32
    assert _out(got).shape == _out(want).shape
    _close(_out(got).numpy(), _out(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_block_train_matches_jax(name):
    """fp32 train forward (batch statistics, momentum 0.2): the output
    within 1e-5 of its largest element and the new BN statistics within
    1e-5."""
    args = _args(name)
    want, stats = _jax_outputs(name)["train"], _jax_outputs(name)["stats"]
    port = _port(name, train=True)
    with torch.no_grad():
        got = port(*map(_t, args), bn_momentum=0.2)
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
    _close(_out(got).numpy(), _out(want))
    _assert_trees(to_jax_tree(port)["batch_stats"], stats, rtol=1e-5,
                  atol=1e-5)


def _f64_grads(name):
    """value_and_grad of sum(out * co) over the parameters and the feature
    inputs, train mode, in f64 on both sides (JAX x64, its BN statistics
    widened as in ``test_torch_knn.cls_step_f64``)."""
    import mm3d_tpu.models.layers as jax_layers

    class _Wide:  # jnp with float32 -> float64, for the BN statistics
        def __getattr__(self, attr):
            return jnp.float64 if attr == "float32" else getattr(jnp, attr)

    args = [None if a is None else a.astype(np.float64) for a in _args(name)]
    grad_at = [i for i, a in enumerate(args)
               if a is not None and (i >= 1 if CASES[name][0] != "fp"
                                     else i >= 2)]
    model = _jax_block(name)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               _vars(name))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _Wide())
        out = jax.eval_shape(lambda a: model.apply(
            v, *a, train=True, mutable=["batch_stats"])[0],
            tuple(map(_j, args)))
        co = np.random.RandomState(5).randn(*_out(out).shape)

        def loss(params, *xs):
            a = list(map(_j, args))
            for i, x in zip(grad_at, xs):
                a[i] = x
            o, _ = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, *a,
                               train=True, mutable=["batch_stats"])
            return jnp.sum(_out(o) * co)

        want = jax.jit(jax.grad(loss, argnums=tuple(
            range(1 + len(grad_at)))))(v["params"],
                                       *[_j(args[i]) for i in grad_at])
    port = load_jax_variables(_port_block(name).double(), v).train()
    ta = [_t(a) for a in args]
    for i in grad_at:
        ta[i].requires_grad_(True)
    (_out(port(*ta)) * torch.from_numpy(co)).sum().backward()
    got = to_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})
    return (got["params"], [ta[i].grad.numpy() for i in grad_at],
            _np_tree(want[0]), [np.asarray(w) for w in want[1:]])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_block_f64_gradients_match_jax(name):
    """Every parameter gradient and the feature inputs' gradients (the
    gather backward's, and three_interpolate's for FP) in f64 within 1e-6
    of each tensor's largest element. A gradient that is zero in exact
    arithmetic (a Dense bias ahead of a train-mode BN) is f64 rounding
    residue of sums of terms the size of the block's largest gradient
    element: held to 1e-12 of it."""
    gp, gx, wp, wx = _f64_grads(name)
    top = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(wp))
    _assert_trees_scaled(gp, wp, 1e-6, atol=1e-12 * top)
    assert len(gx) == len(wx) >= (0 if name in ("ssg", "msg") else 1)
    for g, w in zip(gx, wx):
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


# ------------------------------------------------------------ bf16

# bf16: both sides round at the same places; a sum taken in another order
# can flip one bf16 rounding (2^-8 relative) and carry it through the next
# layer. Eval outputs are held to 2^-6 of the largest element (measured: 0,
# 5.8e-4 at fp-noskip). A train-mode BN normalises by batch statistics
# whose f32 sums run in another order on each side, so a flipped bf16
# rounding of a channel's mean moves the whole channel: train outputs are
# held to 2^-5, four bf16 ulps of an element in [1, 2) (measured up to
# 1.94e-2, fp-m1-noskip, whose rows repeat one sparse row). f32 outputs
# (the MSG scales) to 1e-5.
BF16_REL = {False: 2.0 ** -6, True: 2.0 ** -5}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_block_bf16_matches_jax(name, train):
    """A bf16 block (bf16 features in, as from a bf16 block before it)
    against JAX's bf16 block: the output dtype JAX gives (bf16 for SSG and
    FP, whose MLP computes in the block's dtype, ``f32_train_guard`` or not;
    f32 for MSG, whose scales' MLPs have no dtype), the values, the
    centroids bit for bit."""
    kind = CASES[name][0]
    args = _args(name)
    feat_at = (1,) if kind != "fp" else (2, 3)
    targs = [_t(a, torch.bfloat16 if i in feat_at else None)
             for i, a in enumerate(args)]
    want = _jax_outputs(name, bf16=True)["train" if train else "eval"]
    port = _port(name, torch.bfloat16, train)
    with torch.no_grad():
        got = port(*targs, bn_momentum=0.2) if train else port(*targs)
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
    g, w = _out(got), _out(want)
    assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert (w.dtype == np.float32) == (kind == "msg")
    g, w = g.float().numpy(), w.astype(np.float32)
    if kind == "msg":
        _close(g, w)
    else:
        _close(g, w, BF16_REL[train])


def test_fp_interpolates_bf16_features_in_f32():
    """JAX's plain FP interpolates with ``_three_interpolate_jax``: bf16
    features times f32 weights promote, so the interpolation is f32. The
    port's block calls three_interpolate on the features promoted to f32:
    JAX's result, in f32 (a bf16 call would round the weights and the
    result)."""
    name = "fp"
    xyz1, xyz2, f1, f2 = _args(name)
    f2_16 = torch.from_numpy(f2).to(torch.bfloat16)
    seen, interpolate = [], tops.three_interpolate

    def spy(points, idx, weight):
        out = interpolate(points, idx, weight)
        seen.append((points, idx, weight, out))
        return out

    port = _port(name, torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(pointnet2.ops, "three_interpolate", spy)
        port(_t(xyz1), _t(xyz2), _t(f1, torch.bfloat16), f2_16)
    (points, idx, weight, out), = seen
    assert points.dtype == weight.dtype == out.dtype == torch.float32
    assert torch.equal(points, f2_16.float())
    want = G._three_interpolate_jax(jnp.asarray(f2, jnp.bfloat16),
                                    jnp.asarray(idx.numpy()),
                                    jnp.asarray(weight.numpy()))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# ------------------------------------------------------------ kernels


# launches of one eval forward: no fused kernel on either dtype, even under
# impl 'cuda'
EVAL_LAUNCHES = {
    "ssg-features": {"farthest_point_sample": 1, "query_ball_point": 1},
    "ssg-knn": {"farthest_point_sample": 1, "query_ball_point": 1},
    "msg-features": {"farthest_point_sample": 1, "query_ball_point": 2},
    "fp": {"three_nn": 1, "three_interpolate": 1},
    "fp-m1": {}}
# and of a train step's backward, the features requiring grad: one gather
# backward an SSG block, one a scale, one weighted an FP block
BACKWARD_LAUNCHES = {"ssg-features": 1, "ssg-knn": 1, "msg-features": 2,
                     "fp": 1, "fp-m1": 0}


def _launches():
    return {k.__name__: k.launches for k in ck.KERNELS if k.launches}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(EVAL_LAUNCHES))
def test_plain_block_launches(name, dtype, monkeypatch):
    """The wrappers' kernel path (``fake_kernels``, impl 'cuda'): an eval
    forward launches FPS and one ball query a scale (the plain SSG block's
    ``knn`` is ignored) or three_nn and three_interpolate, and no fused
    kernel; its output is the plain path's bit for bit. A train forward and
    backward with the features requiring grad adds the gather backward
    (weighted for FP) and gives the plain path's gradients bit for bit."""
    args = _args(name)
    fp = CASES[name][0] == "fp"
    feat_at, cast_at = (3, (2, 3)) if fp else (1, (1,))

    def run(train):
        port = _port(name, dtype, train)
        ta = [_t(a, dtype if i in cast_at else None)
              for i, a in enumerate(args)]
        if not train:
            with torch.no_grad():
                return _out(port(*ta)), None
        ta[feat_at].requires_grad_(True)
        out = _out(port(*ta))
        out.float().sum().backward()
        return out.detach(), ta[feat_at].grad

    with dispatch.use_impl("torch"):
        want = [run(False), run(True)]
    fake_kernels(monkeypatch)
    monkeypatch.setattr(dispatch, "get_impl", lambda: "cuda")
    ck.reset_launches()
    got_eval = run(False)
    assert _launches() == EVAL_LAUNCHES[name]
    ck.reset_launches()
    got_train = run(True)
    bwd = BACKWARD_LAUNCHES[name]
    assert _launches() == dict(EVAL_LAUNCHES[name],
                               **({"gather_backward": bwd} if bwd else {}))
    for g, w in zip(got_eval + got_train, want[0] + want[1]):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def _raise(*a, **k):
    raise AssertionError("a sharded function was called")


@pytest.mark.parametrize("name", KINDS)
def test_plain_block_never_shards(name, monkeypatch):
    """Under a point-shard context whose gates a project-first block of
    the same widths passes (eval, 3-layer MLPs, N >= min_points, N divides
    by the ranks), the plain block makes no sharded call and gives its
    output outside the context, as JAX's plain branches do (SSG returns
    before the gate, MSG shards only when project_first, FP has no sharded
    branch); the project-first block there does call one."""
    monkeypatch.setattr(pointnet2, "sharded_fps", _raise)
    for fn in ("sharded_sa_group_max", "sharded_idx_group_max",
               "sharded_knn_point", "sharded_fp"):
        monkeypatch.setattr(pointnet2.sg, fn, _raise)
    args = [_t(a) for a in _args(name)]
    port = _port(name)
    proj = _port_block(name, project_first=True).eval()
    with torch.no_grad():
        want = _out(port(*args))
        with point_shard(Mesh(None, 0, 2), min_points=64):
            got = _out(port(*args))
            with pytest.raises(AssertionError, match="sharded"):
                proj(*args)
    assert torch.equal(got, want)


def test_plain_ssg_random_fps_start():
    """The plain SSG block draws its FPS start as the project-first one
    does (``_fps_start``: random in training with a generator, else 0)."""
    name = "ssg-features"
    args = [_t(a) for a in _args(name)]
    plain = _port(name, train=True)
    proj = _port_block(name, project_first=True).train()
    with torch.no_grad():
        a = plain(*args, fps_generator=torch.Generator().manual_seed(7))[0]
        b = proj(*args, fps_generator=torch.Generator().manual_seed(7))[0]
        c = plain(*args)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    np.testing.assert_array_equal(c.numpy(), _jax_outputs(name)["eval"][0])


# ------------------------------------------------------------ trees


@pytest.mark.parametrize("name", KINDS)
def test_plain_block_tree_round_trip(name):
    """The port's plain block holds JAX's tree: every entry of the flax
    variables, and nothing else, back out bit for bit."""
    port = _port(name)
    _assert_trees(to_jax_tree(port), _np_tree(_vars(name)), rtol=0, atol=0)


def _plain_to_proj(name, tree):
    """The map of ``tests/test_project_first.py``: the plain MLP's first
    layer becomes proj_kernel / proj_bias / proj_bn, the rest mlp_rest; a
    scale at a time for MSG."""
    if CASES[name][0] != "msg":
        return _transfer_plain_to_proj(tree)
    out = {"params": {}, "batch_stats": {}}
    for i in range(len(MSG["mlp_list"])):
        one = _transfer_plain_to_proj(
            {c: {"mlp": tree[c][f"mlp_{i}"]} for c in out})
        for c in out:
            out[c].update({f"{k}_{i}": v for k, v in one[c].items()})
    return out


@pytest.mark.parametrize("name", ["ssg", "ssg-features", "msg",
                                  "msg-features", "fp", "fp-noskip",
                                  "fp-m1"])
def test_plain_equals_project_first(name):
    """The port's plain block against its project-first block carrying the
    same weights: fp32 eval within 1e-4 (the bound of
    ``tests/test_project_first.py``), centroids bit for bit."""
    args = [_t(a) for a in _args(name)]
    plain = _port(name)
    proj = _port_block(name, project_first=True).eval()
    load_jax_variables(proj, _plain_to_proj(name, to_jax_tree(plain)))
    with torch.no_grad():
        a, b = plain(*args), proj(*args)
    if isinstance(a, tuple):
        assert torch.equal(a[0], b[0])
    np.testing.assert_allclose(_out(a).numpy(), _out(b).numpy(), rtol=1e-4,
                               atol=1e-4)
