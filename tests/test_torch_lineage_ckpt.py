"""The port's lineage checkpoint import and export
(``utils/torch_import.py``) against the JAX package's, on the CPU.

For each model of ``SUPPORTED``: a state dict from the JAX package's
``export_state_dict`` of one flax init (BN statistics, affines and biases
drawn with numpy) is imported by both sides; the port's flax-layout tree
must be JAX's bit for bit, the port model filled from it must give JAX's
fp32 eval log-probs within 1e-4, and exporting it again must give the state
dict back bit for bit. The lineage's ``{"model_state_dict": ...}`` wrapper
and DataParallel's ``module.`` prefix load; the fusion models and
``pointnet_part_seg`` are refused. (``tests/test_torch_import.py`` is the
JAX package's own test of its module.)
"""

import numpy as np
import pytest
import torch

from test_torch_fusion_semseg import _apply, _init, _np_tree
from mm3d_tpu.models import get_model as jax_get_model
from mm3d_tpu.utils import torch_import as jti
from mm3d_tpu_torch.models import get_model
from mm3d_tpu_torch.training import make_predictor
from mm3d_tpu_torch.utils import load_jax_variables, to_jax_tree
from mm3d_tpu_torch.utils import torch_import as ti
from mm3d_tpu_torch.utils.jax_import import _flatten


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (several
    test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kwargs(name):
    task = get_model(name).task
    return ({"num_class": 10} if task == "classification"
            else {"num_class": 13} if task == "semseg" else {})


def _inputs(name, B=2, N=128, seed=5):
    r = np.random.RandomState(seed)
    task = get_model(name).task
    xyz = r.randn(B, N, 3).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1).max()
    if task == "semseg":
        return (np.concatenate([xyz * 1.5, r.rand(B, N, 6)], -1).astype(
            np.float32),)
    if task == "partseg":
        onehot = np.eye(16, dtype=np.float32)[r.randint(0, 16, B)]
        return xyz, onehot
    return (xyz,)


def _assert_same_tree(got, want):
    g, w = dict(_flatten(got)), dict(_flatten(want))
    assert g.keys() == w.keys()
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_same_sd(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module", params=ti.SUPPORTED)
def lineage_case(request):
    """One flax init of the model, its JAX lineage state dict, and the
    port model with the tree the port imported from it."""
    name = request.param
    args = _inputs(name)
    jmodel = jax_get_model(name).builder(**_kwargs(name))
    v = _np_tree(_init(jmodel, args, seed=2))
    sd = jti.export_state_dict(name, v)
    port = get_model(name).builder(**_kwargs(name))
    tree = ti.import_state_dict(name, port, sd)
    return name, args, jmodel, v, sd, port, tree


def test_supported_matches_jax():
    assert ti.SUPPORTED == jti.SUPPORTED


def test_import_matches_jax_bit_for_bit(lineage_case):
    name, _, _, v, sd, port, tree = lineage_case
    want = jti.import_state_dict(name, v, sd)
    _assert_same_tree(tree, want)
    # the flax template may also be given as a tree
    _assert_same_tree(ti.import_state_dict(name, to_jax_tree(port), sd),
                      want)


def test_imported_model_matches_jax_logprobs(lineage_case):
    name, args, jmodel, v, sd, port, tree = lineage_case
    load_jax_variables(port, tree)
    want = _apply(jmodel, jti.import_state_dict(name, v, sd), args,
                  "jax")[0]
    pred = make_predictor(name, port.state_dict(), device="cpu",
                          **_kwargs(name))
    got = pred(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    print(f"{name}: fp32 max|d logp| {err}")
    assert err <= 1e-4


def test_export_round_trips_bit_for_bit(lineage_case):
    name, _, _, v, sd, port, tree = lineage_case
    load_jax_variables(port, tree)
    # the port model's export is the state dict it came from
    _assert_same_sd(ti.export_state_dict(name, port), sd)
    _assert_same_sd(ti.export_state_dict(name, tree),
                    jti.export_state_dict(name, v))
    # and imports back to the model's own tensors
    _assert_same_tree(ti.import_state_dict(
        name, port, ti.export_state_dict(name, port)), to_jax_tree(port))


def test_lineage_wrapper_and_module_prefix_load(tmp_path):
    name = "pointnet2_cls_ssg"
    port = get_model(name).builder(**_kwargs(name))
    v = to_jax_tree(port)
    r = np.random.RandomState(0)
    sd = {k: (a + r.randn(*a.shape)).astype(np.float32)
          for k, a in ti.export_state_dict(name, v).items()}
    want = ti.import_state_dict(name, v, sd)
    tensors = {k: torch.from_numpy(a) for k, a in sd.items()}
    cases = {
        "bare": tensors,
        "wrapped": {"model_state_dict": tensors, "epoch": 3},
        "prefixed": {"model_state_dict": {f"module.{k}": t
                                          for k, t in tensors.items()}},
        # BN's counters: not part of the map, ignored
        "counters": {**tensors, "sa1.mlp_bns.0.num_batches_tracked":
                     torch.tensor(7)},
    }
    for label, obj in cases.items():
        path = str(tmp_path / f"{label}.pth")
        torch.save(obj, path)
        _assert_same_tree(ti.load_torch_checkpoint(name, port, path), want)
        _assert_same_tree(ti.load_torch_checkpoint(name, port, path),
                          jti.load_torch_checkpoint(name, v, path))
    model = ti.load_torch_into_model(name, get_model(name).builder(
        **_kwargs(name)), str(tmp_path / "prefixed.pth"))
    _assert_same_tree(to_jax_tree(model), want)


@pytest.mark.parametrize("name", ["fusion_cls", "fusion_sem_seg",
                                  "fusion_cls_attention", "pointnet_part_seg"])
def test_unmapped_models_are_refused(name):
    port = get_model(name).builder()
    for fn in (lambda: ti.export_state_dict(name, port),
               lambda: ti.import_state_dict(name, port, {})):
        with pytest.raises(ValueError, match="no canonical torch layout"):
            fn()


def test_shape_mismatch_is_refused():
    name = "pointnet2_cls_ssg"
    sd = ti.export_state_dict(name, get_model(name).builder(num_class=10))
    with pytest.raises(ValueError, match="shape mismatch"):
        ti.import_state_dict(name, get_model(name).builder(num_class=40), sd)
