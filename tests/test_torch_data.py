"""The port's data layer against the JAX package, on the CPU.

Augmentation: each JAX op's own random draws (made with the op's key, as
the op makes them) are fed to the port's apply function, which must give
the JAX op's output exactly. Synthetic data: the port's generators must give
the JAX package's arrays for the same seed. The input pipeline is checked
on its own contract (padding masks, bounds, prefetch, device copies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3d_tpu.data import augment as jaug
from mm3d_tpu.data import synthetic as jsyn
from mm3d_tpu_torch.data import augment as aug
from mm3d_tpu_torch.data import synthetic as syn
from mm3d_tpu_torch.data.pipeline import DataPipeline


def _batch(seed=0, B=4, N=64, C=3):
    return np.random.RandomState(seed).randn(B, N, C).astype(np.float32)


# ------------------------------------------------------------ augment


def test_random_point_dropout_apply_matches_jax():
    b = _batch(1)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    ratio = jax.random.uniform(k1, (4, 1)) * 0.875
    drop = np.array(jax.random.uniform(k2, (4, 64)) <= ratio)
    assert drop.any() and not drop.all()
    want = np.asarray(jaug.random_point_dropout(key, jnp.asarray(b)))
    got = aug.random_point_dropout(torch.from_numpy(b), torch.from_numpy(drop))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", [3, 6])
def test_random_scale_apply_matches_jax(C):
    b = _batch(2, C=C)
    key = jax.random.PRNGKey(4)
    scale = np.array(jax.random.uniform(key, (4, 1, 1), minval=0.8,
                                        maxval=1.25))
    want = np.asarray(jaug.random_scale_point_cloud(key, jnp.asarray(b)))
    got = aug.random_scale_point_cloud(torch.from_numpy(b),
                                       torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", [3, 6])
def test_shift_apply_matches_jax(C):
    b = _batch(3, C=C)
    key = jax.random.PRNGKey(5)
    shift = np.array(jax.random.uniform(key, (4, 1, 3), minval=-0.1,
                                        maxval=0.1))
    want = np.asarray(jaug.shift_point_cloud(key, jnp.asarray(b)))
    got = aug.shift_point_cloud(torch.from_numpy(b), torch.from_numpy(shift))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fusion_cls_pipeline_matches_jax():
    """augment_fusion_batch over TASK_PIPELINES['fusion_cls'], with the
    draws the JAX pipeline makes (op i uses fold_in(key, i))."""
    names = aug.TASK_PIPELINES["fusion_cls"]
    assert names == jaug.TASK_PIPELINES["fusion_cls"]
    b = _batch(6)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
    key = jax.random.PRNGKey(7)
    want, want_R = jaug.augment_fusion_batch(key, jnp.asarray(b),
                                             jnp.asarray(R), names)
    k0, k1, k2 = (jax.random.fold_in(key, i) for i in range(3))
    ka, kb = jax.random.split(k0)
    drop = jax.random.uniform(kb, (4, 64)) <= (
        jax.random.uniform(ka, (4, 1)) * 0.875)
    draws = [np.array(drop),
             np.array(jax.random.uniform(k1, (4, 1, 1), minval=0.8,
                                         maxval=1.25)),
             np.array(jax.random.uniform(k2, (4, 1, 3), minval=-0.1,
                                         maxval=0.1))]
    got = torch.from_numpy(b)
    for name, d in zip(names, draws):
        got = aug._REGISTRY[name][1](got, torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want_R), R)


def test_draws_come_from_the_generator():
    b = torch.from_numpy(_batch(7))
    R = torch.eye(3).expand(4, 3, 3)
    names = aug.TASK_PIPELINES["fusion_cls"]
    a, Ra = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                     names)
    c, _ = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                    names)
    d, _ = aug.augment_fusion_batch(torch.Generator().manual_seed(2), b, R,
                                    names)
    assert torch.equal(a, c) and not torch.equal(a, d)
    assert torch.equal(Ra, R) and a.shape == b.shape
    scale = aug.draw_random_scale(torch.Generator().manual_seed(3), b)
    assert bool(((scale >= 0.8) & (scale <= 1.25)).all())
    shift = aug.draw_shift(torch.Generator().manual_seed(3), b)
    assert bool((shift.abs() <= 0.1).all())
    # the Z rotations are ported (they raised before fusion_semseg's
    # training): their angles come from the generator too, and only the
    # calib-aware one moves R
    semseg = aug.TASK_PIPELINES["fusion_semseg"]
    a, Ra = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                     semseg)
    c, Rc = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                     semseg)
    d, Rd = aug.augment_fusion_batch(torch.Generator().manual_seed(2), b, R,
                                     semseg)
    assert torch.equal(a, c) and torch.equal(Ra, Rc)
    assert not torch.equal(a, d) and not torch.equal(Ra, Rd)
    e, Re = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                     ("rotate_point_cloud_z",))
    assert torch.equal(e, a) and torch.equal(Re, R)
    angle = aug.draw_rotation(torch.Generator().manual_seed(3), b)
    assert bool(((angle >= 0) & (angle <= 2 * np.pi)).all())
    # every op of the JAX registry is ported now: jitter draws from the
    # generator too, and only an unknown name is refused
    j1, _ = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                     ("jitter_point_cloud",))
    j2, _ = aug.augment_fusion_batch(torch.Generator().manual_seed(1), b, R,
                                     ("jitter_point_cloud",))
    assert torch.equal(j1, j2) and not torch.equal(j1, b)
    with pytest.raises(KeyError, match="unknown augmentation"):
        aug.augment_fusion_batch(None, b, R, ("no_such_op",))


def _hp(fn, *args):
    """A JAX op under f32 matmuls (the perturbation composes Rz Ry Rx with
    the default precision)."""
    with jax.default_matmul_precision("float32"):
        return np.asarray(fn(*args))


@pytest.mark.parametrize("C,normals", [(3, False), (6, False), (6, True),
                                       (9, True)])
def test_rotate_point_cloud_apply_matches_jax(C, normals):
    """The Y rotation for the JAX op's own angles within 1e-6 (sin/cos and
    the three-term sums may round apart in the last bit); with
    ``rotate_normals`` channels 3:6 turn with the same matrix as the xyz,
    and the channels past 6 stay."""
    b = _batch(9, C=C)
    key = jax.random.PRNGKey(10)
    angle = np.array(jax.random.uniform(key, (4,)) * 2.0 * jnp.pi)
    want = _hp(lambda: jaug.rotate_point_cloud(key, jnp.asarray(b),
                                               rotate_normals=normals))
    got = aug.rotate_point_cloud(torch.from_numpy(b), torch.from_numpy(angle),
                                 rotate_normals=normals).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if normals:
        turned = aug.rotate_point_cloud(torch.from_numpy(b[..., 3:6].copy()),
                                        torch.from_numpy(angle)).numpy()
        np.testing.assert_array_equal(got[..., 3:6], turned)
        np.testing.assert_array_equal(got[..., 6:], b[..., 6:])
    else:
        np.testing.assert_array_equal(got[..., 3:], b[..., 3:])
    # a rotation keeps each point's distance from the origin
    np.testing.assert_allclose(np.linalg.norm(got[..., :3], axis=-1),
                               np.linalg.norm(b[..., :3], axis=-1),
                               rtol=1e-5)


@pytest.mark.parametrize("C,normals", [(3, False), (6, True)])
def test_rotate_perturbation_apply_matches_jax(C, normals):
    b = _batch(11, C=C)
    key = jax.random.PRNGKey(12)
    angles = np.array(jnp.clip(0.06 * jax.random.normal(key, (4, 3)),
                               -0.18, 0.18))
    assert np.abs(angles).max() <= 0.18
    want = _hp(lambda: jaug.rotate_perturbation_point_cloud(
        key, jnp.asarray(b), rotate_normals=normals))
    got = aug.rotate_perturbation_point_cloud(
        torch.from_numpy(b), torch.from_numpy(angles),
        rotate_normals=normals).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    draw = aug.draw_rotate_perturbation(torch.Generator().manual_seed(0),
                                        torch.from_numpy(b))
    assert draw.shape == (4, 3) and float(draw.abs().max()) <= 0.18


@pytest.mark.parametrize("C", [3, 6])
def test_jitter_apply_matches_jax(C):
    b = _batch(13, C=C)
    key = jax.random.PRNGKey(14)
    noise = np.array(jnp.clip(0.01 * jax.random.normal(key, (4, 64, 3)),
                              -0.05, 0.05))
    want = np.asarray(jaug.jitter_point_cloud(key, jnp.asarray(b)))
    got = aug.jitter_point_cloud(torch.from_numpy(b),
                                 torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3:], b[..., 3:])
    draw = aug.draw_jitter(torch.Generator().manual_seed(0),
                           torch.from_numpy(b))
    assert draw.shape == (4, 64, 3) and float(draw.abs().max()) <= 0.05


def test_shuffle_points_apply_matches_jax():
    """One permutation for the whole batch, exactly JAX's."""
    b = _batch(15, C=6)
    key = jax.random.PRNGKey(16)
    perm = np.array(jax.random.permutation(key, 64))
    want = np.asarray(jaug.shuffle_points(key, jnp.asarray(b)))
    got = aug.shuffle_points(torch.from_numpy(b), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), want)
    draw = aug.draw_shuffle(torch.Generator().manual_seed(0),
                            torch.from_numpy(b))
    assert torch.equal(draw.sort().values, torch.arange(64))


@pytest.mark.parametrize("C", [3, 6])
def test_pc_normalize_matches_jax(C):
    b = _batch(17, C=C) * 3.0 + 1.5
    want = np.asarray(jaug.pc_normalize(jnp.asarray(b)))
    got = aug.pc_normalize(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.allclose(np.linalg.norm(got[..., :3], axis=-1).max(1), 1.0)
    # by name, as the other ops: it has no draw
    named = aug.augment_batch(None, torch.from_numpy(b), ("pc_normalize",))
    np.testing.assert_array_equal(named.numpy(), got)


def test_registry_holds_every_jax_op():
    """Every name of the JAX registry is ported, and a pipeline of all of
    them draws from the generator alone."""
    assert set(jaug._REGISTRY) <= set(aug._REGISTRY)
    assert set(jaug._CALIB_REGISTRY) == set(aug._CALIB_REGISTRY)
    b = torch.from_numpy(_batch(18, C=6))
    names = sorted(jaug._REGISTRY)
    x = aug.augment_batch(torch.Generator().manual_seed(4), b, names)
    y = aug.augment_batch(torch.Generator().manual_seed(4), b, names)
    assert torch.equal(x, y) and x.shape == b.shape


HOST_CASES = {"pc_normalize": {}, "rotate_point_cloud": {"rng": True},
              "jitter_point_cloud": {"rng": True},
              "shift_point_cloud": {"rng": True},
              "random_scale_point_cloud": {"rng": True},
              "random_point_dropout": {"rng": True}}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_np_matches_jax(name):
    """``host_np`` is JAX's numpy twin bit for bit under the same
    ``np.random.RandomState``."""
    assert sorted(n for n in vars(aug.host_np) if not n.startswith("_")) \
        == sorted(n for n in vars(jaug.host_np) if not n.startswith("_")) \
        == sorted(HOST_CASES)
    b = _batch(19, C=6) * 2.0

    def run(cls):
        kw = ({"rng": np.random.RandomState(20)} if HOST_CASES[name]
              else {})
        return getattr(cls, name)(b.copy(), **kw)

    want, got = run(jaug.host_np), run(aug.host_np)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_rotate_point_cloud_z_with_calib_matches_jax():
    """For the JAX op's own angles: the rotated points and the rewritten R
    equal the JAX op's (the products round alike; 1e-6 for the last-bit
    rounding of sin/cos and of XLA's three-term dot), the TASK_PIPELINES
    entry is the JAX one, and the projected pixels do not move."""
    from mm3d_tpu.data import synthetic as jsyn_
    from mm3d_tpu_torch.ops import projection
    assert (aug.TASK_PIPELINES["fusion_semseg"]
            == jaug.TASK_PIPELINES["fusion_semseg"])
    r = np.random.RandomState(8)
    b = (r.randn(3, 50, 9) * 1.5).astype(np.float32)
    Rt = [jsyn_.random_viewpoint_extrinsics(r) for _ in range(3)]
    R = np.stack([x for x, _ in Rt])
    t = np.stack([y for _, y in Rt])
    K = np.stack([jsyn_.default_intrinsics((32, 32))] * 3)
    key = jax.random.PRNGKey(9)
    angle = np.array(jax.random.uniform(key, (3,)) * 2.0 * jnp.pi)
    want, want_R = jaug.rotate_point_cloud_z_with_calib(key, jnp.asarray(b),
                                                        jnp.asarray(R))
    got, got_R = aug.rotate_point_cloud_z_with_calib(
        torch.from_numpy(b), torch.from_numpy(R), torch.from_numpy(angle))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[..., 2:], b[..., 2:])
    uv0, z0 = projection.project_points(torch.from_numpy(b[..., :3]),
                                        *map(torch.from_numpy, (K, R, t)))
    uv1, z1 = projection.project_points(got[..., :3], torch.from_numpy(K),
                                        got_R, torch.from_numpy(t))
    # the points the camera sees keep their pixel (to f32 rounding; points
    # near the camera plane, far outside the frame, magnify it by 1/z)
    seen = (z0 > 0) & (uv0 >= 0).all(-1) & (uv0 <= 31).all(-1)
    assert 0 < float(seen.float().mean()) < 1
    assert float((uv1 - uv0).abs()[seen].max()) < 1e-4
    assert float((z1 - z0).abs().max()) < 1e-5


# ------------------------------------------------------------ synthetic


@pytest.mark.parametrize("split,normals", [("train", False), ("test", True)])
def test_synthetic_multimodal_matches_jax(split, normals):
    kw = dict(num_classes=10, npoints=256, normals=normals, size=12, seed=3,
              split=split)
    want = jsyn.SyntheticMultimodal(base=jsyn.SyntheticModelNet(**kw),
                                    hw=(32, 32), seed=3)
    got = syn.SyntheticMultimodal(base=syn.SyntheticModelNet(**kw),
                                  hw=(32, 32), seed=3)
    assert len(got) == len(want) == 12
    for i in (0, 5, 11):
        w, g = want[i], got[i]
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("split,seed", [("train", 0), ("test", 4)])
def test_synthetic_indoor_scene_matches_jax(split, seed):
    kw = dict(npoints=512, size=8, seed=seed, split=split)
    want, got = jsyn.SyntheticIndoorScene(**kw), syn.SyntheticIndoorScene(**kw)
    assert len(got) == len(want) == 8
    for i in (0, 7):
        (wf, ws), (gf, gs) = want[i], got[i]
        assert gf.shape == (512, 9) and gf.dtype == wf.dtype == np.float32
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gs, ws)
        assert gs.dtype == ws.dtype


def test_synthetic_multimodal_indoor_matches_jax():
    """The semseg pairing: 9-dim block, rendered view, camera, seg labels."""
    kw = dict(npoints=256, size=4, seed=1, split="test")
    want = jsyn.SyntheticMultimodal(base=jsyn.SyntheticIndoorScene(**kw),
                                    hw=(32, 32), seed=1)
    got = syn.SyntheticMultimodal(base=syn.SyntheticIndoorScene(**kw),
                                  hw=(32, 32), seed=1)
    for i in (0, 3):
        w, g = want[i], got[i]
        assert sorted(w) == sorted(g) and "seg" in g
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


# ------------------------------------------------------------- pipeline


class _Count:
    """A map-style dataset of dict samples: index -> (points, label)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"points": np.full((4, 3), i, np.float32),
                "label": np.int32(i)}


def test_pipeline_pads_the_last_batch_with_a_valid_mask():
    pipe = DataPipeline(_Count(10), 4, shuffle=False, pad_remainder=True,
                        to_device="cpu")
    assert pipe.steps_per_epoch() == 3
    batches = list(pipe.epoch(0))
    assert len(batches) == 3
    labels = torch.cat([b["label"] for b, _ in batches]).tolist()
    valid = torch.cat([v for _, v in batches]).tolist()
    assert labels == list(range(10)) + [0, 1]
    assert valid == [True] * 10 + [False] * 2
    assert batches[0][0]["points"].shape == (4, 4, 3)


def test_pipeline_shuffles_per_epoch_and_drops_the_tail():
    pipe = DataPipeline(_Count(10), 4, shuffle=True, seed=3)
    e0 = [b["label"].tolist() for b in pipe.epoch(0)]
    e0b = [b["label"].tolist() for b in pipe.epoch(0)]
    e1 = [b["label"].tolist() for b in pipe.epoch(1)]
    assert len(e0) == 2 and e0 == e0b and e0 != e1
    assert len(set(sum(e0, []))) == 8


def test_pipeline_max_steps_and_abandoned_consumer():
    pipe = DataPipeline(_Count(40), 2, shuffle=False, prefetch=1)
    assert len(list(pipe.epoch(0, max_steps=3))) == 3
    it = pipe.epoch(0)
    next(it)
    it.close()  # the worker must not stay blocked on the full queue


def test_pipeline_surfaces_worker_errors():
    class Broken(_Count):
        def __getitem__(self, i):
            raise ValueError("bad sample")

    with pytest.raises(ValueError, match="bad sample"):
        list(DataPipeline(Broken(4), 2).epoch(0))
