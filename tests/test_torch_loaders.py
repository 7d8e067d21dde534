"""The port's real-dataset loaders, native parser and renderer against the
JAX package's, on the CPU.

Each loader reads the same generated tree (the fixture writers of
``tests/test_loaders_native.py`` and ``tests/test_real_dataset_cli.py``)
on both sides and must give the same samples bit for bit, at epochs 0 and 1
through ``set_epoch`` and through each side's ``DataPipeline``. The JAX
package's native parser and renderer are pointed at the libraries the port
built from the same ``native/*.cpp`` with the same flags
(``jax_native``), so no test here runs ``make`` in ``native/`` while another
test worker may be running it too.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_loaders_native import _write_modelnet
from tests.test_real_dataset_cli import _write_s3dis
from mm3d_tpu.data import loaders as jloaders
from mm3d_tpu.data import native_io as jnative_io
from mm3d_tpu.data.pipeline import DataPipeline as JaxPipeline
from mm3d_tpu.utils import visualizer as jvisualizer
from mm3d_tpu_torch.data import loaders, native_io
from mm3d_tpu_torch.data.pipeline import DataPipeline
from mm3d_tpu_torch.ops import _build
from mm3d_tpu_torch.utils import visualizer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (several
    test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's ctypes bindings, loading the port's builds of the
    same sources instead of running ``make`` in ``native/``."""
    assert native_io.available(), native_io.load_error()
    assert visualizer.available(), visualizer.load_error()
    for mod, name, src in ((jnative_io, "mm3d_io", "pointcloud_io.cpp"),
                           (jvisualizer, "mm3d_render", "render_balls.cpp")):
        monkeypatch.setattr(mod, "_LIB_PATH",
                            _build.native_lib_path(name, src))
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_build_failed", False)
    assert jnative_io.available() and jvisualizer._load() is not None


def _write_shapenetpart(root, n=2, rows=50):
    rng = np.random.RandomState(1)
    cats = [("Airplane", "02691156"), ("Chair", "03001627")]
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for name, syn in cats:
            f.write(f"{name}\t{syn}\n")
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    files = []
    for _, syn in cats:
        os.makedirs(os.path.join(root, syn), exist_ok=True)
        for i in range(n):
            files.append(f"shape_data/{syn}/shape{i}")
            data = np.concatenate(
                [rng.randn(rows, 6), rng.randint(0, 4, (rows, 1))], -1)
            np.savetxt(os.path.join(root, syn, f"shape{i}.txt"), data,
                       fmt="%.6f")
    for split in ("train", "test"):
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(files, f)


def _write_views(root, split, n, hw=16):
    d = os.path.join(root, f"views_{split}")
    os.makedirs(d)
    rng = np.random.RandomState(5)
    for i in range(n):
        np.savez(os.path.join(d, f"{i}.npz"),
                 image=rng.rand(hw, hw, 3).astype(np.float32),
                 K=np.eye(3, dtype=np.float32),
                 R=np.eye(3, dtype=np.float32),
                 t=rng.randn(3).astype(np.float32))


def _assert_samples_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_samples_equal(a[k], b[k])
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_samples_equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _assert_datasets_equal(port, jax_ds, epochs=(0, 1)):
    assert len(port) == len(jax_ds)
    for epoch in epochs:
        for ds in (port, jax_ds):
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)
        for i in range(len(port)):
            _assert_samples_equal(port[i], jax_ds[i])


@pytest.mark.parametrize("normals,uniform", [(False, False), (True, False),
                                             (False, True)])
def test_modelnet_matches_jax(tmp_path, jax_native, normals, uniform):
    _write_modelnet(str(tmp_path), classes=("flower_pot", "chair", "b"),
                    rows=48)
    for split in ("train", "test"):
        port = loaders.ModelNetDataset(str(tmp_path), split, npoints=32,
                                       normals=normals,
                                       uniform_sample=uniform)
        jax_ds = jloaders.ModelNetDataset(str(tmp_path), split, npoints=32,
                                          normals=normals,
                                          uniform_sample=uniform)
        assert port.classes == jax_ds.classes == ["flower_pot", "chair", "b"]
        assert port.paths == jax_ds.paths
        _assert_datasets_equal(port, jax_ds)
    # a short file wrap-pads, as JAX's does
    short = loaders.ModelNetDataset(str(tmp_path), "train", npoints=64)
    _assert_samples_equal(short[1], jloaders.ModelNetDataset(
        str(tmp_path), "train", npoints=64)[1])


def test_shapenetpart_matches_jax_per_epoch(tmp_path, jax_native):
    _write_shapenetpart(str(tmp_path))
    for normals in (False, True):
        port = loaders.ShapeNetPartDataset(str(tmp_path), "train",
                                           npoints=64, normals=normals)
        jax_ds = jloaders.ShapeNetPartDataset(str(tmp_path), "train",
                                              npoints=64, normals=normals)
        _assert_datasets_equal(port, jax_ds)
    # the draws change with the epoch
    port.set_epoch(0)
    a = port[0][0]
    port.set_epoch(1)
    assert not np.array_equal(a, port[0][0])


def test_s3dis_matches_jax_per_epoch(tmp_path):
    _write_s3dis(str(tmp_path), rooms=("Area_1_office_1.npy",
                                       "Area_5_office_1.npy",
                                       "Area_10_lobby_1.npy"))
    for split in ("train", "test"):
        for area in (1, 5):
            port = loaders.S3DISDataset(str(tmp_path), split, npoints=96,
                                        test_area=area, samples_per_room=3)
            jax_ds = jloaders.S3DISDataset(str(tmp_path), split, npoints=96,
                                           test_area=area,
                                           samples_per_room=3)
            assert port.rooms == jax_ds.rooms
            _assert_datasets_equal(port, jax_ds)
    assert not loaders.s3dis_room_in_area("Area_10_lobby_1.npy", 1)
    assert loaders.s3dis_room_in_area("Area_1_office_1.npy", 1)


def test_multimodal_matches_jax_and_forwards_set_epoch(tmp_path, jax_native):
    _write_modelnet(str(tmp_path))
    _write_s3dis(str(tmp_path))
    _write_views(str(tmp_path), "train", 32)
    _write_views(str(tmp_path), "test", 16)
    for task in ("fusion_cls", "fusion_semseg"):
        port = loaders.build_real_datasets("multimodal", str(tmp_path), task,
                                           npoints=32)
        jax_ds = jloaders.build_real_datasets("multimodal", str(tmp_path),
                                              task, npoints=32)
        for p, j in zip(port, jax_ds):
            _assert_datasets_equal(p, j)
    # set_epoch reaches the point dataset
    port[0].set_epoch(3)
    assert port[0].base._epoch == 3


def test_s3dis_pipeline_resamples_per_epoch_as_jax(tmp_path):
    """The port's DataPipeline gives JAX's DataPipeline's batches over two
    epochs of an epoch-seeded loader: the same shuffles and the same
    per-epoch crops."""
    _write_s3dis(str(tmp_path))
    port = DataPipeline(loaders.S3DISDataset(str(tmp_path), "train",
                                             npoints=64, samples_per_room=4),
                        batch_size=2, seed=3)
    jax_p = JaxPipeline(jloaders.S3DISDataset(str(tmp_path), "train",
                                              npoints=64, samples_per_room=4),
                        batch_size=2, seed=3, to_device=False)
    seen = []
    for epoch in (0, 1):
        got = list(port.epoch(epoch))
        want = list(jax_p.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, (pts, seg) in zip(got, want):
            np.testing.assert_array_equal(g["points"].numpy(), pts)
            np.testing.assert_array_equal(g["seg"].numpy(), seg)
        seen.append(got[0]["points"].numpy())
    assert not np.array_equal(seen[0], seen[1])


class _EpochRecorder:
    def __init__(self):
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.zeros((8, 3), np.float32), np.int32(i)


def test_pipeline_calls_set_epoch_before_each_epoch():
    ds = _EpochRecorder()
    pipe = DataPipeline(ds, batch_size=2, shuffle=True, seed=0)
    for epoch in (0, 3):
        assert len(list(pipe.epoch(epoch))) == 2
    assert ds.epochs == [0, 3]


def test_native_parse_equals_numpy_parse(tmp_path, jax_native):
    rng = np.random.RandomState(3)
    data = (rng.randn(300, 6) * rng.choice([0.01, 1.0, 100.0], 6)).astype(
        np.float32)
    comma = str(tmp_path / "c.txt")
    np.savetxt(comma, data, fmt="%.6f", delimiter=",")
    space = str(tmp_path / "s.txt")
    np.savetxt(space, data, fmt="%.6f")
    want = np.loadtxt(comma, delimiter=",", dtype=np.float32)
    got = native_io.parse_table(comma, 6)
    np.testing.assert_array_equal(got, want)
    many = native_io.parse_many([comma, space], 6)
    for g in many:
        np.testing.assert_array_equal(g, want)
    # a buffer that fills up parses again with a larger one
    np.testing.assert_array_equal(native_io.parse_table(comma, 6,
                                                        max_rows=300), want)
    np.testing.assert_array_equal(native_io.parse_many([comma], 6,
                                                       max_rows=100)[0], want)
    # the JAX package's binding of the same library parses the same
    np.testing.assert_array_equal(jnative_io.parse_table(comma, 6), got)
    with pytest.raises(FileNotFoundError):
        native_io.parse_table(str(tmp_path / "missing.txt"), 6)
    # the loaders parse natively, and as numpy would
    np.testing.assert_array_equal(loaders._parse_float_table(space, 6), want)


def test_native_build_is_keyed_by_source_and_flags():
    path = _build.native_lib_path("mm3d_io", "pointcloud_io.cpp")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libmm3d_io-")
    assert os.path.exists(path)
    assert path != _build.native_lib_path("mm3d_render", "render_balls.cpp")


def test_build_real_datasets_refusals_match_jax(tmp_path):
    def error(fn, *a, **kw):
        with pytest.raises(Exception) as e:
            fn(*a, **kw)
        return type(e.value), str(e.value)

    _write_modelnet(str(tmp_path))
    os.makedirs(tmp_path / "views")
    cases = [
        # a task the format does not serve
        (("modelnet40", str(tmp_path), "semseg"), ValueError),
        # no such root
        (("modelnet40", str(tmp_path / "nope"), "classification"),
         FileNotFoundError),
        # one views/ for both splits
        (("multimodal", str(tmp_path), "fusion_cls"), FileNotFoundError),
    ]
    for args, exc in cases:
        got = error(loaders.build_real_datasets, *args, npoints=32)
        assert got == error(jloaders.build_real_datasets, *args, npoints=32)
        assert got[0] is exc
    # views/ serves one split
    _, te = loaders.build_real_datasets("multimodal", str(tmp_path),
                                        "fusion_cls", npoints=32,
                                        splits=("test",))
    assert te.views_dir.endswith("views")
    assert loaders.DATASET_TASKS == jloaders.DATASET_TASKS
    assert loaders.REAL_DATASETS == jloaders.REAL_DATASETS


def test_host_helpers_match_jax():
    rng = np.random.RandomState(9)
    xyz = rng.randn(500, 3).astype(np.float32)
    np.testing.assert_array_equal(loaders.farthest_point_sample_np(xyz, 64),
                                  jloaders.farthest_point_sample_np(xyz, 64))
    np.testing.assert_array_equal(loaders.pc_normalize(xyz),
                                  jloaders.pc_normalize(xyz))
    rgb = rng.rand(500, 3).astype(np.float32)
    lo, ext = xyz.min(0), xyz.max(0) - xyz.min(0)
    np.testing.assert_array_equal(
        loaders.semseg_block_features(xyz[:64], rgb[:64], lo, ext),
        jloaders.semseg_block_features(xyz[:64], rgb[:64], lo, ext))


def test_render_points_matches_jax(tmp_path, jax_native):
    rng = np.random.RandomState(4)
    pts = rng.randn(500, 3).astype(np.float32)
    labels = rng.randint(0, 13, 500)
    for kw in ({"labels": labels, "hw": (64, 48)}, {"hw": (40, 40)},
               {"colors": rng.rand(500, 3), "hw": (32, 32),
                "ball_radius": 0.05}):
        got = visualizer.render_points(pts, **kw)
        np.testing.assert_array_equal(got, jvisualizer.render_points(pts,
                                                                     **kw))
        assert (got != 1.0).any()
    np.testing.assert_array_equal(visualizer.PALETTE, jvisualizer.PALETTE)
    # the numpy splat, with the native renderer's contract
    np.testing.assert_array_equal(
        visualizer._render_numpy(pts + [0, 0, 3], labels[:, None]
                                 * np.ones(3) / 13.0, 32, 32, 28.8, 0.02,
                                 1.0),
        jvisualizer._render_numpy(pts + [0, 0, 3], labels[:, None]
                                  * np.ones(3) / 13.0, 32, 32, 28.8, 0.02,
                                  1.0))
    out = visualizer.show_points(pts, labels=labels, hw=(32, 32),
                                 out_path=str(tmp_path / "cloud.png"))
    assert os.path.getsize(out) > 100
