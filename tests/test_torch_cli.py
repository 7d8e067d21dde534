"""The port's train and test command lines (``python -m
mm3d_tpu_torch.train`` / ``.test``) on the CPU, with ``--device cpu``.

The ModelNet40 and S3DIS round trips of ``tests/test_real_dataset_cli.py``
through the port's CLIs (the same fixture trees and the smallest models),
``--scene`` on a room file, a directory and ``area``, one lineage ``.pth``
evaluated by the JAX package's ``test.main`` and by the port's on the same
tree (fp32: equal instance accuracy; rooms: equal coverage, metrics within
1e-6), ``--export`` served by ``load_serving``, the refusals, the exit
without CUDA and the TF32 flags. Every run writes under ``tmp_path``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_loaders import jax_native  # noqa: F401  (a fixture)
from tests.test_loaders_native import _write_modelnet
from tests.test_real_dataset_cli import _write_s3dis
from mm3d_tpu_torch import test as test_cli
from mm3d_tpu_torch import train as train_cli
from mm3d_tpu_torch.models import get_model, init_params
from mm3d_tpu_torch.serving import load_serving
from mm3d_tpu_torch.training import make_predictor
from mm3d_tpu_torch.utils.torch_import import export_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS = ["--model", "pointnet_cls", "--npoint", "64", "--num_class", "4",
       "--batch_size", "8", "--device", "cpu"]
SEG = ["--model", "pointnet_sem_seg", "--npoint", "128", "--batch_size", "4",
       "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's tests, restored after (several
    test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def modelnet(tmp_path):
    data = tmp_path / "modelnet"
    os.makedirs(data)
    _write_modelnet(str(data), classes=("a", "b", "c", "d"))  # 8 tr / 4 te
    return str(data)


@pytest.fixture
def s3dis(tmp_path):
    data = tmp_path / "s3dis"
    os.makedirs(data)
    _write_s3dis(str(data))
    return str(data)


def _lineage_pth(path, name, **kw):
    """A lineage .pth of a seeded init of the port's model, in the train
    scripts' wrapper with DataParallel's prefix."""
    model = init_params(get_model(name).builder(**kw), 3)
    sd = export_state_dict(name, model)
    torch.save({"model_state_dict": {f"module.{k}": torch.from_numpy(v)
                                     for k, v in sd.items()}}, path)
    return path


def test_modelnet40_cli_roundtrip(tmp_path, modelnet):
    log = str(tmp_path / "log")
    res = train_cli.main(CLS + [
        "--epoch", "1", "--dataset", "modelnet40", "--data_root", modelnet,
        "--log_dir", log, "--run_name", "mn"])
    assert "instance_acc" in res
    run_dir = os.path.join(log, "classification", "mn")
    ev = test_cli.main(CLS + [
        "--log_dir", run_dir, "--dataset", "modelnet40", "--data_root",
        modelnet, "--num_votes", "3"])
    # the test split has 4 shapes: accuracy over those
    assert ev["instance_acc"] in (0.0, 0.25, 0.5, 0.75, 1.0)
    assert ev["vote_instance_acc"] in (0.0, 0.25, 0.5, 0.75, 1.0)
    # one draw a batch from --seed: the votes repeat
    ev2 = test_cli.main(CLS + [
        "--log_dir", run_dir, "--dataset", "modelnet40", "--data_root",
        modelnet, "--num_votes", "3"])
    assert ev2 == ev
    # the module entry point, in a new process
    out = subprocess.run(
        [sys.executable, "-m", "mm3d_tpu_torch.test", *CLS, "--log_dir",
         run_dir, "--dataset", "modelnet40", "--data_root", modelnet],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "instance_acc" in out.stdout


def test_s3dis_cli_roundtrip_and_scenes(tmp_path, s3dis):
    log = str(tmp_path / "log")
    res = train_cli.main(SEG + [
        "--epoch", "1", "--dataset", "s3dis", "--data_root", s3dis,
        "--test_area", "5", "--log_dir", log, "--run_name", "s3"])
    assert "miou" in res
    run_dir = os.path.join(log, "semseg", "s3")
    ev = test_cli.main(SEG + [
        "--log_dir", run_dir, "--dataset", "s3dis", "--data_root", s3dis,
        "--test_area", "5"])
    assert 0.0 <= ev["miou"] <= 1.0
    scene = SEG + ["--log_dir", run_dir, "--block_size", "4.0", "--stride",
                   "4.0"]
    # the held-out area: the Area_5 room only
    area = test_cli.main(scene + ["--scene", "area", "--dataset", "s3dis",
                                  "--data_root", s3dis, "--test_area", "5"])
    assert area["rooms"] == 1
    assert {"coverage", "point_acc", "miou"} <= set(area)
    # one room file: the same room, the same numbers
    room = os.path.join(s3dis, "Area_5_office.npy")
    one = test_cli.main(scene + ["--scene", room])
    assert one == pytest.approx({k: area[k] for k in one}, abs=1e-12)
    # a directory: both rooms, over the summed confusion matrix
    both = test_cli.main(scene + ["--scene", s3dis])
    assert both["rooms"] == 2 and 0.0 <= both["miou"] <= 1.0
    # an .npz room, and an 8-column room whose label is column 6
    d = np.load(room)
    npz = str(tmp_path / "room.npz")
    np.savez(npz, xyz=d[:, :3], rgb=d[:, 3:6], labels=d[:, 6])
    assert test_cli.main(scene + ["--scene", npz]) == pytest.approx(
        one, abs=1e-12)
    wide = str(tmp_path / "room8.npy")
    np.save(wide, np.concatenate([d, np.full((len(d), 1), 99.0)], 1))
    assert test_cli.main(scene + ["--scene", wide]) == pytest.approx(
        one, abs=1e-12)
    # a synthetic room
    syn = test_cli.main(scene + ["--scene", "synthetic", "--scene_points",
                                 "3000"])
    assert syn["coverage"] > 0.9


def test_jax_and_port_test_cli_agree_on_one_lineage_pth(tmp_path, modelnet,
                                                       s3dis, jax_native):
    import test as jax_test_cli
    pth = _lineage_pth(str(tmp_path / "cls.pth"), "pointnet_cls",
                       num_class=4)
    argv = CLS[:-2] + ["--torch_ckpt", pth, "--dataset", "modelnet40",
                       "--data_root", modelnet]
    want = jax_test_cli.main(argv + ["--log_dir", str(tmp_path / "j")])
    got = test_cli.main(argv + ["--log_dir", str(tmp_path / "p"),
                                "--device", "cpu"])
    assert got["instance_acc"] == want["instance_acc"]
    assert got["class_acc"] == pytest.approx(want["class_acc"], abs=1e-6)
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-4)
    # a whole room of the held-out area
    pth = _lineage_pth(str(tmp_path / "seg.pth"), "pointnet_sem_seg",
                       num_class=13)
    argv = SEG[:-2] + ["--torch_ckpt", pth, "--scene", "area", "--data_root",
                       s3dis, "--test_area", "5", "--block_size", "2.0",
                       "--stride", "1.0"]
    want = jax_test_cli.main(argv + ["--log_dir", str(tmp_path / "j")])
    got = test_cli.main(argv + ["--log_dir", str(tmp_path / "p"),
                                "--device", "cpu"])
    assert got.keys() == want.keys()
    assert got["rooms"] == want["rooms"] == 1
    assert got["coverage"] == want["coverage"]
    for k in ("point_acc", "miou"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)


def test_export_is_served_like_make_predictor(tmp_path, modelnet):
    pth = _lineage_pth(str(tmp_path / "cls.pth"), "pointnet_cls",
                       num_class=4)
    art = str(tmp_path / "cls.pt2")
    argv = CLS + ["--torch_ckpt", pth, "--log_dir", str(tmp_path / "p"),
                  "--dataset", "modelnet40", "--data_root", modelnet]
    res = test_cli.main(argv + ["--export", art])
    assert res["in_shapes"] == [[8, 64, 3]] and res["device"] == "cpu"
    served = load_serving(art, device="cpu")
    model = get_model("pointnet_cls").builder(num_class=4)
    from mm3d_tpu_torch.utils.torch_import import load_torch_into_model
    load_torch_into_model("pointnet_cls", model, pth)
    pred = make_predictor("pointnet_cls", model.state_dict(), device="cpu",
                          num_class=4)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 64, 3).astype(
        np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(served(x).numpy(), pred(x).numpy())
    # one symbolic batch
    poly = str(tmp_path / "poly.pt2")
    test_cli.main(argv + ["--export", poly, "--export_batch", "poly"])
    with torch.no_grad():
        np.testing.assert_array_equal(load_serving(poly, "cpu")(x[:3]).numpy(),
                                      pred(x[:3]).numpy())


def test_cli_refusals(tmp_path, modelnet):
    log = ["--log_dir", str(tmp_path / "log")]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_cli.main(CLS + log + ["--torch_ckpt", "x.pth", "--resume"])
    with pytest.raises(SystemExit, match="requires --data_root"):
        train_cli.main(CLS + log + ["--dataset", "modelnet40", "--epoch",
                                    "1", "--no_checkpoint"])
    with pytest.raises(SystemExit, match="pass --num_class 4"):
        train_cli.main(["--model", "pointnet_cls", "--num_class", "3",
                        "--npoint", "64", "--device", "cpu", "--dataset",
                        "modelnet40", "--data_root", modelnet] + log)
    pth = _lineage_pth(str(tmp_path / "cls.pth"), "pointnet_cls",
                       num_class=4)
    with pytest.raises(SystemExit, match="--scene requires a semseg"):
        test_cli.main(CLS + log + ["--torch_ckpt", pth, "--scene",
                                   "synthetic"])
    with pytest.raises(SystemExit, match="--scene area requires"):
        test_cli.main(SEG + log + ["--scene", "area", "--torch_ckpt",
                                   _lineage_pth(str(tmp_path / "s.pth"),
                                                "pointnet_sem_seg",
                                                num_class=13)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there")
def test_no_cuda_without_device_cpu_exits_nonzero():
    argv = ["--model", "pointnet_cls", "--epoch", "1", "--no_checkpoint"]
    for main, args in ((train_cli.main, argv),
                       (test_cli.main, ["--model", "pointnet_cls",
                                        "--log_dir", "nowhere"])):
        with pytest.raises(SystemExit, match="--device cpu") as e:
            main(args)
        assert e.value.code not in (0, None)
    out = subprocess.run([sys.executable, "-m", "mm3d_tpu_torch.train",
                          *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "--device cpu" in out.stderr


def test_main_turns_tf32_off(tmp_path, modelnet):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for main, argv in ((train_cli.main, CLS + [
                "--epoch", "1", "--train_size", "8", "--test_size", "8",
                "--no_checkpoint", "--log_dir", str(tmp_path / "log")]),
                (test_cli.main, CLS + [
                    "--log_dir", str(tmp_path / "log"), "--torch_ckpt",
                    _lineage_pth(str(tmp_path / "c.pth"), "pointnet_cls",
                                 num_class=4), "--test_size", "8"])):
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            main(argv)
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
