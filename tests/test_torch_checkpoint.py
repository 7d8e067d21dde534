"""Checkpoints, resume and the run directory of the port against the JAX
package, on the CPU.

Retention: the same saves go through the JAX package's ``CheckpointManager``
(Orbax) and the port's, which must keep the same steps and name the same
latest and best ones. Resume: a run of two epochs straight and a run of one
epoch, then a new ``Trainer(resume=True)`` for the second, end bit for bit
alike (parameters, BN buffers, Adam state, step, generators and the logged
metrics but their times), as ``tests/test_training.py`` holds the JAX
``Trainer``'s resume. The run directory: unique time-stamped directories
and JAX's ``metrics.jsonl`` keys for the same ``fit``. Every run writes
under the test's ``tmp_path``.
"""

import datetime
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from mm3d_tpu.training.loop import TrainConfig as JaxConfig
from mm3d_tpu.training.loop import Trainer as JaxTrainer
from mm3d_tpu.utils import logging_utils as jlog
from mm3d_tpu.utils.checkpoint import CheckpointManager as JaxManager
from mm3d_tpu_torch.training import TrainConfig, Trainer
from mm3d_tpu_torch.training.state import (generator_state,
                                           set_generator_state)
from mm3d_tpu_torch.utils import logging_utils
from mm3d_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads, restored after (see test_torch_partseg.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ retention

# (step, metric or None); a repeated value (0.9), a save without metrics
# and two stale steps (at or below the newest kept one), which neither
# manager writes
SAVES = [(1, 0.5), (2, 0.9), (3, None), (4, 0.1), (5, 0.9), (4, 0.95),
         (6, 0.7), (7, 0.3), (7, 0.99), (8, 0.2)]


def _kept(m):
    return (sorted(m.all_steps()), m.latest_step(), m.best_step())


@pytest.mark.parametrize("best_metric,best_mode,max_to_keep", [
    (None, "max", 3), (None, "max", 1), ("acc", "max", 3), ("acc", "max", 1),
    ("acc", "min", 2)])
def test_retention_matches_orbax(tmp_path, best_metric, best_mode,
                                 max_to_keep):
    """After every save, and in managers opened again on the directories,
    the kept steps, the latest and the best step are Orbax's."""
    kw = dict(max_to_keep=max_to_keep, best_metric=best_metric,
              best_mode=best_mode)
    jm = JaxManager(str(tmp_path / "jax"), **kw)
    pm = CheckpointManager(str(tmp_path / "port"), **kw)
    for step, metric in SAVES:
        metrics = None if metric is None else {"acc": metric}
        jm.save(step, {"x": np.full(2, step, np.float32)}, metrics)
        jm.wait()
        pm.save(step, {"x": torch.full((2,), float(step))}, metrics)
        assert _kept(pm) == _kept(jm._mngr), (step, metric)
    assert len(os.listdir(tmp_path / "port")) == 2 * len(pm.all_steps())
    jm.close()
    assert _kept(CheckpointManager(str(tmp_path / "port"), **kw)) == \
        _kept(JaxManager(str(tmp_path / "jax"), **kw)._mngr)


def test_latest_manager_pins_newest_for_resume(tmp_path):
    """The JAX test of the same name on the port's managers: with the best
    epoch early, best retention drops the newest save, and the size-1
    latest manager keeps it for resume."""
    best = CheckpointManager(str(tmp_path / "checkpoints"), max_to_keep=1,
                             best_metric="acc")
    latest = CheckpointManager(str(tmp_path / "checkpoints_latest"),
                               max_to_keep=1)
    s1, s2 = {"x": torch.full((4,), 1.0)}, {"x": torch.full((4,), 2.0)}
    best.save(1, s1, {"acc": 0.9})
    latest.save(1, s1)
    best.save(2, s2, {"acc": 0.1})
    latest.save(2, s2)
    best.wait()
    latest.wait()
    assert best.best_step() == 1 and best.all_steps() == [1]
    assert latest.latest_step() == 2
    assert torch.equal(latest.restore()["x"], s2["x"])


def test_restore_roundtrip_and_missing(tmp_path):
    """Tensors, numbers, strings and a generator's state come back as they
    were saved; no checkpoint raises as JAX's manager does."""
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        JaxManager(str(tmp_path / "jax")).restore({"x": np.zeros(1)})
    m = CheckpointManager(str(tmp_path / "port"))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        m.restore()
    g = torch.Generator().manual_seed(5)
    torch.rand(3, generator=g)
    state = {"w": torch.randn(3, 4), "b": torch.arange(5, dtype=torch.int32),
             "h": torch.randn(2).to(torch.bfloat16), "step": 7, "lr": 1e-3,
             "gen": generator_state(g), "nested": {"l": [1, 2.5, "s"]}}
    assert m.save(7, state)
    assert not m.save(7, state) and not m.save(3, state)
    got = m.restore(map_location="cpu")
    for k in ("w", "b", "h"):
        assert got[k].dtype == state[k].dtype and torch.equal(got[k], state[k])
    assert (got["step"], got["lr"], got["nested"]) == (7, 1e-3,
                                                      {"l": [1, 2.5, "s"]})
    h = torch.Generator()
    set_generator_state(h, got["gen"])
    assert torch.equal(torch.rand(3, generator=h), torch.rand(3, generator=g))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        m.restore(step=3)


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies while writing leaves the earlier checkpoints, no
    part of the new one and no temporary file."""
    m = CheckpointManager(str(tmp_path), max_to_keep=1)
    m.save(1, {"x": torch.ones(3)})
    real_save = torch.save

    def dying(obj, f, *a, **kw):
        f.write(b"half a checkpoint")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dying)
    with pytest.raises(KeyboardInterrupt):
        m.save(2, {"x": torch.zeros(3)})
    monkeypatch.setattr(torch, "save", real_save)
    assert sorted(os.listdir(tmp_path)) in (["1.json", "1.pt"],
                                            ["1.json", "1.pt", "2.json"])
    again = CheckpointManager(str(tmp_path), max_to_keep=1)
    assert again.all_steps() == [1]
    assert torch.equal(again.restore()["x"], torch.ones(3))


def test_generator_state_needs_the_same_device_type():
    cpu = torch.Generator()
    with pytest.raises(ValueError, match="cuda generator's state .* cpu"):
        set_generator_state(cpu, {"device": "cuda",
                                  "state": torch.zeros(16, dtype=torch.uint8)})


# ---------------------------------------------------------- run directory


def test_create_run_dir_is_unique_in_one_second(tmp_path, monkeypatch):
    """Runs stamped in the same second, in threads at once, each get a
    directory of their own; an explicit name is shared (resume); the layout
    is JAX's."""

    class _Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5)

    monkeypatch.setattr(logging_utils, "datetime",
                        types.SimpleNamespace(datetime=_Frozen))
    dirs = []
    threads = [threading.Thread(target=lambda: dirs.append(
        logging_utils.create_run_dir(str(tmp_path), "classification")))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(dirs)) == 8
    assert {os.path.basename(d) for d in dirs} == (
        {"2026-01-02_03-04-05"}
        | {f"2026-01-02_03-04-05_{i}" for i in range(2, 9)})
    a = logging_utils.create_run_dir(str(tmp_path), "semseg", "run")
    assert logging_utils.create_run_dir(str(tmp_path), "semseg", "run") == a
    j = jlog.create_run_dir(str(tmp_path / "jax"), "semseg", "run")
    assert sorted(os.listdir(a)) == sorted(os.listdir(j)) == ["checkpoints",
                                                              "logs"]


def test_metrics_logger_matches_jax(tmp_path):
    """The same records give the same jsonl lines as JAX's logger (a 0-d
    torch tensor too), and close() releases the handlers."""
    recs = {"i": 3, "b": True, "f": 0.25, "n": np.float32(1.5),
            "a": np.arange(3), "one": np.ones((1,))}
    logs = []
    for mod, d, extra in ((jlog, tmp_path / "jax", {}),
                          (logging_utils, tmp_path / "port",
                           {"t": torch.tensor(2.5), "v": torch.arange(2)})):
        os.makedirs(d / "logs")
        log = mod.MetricsLogger(str(d))
        log.log_metrics(4, {**recs, **extra}, prefix="eval/")
        log.close()
        assert not log.logger.handlers
        logs.append(json.loads(open(d / "logs" / "metrics.jsonl").read()))
    want, got = logs
    assert got == {**want, "eval/t": 2.5, "eval/v": [0, 1]}


# ---------------------------------------------------------------- resume


def _cfg(tmp_path, model, **kw):
    base = dict(model=model, epochs=2, batch_size=4, npoint=64, num_class=4,
                train_size=8, test_size=4, log_dir=str(tmp_path),
                log_every=1, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def _metrics(tr):
    with open(os.path.join(tr.run_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_same_state(a, b):
    sa, sb = a.train_state(), b.train_state()
    assert sa["step"] == sb["step"]
    for n, x in sa["model"].items():
        assert torch.equal(x, sb["model"][n]), n
    oa, ob = sa["optimizer"], sb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, st in oa["state"].items():
        for k, x in st.items():
            assert torch.equal(x, ob["state"][i][k]), (i, k)
    for g in ("generator", "fps_generator"):
        if sa[g] is None:
            assert sb[g] is None
        else:
            assert torch.equal(sa[g]["state"], sb[g]["state"])


@pytest.mark.parametrize("model,dtype,kw", [
    ("pointnet2_cls_ssg", "float32", {}),
    ("fusion_cls", "bfloat16", {"image_hw": (16, 16), "bn_refresh_steps": 1,
                                "fps_random_start": True})])
def test_resume_is_bit_identical(tmp_path, model, dtype, kw):
    """Two epochs straight against one, then a resumed Trainer for the
    second: parameters, BN buffers, Adam moments, step, generators and the
    logged metrics (but the epoch's time and rate) end alike; the resumed
    Trainer starts from the state saved after epoch 1."""
    a = Trainer(_cfg(tmp_path, model, dtype=dtype, run_name="a", **kw))
    a.fit()
    b1 = Trainer(_cfg(tmp_path, model, dtype=dtype, run_name="b", epochs=1,
                      **kw))
    b1.fit()
    b1.close()
    b = Trainer(_cfg(tmp_path, model, dtype=dtype, run_name="b",
                     resume=True, **kw))
    assert (b.start_epoch, b.step) == (1, 2)
    _assert_same_state(b, b1)
    b.fit()
    assert a.step == b.step == 4
    _assert_same_state(a, b)
    times = ("train/epoch_time_s", "train/clouds_per_s")
    ma, mb = _metrics(a), _metrics(b)
    assert len(ma) == len(mb) == 4
    assert ([{k: v for k, v in r.items() if k not in times} for r in ma]
            == [{k: v for k, v in r.items() if k not in times} for r in mb])
    assert b.ckpt.all_steps() == [2, 4] and b.ckpt_latest.all_steps() == [4]
    a.close()
    b.close()


def test_resume_without_checkpoint_raises(tmp_path):
    """As the JAX Trainer: resume of a run with no checkpoint, or with
    checkpointing off, raises SystemExit instead of training from scratch."""
    with pytest.raises(SystemExit, match="no checkpoint"):
        JaxTrainer(JaxConfig(model="pointnet_cls", npoint=32, batch_size=2,
                             train_size=4, test_size=2, num_class=2,
                             log_dir=str(tmp_path / "jax"), resume=True,
                             run_name="never_ran"))
    for checkpoint in (True, False):
        with pytest.raises(SystemExit, match="no checkpoint"):
            Trainer(_cfg(tmp_path, "pointnet_cls", run_name="never_ran",
                         resume=True, checkpoint=checkpoint))


def test_best_early_run_resumes_from_latest(tmp_path, monkeypatch):
    """Four epochs whose eval gets worse: checkpoints/ keeps the three best
    (epochs 1-3), checkpoints_latest/ the last, from which resume goes on
    (nothing left to train); without checkpoints_latest/ (a run directory
    of an older layout) resume takes the newest of checkpoints/."""
    accs = iter([0.9, 0.8, 0.7, 0.1])
    monkeypatch.setattr(Trainer, "evaluate",
                        lambda self: {"instance_acc": next(accs)})
    cfg = dict(model="pointnet_cls", epochs=4, batch_size=2, train_size=4,
               test_size=2, run_name="run")
    tr = Trainer(_cfg(tmp_path, **cfg))
    assert tr.fit()["best_instance_acc"] == 0.9
    assert tr.ckpt.all_steps() == [2, 4, 6] and tr.ckpt.best_step() == 2
    assert tr.ckpt_latest.all_steps() == [8]
    tr.close()
    again = Trainer(_cfg(tmp_path, resume=True, **cfg))
    assert (again.step, again.start_epoch) == (8, 4)
    _assert_same_state(again, tr)
    again.close()
    for name in os.listdir(again.ckpt_latest.directory):
        os.remove(os.path.join(again.ckpt_latest.directory, name))
    older = Trainer(_cfg(tmp_path, resume=True, **cfg))
    assert (older.step, older.start_epoch) == (6, 3)
    older.close()


def test_metrics_jsonl_keys_match_jax(tmp_path):
    """The same tiny fit writes the same metrics.jsonl keys, record by
    record, in the JAX Trainer and in the port's."""
    cfg = dict(model="pointnet_cls", epochs=2, batch_size=2, npoint=32,
               train_size=4, test_size=2, num_class=2, log_every=1,
               checkpoint=False)
    jt = JaxTrainer(JaxConfig(log_dir=str(tmp_path / "jax"), **cfg))
    jt.fit()
    jt.close()
    pt = Trainer(TrainConfig(log_dir=str(tmp_path / "port"), device="cpu",
                             **cfg))
    pt.fit()
    pt.close()
    assert pt.ckpt is None
    assert sorted(os.listdir(pt.run_dir)) == sorted(os.listdir(jt.run_dir))
    want = [sorted(r) for r in _metrics(jt)]
    assert [sorted(r) for r in _metrics(pt)] == want and len(want) == 4
    assert os.path.dirname(pt.run_dir) == str(tmp_path / "port" /
                                              "classification")


def test_trainer_without_cuda_writes_nothing(tmp_path, monkeypatch):
    """The default device is the card: without one the Trainer raises
    before it makes a run directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(train_size=4, test_size=4))
    assert os.listdir(tmp_path) == []
