"""Run directory and metrics logging (counterpart of
``mm3d_tpu/utils/logging_utils.py``).

A run writes under ``<root>/<task>/<name>/``: ``checkpoints/`` and
``logs/``, where ``logs/metrics.jsonl`` takes one JSON object per logged
record and ``logs/train.log`` the console lines.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
from typing import Optional


def create_run_dir(root: str, task: str, name: Optional[str] = None) -> str:
    """Make ``<root>/<task>/<name>`` with its ``checkpoints`` and ``logs``.

    Without ``name`` the directory is stamped with the second and claimed
    atomically (``makedirs`` with ``exist_ok=False``): a second run that
    starts in the same second, in this process or another, takes the next
    suffix (``<stamp>_2``, ...) and never shares the directory. An explicit
    ``name`` may exist already: that is how ``resume`` finds its run."""
    base = os.path.join(root, task)
    if name is None:
        ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        os.makedirs(base, exist_ok=True)
        i = 1
        while True:
            cand = ts if i == 1 else f"{ts}_{i}"
            try:
                os.makedirs(os.path.join(base, cand), exist_ok=False)
                break
            except FileExistsError:
                i += 1
        name = cand
    run_dir = os.path.join(base, name)
    os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "logs"), exist_ok=True)
    return run_dir


class MetricsLogger:
    """Console logger, ``logs/train.log`` and append-only
    ``logs/metrics.jsonl`` of one run directory."""

    def __init__(self, run_dir: str, name: str = "mm3d"):
        self.run_dir = run_dir
        self._jsonl = open(
            os.path.join(run_dir, "logs", "metrics.jsonl"), "a")
        self.logger = logging.getLogger(f"{name}:{run_dir}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        if not self.logger.handlers:
            fh = logging.FileHandler(
                os.path.join(run_dir, "logs", "train.log"))
            sh = logging.StreamHandler(sys.stdout)
            fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            fh.setFormatter(fmt)
            sh.setFormatter(fmt)
            self.logger.addHandler(fh)
            self.logger.addHandler(sh)

    def info(self, msg: str, *args):
        self.logger.info(msg, *args)

    @staticmethod
    def _jsonable(v):
        """Python scalars as they are; a one-element array or tensor (a 0-d
        torch tensor too) as its number; a larger one as a list."""
        if isinstance(v, (bool, int, float, str)) or v is None:
            return v
        size = getattr(v, "size", None)
        if callable(size):  # torch.Tensor.size() is a method
            size = v.numel()
        if size is not None and size != 1 and hasattr(v, "tolist"):
            return v.tolist()
        if hasattr(v, "item"):
            return v.item()
        return float(v)

    def log_metrics(self, step: int, metrics: dict, prefix: str = ""):
        rec = {"step": int(step)}
        rec.update({f"{prefix}{k}": self._jsonable(v)
                    for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        pretty = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k != "step")
        self.logger.info("step %d %s", step, pretty)

    def close(self):
        """Close the jsonl file and remove the logger's handlers: the
        logger is registered process-wide, so without this every run keeps
        its files open for the life of the process."""
        self._jsonl.close()
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
