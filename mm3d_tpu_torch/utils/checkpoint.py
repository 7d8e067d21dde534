"""Checkpoints of a train state with best-metric retention (counterpart of
``mm3d_tpu/utils/checkpoint.py``, which wraps Orbax).

One ``torch.save`` file a step, ``<directory>/<step>.pt``, beside a small
``<step>.json`` that holds the step's metrics, so that a manager opened on
an existing directory ranks its checkpoints without loading them. Each file
is written under a temporary name, synced and then renamed over its final
name (``os.replace``), so a run killed in the middle of a save leaves the
earlier checkpoints and no partial one. Saves are synchronous: ``wait``
returns at once.

Retention is Orbax's (``CheckpointManagerOptions`` with ``max_to_keep``,
``best_fn``, ``best_mode`` and ``keep_checkpoints_without_metrics``):
without ``best_metric`` the newest ``max_to_keep`` steps stay; with it the
``max_to_keep`` best by that metric stay (ties to the newer step), and so
does every step saved with ``metrics=None``. As in Orbax, a step at or
below the newest kept one is not saved (``save`` returns False).

A state is a dict of tensors, numbers, strings and dicts or lists of them
(a model's and an optimizer's ``state_dict``, a generator's state), and is
loaded with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _replace_atomically(path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, synced, then
    renamed to ``path``."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Keeps the checkpoints of one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 best_metric: Optional[str] = None, best_mode: str = "max"):
        if best_mode not in ("max", "min"):
            raise ValueError(
                f"best_mode must be 'max' or 'min': {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        # (step, metrics or None) of every kept checkpoint, oldest first
        self._infos: List[Tuple[int, Optional[Dict[str, float]]]] = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                step = int(m.group(1))
                self._infos.append((step, self._read_metrics(step)))
        self._infos.sort(key=lambda info: info[0])

    def _path(self, step: int, ext: str = "pt") -> str:
        return os.path.join(self.directory, f"{step}.{ext}")

    def _read_metrics(self, step: int) -> Optional[Dict[str, float]]:
        try:
            with open(self._path(step, "json")) as f:
                return json.load(f)["metrics"]
        except FileNotFoundError:
            return None

    # ------------------------------------------------------------ ranking

    def _by_metric(self):
        """The checkpoints saved with metrics, worst first; equal values
        keep step order, so the newer step ranks higher (Orbax's stable
        sort, reversed for ``min``)."""
        with_metrics = [(i, info) for i, info in enumerate(self._infos)
                        if info[1] is not None]
        return sorted(with_metrics,
                      key=lambda item: item[1][1][self.best_metric],
                      reverse=self.best_mode == "min")

    def _kept(self) -> List[bool]:
        n, infos = self.max_to_keep, self._infos
        if n is None or len(infos) <= n:
            return [True] * len(infos)
        if n == 0:
            return [False] * len(infos)
        if self.best_metric is None:
            return [False] * (len(infos) - n) + [True] * n
        keep = {i for i, _ in self._by_metric()[-n:]}
        keep |= {i for i, info in enumerate(infos) if info[1] is None}
        return [i in keep for i in range(len(infos))]

    # -------------------------------------------------------------- API

    def save(self, step: int, state: Any,
             metrics: Optional[dict] = None) -> bool:
        """Write ``state`` as ``step`` and drop what retention no longer
        keeps. Returns False, writing nothing, when ``step`` is not newer
        than the newest kept checkpoint."""
        step = int(step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        if metrics is not None:
            metrics = {k: float(v) for k, v in metrics.items()}
        meta = json.dumps({"step": step, "metrics": metrics}).encode()
        _replace_atomically(self._path(step, "json"),
                            lambda f: f.write(meta))
        _replace_atomically(self._path(step),
                            lambda f: torch.save(state, f))
        self._infos.append((step, metrics))
        kept = self._kept()
        for (old, _), keep in zip(self._infos, kept):
            if not keep:
                os.remove(self._path(old))
                os.remove(self._path(old, "json"))
        self._infos = [info for info, keep in zip(self._infos, kept) if keep]
        return True

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu") -> Any:
        """The state saved as ``step`` (default: the newest), its tensors
        on ``map_location``."""
        if step is None:
            step = self.latest_step()
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(
                "no checkpoint found" + ("" if step is None else
                                         f" for step {step}")
                + f" in {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def all_steps(self) -> List[int]:
        return [step for step, _ in self._infos]

    def latest_step(self) -> Optional[int]:
        return self._infos[-1][0] if self._infos else None

    def best_step(self) -> Optional[int]:
        """The best step by ``best_metric`` (without it: the newest); None
        when no kept checkpoint has metrics."""
        if self.best_metric is None:
            return self.latest_step()
        ranked = self._by_metric()
        return ranked[-1][1][0] if ranked else None

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between calls."""
