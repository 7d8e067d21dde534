"""Host-side input pipeline: fixed-shape batches + background prefetch.

Counterpart of ``mm3d_tpu/data/pipeline.py``. A daemon thread builds the
next batches while the device runs the current step, and, with a CUDA
``to_device``, starts each batch's host-to-device copy from pinned memory
without blocking, so the copy overlaps the previous step's compute (the
copy is queued on the device's current stream, which the step that uses the
batch runs on too).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch


def _as_dict(sample) -> dict:
    """A dict sample as it is; a classification sample ``(points, label)``
    (``SyntheticModelNet``) as {"points", "label"}, the label int32; a
    sem-seg sample ``(points, seg [N])`` (``SyntheticIndoorScene``) as
    {"points", "seg"}; a part-seg sample ``(points, cat, seg)``
    (``SyntheticShapeNetPart``) as {"points", "cat", "seg"}, the labels
    int32."""
    if isinstance(sample, dict):
        return sample
    if len(sample) == 3:
        points, cat, seg = sample
        return {"points": points, "cat": np.int32(cat),
                "seg": np.asarray(seg, np.int32)}
    points, label = sample
    if np.ndim(label):
        return {"points": points, "seg": np.asarray(label, np.int32)}
    return {"points": points, "label": np.int32(label)}


def _collate(samples: Sequence) -> dict:
    """Stack samples key by key into tensors."""
    samples = [_as_dict(s) for s in samples]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples]))
            for k in samples[0]}


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DataPipeline:
    """Batches a map-style dataset with per-epoch shuffling and prefetch.

    Args:
      dataset: supports __len__ and __getitem__(int) -> dict of arrays, a
        classification sample (points, label), a sem-seg sample
        (points, seg) or a part-seg sample (points, cat, seg).
      batch_size: static batch size; incomplete tails are dropped so every
        step sees the same shapes.
      shuffle: reshuffle indices every epoch from ``seed``.
      prefetch: number of batches prepared ahead by the worker thread.
      to_device: device each batch is copied to as it is produced (pinned,
        non-blocking for CUDA), or None to keep host tensors.
      pad_remainder: if True, the final incomplete batch is padded (by
        wrapping to the first samples) instead of dropped, and the epoch
        iterator yields ``(batch, valid)`` pairs where ``valid`` is a bool
        [batch_size] row mask: eval must see the full test set.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, to_device=None,
                 pad_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.device = None if to_device is None else torch.device(to_device)
        self.pad_remainder = pad_remainder

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.pad_remainder:
            return -(-n // self.batch_size)
        return n // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        total = self.steps_per_epoch() * self.batch_size
        if self.pad_remainder and total > n:
            # wrap-pad; np.resize cycles when the pad exceeds the dataset
            idx = np.concatenate([idx, np.resize(idx, total - n)])
        return idx[:total]

    def epoch(self, epoch: int = 0,
              max_steps: Optional[int] = None) -> Iterator[Any]:
        """Iterate one epoch of batches with background prefetch.

        ``max_steps`` bounds the epoch (e.g. the Trainer's BN-refresh
        passes); the worker sees the same bound, so a consumer that stops
        there leaves no worker blocked on a full queue."""
        n = len(self.dataset)
        idx = self._epoch_indices(epoch)
        nsteps = len(idx) // self.batch_size
        if max_steps is not None:
            nsteps = min(nsteps, max_steps)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item):
            # bounded put: an abandoned consumer sets `stop` from the
            # generator's finally, so the worker exits instead of blocking
            # on a full queue while it holds device batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for s in range(nsteps):
                    lo = s * self.batch_size
                    rows = idx[lo:lo + self.batch_size]
                    batch = _collate([self.dataset[int(i)] for i in rows])
                    if self.device is not None:
                        batch = {k: _to_device(v, self.device)
                                 for k, v in batch.items()}
                    if self.pad_remainder:
                        valid = torch.from_numpy(
                            np.arange(lo, lo + self.batch_size) < n)
                        if self.device is not None:
                            valid = _to_device(valid, self.device)
                        batch = (batch, valid)
                    if not put(batch):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
