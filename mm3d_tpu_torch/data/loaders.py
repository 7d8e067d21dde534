"""Real-dataset loaders (counterpart of ``mm3d_tpu/data/loaders.py``), in
the canonical on-disk formats:

* ModelNet40 "normal_resampled": ``modelnet40_shape_names.txt``,
  ``modelnet40_{split}.txt`` shape-id lists, per-shape
  ``<class>/<class>_NNNN.txt`` with comma-separated x,y,z,nx,ny,nz rows.
* ShapeNetPart "partanno_segmentation_benchmark_v0_normal":
  ``synsetoffset2category.txt``,
  ``train_test_split/shuffled_{split}_file_list.json``, per-shape
  ``<synset>/<id>.txt`` with space-separated x y z nx ny nz seg.
* S3DIS (preprocessed): per-room ``.npy`` [N, 7] = xyz rgb label; the loader
  crops fixed-size blocks with the 9-dim feature convention.
* Multimodal pairing: any point dataset with a rendered view and its camera
  per sample, stored as ``.npz`` (image, K, R, t).

Samples are numpy, with the sample contracts of the synthetic sets
(``data/synthetic.py``), so ``DataPipeline`` and ``Trainer`` take them
unchanged and move them to the device. The random draws are numpy's, seeded
as the JAX package seeds them, so a loader gives the JAX loader's samples
bit for bit. Text tables are parsed by the native parser
(``data/native_io.py``) when it builds, by numpy otherwise.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np


def _parse_float_table(path: str, cols: int) -> np.ndarray:
    """A whitespace- or comma-separated float table: the native parser when
    it is built, numpy otherwise."""
    try:
        from mm3d_tpu_torch.data import native_io
        out = native_io.parse_table(path, cols)
        if out is not None:
            return out
    except Exception:
        pass
    return np.loadtxt(path, delimiter=None if _is_space_sep(path) else ",",
                      dtype=np.float32).reshape(-1, cols)


def _is_space_sep(path: str) -> bool:
    with open(path, "r") as f:
        first = f.readline()
    return "," not in first


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    centroid = pc.mean(0, keepdims=True)
    pc = pc - centroid
    return pc / (np.max(np.linalg.norm(pc, axis=1)) + 1e-9)


def farthest_point_sample_np(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """Host FPS for load-time downsampling (the lineage's ModelNet loader
    does this)."""
    n = xyz.shape[0]
    if npoint >= n:
        return np.arange(n)
    dist = np.full(n, 1e10, np.float32)
    far = 0
    out = np.zeros(npoint, np.int64)
    for i in range(npoint):
        out[i] = far
        d = np.sum((xyz - xyz[far]) ** 2, axis=1)
        np.minimum(dist, d, out=dist)
        far = int(dist.argmax())
    return out


class ModelNetDataset:
    """ModelNet40-format classification loader: (points [npoints, 3(+3)]
    f32, label int)."""

    def __init__(self, root: str, split: str = "train", npoints: int = 1024,
                 normals: bool = False, uniform_sample: bool = False,
                 cache_size: int = 15000):
        self.root = root
        self.npoints = npoints
        self.normals = normals
        self.uniform_sample = uniform_sample
        names_file = os.path.join(root, "modelnet40_shape_names.txt")
        self.classes = [l.strip() for l in open(names_file) if l.strip()]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        ids = [l.strip() for l in
               open(os.path.join(root, f"modelnet40_{split}.txt"))
               if l.strip()]
        self.paths: List[Tuple[str, int]] = []
        for sid in ids:
            cls = "_".join(sid.split("_")[:-1])
            self.paths.append(
                (os.path.join(root, cls, f"{sid}.txt"),
                 self.class_to_idx[cls]))
        self._cache = {}
        self._cache_size = cache_size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int):
        if index in self._cache:
            return self._cache[index]
        path, label = self.paths[index]
        data = _parse_float_table(path, 6)
        if self.uniform_sample:
            idx = farthest_point_sample_np(data[:, :3], self.npoints)
            data = data[idx]
        else:
            data = data[: self.npoints]
        if data.shape[0] < self.npoints:
            # a short shape file: wrap-pad its rows, so batches keep one
            # shape
            data = data[np.resize(np.arange(data.shape[0]), self.npoints)]
        pts = data[:, : 6 if self.normals else 3].copy()
        pts[:, :3] = pc_normalize(pts[:, :3])
        sample = (pts.astype(np.float32), label)
        if len(self._cache) < self._cache_size:
            self._cache[index] = sample
        return sample


class _EpochSeeded:
    """Per-sample randomness that is deterministic but new each epoch.

    The lineage's loaders draw a fresh subsample or crop on every access.
    The datasets mix the epoch (``DataPipeline.epoch`` calls ``set_epoch``)
    into the per-index seed; epoch 0 gives the fixed-seed draws.
    """

    _epoch: int = 0

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch) % (1 << 20)

    def _rng(self, index: int) -> np.random.RandomState:
        # RandomState seeds must lie in [0, 2**32)
        return np.random.RandomState(
            (index + 1000003 * self._epoch) % (1 << 32))


class ShapeNetPartDataset(_EpochSeeded):
    """ShapeNetPart-format part-segmentation loader: (points [npoints,
    3(+3)], category int, seg [npoints] int32)."""

    def __init__(self, root: str, split: str = "train", npoints: int = 2048,
                 normals: bool = False, cache_size: int = 15000):
        self.root = root
        self.npoints = npoints
        self.normals = normals
        self._cache = {}
        self._cache_size = cache_size
        cat_file = os.path.join(root, "synsetoffset2category.txt")
        self.categories = []  # (name, synset)
        for line in open(cat_file):
            if line.strip():
                name, synset = line.strip().split()
                self.categories.append((name, synset))
        self.synset_to_cat = {s: i for i, (_, s) in
                              enumerate(self.categories)}
        split_file = os.path.join(
            root, "train_test_split", f"shuffled_{split}_file_list.json")
        files = json.load(open(split_file))
        # entries look like "shape_data/<synset>/<id>"
        self.items = []
        for f in files:
            parts = f.split("/")
            synset, sid = parts[-2], parts[-1]
            self.items.append(
                (os.path.join(root, synset, sid + ".txt"),
                 self.synset_to_cat[synset]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        path, cat = self.items[index]
        cached = self._cache.get(index)
        if cached is None:
            data = _parse_float_table(path, 7)
            # the lineage's order: normalise the whole cloud, then draw the
            # subsample (so the parsed, normalised cloud can be cached)
            data = data.copy()
            data[:, :3] = pc_normalize(data[:, :3])
            if len(self._cache) < self._cache_size:
                self._cache[index] = data
        else:
            data = cached
        n = data.shape[0]
        choice = self._rng(index).choice(
            n, self.npoints, replace=n < self.npoints)
        data = data[choice]
        pts = data[:, : 6 if self.normals else 3].astype(np.float32)
        seg = data[:, 6].astype(np.int32)
        return pts, cat, seg


def s3dis_room_in_area(fname: str, area: int) -> bool:
    """Whether an S3DIS room file belongs to ``area``: a delimited prefix,
    so that Area_1 does not take Area_10's rooms. Shared by the training
    loader and ``test.py --scene area``."""
    return os.path.basename(fname).startswith(f"Area_{area}_")


def semseg_block_features(bxyz: np.ndarray, brgb: np.ndarray,
                          room_min: np.ndarray,
                          room_extent: np.ndarray) -> np.ndarray:
    """The 9-dim sem-seg block features, shared by the training loader and
    the whole-room tiler: [block-local xyz, rgb in [0,1], room-normalised
    xyz], the room normalisation shifted by the room's minimum."""
    local = bxyz - bxyz.mean(0, keepdims=True)
    norm = (bxyz - room_min) / np.maximum(room_extent, 1e-6)
    return np.concatenate([local, brgb, norm], -1).astype(np.float32)


class S3DISDataset(_EpochSeeded):
    """S3DIS-format semantic-segmentation loader over preprocessed per-room
    ``.npy`` files ([N, 7] = x y z r g b label).

    Crops random ``block_size`` x ``block_size`` columns of ``npoints``
    points and returns (features [npoints, 9] f32, seg [npoints] int32).
    """

    def __init__(self, root: str, split: str = "train", npoints: int = 4096,
                 block_size: float = 1.0, test_area: int = 5,
                 num_classes: int = 13, samples_per_room: int = 16):
        self.npoints = npoints
        self.block_size = block_size
        self.num_classes = num_classes
        self.samples_per_room = samples_per_room
        rooms = sorted(f for f in os.listdir(root) if f.endswith(".npy"))
        if split == "train":
            rooms = [r for r in rooms
                     if not s3dis_room_in_area(r, test_area)]
        else:
            rooms = [r for r in rooms if s3dis_room_in_area(r, test_area)]
        if not rooms:
            raise FileNotFoundError(f"no rooms for split {split} in {root}")
        self.rooms = [os.path.join(root, r) for r in rooms]
        self._cache = {}

    def __len__(self):
        return len(self.rooms) * self.samples_per_room

    def _room(self, ridx):
        if ridx not in self._cache:
            room = np.load(self.rooms[ridx]).astype(np.float32)
            if room[:, 3:6].max() > 1.5:  # rgb stored 0..255: scaled for
                room[:, 3:6] /= 255.0     # the whole room at once
            self._cache[ridx] = room
        return self._cache[ridx]

    def __getitem__(self, index: int):
        rng = self._rng(index)
        data = self._room(index % len(self.rooms))
        xyz, rgb, label = data[:, :3], data[:, 3:6], data[:, 6].astype(np.int32)
        room_min = xyz.min(0)
        room_extent = xyz.max(0) - room_min
        for _ in range(10):
            center = xyz[rng.randint(len(xyz))][:2]
            lo = center - self.block_size / 2
            hi = center + self.block_size / 2
            mask = ((xyz[:, 0] >= lo[0]) & (xyz[:, 0] <= hi[0])
                    & (xyz[:, 1] >= lo[1]) & (xyz[:, 1] <= hi[1]))
            if mask.sum() > 32:
                break
        else:  # a sparse room: no attempt held enough points
            mask = np.ones(len(xyz), bool)
        sel = np.where(mask)[0]
        choice = rng.choice(sel, self.npoints, replace=len(sel) < self.npoints)
        feats = semseg_block_features(xyz[choice], rgb[choice],
                                      room_min, room_extent)
        return feats, label[choice]


# which on-disk format serves which model task (the registry's task); the
# CLIs refuse a mismatched pairing before they build anything
DATASET_TASKS = {
    "modelnet40": ("classification",),
    "shapenetpart": ("partseg",),
    "s3dis": ("semseg",),
    "multimodal": ("fusion_cls", "fusion_semseg"),
}

# the CLIs' --dataset choices
REAL_DATASETS = tuple(DATASET_TASKS)


def build_real_datasets(dataset: str, root: str, task: str,
                        npoints: int, normals: bool = False,
                        test_area: int = 5, uniform_sample: bool = False,
                        splits=("train", "test")):
    """The datasets of an on-disk tree for ``train`` / ``test``
    ``--dataset`` / ``--data_root``: one per split, None for a split not in
    ``splits`` (an eval-only tree needs no train files). ``multimodal``
    pairs the task's point loader with per-sample rendered views from
    ``<root>/views_<split>/``, else ``<root>/views/`` (which then may serve
    one split only: its files are keyed by the split's own indices)."""
    if task not in DATASET_TASKS.get(dataset, ()):
        raise ValueError(
            f"--dataset {dataset} serves task(s) "
            f"{DATASET_TASKS.get(dataset)}, but the selected model's "
            f"task is {task!r}")
    if not os.path.isdir(root):
        raise FileNotFoundError(f"--data_root {root} is not a directory")

    def _views_dir(split):
        d = os.path.join(root, f"views_{split}")
        if os.path.isdir(d):
            return d
        d = os.path.join(root, "views")
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"--dataset multimodal needs {root}/views_{split}/ or "
                f"{root}/views/ (per-sample <index>.npz with "
                "image/K/R/t); neither exists")
        if "train" in splits and "test" in splits:
            # views/<index>.npz is keyed by the split's own index: one
            # directory for both splits would pair train[i] and test[i]
            # with the same view
            raise FileNotFoundError(
                f"{d} cannot serve both splits (per-split indices "
                f"collide); provide {root}/views_train/ and "
                f"{root}/views_test/")
        return d

    if dataset == "modelnet40":
        mk = lambda split: ModelNetDataset(
            root, split, npoints=npoints, normals=normals,
            uniform_sample=uniform_sample)
    elif dataset == "shapenetpart":
        mk = lambda split: ShapeNetPartDataset(
            root, split, npoints=npoints, normals=normals)
    elif dataset == "s3dis":
        mk = lambda split: S3DISDataset(
            root, split, npoints=npoints, test_area=test_area)
    else:  # multimodal: the point format follows the model's task
        if task == "fusion_cls":
            base = lambda split: ModelNetDataset(
                root, split, npoints=npoints, normals=normals,
                uniform_sample=uniform_sample)
        else:
            base = lambda split: S3DISDataset(
                root, split, npoints=npoints, test_area=test_area)
        mk = lambda split: MultimodalPairedDataset(base(split),
                                                   _views_dir(split))
    return tuple(mk(s) if s in splits else None
                 for s in ("train", "test"))


class MultimodalPairedDataset:
    """A point dataset paired with a rendered view and its camera per
    sample: ``views/<index>.npz`` holding image [H,W,3] f32, K, R, t. The
    sample contract of ``synthetic.SyntheticMultimodal``."""

    def __init__(self, base, views_dir: str):
        self.base = base
        self.views_dir = views_dir

    def set_epoch(self, epoch: int):
        # the pipeline's per-epoch reseeding goes on to the point dataset
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index: int):
        sample = self.base[index]
        view = np.load(os.path.join(self.views_dir, f"{index}.npz"))
        if len(sample) == 2 and np.ndim(sample[1]) == 0:
            pts, label = sample
            out = {"points": pts, "label": np.int32(label)}
        elif len(sample) == 2:
            pts, seg = sample
            out = {"points": pts, "seg": seg.astype(np.int32),
                   "label": np.int32(0)}
        else:
            pts, cat, seg = sample
            out = {"points": pts, "label": np.int32(cat),
                   "seg": seg.astype(np.int32)}
        out.update({"image": view["image"].astype(np.float32),
                    "K": view["K"].astype(np.float32),
                    "R": view["R"].astype(np.float32),
                    "t": view["t"].astype(np.float32)})
        return out
