"""Synthetic datasets of the ported models (the port's own copy of the
parts of ``mm3d_tpu/data/synthetic.py`` it needs).

ModelNet40-shaped clouds (``SyntheticModelNet``), ShapeNetPart-shaped
part-seg clouds (``SyntheticShapeNetPart``, with ``shapenet_part_ranges``),
S3DIS-shaped indoor blocks (``SyntheticIndoorScene``) and their multimodal
pairing with a rendered view and camera calibration
(``SyntheticMultimodal``). Each class is a fixed parametric primitive
composition drawn from a seeded RNG, so the task is learnable. Host-side
numpy, deterministic in (seed, index), and array-for-array identical with
the JAX package's generators for the same seed (``tests/test_torch_data.py``,
``tests/test_torch_partseg.py``), and the whole room of the scene-eval
protocol (``synthetic_room``, ``tests/test_torch_scene_eval.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ------------------------------------------------------------- primitives


def _split_offset(split: str) -> int:
    return {"train": 0, "test": 7_654_321, "val": 3_210_987}[split]


def _unit(v, axis=-1):
    return v / (np.linalg.norm(v, axis=axis, keepdims=True) + 1e-9)


def sample_sphere(rng, n, radii):
    """Points + normals on an axis-aligned ellipsoid with semi-axes `radii`."""
    d = _unit(rng.randn(n, 3))
    pts = d * radii
    # gradient of (x/r1)^2+(y/r2)^2+(z/r3)^2 at pts = d*radii is
    # pts/radii^2 = d/radii
    nrm = _unit(d / np.asarray(radii))
    return pts, nrm


def sample_box(rng, n, half):
    """Points + normals on a box surface with half-extents `half`."""
    hx, hy, hz = half
    areas = np.array([hy * hz, hx * hz, hx * hy]) * 8
    face_axis = rng.choice(3, size=n, p=areas / areas.sum())
    sign = rng.choice([-1.0, 1.0], size=n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.empty((n, 3)); nrm = np.zeros((n, 3))
    h = np.array(half)
    for a in range(3):
        m = face_axis == a
        o1, o2 = [i for i in range(3) if i != a]
        pts[m, a] = sign[m] * h[a]
        pts[m, o1] = uv[m, 0] * h[o1]
        pts[m, o2] = uv[m, 1] * h[o2]
        nrm[m, a] = sign[m]
    return pts, nrm


def sample_cylinder(rng, n, radius, height, capped=True):
    """Points + normals on a Y-axis cylinder."""
    a_side = 2 * np.pi * radius * height
    a_cap = 2 * np.pi * radius ** 2 if capped else 0.0
    p_side = a_side / (a_side + a_cap)
    on_side = rng.uniform(size=n) < p_side
    theta = rng.uniform(0, 2 * np.pi, n)
    pts = np.empty((n, 3)); nrm = np.zeros((n, 3))
    y = rng.uniform(-height / 2, height / 2, n)
    pts[on_side] = np.stack(
        [radius * np.cos(theta), y, radius * np.sin(theta)], -1)[on_side]
    nrm[on_side] = np.stack(
        [np.cos(theta), np.zeros(n), np.sin(theta)], -1)[on_side]
    if capped:
        r = radius * np.sqrt(rng.uniform(size=n))
        top = rng.choice([-1.0, 1.0], size=n)
        cap_pts = np.stack(
            [r * np.cos(theta), top * height / 2, r * np.sin(theta)], -1)
        cap_nrm = np.stack([np.zeros(n), top, np.zeros(n)], -1)
        pts[~on_side] = cap_pts[~on_side]
        nrm[~on_side] = cap_nrm[~on_side]
    return pts, nrm


def sample_cone(rng, n, radius, height):
    """Points + normals on a Y-axis cone (apex up) with a base disk."""
    slant = np.sqrt(radius ** 2 + height ** 2)
    a_side = np.pi * radius * slant
    a_base = np.pi * radius ** 2
    on_side = rng.uniform(size=n) < a_side / (a_side + a_base)
    theta = rng.uniform(0, 2 * np.pi, n)
    u = np.sqrt(rng.uniform(size=n))  # uniform over the lateral surface
    pts = np.empty((n, 3)); nrm = np.empty((n, 3))
    r_side = radius * u
    y_side = height / 2 - height * u
    side_pts = np.stack(
        [r_side * np.cos(theta), y_side, r_side * np.sin(theta)], -1)
    k = radius / height
    side_nrm = _unit(np.stack(
        [np.cos(theta), np.full(n, k), np.sin(theta)], -1))
    pts[on_side] = side_pts[on_side]; nrm[on_side] = side_nrm[on_side]
    r_base = radius * np.sqrt(rng.uniform(size=n))
    base_pts = np.stack(
        [r_base * np.cos(theta), np.full(n, -height / 2),
         r_base * np.sin(theta)], -1)
    pts[~on_side] = base_pts[~on_side]
    nrm[~on_side] = np.array([0.0, -1.0, 0.0])
    return pts, nrm


def sample_torus(rng, n, big_r, small_r):
    """Points + normals on a torus around the Y axis."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cx = np.stack([big_r * np.cos(u), np.zeros(n), big_r * np.sin(u)], -1)
    ring = np.stack(
        [np.cos(u) * np.cos(v), np.sin(v), np.sin(u) * np.cos(v)], -1)
    pts = cx + small_r * ring
    return pts, ring


_PRIMS = [sample_sphere, sample_box, sample_cylinder, sample_cone,
          sample_torus]


def _sample_primitive(rng, kind, n, params):
    if kind == 0:
        return sample_sphere(rng, n, params["radii"])
    if kind == 1:
        return sample_box(rng, n, params["half"])
    if kind == 2:
        return sample_cylinder(rng, n, params["r"], params["h"])
    if kind == 3:
        return sample_cone(rng, n, params["r"], params["h"])
    return sample_torus(rng, n, params["R"], params["r2"])


def _class_params(rng, kind):
    if kind == 0:
        return {"radii": rng.uniform(0.3, 1.0, 3)}
    if kind == 1:
        return {"half": rng.uniform(0.25, 0.9, 3)}
    if kind == 2:
        return {"r": rng.uniform(0.2, 0.7), "h": rng.uniform(0.6, 1.8)}
    if kind == 3:
        return {"r": rng.uniform(0.3, 0.9), "h": rng.uniform(0.6, 1.6)}
    return {"R": rng.uniform(0.5, 0.9), "r2": rng.uniform(0.1, 0.35)}


def _jitter_params(rng, kind, params, frac=0.1):
    out = {}
    for k, v in params.items():
        out[k] = v * (1.0 + frac * rng.uniform(-1, 1, np.shape(v)))
    return out


def _rot_y_np(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


# ------------------------------------------------------ ModelNet-style cls


@dataclasses.dataclass
class SyntheticModelNet:
    """ModelNet40-shaped classification set: [npoints, 3(+3)] + int label.

    Each class is a fixed 1-2 primitive composition; instances vary by
    parameter jitter, Y-rotation and surface noise.  Matches the real
    loader's output contract: pc_normalized xyz (+ unit normals).
    """

    num_classes: int = 40
    npoints: int = 1024
    normals: bool = False
    size: int = 2048
    seed: int = 0
    split: str = "train"  # class definitions depend only on `seed`;
    # the split offsets the instance stream so train/test are disjoint.

    def __post_init__(self):
        crng = np.random.RandomState(self.seed + 777)
        self.class_specs = []
        for c in range(self.num_classes):
            kind = c % len(_PRIMS)
            spec = {"kind": kind, "params": _class_params(crng, kind)}
            if crng.uniform() < 0.5:  # second component for half the classes
                k2 = crng.randint(len(_PRIMS))
                spec["kind2"] = k2
                spec["params2"] = _class_params(crng, k2)
                spec["offset2"] = crng.uniform(-0.6, 0.6, 3)
            self.class_specs.append(spec)

    def __len__(self):
        return self.size

    def __getitem__(self, index) -> Tuple[np.ndarray, int]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + _split_offset(self.split) + index)
            % (2**32))
        label = index % self.num_classes
        spec = self.class_specs[label]
        n1 = self.npoints if "kind2" not in spec else self.npoints // 2
        pts, nrm = _sample_primitive(
            rng, spec["kind"], n1,
            _jitter_params(rng, spec["kind"], spec["params"]))
        if "kind2" in spec:
            p2, n2 = _sample_primitive(
                rng, spec["kind2"], self.npoints - n1,
                _jitter_params(rng, spec["kind2"], spec["params2"]))
            pts = np.concatenate([pts, p2 + spec["offset2"]], 0)
            nrm = np.concatenate([nrm, n2], 0)
        rot = _rot_y_np(rng.uniform(0, 2 * np.pi))
        pts = pts @ rot.T
        nrm = nrm @ rot.T
        pts += 0.005 * rng.randn(*pts.shape)
        # pc_normalize, as the real ModelNet loader does at load time
        pts -= pts.mean(0, keepdims=True)
        pts /= np.max(np.linalg.norm(pts, axis=1)) + 1e-9
        out = np.concatenate([pts, nrm], -1) if self.normals else pts
        return out.astype(np.float32), label


# -------------------------------------------------- ShapeNetPart-style seg

# Category -> global part-label range, ShapeNetPart-shaped: 16 categories,
# 50 parts, 2-6 parts a category like the real label map
_PARTS_PER_CAT = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]  # sum=50


def shapenet_part_ranges():
    """category -> (first global part label, one past the last)."""
    starts = np.cumsum([0] + _PARTS_PER_CAT[:-1])
    return {c: (int(s), int(s + p)) for c, (s, p) in
            enumerate(zip(starts, _PARTS_PER_CAT))}


@dataclasses.dataclass
class SyntheticShapeNetPart:
    """ShapeNetPart-shaped part-seg set.

    Sample: (points [npoints, 3(+3)], category int, seg [npoints] int in the
    category's global part range). Each category is a stack of primitives
    along Y, one part label each.
    """

    npoints: int = 2048
    normals: bool = False
    size: int = 1024
    seed: int = 0
    split: str = "train"
    num_categories: int = 16
    num_parts: int = 50

    def __post_init__(self):
        self.ranges = shapenet_part_ranges()
        crng = np.random.RandomState(self.seed + 555)
        self.cat_specs = []
        for c in range(self.num_categories):
            lo, hi = self.ranges[c]
            parts = []
            y = 0.0
            for _ in range(hi - lo):
                kind = crng.randint(len(_PRIMS))
                params = _class_params(crng, kind)
                parts.append({"kind": kind, "params": params,
                              "offset": np.array([0.0, y, 0.0])})
                y += crng.uniform(0.5, 1.0)
            self.cat_specs.append(parts)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = np.random.RandomState(
            (self.seed * 2_000_003 + _split_offset(self.split) + index)
            % (2**32))
        cat = index % self.num_categories
        lo, hi = self.ranges[cat]
        parts = self.cat_specs[cat]
        k = len(parts)
        counts = np.full(k, self.npoints // k)
        counts[: self.npoints - counts.sum()] += 1
        pts_l, nrm_l, seg_l = [], [], []
        for j, part in enumerate(parts):
            p, nr = _sample_primitive(
                rng, part["kind"], int(counts[j]),
                _jitter_params(rng, part["kind"], part["params"]))
            pts_l.append(p + part["offset"])
            nrm_l.append(nr)
            seg_l.append(np.full(int(counts[j]), lo + j, np.int32))
        pts = np.concatenate(pts_l, 0)
        nrm = np.concatenate(nrm_l, 0)
        seg = np.concatenate(seg_l, 0)
        perm = rng.permutation(self.npoints)
        pts, nrm, seg = pts[perm], nrm[perm], seg[perm]
        pts -= pts.mean(0, keepdims=True)
        pts /= np.max(np.linalg.norm(pts, axis=1)) + 1e-9
        pts += 0.004 * rng.randn(*pts.shape)
        out = np.concatenate([pts, nrm], -1) if self.normals else pts
        return out.astype(np.float32), cat, seg


def partseg_request(batch: int, npoint: int = 2048, seed: int = 0) -> list:
    """One part-seg request: ``batch`` ShapeNetPart-style test clouds of
    ``npoint`` points and their categories one-hot, as numpy [points [B,N,3]
    f32, onehot [B,16] f32] (the models' inputs), and their labels
    [cat [B], seg [B,N]] int32."""
    ds = SyntheticShapeNetPart(npoints=npoint, size=batch, seed=seed,
                               split="test")
    samples = [ds[i] for i in range(batch)]
    cat = np.array([s[1] for s in samples], np.int32)
    return [np.stack([s[0] for s in samples]),
            np.eye(ds.num_categories, dtype=np.float32)[cat], cat,
            np.stack([s[2] for s in samples]).astype(np.int32)]


# ------------------------------------------------------- S3DIS-style semseg


@dataclasses.dataclass
class SyntheticIndoorScene:
    """S3DIS-shaped semantic-seg blocks: ([npoints, 9], seg [npoints]).

    9-dim features: xyz (block-local), rgb in [0,1], normalized room xyz.
    13 classes: floor/ceiling/wall + 10 "furniture" primitive classes.
    """

    npoints: int = 4096
    size: int = 512
    seed: int = 0
    split: str = "train"
    num_classes: int = 13

    def __getitem__(self, index):
        rng = np.random.RandomState(
            (self.seed * 3_000_017 + _split_offset(self.split) + index)
            % (2**32))
        xyz, rgb, seg, room_max = _gen_room(rng, self.npoints,
                                            self.num_classes, self.seed)
        norm_xyz = xyz / room_max
        local = xyz - xyz.mean(0, keepdims=True)
        feats = np.concatenate([local, rgb, norm_xyz], -1)
        return feats.astype(np.float32), seg

    def __len__(self):
        return self.size


def scene_request(batch: int, npoint: int = 4096, seed: int = 0) -> list:
    """One semantic-segmentation request: ``batch`` S3DIS-style test blocks
    of ``npoint`` 9-dim points, as numpy [points [B,N,9] f32, seg [B,N]
    int32]."""
    ds = SyntheticIndoorScene(npoints=npoint, size=batch, seed=seed,
                              split="test")
    samples = [ds[i] for i in range(batch)]
    return [np.stack([s[0] for s in samples]),
            np.stack([s[1] for s in samples]).astype(np.int32)]


def _gen_room(rng, n, num_classes, seed):
    """One synthetic indoor room: (xyz [n,3], rgb [n,3], seg [n],
    room_max [3]): floor, ceiling and walls, then 3-6 furniture primitives
    of classes 3..12 standing on the floor."""
    room = rng.uniform(4.0, 8.0, 2)  # W, D
    H = rng.uniform(2.5, 3.5)
    quota = [int(n * 0.25), int(n * 0.15), int(n * 0.25)]
    pts, lbl, col = [], [], []
    # floor(0), ceiling(1), wall(2)
    f = np.stack([rng.uniform(0, room[0], quota[0]),
                  rng.uniform(0, room[1], quota[0]),
                  np.zeros(quota[0])], -1)
    c = np.stack([rng.uniform(0, room[0], quota[1]),
                  rng.uniform(0, room[1], quota[1]),
                  np.full(quota[1], H)], -1)
    nw = quota[2]
    side = rng.randint(0, 4, nw)
    wx = rng.uniform(0, room[0], nw); wy = rng.uniform(0, room[1], nw)
    wz = rng.uniform(0, H, nw)
    w = np.stack([np.where(side < 2, wx, np.where(side == 2, 0, room[0])),
                  np.where(side < 2, np.where(side == 0, 0, room[1]), wy),
                  wz], -1)
    for arr, klass, base in ((f, 0, 0.45), (c, 1, 0.85), (w, 2, 0.65)):
        pts.append(arr)
        lbl.append(np.full(len(arr), klass, np.int32))
        col.append(np.clip(base + 0.1 * rng.randn(len(arr), 3), 0, 1))
    # furniture: classes 3..12 from seeded primitives on the floor
    remaining = n - sum(quota)
    n_obj = rng.randint(3, 7)
    counts = np.full(n_obj, remaining // n_obj)
    counts[: remaining - counts.sum()] += 1
    for j in range(n_obj):
        klass = 3 + rng.randint(num_classes - 3)
        prng = np.random.RandomState(seed + 91 * klass)
        kind = klass % len(_PRIMS)
        params = _class_params(prng, kind)
        p, _ = _sample_primitive(rng, kind, int(counts[j]), params)
        p = p * 0.4
        p = p - p.min(0, keepdims=True)
        p += np.array([rng.uniform(0.5, room[0] - 0.5),
                       rng.uniform(0.5, room[1] - 0.5), 0.0])
        pts.append(p)
        lbl.append(np.full(int(counts[j]), klass, np.int32))
        hue = np.array([klass / num_classes, 1 - klass / num_classes, 0.5])
        col.append(np.clip(hue + 0.05 * rng.randn(int(counts[j]), 3), 0, 1))
    xyz = np.concatenate(pts, 0).astype(np.float32)
    seg = np.concatenate(lbl, 0)
    rgb = np.concatenate(col, 0).astype(np.float32)
    perm = rng.permutation(n)
    xyz, seg, rgb = xyz[perm], seg[perm], rgb[perm]
    room_max = np.array([room[0], room[1], H], np.float32)
    return xyz, rgb, seg, room_max


def synthetic_room(n: int = 20000, seed: int = 0, num_classes: int = 13):
    """A whole synthetic room for the whole-room protocol (``test --scene
    synthetic``): (xyz [n,3] in room coordinates, rgb [n,3] in [0,1],
    labels [n] int32). Its stream's seed multiplier differs from
    ``SyntheticIndoorScene``'s, and seed + 1 keeps seed 0 off it too, so
    the room is no training block."""
    rng = np.random.RandomState(((seed + 1) * 4_000_037 + 7919) % (2**32))
    xyz, rgb, seg, _ = _gen_room(rng, n, num_classes, seed)
    return xyz, rgb, seg


# --------------------------------------------------------------- multimodal


def look_at_extrinsics(eye, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0])):
    """World->camera [R|t] with camera looking down +z at `target`."""
    z = _unit(target - eye)
    x = _unit(np.cross(z, up))
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)  # rows
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def render_depth_image(xyz, K, R, t, hw=(64, 64)):
    """Z-buffer point splat -> 3-channel image (depth, depth², mask).

    A cheap differentiable-free synthetic "photo" so the image branch has
    real geometric signal correlated with the cloud.
    """
    H, W = hw
    cam = xyz @ R.T + t
    z = np.maximum(cam[:, 2], 1e-6)
    u = K[0, 0] * cam[:, 0] / z + K[0, 2]
    v = K[1, 1] * cam[:, 1] / z + K[1, 2]
    img = np.zeros((H, W, 3), np.float32)
    ui = np.round(u).astype(int); vi = np.round(v).astype(int)
    ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (cam[:, 2] > 0)
    # vectorized z-buffer: far-first fancy assignment, nearest point's
    # write lands last
    zk, uk, vk = z[ok], ui[ok], vi[ok]
    order = np.argsort(-zk)
    uo, vo, zo = uk[order], vk[order], zk[order]
    img[vo, uo, 0] = 1.0 / zo
    img[vo, uo, 1] = np.tanh(zo - 2.0)
    img[vo, uo, 2] = 1.0
    return img



def random_viewpoint_extrinsics(rng):
    """The multimodal pairing's random camera pose (radius 2.5,
    elevation 0.45, uniform azimuth)."""
    theta = rng.uniform(0, 2 * np.pi)
    eye = 2.5 * np.array([np.cos(theta), 0.45, np.sin(theta)])
    return look_at_extrinsics(eye.astype(np.float32))

def default_intrinsics(hw=(64, 64), fov_deg=60.0):
    H, W = hw
    f = 0.5 * W / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


@dataclasses.dataclass
class SyntheticMultimodal:
    """Cloud + rendered view + calib, for fusion configs 4-5.

    Sample: dict(points [N,3], image [H,W,3], K [3,3], R [3,3], t [3],
    label int, seg [N]).  The image is a deterministic function of the
    cloud geometry, so fusion genuinely adds signal.
    """

    base: object = None  # SyntheticModelNet or SyntheticShapeNetPart
    hw: Tuple[int, int] = (64, 64)
    seed: int = 0

    def __post_init__(self):
        if self.base is None:
            self.base = SyntheticModelNet()
        self.K = default_intrinsics(self.hw)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index):
        sample = self.base[index]
        off = _split_offset(getattr(self.base, "split", "train"))
        rng = np.random.RandomState(
            (self.seed * 5_000_011 + off + index) % (2**32))
        if len(sample) == 2 and np.ndim(sample[1]) == 0:
            pts, label = sample  # classification base (ModelNet-style)
            seg = None
        elif len(sample) == 2:
            pts, seg = sample    # semseg base (IndoorScene-style)
            label = 0
        else:
            pts, cat, seg = sample  # partseg base
            label = cat
        xyz = pts[:, :3]
        R, t = random_viewpoint_extrinsics(rng)
        img = render_depth_image(xyz, self.K, R, t, self.hw)
        out = {"points": pts, "image": img, "K": self.K, "R": R, "t": t,
               "label": np.int32(label)}
        if seg is not None:
            out["seg"] = seg.astype(np.int32)
        return out


def semseg_request(batch: int, npoint: int = 2048, hw=(64, 64),
                   seed: int = 0) -> list:
    """One fusion_sem_seg request: ``batch`` S3DIS-style test blocks of
    ``npoint`` 9-dim points with their rendered views and cameras, as numpy
    [points, image, K, R, t]."""
    ds = SyntheticMultimodal(
        base=SyntheticIndoorScene(npoints=npoint, size=batch, seed=seed,
                                  split="test"), hw=hw, seed=seed)
    samples = [ds[i] for i in range(batch)]
    return [np.stack([s[k] for s in samples])
            for k in ("points", "image", "K", "R", "t")]
