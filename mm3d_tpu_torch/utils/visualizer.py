"""Point-cloud rendering to an offline PNG (counterpart of
``mm3d_tpu/utils/visualizer.py``; the lineage's interactive show3d_balls
needs a display server).

Rendering uses the native z-buffer ball splatter, built from the
repository's ``native/render_balls.cpp`` by ``g++`` into the package's
``build/libmm3d_render-<digest>.so`` (``ops._build.load_native``), never the
JAX package's build in ``native/``; without it, a numpy splat with the same
contract. ``available`` says whether the native renderer is in use.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None

# a qualitative 13-color palette for segmentation labels
PALETTE = np.array([
    [0.65, 0.81, 0.89], [0.12, 0.47, 0.71], [0.70, 0.87, 0.54],
    [0.20, 0.63, 0.17], [0.98, 0.60, 0.60], [0.89, 0.10, 0.11],
    [0.99, 0.75, 0.44], [1.00, 0.50, 0.00], [0.79, 0.70, 0.84],
    [0.42, 0.24, 0.60], [1.00, 1.00, 0.60], [0.69, 0.35, 0.16],
    [0.50, 0.50, 0.50]], np.float32)


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            from mm3d_tpu_torch.ops import _build
            lib = _build.load_native("mm3d_render", "render_balls.cpp")
            lib.mm3d_render_balls.restype = None
            lib.mm3d_render_balls.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                ctypes.c_float]
            _lib = lib
        except Exception as e:
            _error = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def available() -> bool:
    """Whether the native renderer is built and loaded."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the native renderer did not load (None if it did)."""
    _load()
    return _error


def _render_numpy(pts, colors, h, w, focal, radius, bg):
    """The numpy ball splat, the native renderer's contract: ``radius`` is
    in world units, each point covers a disc of max(1, focal*radius/z)
    pixels, and the nearest point wins a pixel."""
    img = np.full((h, w, 3), bg, np.float32)
    z = pts[:, 2]
    ok = z > 1e-6
    u = focal * pts[:, 0] / np.maximum(z, 1e-6) + w / 2
    v = focal * pts[:, 1] / np.maximum(z, 1e-6) + h / 2
    ui = np.round(u[ok]).astype(int)
    vi = np.round(v[ok]).astype(int)
    zk = z[ok]
    ck = colors[ok]
    if not len(zk):
        return img
    r_px = np.maximum(1.0, focal * radius / zk)  # per-point, like native
    rmax = int(np.ceil(r_px.max()))
    dy, dx = np.mgrid[-rmax:rmax + 1, -rmax:rmax + 1]
    dy, dx = dy.ravel(), dx.ravel()
    keep = (dy[None, :] ** 2 + dx[None, :] ** 2) <= r_px[:, None] ** 2
    # splat every kept disc offset, far-first so the nearest write wins
    vv = (vi[:, None] + dy[None, :])[keep]
    uu = (ui[:, None] + dx[None, :])[keep]
    zz = np.broadcast_to(zk[:, None], keep.shape)[keep]
    cc = np.broadcast_to(ck[:, None, :], keep.shape + (3,))[keep]
    inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
    order = np.argsort(-zz[inb])
    img[vv[inb][order], uu[inb][order]] = cc[inb][order]
    return img


def render_points(points: np.ndarray, colors: Optional[np.ndarray] = None,
                  labels: Optional[np.ndarray] = None, hw=(480, 480),
                  camera_distance: float = 2.5, elevation: float = 0.4,
                  azimuth: float = 0.6, ball_radius: float = 0.012,
                  background: float = 1.0) -> np.ndarray:
    """Render a point cloud to an RGB float image [H,W,3].

    colors: [N,3] in [0,1]; labels: int per point -> palette colors;
    default: depth-shaded single color.
    """
    pts = np.asarray(points, np.float32)[:, :3]
    n = len(pts)
    if labels is not None:
        colors = PALETTE[np.asarray(labels) % len(PALETTE)]
    if colors is None:
        colors = np.tile(np.array([[0.25, 0.45, 0.85]], np.float32), (n, 1))
    colors = np.ascontiguousarray(colors, np.float32)

    # normalized cloud -> camera frame (look-at origin)
    c = pts - pts.mean(0, keepdims=True)
    c = c / (np.abs(c).max() + 1e-9)
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    ce, se = np.cos(elevation), np.sin(elevation)
    rot_y = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
    rot_x = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]], np.float32)
    cam = c @ rot_y.T @ rot_x.T
    cam[:, 2] += camera_distance
    cam = np.ascontiguousarray(cam, np.float32)

    h, w = hw
    focal = 0.9 * min(h, w)
    lib = _load()
    if lib is None:
        return _render_numpy(cam, colors, h, w, focal, ball_radius,
                             background)
    img = np.empty((h, w, 3), np.float32)
    lib.mm3d_render_balls(
        cam.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, focal, ball_radius, background)
    return img


def save_png(path: str, img: np.ndarray) -> None:
    """Write an [H,W,3] float image to PNG (PIL, else matplotlib)."""
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image
        Image.fromarray(arr).save(path)
        return
    except Exception:
        pass
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.imsave(path, arr)


def show_points(points, labels=None, colors=None, out_path="cloud.png",
                **kw) -> str:
    """One-call equivalent of the reference's show3d_balls.showpoints:
    renders and writes a PNG, returns the path."""
    img = render_points(points, colors=colors, labels=labels, **kw)
    save_png(out_path, img)
    return out_path
