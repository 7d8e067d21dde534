"""ctypes bindings of the native text parser (counterpart of
``mm3d_tpu/data/native_io.py``).

The library is built from the repository's ``native/pointcloud_io.cpp`` by
``g++`` into the package's ``build/libmm3d_io-<digest>.so``
(``ops._build.load_native``), at first use; the JAX package's own build in
``native/`` is never loaded. Without a compiler or the source,
``parse_table`` and ``parse_many`` return None and the loaders parse with
numpy instead: the parser is never a hard dependency, as in the JAX
package. ``load_error`` says why the library did not load.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            from mm3d_tpu_torch.ops import _build
            lib = _build.load_native("mm3d_io", "pointcloud_io.cpp")
            lib.mm3d_parse_table.restype = ctypes.c_int64
            lib.mm3d_parse_table.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64]
            lib.mm3d_parse_many.restype = None
            lib.mm3d_parse_many.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            _lib = lib
        except Exception as e:
            _error = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not load (None if it did or was not tried)."""
    _load()
    return _error


def parse_table(path: str, cols: int,
                max_rows: int = 200_000) -> Optional[np.ndarray]:
    """Parse a float text table; None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    while True:
        out = np.empty((max_rows, cols), np.float32)
        rows = lib.mm3d_parse_table(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_rows, cols)
        if rows < 0:
            raise FileNotFoundError(path)
        if rows < max_rows:
            return out[:rows].copy()
        # a full buffer may have cut the file short (the parser stops at
        # max_rows without saying so): parse again with twice the rows
        max_rows *= 2


def parse_many(paths: List[str], cols: int, max_rows: int = 200_000,
               n_threads: int = 4) -> Optional[List[np.ndarray]]:
    """Parse many tables with the native thread pool."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, max_rows, cols), np.float32)
    rows = np.empty(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.mm3d_parse_many(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_rows, cols, n_threads)
    bad = np.where(rows < 0)[0]
    if bad.size:  # -1: the file could not be opened or read
        raise FileNotFoundError(paths[int(bad[0])])
    # a full buffer may have cut a file short: parse it again with
    # parse_table's growing buffer
    return [parse_table(paths[i], cols, max_rows * 2)
            if rows[i] == max_rows else out[i, : rows[i]].copy()
            for i in range(n)]
