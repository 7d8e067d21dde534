"""Build and load the hand-written CUDA kernels in ``mm3d_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, ``build/lib<name>-<digest>.so`` inside the
package, and loaded with ``ctypes``. The digest covers the source, every
``csrc/*.cuh`` header and the compiler flags, so an edited source builds anew
and an unchanged one is reused. The build runs at first use; ``build()``
starts one ``nvcc`` per source, all at once. A failed build raises with
nvcc's output.

Nothing here runs at import time: the CPU tests import every module of the
package on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("fps", "ball_query", "fused_sa", "gather_bwd", "fused_fp",
           "bilinear", "three_nn", "three_interp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas report (registers, shared memory, spills) of each library built in
# this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the mm3d_tpu_torch kernels")
    return path


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs = [os.path.join(CSRC_DIR, f"{name}.cu")]
    srcs += sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile the named sources that are not built yet, in parallel.

    Returns the wall seconds spent. Raises RuntimeError with nvcc's output
    if any compile fails."""
    t0 = time.perf_counter()
    todo = [(n, lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not os.path.exists(p)]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib: Optional[ctypes.CDLL] = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            lib.mm3d_error_string.argtypes = [ctypes.c_int]
            lib.mm3d_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib
