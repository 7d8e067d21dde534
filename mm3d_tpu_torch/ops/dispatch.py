"""Implementation dispatch for the port's kernel-backed ops.

Every op has a plain PyTorch implementation (``geometry.py`` and the
``*_torch`` twins in ``cuda_kernels.py``) and a hand-written CUDA kernel
(``csrc/``). The mode selects between them:

* ``auto``  -- the kernel for CUDA tensors, the plain version for CPU tensors;
* ``torch`` -- the plain version everywhere (explicit; nothing on the serving
               path sets it);
* ``cuda``  -- the kernel always; a CPU tensor raises.

There is no fallback: a CUDA tensor in ``auto`` mode launches the kernel or
raises. The mode is read when an op is called (PyTorch runs eagerly, so
there is no trace-time caveat as in the JAX package).
"""

from __future__ import annotations

import contextlib
import threading

import torch

MODES = ("auto", "torch", "cuda")

# process-wide default (set_impl) plus a per-thread override (use_impl), so
# that worker threads see the default a caller set for the process
_GLOBAL_MODE = "auto"
_state = threading.local()


def _check(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown impl mode {mode!r}; expected one of {MODES}")


def set_impl(mode: str) -> None:
    """Set the PROCESS-WIDE mode ('auto'|'torch'|'cuda')."""
    global _GLOBAL_MODE
    _check(mode)
    _GLOBAL_MODE = mode


def get_impl() -> str:
    return getattr(_state, "mode", None) or _GLOBAL_MODE


@contextlib.contextmanager
def use_impl(mode: str):
    """Pin the mode FOR THIS THREAD; restores the previous override on exit."""
    _check(mode)
    prev = getattr(_state, "mode", None)
    _state.mode = mode
    try:
        yield
    finally:
        _state.mode = prev


def resolve(t: torch.Tensor) -> str:
    """'cuda' or 'torch': the implementation an op runs for tensor ``t``."""
    mode = get_impl()
    if mode == "torch":
        return "torch"
    if t.is_cuda:
        return "cuda"
    if mode == "cuda":
        raise RuntimeError(
            f"impl mode 'cuda' launches kernels only on CUDA tensors; got a "
            f"tensor on {t.device}")
    return "torch"
