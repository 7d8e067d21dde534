"""A per-thread stack of context values, the storage of the point-sharding
(``point_shard``) and data-parallel (``data_parallel``) contexts. A block
reads the innermost value when it runs (PyTorch is eager), per thread, as
``ops.dispatch``'s mode is."""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional


class ContextStack:
    """``push(value)`` is a context manager that makes ``value`` this
    thread's ``current()`` until it exits; None outside every push."""

    def __init__(self):
        self._tls = threading.local()

    def _stack(self) -> list:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    @contextlib.contextmanager
    def push(self, value: Any):
        s = self._stack()
        s.append(value)
        try:
            yield value
        finally:
            s.pop()

    def current(self) -> Optional[Any]:
        s = self._stack()
        return s[-1] if s else None
