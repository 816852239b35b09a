"""Device-resident handle (the role of sppark's gpu_ptr_t / dev_ptr_t,
util/gpu_t.cuh:269).

Tensors are already refcounted device buffers; DevPtr adds the explicit
clone/drop lifecycle the reference exposes across its FFI (clone_gpu_ptr_t /
drop_gpu_ptr_t, util/all_gpus.cpp:56-76), so foreign callers can hold an
opaque integer handle.  The handle registers on first access of `.handle`,
not at construction: a DevPtr nobody asks a handle of never enters the
registry, and so never pins its tensors after its last Python reference
goes.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Optional


class DevPtr:
    """Opaque handle over a device-resident tuple of tensors."""

    _registry: dict = {}
    _ids = itertools.count(1)
    _lock = threading.Lock()

    def __init__(self, value: Any):
        self.value = value
        self._handle: Optional[int] = None
        self._refs = 1

    @property
    def handle(self) -> int:
        """The integer handle, registered on first access."""
        with DevPtr._lock:
            if self._handle is None:
                self._handle = next(DevPtr._ids)
                DevPtr._registry[self._handle] = self
            return self._handle

    @classmethod
    def from_handle(cls, handle: int) -> "DevPtr":
        ptr = cls._registry.get(handle)
        if ptr is None:
            raise KeyError(f"dangling DevPtr handle {handle}")
        return ptr

    def clone(self) -> "DevPtr":
        """One more reference to the same buffers (clone_gpu_ptr_t)."""
        with DevPtr._lock:
            self._refs += 1
        return self

    def drop(self) -> None:
        """Release one reference; the last one unregisters the handle and
        lets the buffers go (drop_gpu_ptr_t)."""
        with DevPtr._lock:
            self._refs -= 1
            if self._refs <= 0:
                if self._handle is not None:
                    DevPtr._registry.pop(self._handle, None)
                self.value = None
