"""Device timing with CUDA events (the role of sppark's
util/cuda_timer_t.cuh)."""

from __future__ import annotations

from typing import Callable, List

import torch


class DeviceTimer:
    """Events recorded on the current stream around device work."""

    def __init__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._stop = torch.cuda.Event(enable_timing=True)
        self.elapsed_ms = 0.0

    def start(self) -> "DeviceTimer":
        self._start.record()
        return self

    def stop(self) -> float:
        self._stop.record()
        self._stop.synchronize()
        self.elapsed_ms = self._start.elapsed_time(self._stop)
        return self.elapsed_ms

    def __repr__(self):
        return f"{self.elapsed_ms:.3f} ms"


def time_ms(fn: Callable[[], object], reps: int = 10,
            warmup: int = 2) -> List[float]:
    """Per-call device times of `fn()` in ms, one event pair per call after
    `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        t = DeviceTimer().start()
        fn()
        out.append(t.stop())
    return out
