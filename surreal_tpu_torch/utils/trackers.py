"""Periodic triggers and throughput counters (port of
surreal_tpu/utils/trackers.py): every-N-steps / every-T-seconds triggers and
steps-per-second tracking feeding the metrics sink."""

from __future__ import annotations

import time


class PeriodicTracker:
    """Fires every `period` increments of a counter."""

    def __init__(self, period: int, init_count: int = 0):
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.period = period
        self._last_fire = init_count

    def track(self, count: int) -> bool:
        if count - self._last_fire >= self.period:
            self._last_fire += ((count - self._last_fire) // self.period) * self.period
            return True
        return False


class TimedTracker:
    """Fires every `interval` seconds of wall-clock."""

    def __init__(self, interval: float):
        self.interval = interval
        self._last = time.monotonic()

    def track(self) -> bool:
        now = time.monotonic()
        if now - self._last >= self.interval:
            self._last = now
            return True
        return False


class ThroughputTracker:
    """Exponentially-smoothed items/second."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self._last_t: float | None = None
        self._last_count = 0.0
        self.rate = 0.0

    def update(self, count: float) -> float:
        now = time.monotonic()
        if self._last_t is not None:
            dt = now - self._last_t
            if dt > 0:
                inst = (count - self._last_count) / dt
                self.rate = (
                    inst
                    if self.rate == 0.0
                    else self.smoothing * self.rate + (1 - self.smoothing) * inst
                )
        self._last_t = now
        self._last_count = count
        return self.rate
