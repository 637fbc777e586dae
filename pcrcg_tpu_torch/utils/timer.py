"""Running-statistic meter and stopwatch for epoch loops (counterpart of
``pcrcg_tpu/utils/timer.py``; the reference's stats meters,
lib/timer.py:4-56)."""
from __future__ import annotations

import time


class RunningStat:
    """Online mean over scalar observations; keeps the latest value and the
    sum of squares for optional variance reporting."""

    __slots__ = ("last", "mean", "total", "total_sq", "n")

    def __init__(self):
        self.reset()

    def reset(self):
        self.last = 0.0
        self.mean = 0.0
        self.total = 0.0
        self.total_sq = 0.0
        self.n = 0

    def update(self, value, weight: int = 1):
        value = float(value)
        self.last = value
        self.total += value * weight
        self.total_sq += value * value * weight
        self.n += weight
        self.mean = self.total / self.n


class Stopwatch:
    """Accumulating stopwatch: ``tic``/``toc`` laps with a running mean;
    also usable as a context manager (``with Stopwatch() as t: ...``)."""

    __slots__ = ("accumulated", "laps", "_t0", "elapsed")

    def __init__(self):
        self.reset()

    def reset(self):
        self.accumulated = 0.0
        self.laps = 0
        self._t0 = 0.0
        self.elapsed = 0.0

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.elapsed = time.perf_counter() - self._t0
        self.accumulated += self.elapsed
        self.laps += 1
        return self.mean if average else self.elapsed

    @property
    def mean(self) -> float:
        return self.accumulated / self.laps if self.laps else 0.0

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc()
        return False
