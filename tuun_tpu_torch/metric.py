"""Fixed-bucket ring-buffer time series (port of the reference's metric.rs).

Tracks a value over a sliding window of wall-clock time, bucketed for
cheap HUD-style rendering: `set()` records into the current bucket,
`series()` returns the per-bucket averages oldest-first.  A clock function
can be injected for deterministic tests (the reference uses MockClock)."""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional


class Metric:
    def __init__(self, window_seconds: float = 10.0, buckets: int = 100,
                 clock: Callable[[], float] = _time.monotonic):
        self.window = window_seconds
        self.n = buckets
        self.bucket_seconds = window_seconds / buckets
        self.clock = clock
        self._sums = [0.0] * buckets
        self._counts = [0] * buckets
        self._epoch = clock()
        self._last_index: Optional[int] = None  # absolute bucket index

    def _advance(self) -> int:
        """Clears any buckets skipped since the last write, returns the
        current absolute bucket index."""
        now = self.clock()
        index = int((now - self._epoch) / self.bucket_seconds)
        if self._last_index is None:
            self._last_index = index
        gap = index - self._last_index
        if gap >= self.n:
            self._sums = [0.0] * self.n
            self._counts = [0] * self.n
        else:
            for i in range(self._last_index + 1, index + 1):
                self._sums[i % self.n] = 0.0
                self._counts[i % self.n] = 0
        self._last_index = index
        return index

    def set(self, value: float) -> None:
        i = self._advance() % self.n
        self._sums[i] += value
        self._counts[i] += 1

    def series(self) -> List[Optional[float]]:
        """Per-bucket averages, oldest to newest (None = no samples)."""
        index = self._advance()
        out: List[Optional[float]] = []
        for k in range(index - self.n + 1, index + 1):
            if k < 0:
                out.append(None)
                continue
            i = k % self.n
            out.append(self._sums[i] / self._counts[i]
                       if self._counts[i] else None)
        return out

    def latest(self) -> Optional[float]:
        s = self.series()
        for v in reversed(s):
            if v is not None:
                return v
        return None
