"""Write throttler (reference weed/util/throttler.go).

A vacuum copies a volume's live needles next to live reads; the
reference caps those writes at a bytes-per-second budget
(compactionBytePerSecond, weed/storage/volume_vacuum.go:37). Call
``maybe_slowdown(n)`` after each write: it sleeps whenever the running
budget goes negative. 0 means unthrottled.
"""

from __future__ import annotations

import time


class WriteThrottler:
    WINDOW = 0.1  # budget granularity, seconds

    def __init__(self, bytes_per_second: int = 0):
        self.bps = int(bytes_per_second)
        self._budget = self.bps * self.WINDOW
        self._last = time.monotonic()

    def maybe_slowdown(self, n: int):
        if self.bps <= 0:
            return
        self._budget -= n
        if self._budget >= 0:
            return
        # refill from the elapsed time, then sleep off what is still owed
        now = time.monotonic()
        self._budget += (now - self._last) * self.bps
        self._last = now
        if self._budget < 0:
            slept = min(-self._budget / self.bps, 2.0)
            time.sleep(slept)
            # the sleep is not refill time for the next call, and a debt
            # past the 2 s cap carries over rather than being forgiven
            self._last = time.monotonic()
            self._budget += slept * self.bps
