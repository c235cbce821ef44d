"""Device-dispatch counters for the EC hot paths.

Every device dispatch, coefficient-constant upload and host-path
small-read fallback increments a process-global counter, and
rebuild_ec_files / write_ec_files report the deltas so a regression to
per-slab uploads (or to no device dispatch at all) shows up as a count
instead of hiding inside wall time.
"""

from __future__ import annotations

import threading


class DispatchStats:
    """Monotonic process-global counters (thread-safe)."""

    _FIELDS = ("dispatches", "bitmat_uploads", "host_fallbacks",
               "device_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def add(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


STATS = DispatchStats()


def delta(before: dict) -> dict:
    """Counter movement since a snapshot() — the per-operation report."""
    now = STATS.snapshot()
    return {f: now[f] - before.get(f, 0) for f in DispatchStats._FIELDS}
