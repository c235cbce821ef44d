"""Per-stage wall-time accounting for the EC pipeline."""

from __future__ import annotations

import threading
from typing import Dict


class StageTimer:
    """Accumulates wall time (and optionally bytes) per named stage.
    Thread-safe: the pipeline's reader and drain threads report too."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, stage: str, dt: float, nbytes: int = 0):
        with self._lock:
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            if nbytes:
                self.bytes[stage] = self.bytes.get(stage, 0) + nbytes
