"""Per-stage wall-time accounting for the EC pipeline and transport, and
the device trace hooks.

``maybe_trace`` and ``annotate`` are the JAX package's ``jax.profiler``
hooks on ``torch.profiler``: a trace of the CPU and the card written as a
Chrome trace under ``profile_dir/<label>`` (the JAX SW_PROFILE_DIR is an
argument here, off when empty), and a named region inside it."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple


@contextlib.contextmanager
def maybe_trace(label: str = "trace", profile_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` into
    ``<profile_dir>/<label>/trace.json`` when ``profile_dir`` is given;
    otherwise do nothing."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(profile_dir, label)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in a captured trace (a no-op outside tracing)."""
    from torch.profiler import record_function
    with record_function(name):
        yield


class StageTimer:
    """Accumulates wall time (and optionally bytes) per named stage, plus
    timestamped intervals for stages whose concurrency matters: transport
    fetches overlap across pool threads, and the interesting figure is the
    union of their busy windows. Thread-safe: the pipeline's reader and
    drain threads and the transport's pool report too."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self.intervals: Dict[str, List[Tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def add(self, stage: str, dt: float, nbytes: int = 0,
            interval: Optional[Tuple[float, float]] = None):
        with self._lock:
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            if nbytes:
                self.bytes[stage] = self.bytes.get(stage, 0) + nbytes
            if interval is not None:
                self.intervals.setdefault(stage, []).append(interval)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.add(name, end - t, nbytes, interval=(t, end))

    def busy_time(self, stage: str) -> float:
        """Union length of the stage's intervals (overlaps collapsed)."""
        with self._lock:
            ivs = sorted(self.intervals.get(stage, []))
        total, cur_start, cur_end = 0.0, None, None
        for s, e in ivs:
            if cur_end is None or s > cur_end:
                if cur_end is not None:
                    total += cur_end - cur_start
                cur_start, cur_end = s, e
            else:
                cur_end = max(cur_end, e)
        if cur_end is not None:
            total += cur_end - cur_start
        return total

    def rate_mbps(self, stage: str, use_busy: bool = False) -> float:
        t = self.busy_time(stage) if use_busy else self.totals.get(stage, 0.0)
        if t <= 0:
            return 0.0
        return self.bytes.get(stage, 0) / t / 1e6
