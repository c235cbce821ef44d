"""Per-stage wall-time accounting for the EC pipeline and transport, the
device trace hooks and the host profilers.

``maybe_trace`` and ``annotate`` are the JAX package's ``jax.profiler``
hooks on ``torch.profiler``: a trace of the CPU and the card written as a
Chrome trace under ``profile_dir/<label>`` (the JAX SW_PROFILE_DIR is an
argument here, off when empty), and a named region inside it.
``cpu_profile`` (cProfile of one thread) and ``SamplingProfiler`` (every
thread's Python stack sampled on an interval, reported as collapsed
stacks: what ``POST /admin/profile`` returns) are the JAX package's."""

from __future__ import annotations

import contextlib
import cProfile
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


@contextlib.contextmanager
def cpu_profile(path: Optional[str]):
    """cProfile the enclosed block into ``path`` (pstats format)."""
    if not path:
        yield
        return
    prof = cProfile.Profile()
    prof.enable()
    try:
        yield
    finally:
        prof.disable()
        prof.dump_stats(path)


class SamplingProfiler:
    """All-thread wall-clock stack sampler.

    A daemon thread snapshots every thread's Python stack
    (``sys._current_frames()``) every ``interval`` seconds and counts
    collapsed stacks. ``stop()`` writes one ``frame;frame;... count``
    line per distinct stack — the folded format flamegraph.pl and
    speedscope ingest directly. Overhead is one GIL-held walk per
    sample (~10-50us), fine at the default 10ms period.
    """

    def __init__(self, path: Optional[str], interval: float = 0.01):
        self.path = path
        self.interval = float(interval)
        self.counts: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sampling-profiler")

    def start(self) -> "SamplingProfiler":
        self._thread.start()
        return self

    def _run(self):
        import sys
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            for tid, top in sys._current_frames().items():
                if tid == me:
                    continue
                frames = []
                f = top
                while f is not None and len(frames) < 64:
                    code = f.f_code
                    frames.append(
                        f"{code.co_name} "
                        f"({code.co_filename.rsplit('/', 1)[-1]}:"
                        f"{f.f_lineno})")
                    f = f.f_back
                key = ";".join(reversed(frames))
                self.counts[key] = self.counts.get(key, 0) + 1

    def report(self) -> str:
        """Collapsed-stack text (``frame;frame;... count`` per line,
        hottest first) from the samples gathered so far."""
        return "".join(
            f"{stack} {n}\n"
            for stack, n in sorted(self.counts.items(),
                                   key=lambda kv: -kv[1]))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        if self.path:
            with open(self.path, "w") as out:
                out.write(self.report())

    @classmethod
    def run_for(cls, seconds: float,
                interval: float = 0.01) -> str:
        """Sample every thread for ``seconds`` and return the collapsed
        stacks — the `POST /admin/profile` path, no file involved."""
        prof = cls(None, interval=interval).start()
        try:
            time.sleep(max(0.0, float(seconds)))
        finally:
            prof.stop()
        return prof.report()


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
