"""The windowed stripe transport, pull role: what every EC data mover
that reads survivors stands on.

A *stripe* is one slab-aligned byte range ``[off, off+w)`` of every
shard. ``StripedPull`` fans the stripe's row reads out over a thread
pool, keeps at most ``window`` stripes in flight, and yields the stripes
strictly in order as ``(k, w)`` uint8 blocks (or whatever shape a
subclass assembles). In-flight memory is O(window * shards * slab), never
O(volume). Subclasses reshape the stream through the ``_stripe_nbytes``
/ ``_assemble`` hooks without touching the window, pool or ordering.

This is the JAX package's ``ec/transport.py`` pull side with its local
reader. Hedging stays off (the reference's ``SW_EC_HEDGE_MS=0``) and the
window defaults to ``DEFAULT_WINDOW``; the port reads no knob from the
environment. The remote readers and the push side come with the server
wiring.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..util.profiling import StageTimer

#: Stripes in flight (the JAX package's SW_EC_GATHER_WINDOW default).
DEFAULT_WINDOW = 4


class TransportStats:
    """Counters + busy-time accounting shared by every endpoint of one
    transport run. Busy time is the UNION of the transfer intervals and
    the stripe assemblies (transfers overlap across stripes and rows), so
    ``bytes / busy_s`` is the effective delivery rate. ``stage`` names the role and prefixes the
    snapshot keys."""

    stage = "transport"

    def __init__(self):
        self.timer = StageTimer()
        self._lock = threading.Lock()
        self.fetches = 0
        self.bytes = 0
        self.stripes = 0
        self.peak_buffered = 0

    def add_fetch(self, nbytes: int, t0: float, t1: float):
        self.timer.add(self.stage, t1 - t0, nbytes, interval=(t0, t1))
        with self._lock:
            self.fetches += 1
            self.bytes += nbytes

    def busy_s(self) -> float:
        return self.timer.busy_time(self.stage)

    def mbps(self) -> float:
        busy = self.busy_s()
        if busy <= 0:
            return 0.0
        return self.bytes / busy / 1e6

    def snapshot(self) -> Dict[str, float]:
        s = self.stage
        with self._lock:
            return {
                f"{s}_bytes": self.bytes,
                f"{s}_fetches": self.fetches,
                f"{s}_stripes": self.stripes,
                f"peak_{s}_buffer": self.peak_buffered,
            }


class GatherStats(TransportStats):
    """Pull-side role of the shared stats: snapshot keys are
    ``gather_*``."""

    stage = "gather"


class LocalShardReader:
    """Range reads of a shard on this node's disk. Opens per call: the
    pull pool reads several stripes of one shard concurrently, and a
    shared seek pointer would race."""

    def __init__(self, path: str, stats: Optional[TransportStats] = None):
        self.path = path
        self.stats = stats or GatherStats()

    def read(self, off: int, n: int) -> bytes:
        t0 = time.perf_counter()
        with open(self.path, "rb") as f:
            f.seek(off)
            data = f.read(n)
        if len(data) != n:
            raise IOError(f"short read of {self.path} at {off}: "
                          f"{len(data)} < {n}")
        self.stats.add_fetch(n, t0, time.perf_counter())
        return data


def remote_only(vid: int, sid: int, holders) -> NotImplementedError:
    """The error for a shard that only remote holders have. The port has
    no remote reader yet; such a shard is neither missing nor read some
    other way."""
    return NotImplementedError(
        f"volume {vid} shard {sid} is held only by remote holders "
        f"{list(holders)}, and the port has no remote shard reader")


class StripedPull:
    """The pull pump: ``slabs()`` yields ``((idx, off, w), block)``
    stripes in strict order, fetching up to ``window`` stripes ahead
    across a shared thread pool. ``readers`` are per-row endpoints, each
    with ``read(off, n) -> bytes``."""

    def __init__(self, readers: Sequence, shard_size: int,
                 slab: int = 8 << 20, window: Optional[int] = None,
                 stats: Optional[TransportStats] = None):
        if not readers:
            raise ValueError("no survivor readers")
        self.readers = list(readers)
        self.shard_size = int(shard_size)
        self.slab = max(1, int(slab))
        self.window = max(1, int(window) if window else DEFAULT_WINDOW)
        self.stats = stats if stats is not None else GatherStats()
        for r in self.readers:
            r.stats = self.stats
        self._buffered = 0
        self._lock = threading.Lock()

    def _note_buffered(self, delta: int):
        with self._lock:
            self._buffered += delta
            if self._buffered > self.stats.peak_buffered:
                self.stats.peak_buffered = self._buffered

    # stream-shape hooks
    def _stripe_nbytes(self, w: int) -> int:
        """Buffered bytes one in-flight stripe accounts for."""
        return len(self.readers) * w

    def _assemble(self, bufs: List[bytes], w: int) -> np.ndarray:
        """Row buffers of one stripe -> the block the consumer wants."""
        rows = [np.frombuffer(b, dtype=np.uint8) for b in bufs]
        return np.stack(rows, axis=0)

    def slabs(self):
        k = len(self.readers)
        stripes: List[Tuple[int, int]] = [
            (off, min(self.slab, self.shard_size - off))
            for off in range(0, self.shard_size, self.slab)]
        self.stats.stripes = len(stripes)
        if not stripes:
            return
        workers = min(16, max(2, min(self.window, len(stripes)) * k))
        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="ec-pull")
        pending: deque = deque()

        def submit(idx: int):
            off, w = stripes[idx]
            # account BEFORE the fetches start: in-flight rows are
            # buffered memory too, and the bound must hold even when
            # every submitted row completes before the consumer drains
            self._note_buffered(self._stripe_nbytes(w))
            futs = [pool.submit(self.readers[r].read, off, w)
                    for r in range(k)]
            pending.append((idx, off, w, futs))

        try:
            nxt = 0
            while nxt < len(stripes) and len(pending) < self.window:
                submit(nxt)
                nxt += 1
            while pending:
                idx, off, w, futs = pending.popleft()
                bufs = [f.result() for f in futs]
                # assembling the stripe is part of delivering it: its
                # interval joins the fetches' union, so the gather's busy
                # time (and the rebuild's overlap_frac) sees it on
                # whichever thread iterates the stream
                with self.stats.timer.stage(self.stats.stage):
                    data = self._assemble(bufs, w)
                self._note_buffered(-self._stripe_nbytes(w))
                if nxt < len(stripes):
                    submit(nxt)
                    nxt += 1
                yield (idx, off, w), data
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
