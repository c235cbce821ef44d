"""The windowed stripe transport, pull role: what every EC data mover
that reads survivors stands on.

A *stripe* is one slab-aligned byte range ``[off, off+w)`` of every
shard. ``StripedPull`` fans the stripe's row reads out over a thread
pool, keeps at most ``window`` stripes in flight, and yields the stripes
strictly in order as ``(k, w)`` uint8 blocks (or whatever shape a
subclass assembles). In-flight memory is O(window * shards * slab), never
O(volume). Subclasses reshape the stream through the ``_stripe_nbytes``
/ ``_assemble`` hooks without touching the window, pool or ordering.

Straggler defenses of the remote reader:
  * rotation: stripe ``s`` leads with holder ``s % len(holders)``, so
    consecutive stripes of a replicated shard split across its holders;
  * failover: a failed pull retries the remaining holders in rotation
    order (each retry counted);
  * hedging (``hedge_ms``, default 0: off): a pull past the deadline
    races a duplicate on the next holder; the loser is never cancelled
    (its response drains in the hedge pool, so the socket goes back to
    the keep-alive pool) and the loss is charged to the slow holder on
    the health board;
  * health routing (``routing``, default off): holders scoring below 0.5
    on ``stats.health.BOARD`` sort to the back of the failover order.

This is the JAX package's ``ec/transport.py`` pull side, local and
remote readers. The window defaults to ``DEFAULT_WINDOW``, the hedge to
off and routing to off, each the JAX default of its knob; the port reads
no knob from the environment. The push side is not ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                TimeoutError as _FutureTimeout, wait)
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..server.http_util import HttpError, http_call
from ..stats.health import BOARD
from ..util.profiling import StageTimer

#: Stripes in flight (the JAX package's SW_EC_GATHER_WINDOW default).
DEFAULT_WINDOW = 4
#: Hedge deadline in ms, 0 = off (the JAX SW_EC_HEDGE_MS default).
DEFAULT_HEDGE_MS = 0.0

# hedged duplicates run here rather than in the mover's own pool: a
# stripe worker submitting back into its (possibly saturated) pool could
# deadlock the window
_HEDGE_POOL: Optional[ThreadPoolExecutor] = None
_HEDGE_LOCK = threading.Lock()


def hedge_pool() -> ThreadPoolExecutor:
    global _HEDGE_POOL
    with _HEDGE_LOCK:
        if _HEDGE_POOL is None:
            _HEDGE_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="ec-transport-hedge")
        return _HEDGE_POOL


class TransportStats:
    """Counters + busy-time accounting shared by every endpoint of one
    transport run. Busy time is the UNION of the transfer intervals and
    the stripe assemblies (transfers overlap across stripes and rows), so
    ``bytes / busy_s`` is the effective delivery rate. ``stage`` names
    the role and prefixes the snapshot keys."""

    stage = "transport"

    def __init__(self):
        self.timer = StageTimer()
        self._lock = threading.Lock()
        self.fetches = 0
        self.bytes = 0
        self.remote_bytes = 0
        self.hedges_fired = 0
        self.hedges_won = 0
        self.hedges_lost = 0
        self.retries = 0
        # a push target handed to a spare; the push side (not ported yet)
        # counts it, a pull reports the JAX snapshot's key at 0
        self.failovers = 0
        self.stripes = 0
        self.peak_buffered = 0
        self.remote_shards = 0
        self.local_shards = 0
        # transfers and failures per holder, so "routing sends fewer
        # reads to the slow holder" can be asserted
        self.holder_fetches: Dict[str, int] = {}
        self.holder_errors: Dict[str, int] = {}

    def add_fetch(self, nbytes: int, t0: float, t1: float,
                  remote: bool = False, holder: Optional[str] = None):
        self.timer.add(self.stage, t1 - t0, nbytes, interval=(t0, t1))
        with self._lock:
            self.fetches += 1
            self.bytes += nbytes
            if remote:
                self.remote_bytes += nbytes
            if holder:
                self.holder_fetches[holder] = \
                    self.holder_fetches.get(holder, 0) + 1

    def add_holder_error(self, holder: str):
        with self._lock:
            self.holder_errors[holder] = \
                self.holder_errors.get(holder, 0) + 1

    def add_hedge_fired(self):
        with self._lock:
            self.hedges_fired += 1

    def add_hedge_won(self):
        with self._lock:
            self.hedges_won += 1

    def add_hedge_lost(self):
        with self._lock:
            self.hedges_lost += 1

    def add_retry(self):
        with self._lock:
            self.retries += 1

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
                f"{s}_remote_bytes": self.remote_bytes,
                f"{s}_fetches": self.fetches,
                f"{s}_stripes": self.stripes,
                f"{s}_retries": self.retries,
                f"{s}_failovers": self.failovers,
                f"peak_{s}_buffer": self.peak_buffered,
                "hedges_fired": self.hedges_fired,
                "hedges_won": self.hedges_won,
                "hedges_lost": self.hedges_lost,
                "holder_fetches": dict(self.holder_fetches),
                "holder_errors": dict(self.holder_errors),
            }


class GatherStats(TransportStats):
    """Pull-side role of the shared stats: snapshot keys are
    ``gather_*``."""

    stage = "gather"


class LocalShardReader:
    """Range reads of a shard on this node's disk. Opens per call: the
    pull pool reads several stripes of one shard concurrently, and a
    shared seek pointer would race."""

    remote = False

    def __init__(self, path: str, stats: Optional[TransportStats] = None):
        self.path = path
        self.stats = stats or GatherStats()

    def read(self, off: int, n: int, stripe_idx: int = 0) -> bytes:
        t0 = time.perf_counter()
        with open(self.path, "rb") as f:
            f.seek(off)
            data = f.read(n)
        if len(data) != n:
            raise IOError(f"short read of {self.path} at {off}: "
                          f"{len(data)} < {n}")
        self.stats.add_fetch(n, t0, time.perf_counter())
        return data


class RemoteShardReader:
    """Ranged reads of one shard from its holder set over
    ``/admin/ec/shard_read``, with rotation by stripe, failover retries,
    optional hedging and optional health routing."""

    remote = True
    # transport hooks: the repair and plane readers hit their routes with
    # another method and response size, and inherit rotation, failover
    # and hedging unchanged
    _method = "GET"
    # the health board's latency kind for this reader's fetches
    _health_kind = "shard_read"

    def __init__(self, vid: int, sid: int, holders: Sequence[str],
                 stats: Optional[TransportStats] = None,
                 timeout: float = 300.0,
                 hedge_ms: Optional[float] = None,
                 routing: bool = False):
        if not holders:
            raise ValueError(f"shard {vid}.{sid}: no holders")
        self.vid = vid
        self.sid = sid
        self.holders = list(holders)
        self.stats = stats or GatherStats()
        self.timeout = timeout
        self.hedge_s = (DEFAULT_HEDGE_MS if hedge_ms is None
                        else float(hedge_ms)) / 1000.0
        self.routing = routing

    def _url(self, holder: str, off: int, n: int) -> str:
        return (f"http://{holder}/admin/ec/shard_read?volume={self.vid}"
                f"&shard={self.sid}&offset={off}&size={n}")

    def _expect_len(self, n: int) -> int:
        """Response bytes expected for an n-byte shard range."""
        return n

    def _read_one(self, holder: str, off: int, n: int) -> bytes:
        expect = self._expect_len(n)
        t0 = time.perf_counter()
        try:
            data = http_call(self._method, self._url(holder, off, n),
                             timeout=self.timeout)
            if len(data) != expect:
                raise HttpError(
                    502, f"short shard read {self.vid}.{self.sid} from "
                         f"{holder} at {off}: {len(data)} < {expect}")
        except Exception:
            self.stats.add_holder_error(holder)
            BOARD.record_error(holder)
            raise
        t1 = time.perf_counter()
        self.stats.add_fetch(len(data), t0, t1, remote=True, holder=holder)
        BOARD.record_latency(holder, self._health_kind, t1 - t0)
        return data

    def _read_failover(self, order: Sequence[str], off: int,
                       n: int) -> bytes:
        last = None
        for i, holder in enumerate(order):
            if i:
                self.stats.add_retry()
            try:
                return self._read_one(holder, off, n)
            except Exception as e:  # noqa: BLE001 - try the next holder
                last = e
        raise last

    def _attribute_hedge_loss(self, loser_future, loser: str, winner: str):
        """The race is decided: when the losing duplicate finishes
        draining (maybe much later), charge the loss to its holder. Its
        latency is recorded by its own ``_read_one``."""
        self.stats.add_hedge_lost()
        loser_future.add_done_callback(
            lambda _f: BOARD.record_hedge_loss(loser, winner))

    def read(self, off: int, n: int, stripe_idx: int = 0) -> bytes:
        h = self.holders
        # rotation spreads load (consecutive stripes of a replicated
        # shard split across its holders) and fixes the failover and
        # hedge order for this stripe
        order = [h[(stripe_idx + j) % len(h)] for j in range(len(h))]
        if len(order) > 1 and self.routing:
            # unhealthy holders to the back, stable within each class
            order = BOARD.order_by_health(order)
        if self.hedge_s <= 0 or len(order) < 2:
            return self._read_failover(order, off, n)
        ex = hedge_pool()
        primary = ex.submit(self._read_one, order[0], off, n)
        try:
            return primary.result(timeout=self.hedge_s)
        except _FutureTimeout:
            pass
        except Exception:  # noqa: BLE001 - fast failure: plain failover
            self.stats.add_retry()
            return self._read_failover(order[1:], off, n)
        # the leading holder is past the deadline: race a duplicate on
        # the next one; the first success wins and the loser drains in
        # the pool thread, its socket back to the connection pool
        self.stats.add_hedge_fired()
        secondary = ex.submit(self._read_one, order[1], off, n)
        pending = {primary, secondary}
        last = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                err = f.exception()
                if err is None:
                    if f is secondary:
                        self.stats.add_hedge_won()
                        self._attribute_hedge_loss(primary, order[0],
                                                   order[1])
                    else:
                        self._attribute_hedge_loss(secondary, order[1],
                                                   order[0])
                    return f.result()
                last = err
        if len(order) > 2:
            self.stats.add_retry()
            return self._read_failover(order[2:], off, n)
        raise last


class StripedPull:
    """The pull pump: ``slabs()`` yields ``((idx, off, w), block)``
    stripes in strict order, fetching up to ``window`` stripes ahead
    across a shared thread pool. ``readers`` are per-row endpoints, local
    files and remote holders mixed freely, each with
    ``read(off, n, stripe_idx) -> bytes``."""

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
        self.stats.remote_shards = sum(
            1 for r in self.readers if getattr(r, "remote", False))
        self.stats.local_shards = len(self.readers) - \
            self.stats.remote_shards
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
            futs = [pool.submit(self.readers[r].read, off, w, idx)
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
