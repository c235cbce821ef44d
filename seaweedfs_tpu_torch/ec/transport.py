"""The windowed stripe transport: what every EC data mover stands on, a
*pull* side (``StripedPull``: stripe readers fan out over a pool,
stripes yield strictly in order) and a *push* side (``StripedPush``:
per-target workers drain bounded send queues, merging contiguous runs).

A *stripe* is one slab-aligned byte range ``[off, off+w)`` of every
shard. The pull side materializes it as a ``(k, w)`` uint8 block for the
decode (or whatever shape a subclass assembles through the
``_stripe_nbytes`` / ``_assemble`` hooks); the push side receives it as
``(k, w)`` data + ``(m, w)`` parity rows from the encode. In-flight
memory is O(window * shards * slab) on either side, never O(volume).

Straggler defenses (shared):
  * rotation: stripe ``s`` leads with holder ``s % len(holders)``, so
    consecutive stripes of a replicated shard split across its holders;
  * failover: a failed pull retries the remaining holders in rotation
    order (each retry counted); a push target that dies before acking
    any byte hands its shard set to a spare and replays from offset 0;
  * hedging (``hedge_ms``, default 0: off): a pull past the deadline
    races a duplicate on the next holder; a first push run past the
    deadline races a duplicate stage on a spare target. The loser is
    never cancelled (its response drains in the hedge pool, so the
    socket goes back to the keep-alive pool) and the loss is charged to
    the slow holder on the health board;
  * health routing (``routing``, default off): holders scoring below 0.5
    on ``stats.health.BOARD`` sort to the back of the pull failover
    order; the healthiest spare is taken first on push failover.

This is the JAX package's ``ec/transport.py``, both roles. The windows
default to ``DEFAULT_WINDOW``, the hedge to off and routing to off, each
the JAX default of its knob; the port reads no knob from the
environment.

Tracing, as in JAX: pool and worker threads do not inherit the tracing
contextvar, so each reader and writer carries its pump's
``parent_span`` and sends that span's ``traceparent`` itself (the
holders' ``shard_read`` / ``shard_write`` spans join the caller's
trace). The pull side records one ``gather.stripe`` span a stripe (op
``ec.rebuild.gather``), the push side one ``spread.run`` span a run
sent (op ``ec.encode.spread``), both under ``parent_span``.
"""

from __future__ import annotations

import os
import queue
import re
import threading
import time
from collections import deque
from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                TimeoutError as _FutureTimeout, wait)
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..server.http_util import HttpError, http_call, post_chunked
from ..stats.health import BOARD
from ..util import tracing
from ..util.locks import make_lock
from ..util.profiling import StageTimer

#: Stripes in flight (the JAX package's SW_EC_GATHER_WINDOW and
#: SW_EC_SPREAD_WINDOW default).
DEFAULT_WINDOW = 4
#: Hedge deadline in ms, 0 = off (the JAX SW_EC_HEDGE_MS default).
DEFAULT_HEDGE_MS = 0.0

_STAGED_RE = re.compile(r"staged=(\d+)")

_SENTINEL = object()


def push_window() -> int:
    """Stripes a push target may have queued per shard it takes."""
    return DEFAULT_WINDOW

# hedged duplicates run here rather than in the mover's own pool: a
# stripe worker submitting back into its (possibly saturated) pool could
# deadlock the window
_HEDGE_POOL: Optional[ThreadPoolExecutor] = None
_HEDGE_LOCK = make_lock("torch.transport._HEDGE_LOCK")


def hedge_pool() -> ThreadPoolExecutor:
    global _HEDGE_POOL
    with _HEDGE_LOCK:
        if _HEDGE_POOL is None:
            _HEDGE_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="ec-transport-hedge")
        return _HEDGE_POOL


class SpreadError(Exception):
    """A transport operation failed beyond what retry and failover can
    absorb (the JAX package's name: the push side raised it first)."""


class TransportStats:
    """Counters + busy-time accounting shared by every endpoint of one
    transport run. Busy time is the UNION of the transfer intervals
    (transfers overlap across stripes, rows and targets), so
    ``bytes / busy_s`` is the effective bandwidth. ``stage`` names the
    role and prefixes the snapshot keys."""

    stage = "transport"

    def __init__(self):
        self.timer = StageTimer()
        self._lock = make_lock("torch.transport.TransportStats._lock")
        self.fetches = 0
        self.sends = 0
        self.bytes = 0
        self.remote_bytes = 0
        self.hedges_fired = 0
        self.hedges_won = 0
        self.hedges_lost = 0
        self.retries = 0
        # a push target handed to its spare (a pull reports 0)
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

    def add_send(self, nbytes: int, t0: float, t1: float,
                 holder: Optional[str] = None):
        self.timer.add(self.stage, t1 - t0, nbytes, interval=(t0, t1))
        with self._lock:
            self.sends += 1
            self.bytes += nbytes
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

    def add_failover(self):
        with self._lock:
            self.failovers += 1

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
                f"{s}_sends": self.sends,
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


class SpreadStats(TransportStats):
    """Push-side role of the shared stats: snapshot keys are
    ``spread_*``."""

    stage = "spread"


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
        self.span = None     # set by StripedPull: the trace parent
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
        # pool and hedge threads do not inherit the tracing contextvar:
        # the caller span's traceparent goes out explicitly
        hdrs = None
        if self.span is not None:
            hdrs = {tracing.TRACEPARENT_HEADER: self.span.traceparent()}
        expect = self._expect_len(n)
        t0 = time.perf_counter()
        try:
            data = http_call(self._method, self._url(holder, off, n),
                             headers=hdrs, timeout=self.timeout)
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

    span_name = "gather.stripe"
    span_op = "ec.rebuild.gather"

    def __init__(self, readers: Sequence, shard_size: int,
                 slab: int = 8 << 20, window: Optional[int] = None,
                 stats: Optional[TransportStats] = None,
                 parent_span=None):
        if not readers:
            raise ValueError("no survivor readers")
        self.readers = list(readers)
        self.shard_size = int(shard_size)
        self.slab = max(1, int(slab))
        self.window = max(1, int(window) if window else DEFAULT_WINDOW)
        self.stats = stats if stats is not None else GatherStats()
        self.parent_span = parent_span
        for r in self.readers:
            r.stats = self.stats
            r.span = parent_span
        self.stats.remote_shards = sum(
            1 for r in self.readers if getattr(r, "remote", False))
        self.stats.local_shards = len(self.readers) - \
            self.stats.remote_shards
        self._buffered = 0
        self._lock = make_lock("torch.transport.StripedPull._lock")

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
            t_sub = time.perf_counter()
            futs = [pool.submit(self.readers[r].read, off, w, idx)
                    for r in range(k)]
            pending.append((idx, off, w, t_sub, futs))

        try:
            nxt = 0
            while nxt < len(stripes) and len(pending) < self.window:
                submit(nxt)
                nxt += 1
            while pending:
                idx, off, w, t_sub, futs = pending.popleft()
                data = self._assemble([f.result() for f in futs], w)
                tracing.record_span(
                    self.span_name, time.perf_counter() - t_sub,
                    parent=self.parent_span, op=self.span_op,
                    stripe=idx, offset=off,
                    bytes=self._stripe_nbytes(w))
                self._note_buffered(-self._stripe_nbytes(w))
                if nxt < len(stripes):
                    submit(nxt)
                    nxt += 1
                yield (idx, off, w), data
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# push side: stripe writers


class LocalShardWriter:
    """Fast path for shards this node keeps: append to the local
    ``.part`` stage file, atomic rename on finalize (the same
    no-partial-shards contract the remote protocol gives)."""

    remote = False

    def __init__(self, path: str,
                 stats: Optional[TransportStats] = None):
        self.path = path
        self.part = path + ".part"
        self.stats = stats or SpreadStats()
        self.span = None
        self._f = None

    def send(self, url: Optional[str], off: int,
             chunks: Sequence[bytes]) -> int:
        t0 = time.perf_counter()
        if self._f is None:
            self._f = open(self.part, "wb" if off == 0 else "ab")
        if self._f.tell() != off:
            raise SpreadError(
                f"local shard write offset mismatch for {self.path}: "
                f"staged={self._f.tell()} offset={off}")
        n = 0
        for c in chunks:
            self._f.write(c)
            n += len(c)
        self.stats.add_send(n, t0, time.perf_counter())
        return n

    def finalize(self, url: Optional[str], size: int):
        if self._f is not None:
            self._f.close()
            self._f = None
        staged = os.path.getsize(self.part) if os.path.exists(self.part) \
            else -1
        if staged != size:
            raise SpreadError(
                f"local shard {self.path}: staged {staged} != {size}")
        os.replace(self.part, self.path)

    def abort(self, url: Optional[str]):
        if self._f is not None:
            self._f.close()
            self._f = None
        try:
            os.remove(self.part)
        except OSError:
            pass


class RemoteShardWriter:
    """Pushes one shard's slab ranges to its holder: each run of
    contiguous chunks goes out as ONE chunked POST to
    ``/admin/ec/shard_write`` (append at the expected offset, 409 on a
    mismatch). Every send feeds the health board under the
    ``shard_write`` kind, so the push path sees slow holders as the pull
    path does."""

    remote = True
    _health_kind = "shard_write"

    def __init__(self, vid: int, sid: int, collection: str = "",
                 stats: Optional[TransportStats] = None,
                 timeout: float = 300.0):
        self.vid = vid
        self.sid = sid
        self.collection = collection
        self.stats = stats or SpreadStats()
        self.span = None     # set by StripedPush: the trace parent
        self.timeout = timeout

    def _url(self, holder: str, query: str) -> str:
        return (f"http://{holder}/admin/ec/shard_write?volume={self.vid}"
                f"&collection={self.collection}&shard={self.sid}&{query}")

    def _headers(self) -> Optional[dict]:
        # worker threads do not inherit the tracing contextvar
        if self.span is None:
            return None
        return {tracing.TRACEPARENT_HEADER: self.span.traceparent()}

    def send(self, url: str, off: int, chunks: Sequence[bytes]) -> int:
        n = sum(len(c) for c in chunks)
        t0 = time.perf_counter()
        try:
            post_chunked(self._url(url, f"offset={off}"), chunks,
                         headers=self._headers(), timeout=self.timeout)
        except HttpError as e:
            if e.status == 409:
                # the holder's staged size disagrees; if it already
                # covers this run the previous delivery merely lost its
                # ack: don't re-append, don't fail
                m = _STAGED_RE.search(str(e))
                if m and int(m.group(1)) == off + n:
                    self.stats.add_send(n, t0, time.perf_counter(),
                                        holder=url)
                    return n
            self.stats.add_holder_error(url)
            BOARD.record_error(url)
            raise
        except Exception:
            self.stats.add_holder_error(url)
            BOARD.record_error(url)
            raise
        t1 = time.perf_counter()
        self.stats.add_send(n, t0, t1, holder=url)
        BOARD.record_latency(url, self._health_kind, t1 - t0)
        return n

    def finalize(self, url: str, size: int):
        http_call("POST", self._url(url, f"action=finalize&size={size}"),
                  headers=self._headers(), timeout=self.timeout)

    def abort(self, url: str):
        try:
            http_call("POST", self._url(url, "action=abort"),
                      headers=self._headers(), timeout=30.0)
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass


class TargetWorker(threading.Thread):
    """Drains one target's bounded send queue: pops queued
    ``(sid, off, chunk)`` items, merges per-shard contiguous runs, and
    sends each run as one chunked POST. Owns the target url, so failover
    (every shard of a dead target to a spare) is a single-variable swap.
    The FIRST run to a remote target may be hedged: past the ``hedge_ms``
    deadline the same run races a duplicate stage on a spare, the first
    ack wins the shard set, and the loser's stage is aborted once its
    send drains."""

    def __init__(self, sink: "StripedPush", url: Optional[str],
                 sids: List[int], window: int):
        super().__init__(daemon=True, name=f"ec-push-{url or 'local'}")
        self.sink = sink
        self.url = url
        self.sids = list(sids)
        self.max_batch = max(1, window * len(sids))
        self.q: queue.Queue = queue.Queue(maxsize=self.max_batch)
        self.acked = 0

    def run(self):
        try:
            stop = False
            while not stop:
                try:
                    item = self.q.get(timeout=0.1)
                except queue.Empty:
                    if self.sink.failed is not None:
                        return
                    continue
                batch = []
                while True:
                    if item is _SENTINEL:
                        stop = True
                        break
                    batch.append(item)
                    if len(batch) >= self.max_batch:
                        break
                    try:
                        item = self.q.get_nowait()
                    except queue.Empty:
                        break
                for sid, off, chunks in merge_runs(batch):
                    n = self._send_run(sid, off, chunks)
                    self.sink._note_buffered(-n)
        except BaseException as e:  # noqa: BLE001 - surfaced to the producer
            self.sink._fail(e)

    def _send_run(self, sid: int, off: int, chunks) -> int:
        writer = self.sink.writers[sid]
        n = sum(len(c) for c in chunks)
        if (self.sink.hedge_s > 0 and self.url is not None
                and self.acked == 0 and off == 0):
            if self._send_run_hedged(writer, off, chunks, n):
                self._trace_run(sid, off, n)
                return n
        while True:
            last = None
            for attempt in range(2):
                if attempt:
                    self.sink.stats.add_retry()
                try:
                    writer.send(self.url, off, chunks)
                    self.acked += n
                    self._trace_run(sid, off, n)
                    return n
                except BaseException as e:  # noqa: BLE001 - retry/failover
                    last = e
            if self.acked > 0 or off != 0 or self.url is None:
                # bytes already landed on this target (or it is the local
                # disk): the dead holder's prefix is unreplayable, since
                # the stripe stream never kept it
                raise last
            spare = self.sink._take_spare(self.url)
            if spare is None:
                raise last
            dead, self.url = self.url, spare
            self.sink.stats.add_failover()
            writer.abort(dead)

    def _send_run_hedged(self, writer, off: int, chunks, n: int) -> bool:
        """Hedge the first run of this target: if the leading holder has
        not acked within the deadline, race the same run against a
        spare's stage. True when the run landed (possibly after swapping
        ``self.url`` to the winning spare); False hands the run to the
        plain retry/failover path, where a duplicate re-send is safe
        because the holder's 409 ``staged=`` identifies a
        delivered-but-unacked run."""
        ex = hedge_pool()
        primary = ex.submit(writer.send, self.url, off, chunks)
        try:
            primary.result(timeout=self.sink.hedge_s)
            self.acked += n
            return True
        except _FutureTimeout:
            pass
        except Exception:  # noqa: BLE001 - fast failure: plain failover
            return False
        spare = self.sink._take_spare(self.url)
        if spare is None:
            # no rival to race: wait the slow send out
            try:
                primary.result()
            except Exception:  # noqa: BLE001 - the plain path retries
                return False
            self.acked += n
            return True
        self.sink.stats.add_hedge_fired()
        secondary = ex.submit(writer.send, spare, off, chunks)
        pending = {primary, secondary}
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                if f.exception() is not None:
                    continue
                self.sink.stats.add_hedge_lost()
                if f is secondary:
                    # the spare won: it owns this worker's shard set from
                    # here on; the slow holder's stage is aborted once its
                    # duplicate drains
                    slow, self.url = self.url, spare
                    self.sink.stats.add_hedge_won()
                    self.sink.stats.add_failover()
                    BOARD.record_hedge_loss(slow, spare)
                    primary.add_done_callback(
                        lambda _f, dead=slow: writer.abort(dead))
                else:
                    BOARD.record_hedge_loss(spare, self.url)

                    def _cleanup(_f, spare=spare):
                        writer.abort(spare)
                        self.sink._return_spare(spare)

                    secondary.add_done_callback(_cleanup)
                self.acked += n
                return True
        # both failed: the plain path retries and fails over; give the
        # consumed spare back first so failover can still reach it
        self.sink._return_spare(spare)
        return False

    def _trace_run(self, sid: int, off: int, n: int):
        tracing.record_span(
            self.sink.span_name, 0.0, parent=self.sink.parent_span,
            op=self.sink.span_op, shard=sid, offset=off,
            bytes=n, target=self.url or "local")


def merge_runs(batch):
    """Merge a drained batch into per-shard contiguous runs, keeping
    per-shard order (queue order is stripe order, so each shard's
    offsets arrive ascending and contiguous)."""
    runs = []          # [sid, start_off, [chunks], next_off]
    open_run: Dict[int, list] = {}
    for sid, off, chunk in batch:
        run = open_run.get(sid)
        if run is not None and run[3] == off:
            run[2].append(chunk)
            run[3] += len(chunk)
        else:
            run = [sid, off, [chunk], off + len(chunk)]
            runs.append(run)
            open_run[sid] = run
    return [(sid, off, chunks) for sid, off, chunks, _ in runs]


class StripedPush:
    """The push pump: ``write_stripe`` routes each shard row of the
    arriving stripe to its holder's bounded send queue; per-target
    workers push the ranges while the producer makes the next stripes.
    ``writers`` holds one endpoint per shard and ``by_target`` groups the
    shard ids by holder url (None for the local disk); window accounting,
    blocked time, failover spares, hedging, finalize/abort and optional
    MB/s pacing live here."""

    span_name = "spread.run"
    span_op = "ec.encode.spread"

    def __init__(self, writers: List, by_target: Dict[Optional[str],
                                                      List[int]],
                 spares: Optional[Sequence[str]] = None,
                 window: Optional[int] = None,
                 stats: Optional[TransportStats] = None,
                 hedge_ms: Optional[float] = None,
                 rate_mbps: float = 0.0, routing: bool = False,
                 parent_span=None):
        self.total = len(writers)
        self.window = max(1, int(window) if window else push_window())
        self.stats = stats if stats is not None else SpreadStats()
        self.parent_span = parent_span
        self.hedge_s = (DEFAULT_HEDGE_MS if hedge_ms is None
                        else float(hedge_ms)) / 1000.0
        # producer-side MB/s ceiling: sleep the producer so cumulative
        # pushed bytes stay under the cap
        self.rate_mbps = float(rate_mbps or 0.0)
        self.routing = routing
        self._rate_t0 = None
        self._rate_bytes = 0
        self.offset = 0
        self.failed: Optional[BaseException] = None
        self._spares = [s for s in (spares or []) if s]
        self._lock = make_lock("torch.transport.StripedPush._lock")
        self._buffered = 0
        self.writers = list(writers)
        for w in self.writers:
            w.stats = self.stats
            w.span = parent_span
        self.stats.remote_shards = sum(1 for w in self.writers if w.remote)
        self.stats.local_shards = self.total - self.stats.remote_shards
        self.workers = [TargetWorker(self, url, sids, self.window)
                        for url, sids in by_target.items()]
        self._worker_of = {}
        for w in self.workers:
            for sid in w.sids:
                self._worker_of[sid] = w
        self.blocked_s = 0.0     # producer time lost to full windows
        for w in self.workers:
            w.start()

    def _note_buffered(self, delta: int):
        with self._lock:
            self._buffered += delta
            if self._buffered > self.stats.peak_buffered:
                self.stats.peak_buffered = self._buffered

    def _fail(self, e: BaseException):
        with self._lock:
            if self.failed is None:
                self.failed = e

    def _take_spare(self, dead: Optional[str]) -> Optional[str]:
        with self._lock:
            cands = self._spares
            if len(cands) > 1 and self.routing:
                # healthiest spare first: failing over onto the next
                # struggling holder just moves the stall
                cands = BOARD.order_by_health(list(cands))
            for s in cands:
                if s != dead:
                    self._spares.remove(s)
                    return s
        return None

    def _return_spare(self, url: str):
        with self._lock:
            if url and url not in self._spares:
                self._spares.append(url)

    def assignment(self) -> Dict[int, str]:
        """Final shard placement (after failover): sid -> holder url,
        '' for shards kept locally."""
        return {sid: (self._worker_of[sid].url or "")
                for sid in range(self.total)}

    def _put(self, worker: TargetWorker, item):
        t0 = time.perf_counter()
        waited = False
        while True:
            if self.failed is not None:
                raise SpreadError(
                    f"shard spread failed: {self.failed!r}") \
                    from self.failed
            try:
                worker.q.put(item, timeout=0.05)
                break
            except queue.Full:
                waited = True
        if waited:
            self.blocked_s += time.perf_counter() - t0

    def _pace(self, nbytes: int):
        """Hold the producer under ``rate_mbps``: sleep, in slices of at
        most 0.25 s, until the cumulative pushed bytes fit the elapsed
        time's budget, so a coarse stripe still honours the cap."""
        if self.rate_mbps <= 0:
            return
        now = time.perf_counter()
        if self._rate_t0 is None:
            self._rate_t0 = now
        self._rate_bytes += nbytes
        need = self._rate_bytes / (self.rate_mbps * 1e6)
        while True:
            spent = time.perf_counter() - self._rate_t0
            if need <= spent:
                break
            time.sleep(min(need - spent, 0.25))

    def write_stripe(self, data, parity):
        """Route one stripe: row i of ``data``/``parity`` is the next
        ``w`` bytes of shard i / shard k+i. Each row is copied before it
        is queued, so the caller may reuse its buffers at once."""
        k = data.shape[0]
        w = data.shape[1]
        off = self.offset
        stripe_bytes = 0
        for sid in range(self.total):
            row = data[sid] if sid < k else parity[sid - k]
            chunk = row.tobytes()
            stripe_bytes += len(chunk)
            self._note_buffered(len(chunk))
            self._put(self._worker_of[sid], (sid, off, chunk))
        self.offset = off + w
        with self._lock:
            self.stats.stripes += 1
        self._pace(stripe_bytes)

    def finish(self):
        """Drain every window, join the workers, then finalize all
        shards (atomic ``.part`` -> shard rename on every holder).
        Raises if any push or finalize failed."""
        t0 = time.perf_counter()
        for w in self.workers:
            self._put(w, _SENTINEL)
        for w in self.workers:
            w.join()
        self.blocked_s += time.perf_counter() - t0
        if self.failed is not None:
            raise SpreadError(
                f"shard spread failed: {self.failed!r}") from self.failed
        for sid in range(self.total):
            self.writers[sid].finalize(self._worker_of[sid].url,
                                       self.offset)

    def abort(self):
        """Stop the workers and leave no partial shards: best-effort
        ``.part`` cleanup on every holder and on the local disk."""
        self._fail(SpreadError("spread aborted"))
        for w in self.workers:
            try:
                w.q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        for w in self.workers:
            w.join(timeout=10.0)
        for sid in range(self.total):
            try:
                self.writers[sid].abort(self._worker_of[sid].url)
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass
