"""The metadata event log. The JAX package's ``filer/log_buffer.py``:
every change of an entry becomes an event (``event_notification``,
both entries in their wire shape) appended to a bounded, time-ordered
buffer; subscribers read what is newer than a timestamp, or wait for it
(``wait_since``, the long poll of ``/filer/events``)."""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional, Tuple

from .entry import entry_to_wire


class LogBuffer:
    def __init__(self, flush_interval: float = 60.0,
                 flush_fn: Optional[Callable[[List[dict]], None]] = None,
                 max_events: int = 100_000):
        self._events: List[Tuple[float, dict]] = []
        self._lock = threading.Condition()
        self._flush_fn = flush_fn
        self._flush_interval = flush_interval
        self._max_events = max_events
        self._closed = False

    def append(self, event: dict, ts: Optional[float] = None):
        ts = time.time() if ts is None else ts
        with self._lock:
            self._events.append((ts, event))
            if len(self._events) > self._max_events:
                self._flush_locked()
            self._lock.notify_all()

    def _flush_locked(self):
        if self._flush_fn and self._events:
            self._flush_fn([e for _, e in self._events])
        # a tail stays for late subscribers
        self._events = self._events[-1000:]

    def flush(self):
        with self._lock:
            self._flush_locked()

    @staticmethod
    def _take_since(events, ts: float, limit: int):
        """The events newer than ``ts``, at most ``limit`` unless that
        would split a run of one timestamp (a subscriber resumes with a
        strict ``> ts``, so a split run would lose its tail)."""
        got = [(t, e) for t, e in events if t > ts]
        if len(got) > limit:
            cut = limit
            last_ts = got[cut - 1][0]
            while cut < len(got) and got[cut][0] == last_ts:
                cut += 1
            got = got[:cut]
        return got

    def read_since(self, ts: float,
                   limit: int = 1024) -> List[Tuple[float, dict]]:
        with self._lock:
            return self._take_since(self._events, ts, limit)

    def wait_since(self, ts: float, timeout: float = 10.0,
                   limit: int = 1024) -> List[Tuple[float, dict]]:
        deadline = time.time() + timeout
        with self._lock:
            while not self._closed:
                got = self._take_since(self._events, ts, limit)
                if got:
                    return got
                remaining = deadline - time.time()
                if remaining <= 0:
                    return []
                self._lock.wait(remaining)
        return []

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()


def event_notification(old, new, delete_chunks: bool) -> dict:
    def enc(e):
        if e is None:
            return None
        d = entry_to_wire(e)
        d["path"] = e.full_path
        d["isDirectory"] = e.is_directory
        return d

    return {"oldEntry": enc(old), "newEntry": enc(new),
            "deleteChunks": delete_chunks, "tsNs": time.time_ns()}


def encode_event_line(event: dict) -> bytes:
    return json.dumps(event, separators=(",", ":")).encode() + b"\n"
