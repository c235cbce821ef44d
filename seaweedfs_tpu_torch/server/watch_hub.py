"""The master's volume-location push channel behind ``/cluster/watch``.

Heartbeats and node deaths publish VolumeLocation events (a volume new or
deleted on a server); clients long-poll ``GET
/cluster/watch?since=<seq>`` and are answered at once with any newer
events, or parked until one arrives (an empty answer after the poll's
timeout: the client polls again). A client whose ``since`` fell off the
bounded buffer, comes from another hub epoch, or is 0 gets a snapshot
with ``reset``. The JAX package's ``server/watch_hub.py``."""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List


class WatchHub:
    def __init__(self, snapshot_fn: Callable[[], Dict[str, List[dict]]],
                 maxlen: int = 8192):
        self._snapshot_fn = snapshot_fn
        self._events: deque = deque(maxlen=maxlen)  # (seq, event)
        # the epoch starts at 1, so a client just given a snapshot
        # (since=1) parks on its next poll instead of asking again
        self._seq = 1
        self._cond = threading.Condition()

    def publish(self, etype: str, vid: int, url: str, public_url: str = "",
                fast_url: str = ""):
        """One location event (``etype`` "new" or "deleted")."""
        with self._cond:
            self._seq += 1
            ev = {"type": etype, "vid": vid, "url": url,
                  "publicUrl": public_url or url}
            if fast_url:
                ev["fastUrl"] = fast_url
            self._events.append((self._seq, ev))
            self._cond.notify_all()

    def wait(self, since: int, timeout: float = 20.0) -> dict:
        """Events newer than ``since``; a reset snapshot when ``since``
        predates the buffer or is not of this epoch; ``{"seq", "events":
        []}`` after ``timeout`` idle."""
        with self._cond:
            oldest = self._events[0][0] if self._events else self._seq + 1
            need_reset = (since == 0 or since < oldest - 1
                          or since > self._seq)
            seq = self._seq
        if need_reset:
            # the snapshot is taken outside the condition: it takes the
            # topology lock, under which the topology publishes here
            return {"reset": True, "seq": seq,
                    "locations": self._snapshot_fn()}
        with self._cond:
            if since >= self._seq:
                self._cond.wait(timeout)
            if since >= self._seq:
                return {"seq": self._seq, "events": []}
            if not (self._events and since < self._events[0][0] - 1):
                return {"seq": self._seq,
                        "events": [e for s, e in self._events if s > since]}
        # the buffer rolled past ``since`` while the client was parked
        return {"reset": True, "seq": self._seq,
                "locations": self._snapshot_fn()}
