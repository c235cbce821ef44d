"""EventSubscriber — follow a filer's metadata events: the JAX
package's ``replication/sub.py`` (reference ``weed watch``). It
long-polls ``/filer/events`` and resumes from the last timestamp seen;
``poll_once(advance=False)`` and ``commit`` let a replicator move the
cursor only once a batch is applied."""

from __future__ import annotations

import urllib.parse
from typing import Iterator, Tuple

from ..server.http_util import HttpError, get_json
from ..util import config


class EventSubscriber:
    def __init__(self, filer_url: str, since: float = 0.0,
                 poll_timeout: float = 10.0, path_prefix: str = ""):
        self.filer_url = filer_url
        self.since = since
        self.poll_timeout = poll_timeout
        self.path_prefix = path_prefix
        self.stopped = False
        self._batch_cursor = since  # scanned mark of the last poll

    def poll_once(self, advance: bool = True):
        """One long-poll; returns the (possibly empty) event batch. With
        advance=False the cursor stays put — callers that might fail to
        apply the batch (a replicator with its sink down) commit() only
        after the whole batch landed, so nothing is ever skipped."""
        params = {"since": repr(self.since),
                  "timeout": self.poll_timeout}
        if self.path_prefix:
            # server-side filter (reference watch -pathPrefix)
            params["prefix"] = self.path_prefix
        q = urllib.parse.urlencode(params)
        out = get_json(f"http://{self.filer_url}/filer/events?{q}",
                       timeout=self.poll_timeout + 30)
        events = out.get("events", [])
        # the server's scanned high-water mark covers every event it
        # looked at, INCLUDING ones the prefix filter dropped — safe to
        # resume from (dropped events can never concern this watcher).
        # A pre-cursor server omits the field: fall back to the batch's
        # own max ts, NOT self.since (that fallback would never advance
        # and follow() would hot-loop re-fetching the same batch)
        batch_hi = max((e["ts"] for e in events), default=self.since)
        self._batch_cursor = max(self._batch_cursor, batch_hi,
                                 float(out.get("cursor", 0) or 0))
        if advance:
            self.since = max(self.since, self._batch_cursor)
        return events

    def commit(self, events):
        """Advance the cursor past an applied batch (and past whatever
        filtered-out foreign events the server scanned alongside it —
        an advance=False + prefix consumer would otherwise busy-loop
        rescanning them)."""
        hi = max((e["ts"] for e in events), default=self.since)
        self.since = max(self.since, hi, self._batch_cursor)

    def follow(self) -> Iterator[Tuple[float, dict]]:
        """Yield (ts, event) forever (until .stopped is set). Transient
        filer outages back off and resume from the cursor."""
        import time
        while not self.stopped:
            try:
                batch = self.poll_once()
            except HttpError:
                time.sleep(max(0.02, config.retry_backoff_s(1.0)))
                continue
            for e in batch:
                yield e["ts"], e["event"]


def format_event(ts: float, event: dict) -> str:
    """One-line rendering for `weed-tpu watch`."""
    old = event.get("oldEntry")
    new = event.get("newEntry")
    if old and new:
        kind = "update" if old.get("FullPath") == new.get("FullPath") \
            else "rename"
    elif new:
        kind = "create"
    elif old:
        kind = "delete"
    else:
        kind = "noop"
    path = (new or old or {}).get("FullPath", "?")
    extra = ""
    if kind == "rename":
        extra = f" <- {old.get('FullPath')}"
    return f"{ts:.6f} {kind:7s} {path}{extra}"
