"""A volume-location map the master pushes: one daemon thread per master
long-polls ``/cluster/watch`` and applies its new/deleted events, so a
route is never staler than one event; until the first snapshot (or after
the master went away) ``lookup`` answers None and the caller asks
``/dir/lookup``. ``shared_vid_map`` keeps one map per master for the
whole process. The JAX package's ``client/vid_map.py``; the retry
backoff is the JAX default, a constant here."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..server.http_util import get_json


class VidMap:
    POLL_TIMEOUT = 20.0
    MAX_CONSECUTIVE_FAILURES = 15  # then park until a lookup revives it

    def __init__(self, master_url: str):
        self.master_url = master_url
        self._locations: Dict[int, List[dict]] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._ready = threading.Event()  # the first snapshot applied
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_start = 0.0

    def start(self) -> "VidMap":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._last_start = time.monotonic()
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"vidmap-{self.master_url}")
                self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _live(self) -> bool:
        """Whether the map may answer; a parked poller is revived (at
        most every 5 s)."""
        if self._ready.is_set():
            return True
        if self._thread is None or not self._thread.is_alive():
            if time.monotonic() - self._last_start > 5:
                self.start()
        return False

    def lookup(self, vid: int) -> Optional[List[str]]:
        """The pushed locations' urls, or None when the map is not live."""
        if not self._live():
            return None
        with self._lock:
            locs = self._locations.get(vid)
            return [loc["url"] for loc in locs] if locs else None

    def lookup_read(self, vid: int) -> Optional[List[str]]:
        """Like ``lookup``, with each holder's read plane first."""
        if not self._live():
            return None
        with self._lock:
            locs = self._locations.get(vid)
            return read_routes(locs) if locs else None

    def known(self, vid: int) -> bool:
        with self._lock:
            return vid in self._locations

    def discard_url(self, vid: int, url: str):
        """Drop a route a caller saw fail, until the master's next event
        says otherwise: a failing read plane loses only its fastUrl, a
        failing holder the whole entry."""
        with self._lock:
            locs = self._locations.get(vid)
            if not locs:
                return
            kept = []
            for loc in locs:
                if loc["url"] == url:
                    continue
                if loc.get("fastUrl") == url:
                    loc = {k: v for k, v in loc.items() if k != "fastUrl"}
                kept.append(loc)
            if kept:
                self._locations[vid] = kept
            else:
                del self._locations[vid]

    def _apply(self, out: dict):
        with self._lock:
            if out.get("reset"):
                self._locations = {
                    int(v): list(locs)
                    for v, locs in (out.get("locations") or {}).items()}
            for ev in out.get("events") or []:
                vid = int(ev["vid"])
                entry = {"url": ev["url"],
                         "publicUrl": ev.get("publicUrl", ev["url"])}
                if ev.get("fastUrl"):
                    entry["fastUrl"] = ev["fastUrl"]
                locs = self._locations.setdefault(vid, [])
                if ev["type"] == "new":
                    if all(loc["url"] != entry["url"] for loc in locs):
                        locs.append(entry)
                else:
                    locs[:] = [loc for loc in locs
                               if loc["url"] != entry["url"]]
                    if not locs:
                        del self._locations[vid]
            self._seq = int(out.get("seq", self._seq))
        self._ready.set()

    def _loop(self):
        failures = 0
        while not self._stop.is_set():
            try:
                out = get_json(
                    f"http://{self.master_url}/cluster/watch"
                    f"?since={self._seq}&timeout={self.POLL_TIMEOUT}",
                    timeout=self.POLL_TIMEOUT + 10)
                self._apply(out)
                failures = 0
            except Exception:  # noqa: BLE001 - the master is away
                failures += 1
                self._ready.clear()  # a stale map must not route
                self._seq = 0        # a snapshot when it comes back
                if failures >= self.MAX_CONSECUTIVE_FAILURES:
                    return           # parked; a lookup revives it
                self._stop.wait(max(0.01, min(2.0, 0.2 * failures)))


def read_routes(locs) -> List[str]:
    """Per holder: its read plane's url (where advertised), then its
    url."""
    out: List[str] = []
    for loc in locs:
        fast = loc.get("fastUrl")
        if fast:
            out.append(fast)
        out.append(loc["url"])
    return out


_shared: Dict[str, VidMap] = {}
_shared_lock = threading.Lock()


def shared_vid_map(master_url: str) -> VidMap:
    with _shared_lock:
        vm = _shared.get(master_url)
        if vm is None:
            vm = _shared[master_url] = VidMap(master_url)
        return vm.start()
