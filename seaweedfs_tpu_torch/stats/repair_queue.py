"""Repair queue of durability incidents, with time-to-re-protection.

Kept by the master. Three sources feed it: scrub syndrome findings
(``POST /cluster/scrub_report``), shards missing from the heartbeat-built
topology, and at-risk holders flagged by a fleet health fold (a kind the
queue keeps; the port's master opens none, see ``server/master``).
Priority comes from what an incident says about durability, not from its
arrival order:

    corruption (0) > lost_shard (1) > at_risk_holder (2)

A corrupt shard is silently wrong, and reads that touch it decode garbage
until it is rebuilt; a lost shard spends margin; an at-risk holder is
advisory. The master's drain pops ``next_incident()`` and drives the
rebuild paths (``/admin/ec/scrub_repair`` for corruption,
``/admin/ec/rebuild`` and a mount for a loss).

**Time to re-protection** of an incident is ``resolved_at -
detected_at``: the window in which its volume ran below its redundancy,
or at it but silently wrong.

The JAX package's ``stats/repair_queue.py``: the same incidents, keys,
priorities, back-off and snapshots.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

PRIORITIES = {"corruption": 0, "lost_shard": 1, "at_risk_holder": 2}

# a failed repair attempt backs off linearly, so one unreachable holder
# cannot spin the drain loop
RETRY_BACKOFF_S = 30.0

_RESOLVED_KEEP = 256


class Incident:
    __slots__ = ("id", "kind", "volume", "shard", "holder", "source",
                 "detail", "detected_at", "resolved_at", "attempts",
                 "not_before", "status", "via", "last_error")

    def __init__(self, iid: int, kind: str, volume: Optional[int],
                 shard: Optional[int], holder: str, source: str,
                 detail: dict, detected_at: float):
        self.id = iid
        self.kind = kind
        self.volume = volume
        self.shard = shard
        self.holder = holder
        self.source = source
        self.detail = detail
        self.detected_at = detected_at
        self.resolved_at = 0.0
        self.attempts = 0
        self.not_before = 0.0
        self.status = "open"
        self.via = ""
        self.last_error = ""

    def key(self) -> tuple:
        return (self.kind, self.volume, self.shard, self.holder)

    def to_dict(self) -> dict:
        out = {"id": self.id, "kind": self.kind,
               "priority": PRIORITIES.get(self.kind, 9),
               "volume": self.volume, "shard": self.shard,
               "holder": self.holder, "source": self.source,
               "detail": self.detail, "detected_at": self.detected_at,
               "attempts": self.attempts, "status": self.status}
        if self.status == "resolved":
            out["resolved_at"] = self.resolved_at
            out["via"] = self.via
            out["time_to_re_protection_s"] = \
                round(self.resolved_at - self.detected_at, 6)
        if self.last_error:
            out["last_error"] = self.last_error
        return out


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class RepairQueue:
    """Deduplicated priority queue of durability incidents."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open: Dict[tuple, Incident] = {}
        self._resolved: deque = deque(maxlen=_RESOLVED_KEEP)
        self._next_id = 1
        self._c = {"reported": 0, "duplicates": 0, "resolved": 0,
                   "attempts": 0, "attempt_failures": 0}

    # -- intake ------------------------------------------------------

    def report(self, kind: str, volume: Optional[int] = None,
               shard: Optional[int] = None, holder: str = "",
               source: str = "", detail: Optional[dict] = None,
               detected_at: Optional[float] = None) -> Incident:
        """Open (or refresh) an incident. A repeat report of the same
        (kind, volume, shard, holder) collapses onto the open incident,
        whose detection time stays the first sighting's, so the time to
        re-protection covers the whole exposure."""
        if kind not in PRIORITIES:
            raise ValueError(f"unknown incident kind {kind!r}")
        key = (kind, volume, shard, holder)
        with self._lock:
            inc = self._open.get(key)
            if inc is not None:
                self._c["duplicates"] += 1
                if detail:
                    inc.detail = detail
                return inc
            inc = Incident(self._next_id, kind, volume, shard, holder,
                           source, detail or {},
                           detected_at if detected_at is not None
                           else time.time())
            if shard is not None and shard < 0:
                # a finding no shard could be pinned on (shard -1): nothing
                # to rebuild yet, so the drain skips it, but it stays
                # visible in the snapshot
                inc.status = "unattributed"
            self._next_id += 1
            self._open[key] = inc
            self._c["reported"] += 1
            return inc

    def resolve(self, kind: str, volume: Optional[int] = None,
                shard: Optional[int] = None, holder: str = "",
                via: str = "") -> Optional[Incident]:
        """Close an open incident; stamps its time to re-protection."""
        key = (kind, volume, shard, holder)
        with self._lock:
            inc = self._open.pop(key, None)
            if inc is None:
                return None
            inc.status = "resolved"
            inc.resolved_at = time.time()
            inc.via = via
            self._resolved.append(inc)
            self._c["resolved"] += 1
            return inc

    def open_for_volume(self, volume: int,
                        kind: Optional[str] = None) -> List[Incident]:
        with self._lock:
            return [i for i in self._open.values()
                    if i.volume == volume
                    and (kind is None or i.kind == kind)]

    # -- drain -------------------------------------------------------

    def next_incident(self) -> Optional[Incident]:
        """The highest-priority open incident that can be acted on now
        (oldest first within a priority). ``at_risk_holder`` incidents
        are advisory and unattributed ones have no shard to rebuild: the
        drain never pops either."""
        now = time.time()
        with self._lock:
            best: Optional[Incident] = None
            for inc in self._open.values():
                if inc.kind == "at_risk_holder":
                    continue
                if inc.status == "unattributed":
                    continue
                if inc.not_before > now:
                    continue
                if best is None or \
                        (PRIORITIES[inc.kind], inc.detected_at) < \
                        (PRIORITIES[best.kind], best.detected_at):
                    best = inc
            if best is not None:
                best.attempts += 1
                self._c["attempts"] += 1
            return best

    def attempt_failed(self, inc: Incident, error: str):
        with self._lock:
            inc.last_error = str(error)[:200]
            inc.not_before = time.time() + RETRY_BACKOFF_S * inc.attempts
            self._c["attempt_failures"] += 1

    # -- export ------------------------------------------------------

    def ttr_stats(self) -> dict:
        with self._lock:
            vals = sorted(i.resolved_at - i.detected_at
                          for i in self._resolved)
        return {"count": len(vals),
                "p50_s": round(_quantile(vals, 0.50), 6),
                "p99_s": round(_quantile(vals, 0.99), 6),
                "max_s": round(vals[-1], 6) if vals else 0.0}

    def depth_by_kind(self) -> Dict[str, int]:
        with self._lock:
            out = {k: 0 for k in PRIORITIES}
            for inc in self._open.values():
                out[inc.kind] += 1
            return out

    def snapshot(self) -> dict:
        with self._lock:
            open_incidents = sorted(
                (i.to_dict() for i in self._open.values()),
                key=lambda d: (d["priority"], d["detected_at"]))
            resolved = [i.to_dict() for i in self._resolved]
            counters = dict(self._c)
            unattributed = sum(1 for i in self._open.values()
                               if i.status == "unattributed")
        return {"open": open_incidents,
                "resolved_recent": resolved[-32:],
                "counters": counters,
                "depth": self.depth_by_kind(),
                "unattributed": unattributed,
                "time_to_re_protection": self.ttr_stats()}

    def summary(self) -> dict:
        """The compact form (open count, depth, time to re-protection)."""
        with self._lock:
            n_open = len(self._open)
        return {"open": n_open, "depth": self.depth_by_kind(),
                "time_to_re_protection": self.ttr_stats()}
