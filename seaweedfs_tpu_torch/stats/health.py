"""Per-holder health scoreboard.

Every remote range read the transport issues reports here: its latency,
its failure, and which holder lost each hedge race. The board folds them
into a 0..1 score per holder:

    lat_score = ref_ms / (ref_ms + latency_ewma_ms)   # 1.0 at 0 ms,
                                                      # 0.5 at ref_ms
    score     = lat_score * (1 - err_ewma) * (1 - 0.5 * hedge_loss_ewma)

clipped to [0, 1]; a holder with no data scores 1.0. With health routing
on (an argument of the readers and of ``Store``, off by default as the
JAX package's SW_EC_HEALTH_ROUTING), the pull rotation demotes holders
below 0.5 to the back of the failover and hedge order, and the full
streaming rebuild drops the worst-scored surplus survivors.

Per-holder event counts (reads, errors, hedges_lost,
hedges_won_against) ride beside the EWMAs; ``snapshot`` is the view
``export_board`` mirrors onto the ``ec_holder_*`` families on every
``/metrics`` scrape, which the master's aggregator folds into
``/cluster/health``.

The JAX package's ``stats/health.py``; the reference latency is the
module constant ``REF_MS`` (the SW_EC_HEALTH_REF_MS default).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

# EWMA smoothing: each observation moves the average 20% of the way to
# the new value, so ~10 observations forget an old regime.
_ALPHA = 0.2

#: Latency (ms) that scores 0.5.
REF_MS = 50.0


class HolderHealthBoard:
    """Thread-safe EWMA scoreboard keyed by holder URL."""

    def __init__(self):
        self._lock = threading.Lock()
        # holder -> kind -> latency EWMA (seconds)
        self._lat: Dict[str, Dict[str, float]] = {}
        # holder -> error-rate EWMA (0..1)
        self._err: Dict[str, float] = {}
        # holder -> hedge-loss-rate EWMA (0..1)
        self._hedge: Dict[str, float] = {}
        # holder -> event -> monotonic count
        self._events: Dict[str, Dict[str, int]] = {}

    def _bump(self, holder: str, event: str, n: int = 1):
        ev = self._events.setdefault(holder, {})
        ev[event] = ev.get(event, 0) + n

    def record_latency(self, holder: str, kind: str, seconds: float):
        """One successful range read against ``holder`` took
        ``seconds``."""
        if not holder or seconds < 0:
            return
        with self._lock:
            kinds = self._lat.setdefault(holder, {})
            prev = kinds.get(kind)
            kinds[kind] = (seconds if prev is None
                           else prev + _ALPHA * (seconds - prev))
            self._err[holder] = (1 - _ALPHA) * self._err.get(holder, 0.0)
            self._hedge[holder] = \
                (1 - _ALPHA) * self._hedge.get(holder, 0.0)
            self._bump(holder, "reads")

    def record_error(self, holder: str):
        """A range read against ``holder`` failed or timed out."""
        if not holder:
            return
        with self._lock:
            prev = self._err.get(holder, 0.0)
            self._err[holder] = prev + _ALPHA * (1.0 - prev)
            self._bump(holder, "errors")

    def record_hedge_loss(self, loser: str, winner: str):
        """A hedged read raced ``loser`` against ``winner`` and the
        loser's response came second (or never)."""
        if not loser:
            return
        with self._lock:
            prev = self._hedge.get(loser, 0.0)
            self._hedge[loser] = prev + _ALPHA * (1.0 - prev)
            self._bump(loser, "hedges_lost")
            if winner:
                self._bump(winner, "hedges_won_against")

    def score(self, holder: str) -> float:
        with self._lock:
            return self._score_locked(holder)

    def _score_locked(self, holder: str) -> float:
        kinds = self._lat.get(holder)
        err = self._err.get(holder, 0.0)
        hedge = self._hedge.get(holder, 0.0)
        if not kinds and not err and not hedge:
            return 1.0
        worst_ms = max(kinds.values()) * 1000.0 if kinds else 0.0
        lat_score = REF_MS / (REF_MS + worst_ms) if worst_ms > 0 else 1.0
        score = lat_score * (1.0 - err) * (1.0 - 0.5 * hedge)
        return min(1.0, max(0.0, score))

    def snapshot(self) -> Dict[str, Dict]:
        """Per-holder view for the ``/metrics`` export."""
        with self._lock:
            holders = (set(self._lat) | set(self._err) | set(self._hedge)
                       | set(self._events))
            out = {}
            for h in sorted(holders):
                out[h] = {
                    "score": round(self._score_locked(h), 4),
                    "latency_ewma_ms": {
                        kind: round(s * 1000.0, 3)
                        for kind, s in self._lat.get(h, {}).items()},
                    "error_ewma": round(self._err.get(h, 0.0), 4),
                    "hedge_loss_ewma": round(self._hedge.get(h, 0.0), 4),
                    "events": dict(self._events.get(h, {})),
                }
            return out

    def order_by_health(self, holders: Sequence[str],
                        threshold: float = 0.5) -> List[str]:
        """Stable partition into healthy-first order: holders scoring
        below ``threshold`` keep their relative order at the back."""
        with self._lock:
            scores = {h: self._score_locked(h) for h in holders}
        healthy = [h for h in holders if scores[h] >= threshold]
        unhealthy = [h for h in holders if scores[h] < threshold]
        return healthy + unhealthy

    def reset(self):
        with self._lock:
            self._lat.clear()
            self._err.clear()
            self._hedge.clear()
            self._events.clear()


# Process-global board: every reader in this process (rebuild gather,
# repair, degraded engine, scrub) feeds the same scoreboard.
BOARD = HolderHealthBoard()


def export_board():
    """Mirror the board onto the ``ec_holder_*`` metric families; the
    ``/metrics`` handlers call it, so every scrape sees fresh scores."""
    from .metrics import observe_health
    observe_health(BOARD.snapshot())
