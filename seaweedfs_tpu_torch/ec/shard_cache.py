"""Tiered-freshness EC shard-location cache.

Degraded reads need to know which volume server holds each .ecNN shard.
Asking the master on every read adds an RTT per interval (and ~10 per
reconstruct), so lookups are cached per EC volume with freshness tiers
that mirror the reference (weed/storage/store_ec.go:218-259
cachedLookupEcShardLocations):

  * fewer than k shards known  -> stale after 11 s (keep retrying — the
    volume is unreadable until more holders appear)
  * every shard known          -> stale after 37 min
  * at least k known           -> stale after 7 min

plus invalidate-on-failure: a holder that fails a shard read is removed
immediately (reference forgetShardId, store_ec.go:211) so the next read
tries someone else instead of timing out again.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

from ..util.locks import make_lock
from .constants import DATA_SHARDS, TOTAL_SHARDS

FEW_SHARDS_TTL = 11.0          # seconds, < k shards known
ALL_SHARDS_TTL = 37 * 60.0     # all shards known
ENOUGH_SHARDS_TTL = 7 * 60.0   # >= k shards known


class EcShardLocationCache:
    def __init__(self, fetch: Callable[[int], Dict[int, List[str]]],
                 data_shards: int = DATA_SHARDS,
                 total_shards: int = TOTAL_SHARDS):
        self._fetch = fetch
        self._data_shards = data_shards
        self._total_shards = total_shards
        self._lock = make_lock("torch.shard_cache._lock")
        self._entries: Dict[int, tuple] = {}  # vid -> (refresh_t, locations)

    def _ttl(self, locations: Dict[int, List[str]]) -> float:
        known = sum(1 for urls in locations.values() if urls)
        if known < self._data_shards:
            return FEW_SHARDS_TTL
        if known >= self._total_shards:
            return ALL_SHARDS_TTL
        return ENOUGH_SHARDS_TTL

    def lookup(self, vid: int) -> Dict[int, List[str]]:
        with self._lock:
            entry = self._entries.get(vid)
            if entry is not None:
                refresh_t, locations = entry
                if time.monotonic() - refresh_t < self._ttl(locations):
                    return locations
        locations = self._fetch(vid) or {}
        with self._lock:
            self._entries[vid] = (time.monotonic(), locations)
        return locations

    def forget(self, vid: int, shard_id: int, holder: str):
        """Drop a failed holder for one shard (keeps the rest fresh)."""
        with self._lock:
            entry = self._entries.get(vid)
            if entry is None:
                return
            refresh_t, locations = entry
            urls = locations.get(shard_id)
            if urls and holder in urls:
                locations = dict(locations)
                locations[shard_id] = [u for u in urls if u != holder]
                self._entries[vid] = (refresh_t, locations)

    def invalidate(self, vid: int):
        with self._lock:
            self._entries.pop(vid, None)
