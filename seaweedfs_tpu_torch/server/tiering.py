"""Hot→warm tiering, the f4 lifecycle: the master's ``VolumeTierer``.

The JAX package's ``server/tiering.py``. Replicated hot Haystack volumes
age into erasure-coded warm storage with no drain window: a volume being
demoted keeps serving reads from its hot replicas the whole time.

* A leader-gated scan every ``interval`` seconds walks the heartbeat
  topology for sealed volumes (readonly, or past ``full_frac`` of the
  size limit) unmodified for ``age_s`` seconds and not yet EC.
* Each candidate is demoted through the shell's encode flow
  (``shell/command_ec.do_ec_encode``, stream mode): freeze the replicas,
  a streaming encode+spread on the source's codec (K1 on its card)
  paced at ``rate_mbps``, mount the shards, delete the hot replicas.
  Until that last delete every read hits a hot copy; after it, the EC
  stripe: the flip is the replica delete, and there is never a moment
  with neither copy mounted.
* Per-volume state (candidate, demoting, warm, failed) is served at
  ``GET /cluster/tiering``; the ``MASTER_TIER_*`` families count the
  demotions, their seconds and bytes.

Client writes are never blocked: a sealed volume takes no assigns, and a
failed demotion unwinds (shards deleted, replicas thawed) inside
``do_ec_encode`` and is retried on a later pass.

The JAX knobs are module constants here (the port has no config
registry), passed through ``MasterServer``'s keywords and the master's
``-tier*`` flags.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Dict, Optional

from ..stats.metrics import (MASTER_TIER_BYTES, MASTER_TIER_DEMOTIONS,
                             MASTER_TIER_MBPS_GAUGE, MASTER_TIER_SECONDS,
                             MASTER_TIER_VOLUMES_GAUGE)
from ..util.locks import make_lock

TIER_ENABLE = False        # SW_TIER_ENABLE: the background loop
TIER_INTERVAL_S = 60.0     # SW_TIER_INTERVAL_S; <= 0: no loop
TIER_AGE_S = 3600.0        # SW_TIER_AGE_S: unmodified this long
TIER_CONCURRENCY = 1       # SW_TIER_CONCURRENCY: demotions at once
TIER_RATE_MBPS = 8.0       # SW_TIER_RATE_MBPS: a demotion's cap; 0: none
TIER_FULL_FRAC = 0.95      # SW_TIER_FULL_FRAC: of the size limit, sealed
DEMOTE_ADMIN_TIMEOUT_S = 900.0  # a demotion's admin calls' bound

# lifecycle states served at /cluster/tiering
CANDIDATE = "candidate"
DEMOTING = "demoting"
WARM = "warm"
FAILED = "failed"

log = logging.getLogger(__name__)


class VolumeTierer:
    """The background demotion driver of a ``MasterServer``. The loop
    acts only while its master leads (followers hold no topology); a
    failover restarts the scan from the new leader's heartbeat view, and
    ``do_ec_encode``'s unwind makes a half-finished demotion safe to
    retry."""

    def __init__(self, master, enabled: bool = TIER_ENABLE,
                 interval: float = TIER_INTERVAL_S,
                 age_s: float = TIER_AGE_S,
                 concurrency: int = TIER_CONCURRENCY,
                 rate_mbps: float = TIER_RATE_MBPS,
                 full_frac: float = TIER_FULL_FRAC):
        self.master = master
        self.enabled = bool(enabled)
        self.interval = float(interval)
        self.age_s = float(age_s)
        self.concurrency = max(1, int(concurrency))
        self.rate_mbps = float(rate_mbps)
        self.full_frac = float(full_frac)
        self._lock = make_lock("torch.tiering.VolumeTierer._lock")
        # vid -> {"state", "collection", "hot_bytes", ...}: the payload
        self._volumes: Dict[int, dict] = {}
        self._inflight: set = set()
        self.scans = 0
        self.demotions_ok = 0
        self.demotions_failed = 0
        self._thread: Optional[threading.Thread] = None
        if self.enabled and self.interval > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="master-tierer")

    def start(self):
        if self._thread is not None:
            self._thread.start()

    def _loop(self):
        while not self.master._stop.wait(self.interval):
            if not self.master.is_leader():
                continue
            try:
                self.run_pass()
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                log.warning("tier scan failed: %s", e)

    # -- the candidate scan ---------------------------------------------------
    def _sealed_volumes(self) -> Dict[int, dict]:
        """Non-EC volumes whose first replica is sealed (readonly or past
        the full fraction) and old enough: vid -> summary."""
        topo = self.master.topology
        now = time.time()
        out: Dict[int, dict] = {}
        with topo.lock:
            limit = topo.volume_size_limit
            ec_vids = set(topo.ec_shard_map)
            by_vid: Dict[int, list] = {}
            for node in topo.all_nodes():
                for vid, vi in node.volumes.items():
                    by_vid.setdefault(vid, []).append(vi)
        for vid, infos in by_vid.items():
            if vid in ec_vids:
                continue
            vi = infos[0]
            sealed = vi.read_only or (
                limit and vi.size >= self.full_frac * limit)
            if not sealed:
                continue
            if vi.modified_at and now - vi.modified_at < self.age_s:
                continue
            out[vid] = {"collection": vi.collection or "",
                        "hot_bytes": int(vi.size),
                        "replicas": len(infos)}
        return out

    def run_pass(self) -> Dict[int, str]:
        """One scan and demotion pass; {vid: state} of what it touched.
        Failed volumes re-enter as candidates (the unwind thawed their
        replicas), and at most ``concurrency`` demotions are in flight.
        Called by the loop, and by ``/cluster/tiering?scan=1``."""
        sealed = self._sealed_volumes()
        with self._lock:
            self.scans += 1
            for vid, summary in sealed.items():
                st = self._volumes.get(vid)
                if st is None or st["state"] == FAILED:
                    self._volumes[vid] = dict(summary, state=CANDIDATE)
            todo = [vid for vid, st in sorted(self._volumes.items())
                    if st["state"] == CANDIDATE
                    and vid not in self._inflight]
            todo = todo[:max(0, self.concurrency - len(self._inflight))]
            for vid in todo:
                self._inflight.add(vid)
                self._volumes[vid]["state"] = DEMOTING
        if not todo:
            self._export_gauges()
            return {}
        threads = [threading.Thread(
            target=self._demote_one, args=(vid,), daemon=True,
            name=f"tier-demote-{vid}") for vid in todo]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._export_gauges()
        with self._lock:
            return {vid: self._volumes[vid]["state"] for vid in todo}

    # -- one demotion ---------------------------------------------------------
    def _demote_one(self, vid: int):
        """Hot→warm through the shell's encode: freeze, the paced
        streaming encode+spread, mount, delete the hot replicas."""
        from ..shell.command_ec import do_ec_encode
        from ..shell.command_env import CommandEnv
        with self._lock:
            st = self._volumes[vid]
            hot_bytes = st.get("hot_bytes", 0)
            st["started_at"] = time.time()
        env = CommandEnv(self.master.url, out=sys.stderr)
        env.admin_timeout = DEMOTE_ADMIN_TIMEOUT_S
        timings: Dict = {}
        t0 = time.perf_counter()
        try:
            do_ec_encode(env, vid, mode="stream", timings=timings,
                         rate_mbps=self.rate_mbps)
        except Exception as e:  # noqa: BLE001 - recorded, retried later
            log.warning("tier demotion of volume %s failed: %s", vid, e)
            with self._lock:
                st.update(state=FAILED, error=str(e)[:300],
                          finished_at=time.time())
                self._inflight.discard(vid)
                self.demotions_failed += 1
            MASTER_TIER_DEMOTIONS.inc("failed")
            return
        wall = time.perf_counter() - t0
        mbps = (hot_bytes / wall / 1e6) if wall > 0 else 0.0
        with self._lock:
            st.update(state=WARM, wall_s=round(wall, 3),
                      demote_mbps=round(mbps, 2),
                      overlap_frac=timings.get("overlap_frac", 0.0),
                      trace_id=timings.get("trace_id", ""),
                      finished_at=time.time())
            self._inflight.discard(vid)
            self.demotions_ok += 1
        MASTER_TIER_DEMOTIONS.inc("ok")
        MASTER_TIER_SECONDS.inc(amount=wall)
        if hot_bytes:
            MASTER_TIER_BYTES.inc(amount=hot_bytes)
        MASTER_TIER_MBPS_GAUGE.set(round(mbps, 2))
        log.info("volume %s demoted hot→warm: %.1f MB in %.2fs (%.1f MB/s, "
                 "rate cap %s)", vid, hot_bytes / 1e6, wall, mbps,
                 self.rate_mbps or "off")

    # -- observability --------------------------------------------------------
    def _export_gauges(self):
        counts = {CANDIDATE: 0, DEMOTING: 0, WARM: 0, FAILED: 0}
        with self._lock:
            for st in self._volumes.values():
                counts[st["state"]] = counts.get(st["state"], 0) + 1
        for state, n in counts.items():
            MASTER_TIER_VOLUMES_GAUGE.set(n, state)

    def snapshot(self) -> dict:
        """The /cluster/tiering payload."""
        with self._lock:
            volumes = {str(vid): dict(st)
                       for vid, st in self._volumes.items()}
            scans, ok, failed = (self.scans, self.demotions_ok,
                                 self.demotions_failed)
        return {
            "enabled": self.enabled,
            "scans": scans,
            "demotions_ok": ok,
            "demotions_failed": failed,
            "knobs": {
                "interval_s": self.interval,
                "age_s": self.age_s,
                "concurrency": self.concurrency,
                "rate_mbps": self.rate_mbps,
                "full_frac": self.full_frac,
            },
            "volumes": volumes,
        }
