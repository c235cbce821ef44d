"""MasterServer — the cluster's coordinator, one master without raft.

The JAX package's ``server/master.py`` in the part a port cluster runs:
volume servers register through heartbeats (full, or a delta against the
state last acknowledged; an unknown server's delta is answered
``resync``), say goodbye on a clean stop, and are dropped once silent
for five pulses (a heartbeat carries its server's collect number, and
one older than a collect already applied is answered ``stale`` and not
applied); clients are handed file ids on writable volumes, with
volumes grown on demand over the servers' ``/admin/assign_volume``; the
volume and EC shard maps are looked up and pushed to watchers.

    POST /cluster/heartbeat   register a server (full, delta, resync)
    POST /cluster/goodbye     drop a server now
    *    /dir/assign          a file id (count, collection, replication,
                              ttl, dataCenter); grows volumes when none
                              is writable
    *    /vol/grow            grow ``count`` volumes
    *    /dir/lookup          a volume's locations
    GET  /cluster/watch       long-poll of location events
    *    /cluster/ec_lookup   an EC volume's shard holders
    *    /cluster/ec_status   every EC volume's shard holders
    *    /cluster/volumes     every volume replica's info
    *    /dir/status          the topology
    *    /vol/status          the volume map by data center and rack
    *    /cluster/status      the servers
    POST /cluster/scrub_report  a scrub's corruption finding: one
                              incident per corrupt shard
    GET  /cluster/repairs     the repair queue (``?refresh=1`` scans the
                              shard map first)
    GET  /<fid>               301 to one of the volume's holders

Paths, query parameters, status codes and JSON are the JAX master's.
Every random draw (a volume for a write, a file id's cookie, placement,
the redirect's holder) comes from one ``random.Random`` that the master
owns, seeded by ``seed``; the JAX master draws the same values in the
same order from the module-global ``random`` (placement from an unseeded
``random.Random``). The JAX package's knob defaults are constants here:
``PULSE_S`` (SW_PULSE_S), ``GROWTH_COUNTS`` and ``REPAIR_INTERVAL_S``
(SW_REPAIR_INTERVAL_S, the ``repair_interval`` argument).

The integrity plane: scrub findings and the scan of the shard map open
incidents in a ``stats/repair_queue.RepairQueue``; every
``repair_interval`` seconds (<= 0: no loop) the master scans and drains up
to four: a corrupt shard goes to ``/admin/ec/scrub_repair`` on its
holder, a lost one to ``/admin/ec/rebuild`` and ``/admin/ec/mount`` on a
holder of the volume's lowest shard. A stripe's hole counts as a loss
only once the stripe was seen whole (a streamed encode registers its
shards one by one). The JAX scan also opens ``at_risk_holder`` incidents
from the fleet health fold; that fold is not ported, so this scan opens
none (the queue keeps the kind).

Left out: raft and its sequencers; the metrics, aggregate, health and
tiering planes (``/cluster/health``); the vacuum and maintenance loops
(``/vol/vacuum``); ``/col/delete`` and ``/submit``; the whitelist guard
and JWT; ``/stats/*`` and the UI. The master does no device work.

    python3 -m seaweedfs_tpu_torch.server.master [-port 9333] [-ip HOST]
        [-volumeSizeLimitMB N] [-defaultReplication 000]
        [-pulseSeconds S] [-seed N] [-repairInterval S]

serves until killed and prints ``master listening on <host>:<port>``.
"""

from __future__ import annotations

import argparse
import logging
import random
import signal
import sys
import threading
from typing import Optional

from ..ec.constants import TOTAL_SHARDS
from ..stats.repair_queue import RepairQueue
from ..storage.types import TTL, ReplicaPlacement, parse_file_id
from ..topology.topology import Topology
from ..topology.volume_growth import NoFreeSlots, find_empty_slots
from .http_util import (HttpError, HttpServer, Request, Response, Router,
                        post_json)
from .watch_hub import WatchHub

PULSE_S = 5.0        # SW_PULSE_S: a heartbeat's period; 5 missed: pruned
# volumes grown per growth event, by the placement's copy count
GROWTH_COUNTS = {1: 7, 2: 6, 3: 3}
REPAIR_INTERVAL_S = 5.0  # SW_REPAIR_INTERVAL_S; <= 0: no repair loop
REPAIR_DRAIN = 4         # incidents drained a tick
VERSION = "seaweedfs_tpu 0.1"

log = logging.getLogger(__name__)


class MasterServer:
    def __init__(self, port: int = 9333, host: str = "127.0.0.1",
                 volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: Optional[float] = None,
                 seed: Optional[int] = None,
                 repair_interval: float = REPAIR_INTERVAL_S):
        self.rng = random.Random(seed)
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=PULSE_S if pulse_seconds is None
            else pulse_seconds, rng=self.rng)
        self.default_replication = default_replication
        self.vg_lock = threading.Lock()
        self.host = host

        router = Router()
        router.add("*", "/dir/assign", self.dir_assign)
        router.add("*", "/dir/lookup", self.dir_lookup)
        router.add("*", "/dir/status", self.dir_status)
        router.add("*", "/vol/grow", self.vol_grow)
        router.add("*", "/vol/status", self.vol_status)
        router.add("POST", "/cluster/heartbeat", self.cluster_heartbeat)
        router.add("POST", "/cluster/goodbye", self.cluster_goodbye)
        router.add("*", "/cluster/status", self.cluster_status)
        router.add("*", "/cluster/ec_lookup", self.ec_lookup)
        router.add("*", "/cluster/ec_status", self.ec_status)
        router.add("*", "/cluster/volumes", self.cluster_volumes)
        router.add("GET", "/cluster/watch", self.cluster_watch)
        router.add("GET", "/cluster/repairs", self.cluster_repairs)
        router.add("POST", "/cluster/scrub_report",
                   self.cluster_scrub_report)
        router.set_fallback(self.redirect_handler)
        # heartbeats and node deaths publish location events here;
        # clients long-poll /cluster/watch
        self.watch_hub = WatchHub(self._location_snapshot)
        self.topology.location_listener = self.watch_hub.publish
        self.server = HttpServer(port, router, host)
        self.port = self.server.port
        self._pruner = threading.Thread(target=self._prune_loop, daemon=True,
                                        name="master-pruner")
        self._stop = threading.Event()
        # the newest (boot, seq) applied per server: heartbeats post at
        # once, so an older collect can arrive after a newer one and is
        # dropped (it would roll back shard bits and revive volumes)
        self._hb_order_lock = threading.Lock()
        self._hb_order: dict = {}
        # the integrity plane: incidents from scrub findings and from the
        # shard map, drained into repairs on the holders
        self.repair_queue = RepairQueue()
        # vids whose stripe the scan has seen whole at least once: only
        # those can lose a shard (a hole mid-encode is no loss)
        self._repair_seen_complete: set = set()
        self.repair_interval = float(repair_interval)
        self._repair_thread = threading.Thread(
            target=self._repair_loop, daemon=True,
            name="master-repair-queue") if self.repair_interval > 0 \
            else None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MasterServer":
        self.server.start()
        self._pruner.start()
        if self._repair_thread is not None:
            self._repair_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.server.stop()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def _prune_loop(self):
        while not self._stop.wait(self.topology.pulse_seconds):
            self.topology.prune_dead_nodes()

    # -- heartbeats ----------------------------------------------------------
    def cluster_heartbeat(self, req: Request):
        hb = req.json()
        url = f"{hb.get('ip', '127.0.0.1')}:{int(hb.get('port', 0))}"
        order = tuple(hb["seq"]) if hb.get("seq") else None
        with self._hb_order_lock:
            last = self._hb_order.get(url)
            if order is not None and last is not None and order < last:
                return {"stale": True,
                        "volume_size_limit": self.topology.volume_size_limit,
                        "leader": self.url}
            resp = self._apply_heartbeat(hb, url)
            if order is not None and not resp.get("resync"):
                self._hb_order[url] = order
        return resp

    def _apply_heartbeat(self, hb: dict, url: str) -> dict:
        # the EC shard bits ride every heartbeat, delta or full
        ec_shards = {int(k): v
                     for k, v in (hb.get("ec_shards") or {}).items()}
        ec_collections = {int(k): v for k, v in
                          (hb.get("ec_collections") or {}).items()}
        if hb.get("delta"):
            applied = self.topology.apply_heartbeat_delta(
                url=url,
                new_volumes=hb.get("new_volumes", []),
                deleted_volumes=[int(v) for v in
                                 hb.get("deleted_volumes", [])],
                ec_shards=ec_shards, ec_collections=ec_collections,
                max_file_key=int(hb.get("max_file_key", 0)))
            if not applied:
                # the master lost (or never had) this server: ask for its
                # whole state
                return {"resync": True,
                        "volume_size_limit": self.topology.volume_size_limit,
                        "leader": self.url}
        else:
            self.topology.register_heartbeat(
                dc_id=hb.get("data_center", ""),
                rack_id=hb.get("rack", ""),
                ip=hb.get("ip", "127.0.0.1"),
                port=int(hb.get("port", 0)),
                public_url=hb.get("public_url", ""),
                fast_url=hb.get("fast_url", ""),
                max_volume_count=int(hb.get("max_volume_count", 7)),
                volumes=hb.get("volumes", []),
                ec_shards=ec_shards,
                ec_collections=ec_collections,
                max_file_key=int(hb.get("max_file_key", 0)))
        return {"volume_size_limit": self.topology.volume_size_limit,
                "leader": self.url}

    def cluster_goodbye(self, req: Request):
        """A server stopping cleanly: drop it now and push the deletions,
        instead of waiting for its expiry."""
        url = req.json().get("url", "")
        node = self.topology.find_node(url)
        if node is not None:
            self.topology.unregister_node(node)
        return {"removed": node is not None}

    # -- assignment and growth -----------------------------------------------
    def dir_assign(self, req: Request):
        count = int(req.query.get("count", 1))
        collection = req.query.get("collection", "")
        replication = req.query.get("replication") \
            or self.default_replication
        ttl = TTL.parse(req.query.get("ttl", ""))
        preferred_dc = req.query.get("dataCenter", "")

        picked = self.topology.pick_for_write(collection, replication, ttl,
                                              count)
        if picked is None:
            with self.vg_lock:
                picked = self.topology.pick_for_write(
                    collection, replication, ttl, count)
                if picked is None:
                    try:
                        self._grow_volumes(collection, replication, ttl,
                                           preferred_dc)
                    except NoFreeSlots as e:
                        raise HttpError(
                            406, f"no free volumes: {e}") from None
                    picked = self.topology.pick_for_write(
                        collection, replication, ttl, count)
        if picked is None:
            raise HttpError(406, "no writable volumes")
        fid, cnt, node, _ = picked
        out = {"fid": fid, "url": node.url,
               "publicUrl": node.public_url, "count": cnt}
        if node.fast_url:
            out["fastUrl"] = node.fast_url
        return out

    def _grow_volumes(self, collection: str, replication: str, ttl: TTL,
                      preferred_dc: str = "", count: int = None) -> int:
        """Create ``count`` volumes (by default GROWTH_COUNTS of the
        placement's copy count) on placed servers; a placement that fails
        after at least one volume grew ends the growth."""
        rp = ReplicaPlacement.parse(replication)
        if count is None:
            count = GROWTH_COUNTS.get(rp.copy_count, 1)
        grown = 0
        for _ in range(count):
            try:
                nodes = find_empty_slots(self.topology, rp, preferred_dc,
                                         rng=self.rng)
            except NoFreeSlots:
                if grown:
                    break
                raise
            vid = self.topology.next_volume_id()
            ok = True
            for n in nodes:
                try:
                    post_json(f"http://{n.url}/admin/assign_volume"
                              f"?volume={vid}&collection={collection}"
                              f"&replication={replication}&ttl={ttl}")
                except HttpError:
                    ok = False
                    break
            if ok:
                grown += 1
        return grown

    def vol_grow(self, req: Request):
        collection = req.query.get("collection", "")
        replication = req.query.get("replication") \
            or self.default_replication
        ttl = TTL.parse(req.query.get("ttl", ""))
        count = int(req.query.get("count", 1))
        with self.vg_lock:
            grown = self._grow_volumes(collection, replication, ttl,
                                       req.query.get("dataCenter", ""),
                                       count)
        return {"count": grown}

    # -- lookups -------------------------------------------------------------
    @staticmethod
    def _location(n) -> dict:
        return {"url": n.url, "publicUrl": n.public_url,
                **({"fastUrl": n.fast_url} if n.fast_url else {})}

    def _location_snapshot(self):
        with self.topology.lock:
            out = {}
            for node in self.topology.all_nodes():
                for vid in node.volumes:
                    out.setdefault(str(vid), []).append(self._location(node))
            return out

    def cluster_watch(self, req: Request):
        since = int(req.query.get("since", 0))
        timeout = min(float(req.query.get("timeout", 20)), 25.0)
        return self.watch_hub.wait(since, timeout)

    def dir_lookup(self, req: Request):
        vid_s = req.query.get("volumeId", "")
        if "," in vid_s:
            vid_s = vid_s.split(",")[0]
        if not vid_s:
            raise HttpError(400, "volumeId required")
        vid = int(vid_s)
        locs = self.topology.lookup(req.query.get("collection", ""), vid)
        if not locs:
            raise HttpError(404, f"volume {vid} not found")
        return {"volumeId": vid_s,
                "locations": [self._location(n) for n in locs]}

    def ec_lookup(self, req: Request):
        vid = int(req.query.get("volumeId", 0))
        shards = self.topology.lookup_ec_shards(vid)
        if shards is None:
            raise HttpError(404, f"ec volume {vid} not found")
        return {"volumeId": vid, "shards": shards}

    def ec_status(self, req: Request):
        """Every EC volume: its collection and shard id -> holder urls."""
        with self.topology.lock:
            return {"volumes": {
                str(vid): {
                    "collection": self.topology.ec_collections.get(vid, ""),
                    "shards": {str(sid): [n.url for n in holders]
                               for sid, holders in enumerate(per_shard)
                               if holders},
                } for vid, per_shard in self.topology.ec_shard_map.items()}}

    def cluster_volumes(self, req: Request):
        """Every volume replica: vid -> [{url, ...volume info}]."""
        out = {}
        with self.topology.lock:
            for node in self.topology.all_nodes():
                for vid, vi in list(node.volumes.items()):
                    d = vi.to_dict()
                    d["url"] = node.url
                    out.setdefault(str(vid), []).append(d)
        return {"volumes": out}

    def dir_status(self, req: Request):
        return {"topology": self.topology.to_dict(),
                "volumeSizeLimit": self.topology.volume_size_limit,
                "version": VERSION}

    def vol_status(self, req: Request):
        """The volume map by data center, rack and server."""
        with self.topology.lock:
            dcs = {}
            total_max = 0
            for dc in self.topology.data_centers.values():
                racks = {}
                for rack in dc.racks.values():
                    racks[rack.id] = {
                        f"{n.ip}:{n.port}":
                            [vi.to_dict() for vi in n.volumes.values()]
                        for n in rack.nodes.values()}
                    total_max += sum(n.max_volume_count
                                     for n in rack.nodes.values())
                dcs[dc.id] = racks
            used = sum(len(n.volumes) for n in self.topology.all_nodes())
        return {"Version": VERSION,
                "Volumes": {"Max": total_max, "Free": total_max - used,
                            "DataCenters": dcs}}

    def cluster_status(self, req: Request):
        return {"isLeader": True, "leader": self.url, "peers": [],
                "nodes": [n.to_dict() for n in self.topology.all_nodes()]}

    # -- the integrity plane -------------------------------------------------
    def cluster_repairs(self, req: Request):
        """The repair queue: open incidents by priority, the recently
        resolved with their time to re-protection, and its counters.
        ``?refresh=1`` scans the shard map first."""
        if req.query.get("refresh"):
            self._repair_scan()
        return self.repair_queue.snapshot()

    def cluster_scrub_report(self, req: Request):
        """A volume server's scrub finding: one corruption incident per
        corrupt shard, or one keyed shard -1 when the finding pins no
        shard, so that the exposure is still tracked."""
        finding = req.json()
        vid = int(finding.get("volume", 0))
        shards = [int(s) for s in (finding.get("shards") or [])] or [-1]
        detected = finding.get("detected_at")
        opened = []
        for sid in shards:
            inc = self.repair_queue.report(
                "corruption", volume=vid, shard=sid,
                source=str(finding.get("source", "")),
                detail={"slabs": finding.get("slabs"),
                        "columns": finding.get("columns"),
                        "collection": finding.get("collection", "")},
                detected_at=float(detected) if detected else None)
            opened.append(inc.id)
        return {"volume": vid, "incidents": opened}

    def _repair_scan(self):
        """Open and close lost-shard incidents from the shard map the
        heartbeats built. Idempotent: a repeat sighting collapses onto
        the open incident, which keeps its first detection time."""
        with self.topology.lock:
            shard_map = {vid: [[n.url for n in holders]
                               for holders in per_shard]
                         for vid, per_shard in
                         self.topology.ec_shard_map.items()}
        for vid, per_shard in shard_map.items():
            if not any(per_shard):
                continue  # a volume gone from every holder: no shard loss
            present = sum(1 for holders in per_shard if holders)
            if present == TOTAL_SHARDS:
                self._repair_seen_complete.add(vid)
            # a hole is a loss only if the stripe was once whole: a
            # streamed encode registers its shards one by one
            if vid not in self._repair_seen_complete:
                continue
            for sid in range(TOTAL_SHARDS):
                holders = per_shard[sid] if sid < len(per_shard) else []
                if holders:
                    self.repair_queue.resolve("lost_shard", volume=vid,
                                              shard=sid, via="remounted")
                else:
                    self.repair_queue.report("lost_shard", volume=vid,
                                             shard=sid, source=self.url)
        # volumes gone from the map: their incidents are moot
        self._repair_seen_complete &= set(shard_map)
        for inc in list(self.repair_queue.snapshot()["open"]):
            if inc["kind"] == "lost_shard" \
                    and inc["volume"] not in shard_map:
                self.repair_queue.resolve("lost_shard",
                                          volume=inc["volume"],
                                          shard=inc["shard"],
                                          via="volume_removed")

    def _repair_loop(self):
        while not self._stop.wait(self.repair_interval):
            try:
                self._repair_scan()
                for _ in range(REPAIR_DRAIN):
                    inc = self.repair_queue.next_incident()
                    if inc is None:
                        break
                    self._drain_one(inc)
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                log.warning("repair loop failed: %s", e)

    def _drain_one(self, inc):
        """One incident through the repair routes: a corrupt shard's
        holder quarantines and rebuilds it (``/admin/ec/scrub_repair``);
        for a lost shard a holder of the volume's lowest shard streams it
        back (``/admin/ec/rebuild``, then ``/admin/ec/mount``). A failure
        backs the incident off."""
        vid = inc.volume
        shards = self.topology.lookup_ec_shards(vid) or {}
        collection = self.topology.ec_collections.get(vid, "")
        try:
            if inc.kind == "corruption":
                if inc.shard < 0 or not shards.get(inc.shard):
                    raise RuntimeError(
                        f"no holder for corrupt shard {vid}.{inc.shard}")
                target = shards[inc.shard][0]
                sources = {str(s): [u for u in urls if u != target]
                           for s, urls in shards.items() if s != inc.shard}
                post_json(
                    f"http://{target}/admin/ec/scrub_repair"
                    f"?volume={vid}&shard={inc.shard}"
                    f"&collection={collection}",
                    {"sources": sources}, timeout=300)
                self.repair_queue.resolve("corruption", volume=vid,
                                          shard=inc.shard,
                                          via="scrub_repair")
            elif inc.kind == "lost_shard":
                if not shards:
                    raise RuntimeError(f"no survivors for volume {vid}")
                # a holder of the volume's shards: its own rows never
                # cross the wire
                target = shards[min(shards)][0]
                sources = {str(s): urls for s, urls in shards.items()
                           if target not in urls}
                out = post_json(
                    f"http://{target}/admin/ec/rebuild"
                    f"?volume={vid}&collection={collection}",
                    {"sources": sources}, timeout=300)
                rebuilt = out.get("rebuilt") or []
                if not rebuilt:
                    raise RuntimeError(f"rebuild of {vid} restored "
                                       f"nothing")
                post_json(
                    f"http://{target}/admin/ec/mount?volume={vid}"
                    f"&collection={collection}"
                    f"&shards={','.join(map(str, rebuilt))}", {},
                    timeout=60)
                for sid in rebuilt:
                    self.repair_queue.resolve("lost_shard", volume=vid,
                                              shard=int(sid),
                                              via="rebuild")
        except Exception as e:  # noqa: BLE001 - back off, retry later
            self.repair_queue.attempt_failed(inc, str(e))
            log.warning("repair of %s %s.%s failed: %s", inc.kind, vid,
                        inc.shard, e)

    def redirect_handler(self, req: Request):
        """GET /<fid>: a 301 to one of the volume's holders, drawn with
        the master's rng, the query kept. A path that is not a fid is a
        404."""
        try:
            vid, _, _ = parse_file_id(req.path.lstrip("/"))
        except ValueError:
            raise HttpError(404, f"no such path {req.path}") from None
        q = ("?" + req.raw_query) if req.raw_query else ""
        locs = self.topology.lookup(req.query.get("collection", ""), vid)
        if not locs:
            raise HttpError(404, f"volume {vid} not found")
        node = self.rng.choice(locs)
        return Response(b"", 301, headers={
            "Location": f"http://{node.public_url}{req.path}{q}"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="A master: volume servers heartbeat to it, clients "
                    "assign and look up through it.")
    ap.add_argument("-port", type=int, default=9333, help="0 picks a port")
    ap.add_argument("-ip", default="127.0.0.1")
    ap.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    ap.add_argument("-defaultReplication", default="000")
    ap.add_argument("-pulseSeconds", type=float, default=PULSE_S)
    ap.add_argument("-seed", type=int, default=None,
                    help="seed of the master's random draws")
    ap.add_argument("-repairInterval", type=float,
                    default=REPAIR_INTERVAL_S,
                    help="seconds between repair-queue scans and drains "
                         "(<= 0: none)")
    args = ap.parse_args(argv)
    m = MasterServer(port=args.port, host=args.ip,
                     volume_size_limit_mb=args.volumeSizeLimitMB,
                     default_replication=args.defaultReplication,
                     pulse_seconds=args.pulseSeconds, seed=args.seed,
                     repair_interval=args.repairInterval).start()
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    print(f"master listening on {m.url}", flush=True)
    while not done.wait(1.0):
        pass
    m.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
