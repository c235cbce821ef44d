"""MasterServer — the cluster's coordinator, alone or one of a raft group.

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
    GET  /cluster/tiering     the tierer's per-volume demotion state, knobs
                              and counters (``?scan=1`` runs one scan and
                              demotion pass first)
    GET  /metrics             the master's Prometheus exposition
    GET  /cluster/metrics     every node's /metrics merged: counters and
                              histograms summed, gauges by ``node``
                              (``?refresh=1`` scrapes first)
    GET  /cluster/health      the per-holder health fold, the nodes'
                              freshness and the repair queue's summary
    GET  /admin/traces        the trace ring; /admin/traces/export one
                              trace as Chrome trace events
    POST /admin/profile       every thread's stacks sampled for
                              ``?seconds=``
    GET  /stats/health, /stats/memory
    GET  /, /ui               the status page (servers, volumes, traces)
    *    /vol/vacuum          compact every volume whose garbage exceeds
                              ``garbageThreshold`` on all its replicas,
                              then commit on all of them
    *    /col/delete          delete a collection's volumes everywhere
    POST /submit              assign a file id and upload the body to it
    GET  /<fid>               301 to one of the volume's holders
    POST /raft/request_vote, /raft/append_entries, /raft/install_snapshot
    GET  /raft/status         the raft RPCs and the node's state (with
                              ``peers`` only)

Paths, query parameters, status codes and JSON are the JAX master's.
Every random draw (a volume for a write, a file id's cookie, placement,
the redirect's holder) comes from one ``random.Random`` that the master
owns, seeded by ``seed``; the JAX master draws the same values in the
same order from the module-global ``random`` (placement from an unseeded
``random.Random``). The JAX package's knob defaults are constants here:
``PULSE_S`` (SW_PULSE_S), ``GROWTH_COUNTS`` and ``REPAIR_INTERVAL_S``
(SW_REPAIR_INTERVAL_S, the ``repair_interval`` argument); the vacuum and
maintenance defaults are those of the JAX master's flags.

The integrity plane: scrub findings and the scan of the shard map open
incidents in a ``stats/repair_queue.RepairQueue``; every
``repair_interval`` seconds (<= 0: no loop) the master scans and drains up
to four: a corrupt shard goes to ``/admin/ec/scrub_repair`` on its
holder, a lost one to ``/admin/ec/rebuild`` and ``/admin/ec/mount`` on a
holder of the volume's lowest shard. A stripe's hole counts as a loss
only once the stripe was seen whole (a streamed encode registers its
shards one by one). The scan also opens an advisory ``at_risk_holder``
incident for each holder the fleet health fold scores below
``at_risk_score`` (``REPAIR_AT_RISK_SCORE``, SW_REPAIR_AT_RISK_SCORE), and
resolves it ``recovered`` once the score is back above it by 0.1; the
drain passes such incidents by.

Observability: every request runs in a server span that continues the
caller's ``traceparent`` and feeds ``SeaweedFS_master_request_*``. A
``ClusterMetricsAggregator`` scrapes every registered server's
``/metrics`` every ``stats/aggregate.CLUSTER_SCRAPE_S`` seconds
(SW_CLUSTER_SCRAPE_S) and serves the merge and the health fold. With
``metrics_address`` (``-metrics.address``) every heartbeat answer names
that push gateway and ``metrics_interval``.

The volume control plane: every ``vacuum_interval`` seconds (<= 0: no
loop) the master vacuums the volumes over ``garbage_threshold`` and
reaps the TTL volumes whose content outlived their TTL by a tenth (each
marked readonly in every layout first, and kept registered until its
delete succeeds); a manual ``/vol/vacuum`` never reaps. Every
``maintenance_interval`` seconds the ';'-separated shell lines of
``maintenance_scripts`` run against this master (no loop without
scripts). ``/col/delete`` keeps the layout of a volume whose delete
failed, so that the volume stays looked up until a later delete takes
it (the JAX master drops the layout and orphans such a volume).

High availability: with ``peers`` (a comma list of every master's
host:port, this one included) the masters form a raft group
(``topology/raft``) that persists its state under ``raft_dir``. Only the
leader holds the topology: volume servers heartbeat to it (a follower
answers a heartbeat ``not_leader`` with the leader's url), and a
follower forwards every other route to it (``X-Raft-Forwarded`` stops a
loop; a body goes over as opaque bytes with its Content-Type and
Authorization), but ``GET /<fid>``, which a follower answers with a 301
to the leader. A new volume id is a raft command, and file keys come
from a ``RaftSequencer`` unless ``sequencer`` is given (an
``EtcdSequencer``), so a new leader never issues an id or a key again.
An assign that loses the leadership or times out in the raft commit
answers a retriable 503 naming the leader. The vacuum, repair and
maintenance loops act on the leader only.

The guard: with a ``whitelist`` (IPs, "10.0."-style prefixes, CIDRs) a
caller from elsewhere gets 403, but on the cluster's own channels
(``/cluster/heartbeat``, ``/cluster/goodbye``, ``/cluster/scrub_report``,
``/raft/*``). With a ``jwt_signing_key`` an assign's answer carries
``auth``, a write token bound to its fid, which ``/submit`` sends on.

Hot→warm tiering: the master owns a ``server/tiering.VolumeTierer``;
with ``tier_enable`` its loop (leader only, every ``tier_interval``
seconds) demotes the sealed volumes untouched for ``tier_age`` seconds
onto EC, each a paced streaming encode on its source's card.

Transport security: the process's ``server/http_util`` TLS (the CLI
configures it from ``-tls*`` or ``security.toml``). Under mutual TLS
``/cluster/*``, ``/raft/*`` and ``/vol/*`` answer 403 to a connection
that presented no client certificate; ``/dir/*``, ``/submit``, the
status page and ``GET /<fid>`` stay public. ``growth_counts`` (copy
count, or ``"other"``, to volumes grown an event: master.toml's
``[master.volume_growth]``) replaces entries of ``GROWTH_COUNTS``;
``maintenance_filer_url`` is the filer the maintenance shell is handed.
The master does no device work.

    python3 -m seaweedfs_tpu_torch.server.master [-port 9333] [-ip HOST]
        [-volumeSizeLimitMB N] [-defaultReplication 000]
        [-pulseSeconds S] [-seed N] [-repairInterval S]
        [-vacuumIntervalSeconds 900] [-garbageThreshold 0.3]
        [-maintenanceScripts "volume.vacuum; ec.rebuild"]
        [-maintenanceIntervalSeconds 1020] [-peers H:P,H:P,H:P]
        [-mdir DIR] [-jwtKey KEY] [-whiteList IP,PREFIX.,CIDR]
        [-metrics.address H:P] [-metrics.intervalSeconds 15]
        [-tierEnable] [-tierInterval 60] [-tierAge 3600]
        [-tierConcurrency 1] [-tierRateMBps 8] [-tierFullFrac 0.95]
        [-sequencer etcd -sequencerEtcd H:P [-sequencerEtcdUser U
         -sequencerEtcdPassword P]]

serves until killed and prints ``master listening on <host>:<port>``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import signal
import sys
import tempfile
import threading
import time
from typing import Optional

from ..ec.constants import TOTAL_SHARDS
from ..security.guard import Guard
from ..security.jwt import GenJwt
from ..shell.command_env import split_script
from ..stats import metrics
from ..stats.aggregate import ClusterMetricsAggregator
from ..stats.repair_queue import RepairQueue
from ..storage.super_block import SUPER_BLOCK_SIZE
from ..storage.types import TTL, ReplicaPlacement, parse_file_id
from ..topology.raft import NotLeaderError, RaftNode
from ..topology.topology import RaftSequencer, Topology
from ..topology.volume_growth import NoFreeSlots, find_empty_slots
from ..util import tracing
from ..util.locks import make_lock
from . import tiering
from .http_util import (HttpError, HttpServer, Request, Response, Router,
                        http_call, post_json, post_multipart,
                        process_memory_stats, profile_handler,
                        require_client_cert, traces_export_handler,
                        traces_handler)
from .watch_hub import WatchHub

PULSE_S = 5.0        # SW_PULSE_S: a heartbeat's period; 5 missed: pruned
# volumes grown per growth event, by the placement's copy count
GROWTH_COUNTS = {1: 7, 2: 6, 3: 3}
REPAIR_INTERVAL_S = 5.0  # SW_REPAIR_INTERVAL_S; <= 0: no repair loop
REPAIR_DRAIN = 4         # incidents drained a tick
REPAIR_AT_RISK_SCORE = 0.4  # SW_REPAIR_AT_RISK_SCORE: health fold floor
VACUUM_INTERVAL_S = 15 * 60       # -vacuumIntervalSeconds; <= 0: no loop
GARBAGE_THRESHOLD = 0.3           # -garbageThreshold
MAINTENANCE_INTERVAL_S = 17 * 60  # -maintenanceIntervalSeconds
MAINTENANCE_ADMIN_TIMEOUT_S = 900.0  # an unattended admin call's bound
VERSION = "seaweedfs_tpu 0.1"
# the routes a whitelist leaves open: servers and raft peers, not clients
GUARD_EXEMPT = ("/cluster/heartbeat", "/cluster/goodbye",
                "/cluster/scrub_report")

log = logging.getLogger(__name__)


class MasterServer:
    def __init__(self, port: int = 9333, host: str = "127.0.0.1",
                 volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: Optional[float] = None,
                 seed: Optional[int] = None,
                 repair_interval: float = REPAIR_INTERVAL_S,
                 garbage_threshold: float = GARBAGE_THRESHOLD,
                 vacuum_interval: float = VACUUM_INTERVAL_S,
                 maintenance_scripts: str = "",
                 maintenance_interval: float = MAINTENANCE_INTERVAL_S,
                 peers: str = "", raft_dir: str = "",
                 jwt_signing_key: str = "", whitelist=(),
                 sequencer=None, metrics_address: str = "",
                 metrics_interval: int = 15,
                 at_risk_score: float = REPAIR_AT_RISK_SCORE,
                 tier_enable: bool = tiering.TIER_ENABLE,
                 tier_interval: float = tiering.TIER_INTERVAL_S,
                 tier_age: float = tiering.TIER_AGE_S,
                 tier_concurrency: int = tiering.TIER_CONCURRENCY,
                 tier_rate_mbps: float = tiering.TIER_RATE_MBPS,
                 tier_full_frac: float = tiering.TIER_FULL_FRAC,
                 growth_counts: Optional[dict] = None,
                 maintenance_filer_url: str = ""):
        self.rng = random.Random(seed)
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=PULSE_S if pulse_seconds is None
            else pulse_seconds, sequencer=sequencer, rng=self.rng)
        self.default_replication = default_replication
        self.jwt_signing_key = jwt_signing_key
        self.guard = Guard(whitelist)
        self.growth_counts = dict(growth_counts or {})
        self.maintenance_filer_url = maintenance_filer_url
        self.garbage_threshold = float(garbage_threshold)
        self.vg_lock = make_lock("torch.master.vg_lock")
        self.host = host

        router = Router()
        router.add("*", "/dir/assign", self.dir_assign)
        router.add("*", "/dir/lookup", self.dir_lookup)
        router.add("*", "/dir/status", self.dir_status)
        router.add("*", "/vol/grow", self.vol_grow)
        router.add("*", "/vol/status", self.vol_status)
        router.add("*", "/vol/vacuum", self.vol_vacuum)
        router.add("*", "/col/delete", self.col_delete)
        router.add("POST", "/submit", self.submit)
        router.add("POST", "/cluster/heartbeat", self.cluster_heartbeat)
        router.add("POST", "/cluster/goodbye", self.cluster_goodbye)
        router.add("*", "/cluster/status", self.cluster_status)
        router.add("*", "/cluster/ec_lookup", self.ec_lookup)
        router.add("*", "/cluster/ec_status", self.ec_status)
        router.add("*", "/cluster/volumes", self.cluster_volumes)
        router.add("GET", "/cluster/watch", self.cluster_watch)
        router.add("GET", "/cluster/repairs", self.cluster_repairs)
        router.add("GET", "/cluster/tiering", self.cluster_tiering)
        router.add("POST", "/cluster/scrub_report",
                   self.cluster_scrub_report)
        router.add("GET", "/metrics", self.metrics_handler)
        router.add("GET", "/cluster/metrics", self.cluster_metrics)
        router.add("GET", "/cluster/health", self.cluster_health)
        router.add("GET", "/admin/traces", traces_handler)
        router.add("GET", "/admin/traces/export", traces_export_handler)
        router.add("POST", "/admin/profile", profile_handler)
        router.add("GET", "/stats/health", self.stats_health)
        router.add("GET", "/stats/memory", self.stats_memory)
        router.add("GET", "/", self.ui_handler)
        router.add("GET", "/ui", self.ui_handler)
        router.set_fallback(self.redirect_handler)
        router.before = self._guard_check

        def observe(label, seconds, ok):
            metrics.MASTER_REQUEST_COUNTER.inc(
                label if ok else label + " error")
            metrics.MASTER_REQUEST_HISTOGRAM.observe(
                seconds, label, trace_id=tracing.current_trace_id())
        router.observe = observe
        # the push gateway the heartbeat answers name (reference
        # master_grpc_server.go:75-77)
        self.metrics_address = metrics_address
        self.metrics_interval = int(metrics_interval)
        # heartbeats and node deaths publish location events here;
        # clients long-poll /cluster/watch
        self.watch_hub = WatchHub(self._location_snapshot)
        self.topology.location_listener = self.watch_hub.publish
        self.server = HttpServer(port, router, host)
        self.port = self.server.port
        router.node = f"{host}:{self.port}"
        # every registered server's /metrics, scraped and merged
        self.cluster_agg = ClusterMetricsAggregator(self._scrape_targets)
        self._pruner = threading.Thread(target=self._prune_loop, daemon=True,
                                        name="master-pruner")
        self._stop = threading.Event()
        # the newest (boot, seq) applied per server: heartbeats post at
        # once, so an older collect can arrive after a newer one and is
        # dropped (it would roll back shard bits and revive volumes)
        self._hb_order_lock = make_lock("torch.master._hb_order_lock")
        self._hb_order: dict = {}
        # the integrity plane: incidents from scrub findings and from the
        # shard map, drained into repairs on the holders
        self.repair_queue = RepairQueue()
        # vids whose stripe the scan has seen whole at least once: only
        # those can lose a shard (a hole mid-encode is no loss)
        self._repair_seen_complete: set = set()
        self.repair_interval = float(repair_interval)
        self.at_risk_score = float(at_risk_score)
        self._repair_thread = threading.Thread(
            target=self._repair_loop, daemon=True,
            name="master-repair-queue") if self.repair_interval > 0 \
            else None
        # the vacuum and TTL reap, and the shell's maintenance scripts
        self.vacuum_interval = float(vacuum_interval)
        self._vacuum_thread = threading.Thread(
            target=self._vacuum_loop, daemon=True,
            name="master-vacuum") if self.vacuum_interval > 0 else None
        self.maintenance_scripts = split_script(maintenance_scripts)
        self.maintenance_interval = float(maintenance_interval)
        self._maintenance_runs = 0
        self._maintenance_thread = threading.Thread(
            target=self._maintenance_loop, daemon=True,
            name="master-maintenance") if self.maintenance_scripts \
            else None
        # hot→warm tiering: the leader's demotions of sealed volumes
        self.tierer = tiering.VolumeTierer(
            self, enabled=tier_enable, interval=tier_interval,
            age_s=tier_age, concurrency=tier_concurrency,
            rate_mbps=tier_rate_mbps, full_frac=tier_full_frac)
        self.raft: Optional[RaftNode] = None
        # requests this master forwarded to its leader
        self.forwarded = 0
        self._forwarded_lock = make_lock("torch.master._forwarded_lock")
        if peers:
            self._init_raft(peers, raft_dir, sequencer, seed, router)

    # -- raft ----------------------------------------------------------------
    def _init_raft(self, peers: str, raft_dir: str, sequencer, seed,
                   router: Router):
        if not raft_dir:
            # a node that forgets its vote can vote twice in one term and
            # elect two leaders: the state always goes somewhere
            raft_dir = default_meta_dir()
        # a snapshot holds committed state only: the topology's
        # max_volume_id is bumped before its propose (and rolled back on
        # a failure), so the apply stream keeps its own maximum
        self._raft_committed_max_vid = 0
        # installed before the node, so that a snapshot restored from
        # disk lands its ceiling in it; the propose resolves self.raft
        # when it is called
        if sequencer is None:
            self.topology.sequencer = RaftSequencer(
                lambda cmd: self.raft.propose(cmd))

        def snapshot_state():
            state = {"max_volume_id": self._raft_committed_max_vid}
            seq = self.topology.sequencer
            if isinstance(seq, RaftSequencer):
                state["sequence_ceiling"] = seq.ceiling()
            return state

        def restore_state(st):
            self._apply_raft({"type": "max_volume_id",
                              "value": int(st.get("max_volume_id", 0))})
            self._apply_raft({"type": "sequence_ceiling",
                              "value": int(st.get("sequence_ceiling", 0))})

        # each master draws its own election deadlines: one seed for all
        # would time them out together and split every vote
        rng = random.Random(f"{seed}-{self.url}") if seed is not None \
            else random.Random()
        self.raft = RaftNode(
            self.url, [p.strip() for p in peers.split(",") if p.strip()],
            self._apply_raft, state_dir=raft_dir,
            snapshot_state_fn=snapshot_state, restore_fn=restore_state,
            rng=rng)
        router.add("POST", "/raft/request_vote",
                   lambda req: self.raft.handle_request_vote(req.json()))
        router.add("POST", "/raft/append_entries",
                   lambda req: self.raft.handle_append_entries(req.json()))
        router.add("POST", "/raft/install_snapshot",
                   lambda req: self.raft.handle_install_snapshot(
                       req.json()))
        router.add("GET", "/raft/status", lambda req: self.raft.status())

    def _apply_raft(self, command: dict):
        """A committed raft command: the highest volume id, or a file-key
        sequence ceiling."""
        if command.get("type") == "max_volume_id":
            value = int(command["value"])
            self._raft_committed_max_vid = max(self._raft_committed_max_vid,
                                               value)
            with self.topology.lock:
                self.topology.max_volume_id = max(
                    self.topology.max_volume_id, value)
        elif command.get("type") == "sequence_ceiling":
            seq = self.topology.sequencer
            if isinstance(seq, RaftSequencer):
                seq.apply_ceiling(int(command["value"]),
                                  command.get("nonce"))

    def is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader

    def leader_url(self) -> str:
        if self.raft is None:
            return self.url
        return self.raft.leader() or ""

    def _leader_forward(self, req: Request):
        """The leader's answer to ``req`` when this master follows; None
        when this master leads (or runs alone) and answers itself. A
        request already forwarded once answers 503: the leadership is
        moving."""
        if self.is_leader():
            return None
        if req.headers.get("X-Raft-Forwarded"):
            raise HttpError(503, "raft leadership unsettled, retry")
        leader = self.leader_url()
        if not leader:
            raise HttpError(503, "no raft leader elected yet")
        with self._forwarded_lock:
            self.forwarded += 1
        url = f"http://{leader}{req.path}" + \
            (f"?{req.raw_query}" if req.raw_query else "")
        headers = {"X-Raft-Forwarded": "1"}
        # the headers that shape the body: without its Content-Type a
        # multipart /submit reaches the leader as opaque bytes
        for h in ("Content-Type", "Authorization"):
            v = req.headers.get(h)
            if v:
                headers[h] = v
        out = http_call(req.method, url, req.body or None, headers)
        return json.loads(out or b"{}")

    def _guard_check(self, req: Request):
        """Under mutual TLS, 403 for a cluster-internal route reached
        without a client certificate; then 403 for a caller off the
        whitelist, but on the cluster's own channels (volume servers and
        raft peers)."""
        if req.path.startswith(("/cluster/", "/raft/", "/vol/")):
            require_client_cert(req)
        if not self.guard.enabled:
            return
        if req.path in GUARD_EXEMPT or req.path.startswith("/raft/"):
            return
        if not self.guard.allows(req.handler.client_address[0]):
            raise HttpError(403, "ip not in whitelist")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MasterServer":
        self.server.start()
        self._pruner.start()
        self.cluster_agg.start()
        if self.raft is not None:
            self.raft.start()
        for thread in (self._repair_thread, self._vacuum_thread,
                       self._maintenance_thread):
            if thread is not None:
                thread.start()
        self.tierer.start()
        return self

    def stop(self):
        self._stop.set()
        self.cluster_agg.stop()
        if self.raft is not None:
            self.raft.stop()
        self.server.stop()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def _prune_loop(self):
        while not self._stop.wait(self.topology.pulse_seconds):
            self.topology.prune_dead_nodes()

    # -- heartbeats ----------------------------------------------------------
    def cluster_heartbeat(self, req: Request):
        # servers register with the leader only: a follower names it
        if not self.is_leader():
            return {"volume_size_limit": self.topology.volume_size_limit,
                    "leader": self.leader_url(), "not_leader": True}
        hb = req.json()
        url = f"{hb.get('ip', '127.0.0.1')}:{int(hb.get('port', 0))}"
        order = tuple(hb["seq"]) if hb.get("seq") else None
        with self._hb_order_lock:
            last = self._hb_order.get(url)
            if order is not None and last is not None and order < last:
                return {"stale": True,
                        "volume_size_limit": self.topology.volume_size_limit,
                        "leader": self.leader_url() or self.url}
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
                        "leader": self.leader_url() or self.url}
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
        out = {"volume_size_limit": self.topology.volume_size_limit,
               "leader": self.leader_url() or self.url}
        if self.metrics_address:
            # the master decides where and how often servers push
            out["metrics_address"] = self.metrics_address
            out["metrics_interval_seconds"] = self.metrics_interval
        return out

    def cluster_goodbye(self, req: Request):
        """A server stopping cleanly: drop it now and push the deletions,
        instead of waiting for its expiry."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        url = req.json().get("url", "")
        node = self.topology.find_node(url)
        if node is not None:
            self.topology.unregister_node(node)
        return {"removed": node is not None}

    # -- assignment and growth -----------------------------------------------
    def dir_assign(self, req: Request):
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        try:
            return self._dir_assign_local(req)
        except NotLeaderError as e:
            # deposed between the forward check and the sequencer's raft
            # grant: a retriable 503 naming the new leader
            raise HttpError(
                503, f"leadership changed during assign; leader is "
                     f"{e.leader or 'unknown'}") from None
        except TimeoutError:
            raise HttpError(
                503, "raft commit timed out during assign; retry") from None

    def _dir_assign_local(self, req: Request):
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
        if self.jwt_signing_key:
            out["auth"] = GenJwt(self.jwt_signing_key, fid)
        return out

    def _next_volume_id(self) -> int:
        """A new volume id; under raft a committed command, so that a new
        leader never issues it again."""
        if self.raft is None:
            return self.topology.next_volume_id()
        with self.topology.lock:
            # bumped before the propose, so two growths at once read two
            # values (the apply takes the maximum)
            value = self.topology.max_volume_id + 1
            self.topology.max_volume_id = value
        try:
            self.raft.propose({"type": "max_volume_id", "value": value})
        except Exception:
            # a failed propose leaves no bump that no entry backs (unless
            # a later one landed on top)
            with self.topology.lock:
                if self.topology.max_volume_id == value:
                    self.topology.max_volume_id = value - 1
            raise
        return value

    def _grow_volumes(self, collection: str, replication: str, ttl: TTL,
                      preferred_dc: str = "", count: int = None) -> int:
        """Create ``count`` volumes (by default the growth count of the
        placement's copy count: ``growth_counts``, else GROWTH_COUNTS) on
        placed servers; a placement that fails after at least one volume
        grew ends the growth."""
        rp = ReplicaPlacement.parse(replication)
        if count is None:
            key = rp.copy_count if rp.copy_count in GROWTH_COUNTS \
                else "other"
            count = self.growth_counts.get(key, GROWTH_COUNTS.get(key, 1))
        grown = 0
        for _ in range(count):
            try:
                nodes = find_empty_slots(self.topology, rp, preferred_dc,
                                         rng=self.rng)
            except NoFreeSlots:
                if grown:
                    break
                raise
            vid = self._next_volume_id()
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
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
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
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        since = int(req.query.get("since", 0))
        timeout = min(float(req.query.get("timeout", 20)), 25.0)
        return self.watch_hub.wait(since, timeout)

    def dir_lookup(self, req: Request):
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
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
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        vid = int(req.query.get("volumeId", 0))
        shards = self.topology.lookup_ec_shards(vid)
        if shards is None:
            raise HttpError(404, f"ec volume {vid} not found")
        return {"volumeId": vid, "shards": shards}

    def ec_status(self, req: Request):
        """Every EC volume: its collection and shard id -> holder urls."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
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
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        out = {}
        with self.topology.lock:
            for node in self.topology.all_nodes():
                for vid, vi in list(node.volumes.items()):
                    d = vi.to_dict()
                    d["url"] = node.url
                    out.setdefault(str(vid), []).append(d)
        return {"volumes": out}

    def dir_status(self, req: Request):
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        return {"topology": self.topology.to_dict(),
                "volumeSizeLimit": self.topology.volume_size_limit,
                "version": VERSION}

    def vol_status(self, req: Request):
        """The volume map by data center, rack and server."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
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
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        return {"isLeader": self.is_leader(),
                "leader": self.leader_url() or self.url,
                "peers": self.raft.peers if self.raft else [],
                "nodes": [n.to_dict() for n in self.topology.all_nodes()]}

    # -- observability -------------------------------------------------------
    def metrics_handler(self, req: Request):
        metrics.observe_repair_queue(self.repair_queue.snapshot())
        return Response(metrics.MASTER_GATHER.render().encode(),
                        content_type="text/plain; version=0.0.4")

    def _scrape_targets(self):
        with self.topology.lock:
            return [n.url for n in self.topology.all_nodes()]

    def cluster_metrics(self, req: Request):
        """The merged exposition: counters and histograms summed over the
        nodes, gauges per node under ``node=``. ``?refresh=1`` scrapes
        every node first; otherwise the loop's snapshots serve."""
        if req.query.get("refresh"):
            self.cluster_agg.scrape_once()
        return Response(self.cluster_agg.render().encode(),
                        content_type="text/plain; version=0.0.4")

    def cluster_health(self, req: Request):
        """The per-holder fold of every node's ``ec_holder_*`` families
        (the worst observer's score wins), the nodes' freshness and the
        repair queue's open incidents and time to re-protection."""
        if req.query.get("refresh"):
            self.cluster_agg.scrape_once()
        out = self.cluster_agg.holder_health()
        out["repairs"] = self.repair_queue.summary()
        return out

    def stats_health(self, req: Request):
        return {"ok": True, "leader": self.is_leader()}

    def stats_memory(self, req: Request):
        return process_memory_stats()

    def ui_handler(self, req: Request):
        """The status page (reference master_ui/templates.go)."""
        from .status_ui import master_status_page
        return Response(master_status_page(self),
                        content_type="text/html; charset=utf-8")

    # -- the integrity plane -------------------------------------------------
    def cluster_repairs(self, req: Request):
        """The repair queue: open incidents by priority, the recently
        resolved with their time to re-protection, and its counters.
        ``?refresh=1`` scans the shard map first."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        if req.query.get("refresh"):
            self._repair_scan()
        return self.repair_queue.snapshot()

    def cluster_tiering(self, req: Request):
        """The hot→warm view: each tracked volume's demotion state
        (candidate, demoting, warm, failed), the knobs and the pass
        counters. ``?scan=1`` runs one scan and demotion pass first, at
        once and without the loop."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        if req.query.get("scan"):
            self.tierer.run_pass()
        return self.tierer.snapshot()

    def cluster_scrub_report(self, req: Request):
        """A volume server's scrub finding: one corruption incident per
        corrupt shard, or one keyed shard -1 when the finding pins no
        shard, so that the exposure is still tracked."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
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
        heartbeats built, and at-risk-holder advisories from the health
        fold. Idempotent: a repeat sighting collapses onto the open
        incident, which keeps its first detection time."""
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
        health = self.cluster_agg.holder_health().get("holders", {})
        for holder, h in health.items():
            score = float(h.get("score", 1.0))
            if score < self.at_risk_score:
                self.repair_queue.report(
                    "at_risk_holder", holder=holder, source=self.url,
                    detail={"score": round(score, 3)})
            elif score > self.at_risk_score + 0.1:  # hysteresis
                self.repair_queue.resolve("at_risk_holder",
                                          holder=holder, via="recovered")

    def _repair_loop(self):
        while not self._stop.wait(self.repair_interval):
            if not self.is_leader():
                continue
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

    # -- the volume control plane --------------------------------------------
    def _ttl_expired_volumes(self):
        """Sorted (vid, [node urls]) of the TTL volumes whose content
        outlived its TTL by a tenth (the grace keeps tail reads served).
        An empty volume, a superblock and nothing more, never expires:
        it is a writable target (the JAX master tests ``size == 0``, which
        a heartbeat never reports, and reaps the empty volumes it grew)."""
        out = {}
        now = time.time()
        with self.topology.lock:
            for node in self.topology.all_nodes():
                for vid, vi in node.volumes.items():
                    ttl = TTL.from_uint32(vi.ttl or 0)
                    if ttl.minutes == 0 or vi.size <= SUPER_BLOCK_SIZE or \
                            not vi.modified_at:
                        continue
                    if now - vi.modified_at > ttl.minutes * 60 * 1.1:
                        out.setdefault(vid, []).append(node.url)
        return sorted(out.items())

    def _run_vacuum_pass(self, threshold: float = None,
                         reap_ttl: bool = False) -> dict:
        """One vacuum pass: each candidate compacted on every replica,
        then committed on every replica (a compact that fails leaves the
        others' .cpd/.cpx, which the next pass compacts over). With
        ``reap_ttl`` (the loop only) the expired TTL volumes are deleted
        too."""
        threshold = self.garbage_threshold if threshold is None \
            else threshold
        results = []
        for vid, nodes in self.topology.vacuum_candidates(threshold):
            ok = True
            for n in nodes:
                try:
                    post_json(f"http://{n.url}/admin/vacuum/compact"
                              f"?volume={vid}")
                except HttpError:
                    ok = False
                    break
            if ok:
                for n in nodes:
                    try:
                        post_json(f"http://{n.url}/admin/vacuum/commit"
                                  f"?volume={vid}")
                    except HttpError:
                        ok = False
            results.append({"volume": vid, "ok": ok})
        expired = []
        if reap_ttl:
            for vid, urls in self._ttl_expired_volumes():
                # no assign may hand out a fid of a dying volume, but it
                # stays registered until each replica's delete succeeds
                # (a delta heartbeat never sends an unchanged volume, so
                # a dropped but undeleted one would be orphaned)
                with self.topology.lock:
                    for layout in self.topology.layouts.values():
                        layout.set_volume_readonly(vid, True)
                reaped = []
                for u in urls:
                    try:
                        post_json(f"http://{u}/admin/delete_volume"
                                  f"?volume={vid}")
                    except HttpError:
                        continue  # still registered: the next pass retries
                    reaped.append(u)
                    with self.topology.lock:
                        node = self.topology.find_node(u)
                        if node is None:
                            continue
                        node.volumes.pop(vid, None)
                        for layout in self.topology.layouts.values():
                            layout.unregister_volume(vid, node)
                        self.topology._publish("deleted", vid, node)
                if reaped:
                    expired.append(vid)
        return {"vacuumed": results, "ttl_expired": expired}

    def _vacuum_loop(self):
        while not self._stop.wait(self.vacuum_interval):
            if not self.is_leader():
                continue
            try:
                out = self._run_vacuum_pass(reap_ttl=True)
                if out["vacuumed"] or out["ttl_expired"]:
                    log.info("auto vacuum: %s", out)
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                log.warning("auto vacuum failed: %s", e)

    def _maintenance_loop(self):
        """The maintenance scripts' lines through the port shell, every
        ``maintenance_interval``; a failing line is logged and the rest
        run."""
        from .. import shell  # registers the commands
        while not self._stop.wait(self.maintenance_interval):
            if not self.is_leader():
                continue
            env = shell.CommandEnv(self.url,
                                   filer_url=self.maintenance_filer_url)
            # one wedged volume server must not stall the loop for the
            # interactive shell's hour
            env.admin_timeout = MAINTENANCE_ADMIN_TIMEOUT_S
            for line in self.maintenance_scripts:
                try:
                    shell.run_command(env, line)
                except Exception as e:  # noqa: BLE001 - keep the loop
                    log.warning("maintenance %r failed: %s", line, e)
            self._maintenance_runs += 1

    def vol_vacuum(self, req: Request):
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        threshold = float(req.query.get("garbageThreshold",
                                        self.garbage_threshold))
        return self._run_vacuum_pass(threshold)

    def col_delete(self, req: Request):
        """Delete every volume of a collection on every holder, then drop
        the collection's layouts, but for those of a volume whose delete
        failed: it stays looked up, and a later delete can take it."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        collection = req.query.get("collection", "")
        if not collection:
            raise HttpError(400, "collection required")
        deleted, failed = [], set()
        for node in self.topology.all_nodes():
            for vid, vi in list(node.volumes.items()):
                if vi.collection == collection:
                    try:
                        post_json(f"http://{node.url}/admin/delete_volume"
                                  f"?volume={vid}")
                        deleted.append(vid)
                    except HttpError:
                        failed.add(vid)
        with self.topology.lock:
            for key in [k for k in self.topology.layouts
                        if k[0] == collection]:
                if not failed & set(self.topology.layouts[key].locations):
                    del self.topology.layouts[key]
        return {"deleted": sorted(set(deleted))}

    def submit(self, req: Request):
        """An upload through the master: a file id assigned as
        ``/dir/assign`` would (the query's collection, replication and
        ttl), and the body posted to it."""
        fwd = self._leader_forward(req)
        if fwd is not None:
            return fwd
        filename, ctype, data = req.upload_payload()
        assign = self.dir_assign(req)
        headers = {"Authorization": f"Bearer {assign['auth']}"} \
            if assign.get("auth") else None
        result = post_multipart(
            f"http://{assign['url']}/{assign['fid']}", filename, data,
            ctype or "application/octet-stream", headers=headers)
        return {"fid": assign["fid"],
                "fileUrl": f"{assign['publicUrl']}/{assign['fid']}",
                "size": result.get("size", len(data))}

    def redirect_handler(self, req: Request):
        """GET /<fid>: a 301 to one of the volume's holders, drawn with
        the master's rng, the query kept; on a follower a 301 to the same
        path on the leader. A path that is not a fid is a 404."""
        try:
            vid, _, _ = parse_file_id(req.path.lstrip("/"))
        except ValueError:
            raise HttpError(404, f"no such path {req.path}") from None
        q = ("?" + req.raw_query) if req.raw_query else ""
        if not self.is_leader():
            leader = self.leader_url()
            if not leader:
                raise HttpError(503, "no leader")
            return Response(b"", 301, headers={
                "Location": f"http://{leader}{req.path}{q}"})
        locs = self.topology.lookup(req.query.get("collection", ""), vid)
        if not locs:
            raise HttpError(404, f"volume {vid} not found")
        node = self.rng.choice(locs)
        return Response(b"", 301, headers={
            "Location": f"http://{node.public_url}{req.path}{q}"})


def default_meta_dir() -> str:
    """Where raft state and ``sequencer.dat`` go without ``-mdir``: a
    directory under the temp dir, as the JAX master's."""
    return os.path.join(tempfile.gettempdir(), "weed-tpu-raft")


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
    ap.add_argument("-vacuumIntervalSeconds", type=float,
                    default=VACUUM_INTERVAL_S,
                    help="seconds between vacuum and TTL-reap passes "
                         "(<= 0: none)")
    ap.add_argument("-garbageThreshold", type=float,
                    default=GARBAGE_THRESHOLD,
                    help="the deleted share past which a volume is "
                         "vacuumed")
    ap.add_argument("-maintenanceScripts", default="",
                    help="';'-separated shell lines run on an interval, "
                         'e.g. "volume.vacuum; ec.rebuild"')
    ap.add_argument("-maintenanceIntervalSeconds", type=float,
                    default=MAINTENANCE_INTERVAL_S)
    ap.add_argument("-peers", default="",
                    help="every master's host:port, comma-separated, this "
                         "one included: a raft group (none: one master)")
    ap.add_argument("-mdir", default="",
                    help="where the raft state (and the etcd sequencer's "
                         "sequencer.dat) is kept")
    ap.add_argument("-jwtKey", default="",
                    help="the HS256 key of per-fid write tokens")
    ap.add_argument("-whiteList", default="",
                    help="comma-separated IPs, prefixes (10.0.) and CIDRs "
                         "allowed on the client routes; heartbeats and "
                         "raft stay open")
    ap.add_argument("-sequencer", default="auto", choices=("auto", "etcd"),
                    help="file keys from memory or raft (auto), or from "
                         "an etcd every master shares")
    ap.add_argument("-sequencerEtcd", default="127.0.0.1:2379",
                    help="the etcd of -sequencer etcd (host:port)")
    ap.add_argument("-metrics.address", dest="metricsAddress", default="",
                    help="a push gateway's host:port, named to the volume "
                         "servers in heartbeat answers")
    ap.add_argument("-metrics.intervalSeconds", dest="metricsInterval",
                    type=int, default=15,
                    help="the servers' push interval")
    ap.add_argument("-tierEnable", action="store_true",
                    help="demote sealed, idle volumes onto EC in the "
                         "background (the leader only)")
    ap.add_argument("-tierInterval", type=float,
                    default=tiering.TIER_INTERVAL_S,
                    help="seconds between tier scans (<= 0: no loop)")
    ap.add_argument("-tierAge", type=float, default=tiering.TIER_AGE_S,
                    help="seconds a sealed volume stays unmodified before "
                         "it is demoted")
    ap.add_argument("-tierConcurrency", type=int,
                    default=tiering.TIER_CONCURRENCY,
                    help="demotions at once")
    ap.add_argument("-tierRateMBps", type=float,
                    default=tiering.TIER_RATE_MBPS,
                    help="a demotion's encode+spread cap in MB/s (0: none)")
    ap.add_argument("-tierFullFrac", type=float,
                    default=tiering.TIER_FULL_FRAC,
                    help="the share of the size limit past which a "
                         "writable volume counts as sealed")
    ap.add_argument("-sequencerEtcdUser", default="")
    ap.add_argument("-sequencerEtcdPassword", default="")
    args = ap.parse_args(argv)
    sequencer = None
    if args.sequencer == "etcd":
        from ..topology.topology import EtcdSequencer
        meta_dir = args.mdir or default_meta_dir()
        os.makedirs(meta_dir, exist_ok=True)
        sequencer = EtcdSequencer(args.sequencerEtcd,
                                  user=args.sequencerEtcdUser,
                                  password=args.sequencerEtcdPassword,
                                  meta_dir=meta_dir)
    m = MasterServer(port=args.port, host=args.ip,
                     volume_size_limit_mb=args.volumeSizeLimitMB,
                     default_replication=args.defaultReplication,
                     pulse_seconds=args.pulseSeconds, seed=args.seed,
                     repair_interval=args.repairInterval,
                     garbage_threshold=args.garbageThreshold,
                     vacuum_interval=args.vacuumIntervalSeconds,
                     maintenance_scripts=args.maintenanceScripts,
                     maintenance_interval=args.maintenanceIntervalSeconds,
                     peers=args.peers, raft_dir=args.mdir,
                     jwt_signing_key=args.jwtKey,
                     whitelist=[w for w in args.whiteList.split(",")
                                if w.strip()],
                     sequencer=sequencer,
                     metrics_address=args.metricsAddress,
                     metrics_interval=args.metricsInterval,
                     tier_enable=args.tierEnable,
                     tier_interval=args.tierInterval,
                     tier_age=args.tierAge,
                     tier_concurrency=args.tierConcurrency,
                     tier_rate_mbps=args.tierRateMBps,
                     tier_full_frac=args.tierFullFrac).start()
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
