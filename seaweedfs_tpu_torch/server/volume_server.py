"""VolumeServer — the needle data plane, the volume admin routes and the
EC routes of a volume server.

The JAX package's ``server/volume_server.py`` in the part a client's
needle traffic, the volume and EC shell commands, a backup, a degraded
read or a scrub on another server calls: the server creates volumes and
takes, serves and deletes their needles, vacuums, mounts, unmounts,
copies, verifies and tails them, freezes and encodes them, takes
the shards another server's encode pushes to it, serves the shards and
the needles of the ``EcVolume``s in its directories (through a lost
shard by reconstruction on its ``DegradedReadEngine``) and rebuilds lost
shards.

    GET|HEAD /<vid>,<key><cookie>     a needle: Content-Type, ETag,
                                      Last-Modified (If-Modified-Since,
                                      If-None-Match: 304), Range (206),
                                      Content-Disposition, the Seaweed-*
                                      pairs; from a plain volume, or
                                      parsed out of an EC volume's shards;
                                      a chunk manifest resolved to its
                                      file (``?cm=false``: the manifest);
                                      an image resized by ``width``,
                                      ``height`` and ``mode``
    POST|PUT /<vid>,<key><cookie>     write a needle: a multipart upload
                                      or a raw body; ?ts=, ?ttl=, ?cm=true
                                      (a chunk manifest), Seaweed-*
                                      headers; answers
                                      {"name", "size", "eTag"}
    DELETE   /<vid>,<key><cookie>     tombstone a needle, a manifest's
                                      chunks first (on an EC volume: the
                                      .ecx and .ecj, then the other
                                      holders the master lists)
    POST /query                       JSON lines of the rows a SQL query
                                      selects from JSON needles (plain or
                                      EC volumes)
    POST /admin/assign_volume         create a volume (replication, ttl)
    POST /admin/delete_volume         delete a volume's files
    POST /admin/volume/readonly       freeze (or thaw) a volume
    POST /admin/volume/configure_replication
                                      rewrite a volume's replica placement
    POST /admin/volume/mount          serve a volume found on disk
    POST /admin/volume/unmount        stop serving a volume, files kept
    POST /admin/volume/copy           pull a volume (.idx, then .dat) from
                                      a source server in 64 MiB ranges
    POST /admin/volume/verify         CRC-check every live needle
    POST /admin/volume/tier_upload   ship a readonly volume's .dat to a
                                      configured tier backend (``dest``,
                                      ``keep_local``)
    POST /admin/volume/tier_download bring a tiered volume's .dat back
                                      (``delete_remote``)
    GET  /admin/volume/sync_status    what an incremental copy needs
    GET  /admin/volume/tail           the raw records after ``since_ns``
    POST /admin/volume/tail_receive   append a tail sender's records
    POST /admin/vacuum/check          the garbage ratio
    POST /admin/vacuum/compact        copy the live needles (.cpd/.cpx)
    POST /admin/vacuum/commit         replay later writes, swap the files
    POST /admin/ec/generate           encode a readonly volume: query only,
                                      every shard here; with an
                                      ``assignment`` body, each shard
                                      streamed to its holder
    POST /admin/ec/shard_write        a pushed shard's ranges: append at
                                      the staged offset (409 ``staged=``),
                                      ``action=finalize`` or ``abort``
    POST /admin/ec/copy               pull shard files and the .ecx (and
                                      the .vif/.ecj where present) from a
                                      source server
    POST /admin/ec/mount              mount shard files found here
    POST /admin/ec/unmount            stop serving shards
    POST /admin/ec/delete_shards      unmount and remove shard files
    POST /admin/ec/to_volume          decode the mounted data shards back
                                      into a plain volume
    POST /admin/ec/rebuild            rebuild lost shards: query only, from
                                      the shard files here; with a
                                      ``sources`` body, streamed from the
                                      holders (``repair`` auto, trace,
                                      piggyback or full)
    GET  /admin/ec/shard_read         ranged shard bytes: the query form
                                      (offset, size), or a Range header
                                      answered 206 with Content-Range
    POST /admin/ec/shard_repair_read  trace-repair symbol planes of a
                                      range (X-Repair-Planes/-Stride)
    POST /admin/ec/shard_plane_read   the piggyback repair half-plane of
                                      a window-aligned range
    POST /admin/ec/scrub              a synchronous syndrome scrub of one
                                      volume (?volume=) or of every local
                                      EC volume
    GET  /admin/ec/scrub_status       the scrub engine's counters
    POST /admin/ec/scrub_repair       quarantine a corrupt shard and
                                      rebuild it from the survivors
    GET  /admin/devices               kernel launches, builds, plan cache
                                      and the card (ops/device_stats)
    GET  /metrics                     the Prometheus text exposition of
                                      the volume-server families
    GET  /admin/traces                the trace ring (``?n=``, or
                                      ``?trace=<id>``'s spans)
    GET  /admin/traces/export         one trace as Chrome trace events
    POST /admin/profile               every thread's stacks sampled for
                                      ``?seconds=`` (collapsed, text)
    GET  /admin/plane/slow            the native plane's slow requests
    GET  /admin/plane/cache           its slab cache and EC read outcomes
    GET  /admin/plane/durability      its group commit (mode, batches,
                                      riders, fsync histogram)
    GET  /stats/disk, /stats/memory   each directory's usage; peak RSS
    GET  /admin/file                  a raw volume, index or shard file
                                      (``offset``/``size`` for a range)
    *    /status                      the store's heartbeat, directories,
                                      and the degraded-read and scrub
                                      engines' counters

Paths, query parameters, status codes, headers and JSON keys are the JAX
server's. The projections run on the host with numpy
(``ops/codec.project_slab``, ``pb_plane_slice``), as the JAX holder runs
them. Only an encode, a rebuild and a degraded read build the store's
codec (on ``device``, the card by default, which raises where there is
none), so a server that only holds shards or serves needles never
touches the card. ``ec_backend`` "mesh" (the JAX ``-ec.backend mesh``)
builds the store's codec as parallel/mesh_codec.MeshCodec over ``mesh``
(every card when None), so each encode and rebuild runs K1 at every
mesh position; "native" runs the host's AVX2 codec (ops/rs_native) and
"numpy" the host oracle.

With ``master_url`` (seeds ``host:port[,host:port]``), the server
heartbeats its master: at start, every ``pulse_seconds``, at once when a
volume is created or deleted or a shard mounted or unmounted (a delta
against the state the master last acknowledged; a ``resync`` answer
replays the whole state), and synchronously after each admin route that
does so in the JAX server (assign and delete a volume, mount, unmount
and copy a volume, a tier upload and download, EC mount, unmount,
delete_shards and to_volume) and
after ``configure_replication`` (which the JAX server leaves to the
next pulse), which then answers 503 after
doing its work when no master answers. It says goodbye on ``stop``. A
volume's replicas come from the master's pushed location map
(``client/vid_map``), else a ``/dir/lookup`` kept 10 s; the holders of
an EC volume's shards from ``/cluster/ec_lookup``. Without a master
nothing is sent: every survivor of a degraded read is local, and no
write, delete or read goes to another server. A needle write or delete
that is not ``type=replicate`` goes on to the volume's other replicas
(all must succeed; a replica's 404 on a delete counts as done); a GET of
a volume held elsewhere answers 301 to a replica.

The syndrome scrub (``ec/scrub.ScrubEngine``) runs a background pass
every ``scrub_idle_s`` (<= 0: none) paced at ``scrub_rate_mbps`` (0:
unpaced), and ``/admin/ec/scrub`` runs one at once; each corrupt shard it
finds is reported to the master's ``/cluster/scrub_report``, whose repair
queue drains back into ``/admin/ec/scrub_repair`` here. A read through a
lost shard goes to the degraded-read engine (``degraded_mode`` "batch"),
or with "naive" reconstructs each range on its own: the first k survivors
the decode plan names, one (1, k) product on the codec's device (the JAX
server multiplies on the host; the bytes are the same).
``device_timing`` turns on the sampled kernel timing of
``ops/device_stats`` (every ``device_timing_sample``th call), which is
process-wide.

The guard: with a ``whitelist`` (IPs, "10.0."-style prefixes, CIDRs)
every route answers 403 to a caller from elsewhere; with a
``jwt_signing_key`` a needle write or delete answers 401 without a
token (``Authorization: Bearer`` or ``?jwt=``) that the key signed for
its fid and that has not expired; the fan-out to the other replicas and
holders carries the writer's token as ``?jwt=``.

Observability, as in JAX: every request runs in a server span that
continues the caller's ``traceparent`` and feeds
``SeaweedFS_volumeServer_request_*``; ``/admin/ec/generate`` (streamed),
``/admin/ec/rebuild`` and ``/admin/ec/scrub_repair`` answer their
``trace_id``; a scrape of ``/metrics`` mirrors the store's volumes,
``ops/telemetry``, the pool's churn, ``ops/device_stats`` (the card's
memory only once CUDA is initialized: a scrape never initializes it),
the plan caches, the degraded and scrub engines and the health board.
When a heartbeat answer names a ``metrics_address`` the server pushes
its exposition there every ``metrics_interval_seconds``.

Tiering: the tier backends (``storage/backend``) are the process's,
configured by ``-tierConfig`` (a JSON file of ``configure_backends``'s
shape) on the command line; a tier move heartbeats after it.

The native plane (``server/native_plane``, ``fast_port`` 0 by default:
a port picked free; -1: none; off under a whitelist): a C++ server on a
second port, advertised to the master as ``fast_url``, serving plain
needle GETs and, for the volumes whose write lease it holds (writable,
one copy, no TTL, v2/v3, no write tokens), plain multipart POSTs and
DELETEs; it redirects everything else here. Every admin route that
changes a volume's files or flags takes the volume off the plane, or
takes the lease back, first and registers it again after, as the JAX
handlers do. The degraded engine's reconstructions are published into
the plane's slab cache, so a warm GET through a lost shard is served
there; a mount or a rebuild drops them. ``index_kind`` is the needle
map of every volume (``-index memory|compact|sortedfile|disk``).

Transport security: the process's ``server/http_util`` TLS. The plane
speaks plain HTTP, so TLS keeps it off, as a whitelist does. Under
mutual TLS every ``/admin/*`` route (the peers' shard reads, the
shell's and the master's admin calls) answers 403 to a connection that
presented no client certificate; the data routes stay server-TLS.
``GET /ui`` is the status page (volumes, EC volumes, traces).

    python3 -m seaweedfs_tpu_torch.server.volume_server --dir D [--dir D2]
        [--host 127.0.0.1] [--port 0] [--device cuda] [--master HOST:PORT]
        [--max N] [--pulse-seconds S] [--scrub-idle-s S]
        [--scrub-rate-mbps R] [--degraded-mode batch|naive]
        [--device-timing] [--device-timing-sample N]
        [--ec.backend cuda|auto|native|numpy|mesh]
        [--mesh.devices cuda:0,cuda:0]
        [--jwt-key KEY] [--whitelist IP,PREFIX.,CIDR]
        [-tierConfig FILE.json] [-fastPort N]
        [-index memory|compact|sortedfile|disk]

serves until killed and prints ``listening <host>:<port>`` once bound,
so a parent process that passed ``--port 0`` can read the port. The
mesh codec spans ``--mesh.devices`` (every card by default).
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timezone
from email.utils import formatdate, parsedate_to_datetime
from typing import Dict, List, Optional

import numpy as np

from ..client.vid_map import shared_vid_map
from ..ec import decoder as ec_decoder
from ..ec.constants import DATA_SHARDS, TOTAL_SHARDS, to_ext
from ..ec.degraded import READ_TIMEOUT_S, DegradedReadEngine
from ..ec.degraded import degraded_mode as _degraded_mode
from ..ec.ec_volume import EcShardNotFound
from ..ec.scrub import ScrubEngine
from ..ec.shard_cache import EcShardLocationCache
from ..images import fix_orientation, resize_image
from ..client.chunked import ChunkManifest
from ..client.operation import delete_file, lookup
from ..ops import codec as ops_codec
from ..ops import device_stats, telemetry
from ..security.guard import Guard
from ..security.jwt import VerifyError, jwt_from_request, verify_fid_jwt
from ..stats import metrics
from ..stats.health import BOARD, export_board
from ..storage import volume_backup, volume_tier
from ..storage.backend import BackendError, configure_backends
from ..storage.compact_map import snapshot_live_items
from ..query import QueryError, query_json_lines
from ..storage.needle import FLAG_IS_CHUNK_MANIFEST, CorruptNeedle, Needle
from ..storage.store import Store, volume_file_prefix
from ..storage.types import TTL, ReplicaPlacement, parse_file_id
from ..storage.volume import NotFound, VolumeError
from ..util import config, tracing
from ..util.fanout import fan_out
from ..util.locks import make_lock
from . import native_plane
from .http_util import (HttpError, HttpServer, Request, Response, Router,
                        get_json, http_call, parse_range, pool_stats_snapshot,
                        post_json, post_multipart, process_memory_stats,
                        profile_handler, pull_file, require_client_cert,
                        tls_enabled, traces_export_handler, traces_handler)

PULSE_S = 5.0        # SW_PULSE_S: the heartbeat's period
LOOKUP_TTL_S = 10.0  # a /dir/lookup answer's life in the replica cache


class VolumeServer:
    """``master_url`` (host:port, optional; a comma list of seeds) is
    heartbeated and asked for locations; ``file_size_limit_mb`` caps an
    upload (413 past it; 0: no cap); ``max_volume_counts`` the slots of
    each directory; ``scrub_idle_s`` and ``scrub_rate_mbps`` the
    background scrub's period and pace (the scrub engine's defaults when
    None); ``degraded_mode`` "batch" or "naive"; ``device_timing`` and
    ``device_timing_sample`` the process's sampled kernel timing (left as
    it is when None); ``ec_backend`` "cuda" (the store's TorchCodec on
    ``device``), "mesh" (MeshCodec over ``mesh``), "native" or "numpy";
    ``jwt_signing_key`` the key of the write tokens (none: writes need
    none); ``whitelist`` the callers allowed (empty: all);
    ``index_kind`` the needle map ("memory", "compact", "sortedfile" or
    "disk"); ``fast_port``
    the native plane's port (0: one picked free, -1: no plane);
    ``data_center`` and ``rack`` this server's place in the heartbeat;
    ``public_url`` the address it advertises (its own by default);
    ``read_redirect`` False answers a GET of a volume held elsewhere 404
    instead of a 301 to a replica; ``compaction_mbps`` paces a vacuum's
    copy that names no ``bytesPerSecond`` (0: unpaced)."""

    def __init__(self, port: int = 8080, host: str = "127.0.0.1",
                 directories=None, device: str = "cuda",
                 layout: str = "flat", codec=None, master_url: str = "",
                 file_size_limit_mb: int = 256, max_volume_counts=None,
                 pulse_seconds: Optional[float] = None,
                 scrub_idle_s: Optional[float] = None,
                 scrub_rate_mbps: Optional[float] = None,
                 degraded_mode: str = "batch",
                 device_timing: Optional[bool] = None,
                 device_timing_sample: int = 1,
                 ec_backend: str = "cuda", mesh=None,
                 jwt_signing_key: str = "", whitelist=(),
                 index_kind: str = "memory", fast_port: int = 0,
                 data_center: str = "", rack: str = "",
                 public_url: str = "", read_redirect: bool = True,
                 compaction_mbps: int = 0):
        self.read_redirect = read_redirect
        self.compaction_bps = int(compaction_mbps) << 20
        self.degraded_mode = _degraded_mode(degraded_mode)
        self.jwt_signing_key = jwt_signing_key
        self.guard = Guard(whitelist)
        if codec is None and ec_backend != "cuda":
            codec = ops_codec.get_codec(DATA_SHARDS,
                                        TOTAL_SHARDS - DATA_SHARDS,
                                        backend=ec_backend, mesh=mesh)
        if device_timing is not None:
            device_stats.DEVICE_STATS.configure(device_timing,
                                                device_timing_sample)
        router = Router()
        router.add("*", "/status", self.status)
        router.add("POST", "/admin/assign_volume", self.admin_assign_volume)
        router.add("POST", "/admin/delete_volume", self.admin_delete_volume)
        router.add("POST", "/admin/volume/readonly", self.admin_readonly)
        router.add("POST", "/admin/volume/configure_replication",
                   self.admin_configure_replication)
        router.add("POST", "/admin/volume/mount", self.admin_volume_mount)
        router.add("POST", "/admin/volume/unmount",
                   self.admin_volume_unmount)
        router.add("POST", "/admin/volume/copy", self.admin_volume_copy)
        router.add("POST", "/admin/volume/verify", self.admin_volume_verify)
        router.add("POST", "/admin/volume/tier_upload",
                   self.admin_tier_upload)
        router.add("POST", "/admin/volume/tier_download",
                   self.admin_tier_download)
        router.add("GET", "/admin/volume/sync_status",
                   self.admin_volume_sync_status)
        router.add("GET", "/admin/volume/tail", self.admin_volume_tail)
        router.add("POST", "/admin/volume/tail_receive",
                   self.admin_volume_tail_receive)
        router.add("POST", "/admin/vacuum/check", self.admin_vacuum_check)
        router.add("POST", "/admin/vacuum/compact", self.admin_vacuum_compact)
        router.add("POST", "/admin/vacuum/commit", self.admin_vacuum_commit)
        router.add("POST", "/admin/ec/generate", self.admin_ec_generate)
        router.add("POST", "/admin/ec/mount", self.admin_ec_mount)
        router.add("POST", "/admin/ec/unmount", self.admin_ec_unmount)
        router.add("POST", "/admin/ec/rebuild", self.admin_ec_rebuild)
        router.add("POST", "/admin/ec/copy", self.admin_ec_copy)
        router.add("POST", "/admin/ec/delete_shards",
                   self.admin_ec_delete_shards)
        router.add("POST", "/admin/ec/to_volume", self.admin_ec_to_volume)
        router.add("POST", "/admin/ec/shard_write",
                   self.admin_ec_shard_write)
        router.add("GET", "/admin/ec/shard_read", self.admin_ec_shard_read)
        router.add("POST", "/admin/ec/shard_repair_read",
                   self.admin_ec_shard_repair_read)
        router.add("POST", "/admin/ec/shard_plane_read",
                   self.admin_ec_shard_plane_read)
        router.add("POST", "/admin/ec/scrub", self.admin_ec_scrub)
        router.add("GET", "/admin/ec/scrub_status",
                   self.admin_ec_scrub_status)
        router.add("POST", "/admin/ec/scrub_repair",
                   self.admin_ec_scrub_repair)
        router.add("GET", "/admin/devices", self.admin_devices)
        router.add("GET", "/admin/file", self.admin_file)
        router.add("GET", "/metrics", self.metrics_handler)
        router.add("GET", "/admin/traces", traces_handler)
        router.add("GET", "/admin/traces/export", traces_export_handler)
        router.add("POST", "/admin/profile", profile_handler)
        router.add("GET", "/stats/disk", self.stats_disk)
        router.add("GET", "/stats/memory", self.stats_memory)
        router.add("GET", "/admin/plane/slow", self.admin_plane_slow)
        router.add("GET", "/admin/plane/cache", self.admin_plane_cache)
        router.add("GET", "/admin/plane/durability",
                   self.admin_plane_durability)
        router.add("GET", "/ui", self.ui_handler)
        router.add("POST", "/query", self.query_handler)
        router.set_fallback(self.data_handler)
        router.before = self._guard_check

        def observe(label, seconds, ok):
            metrics.VOLUME_REQUEST_COUNTER.inc(
                label if ok else label + " error")
            # the router's span is still current: the bucket this lands
            # in carries its trace id as an exemplar
            metrics.VOLUME_REQUEST_HISTOGRAM.observe(
                seconds, label, trace_id=tracing.current_trace_id())
        router.observe = observe
        # without a ``codec``, the store builds RS(10,4) on ``device`` only
        # when an encode, a rebuild or a degraded read first needs it
        self.store = Store(directories or ["."], codec=codec, device=device,
                           layout=layout, max_volume_counts=max_volume_counts,
                           index_kind=index_kind)
        self.server = HttpServer(port, router, host=host)
        self.host = host
        self.port = self.server.port
        self.url = f"{host}:{self.port}"
        router.node = self.url
        self.store.ip = host
        self.store.port = self.port
        self.store.public_url = public_url or self.url
        self.store.data_center = data_center
        self.store.rack = rack
        # heartbeats follow the leader hint and rotate through the seeds
        self._seed_masters = [m.strip() for m in master_url.split(",")
                              if m.strip()]
        self.master_url = self._seed_masters[0] if self._seed_masters \
            else ""
        self._seed_i = 0
        self.pulse_seconds = PULSE_S if pulse_seconds is None \
            else pulse_seconds
        self.file_size_limit = max(0, int(file_size_limit_mb)) << 20
        self._lookup_cache: Dict[int, tuple] = {}
        self._vid_map = shared_vid_map(self.master_url) \
            if self.master_url else None
        self._ec_loc_cache = EcShardLocationCache(
            self._fetch_ec_shard_locations)
        # reconstruct-on-read of lost shards: coalesced batches, an
        # exactly-k survivor gather and a slab LRU (ec/degraded.py)
        self.degraded = DegradedReadEngine(
            store=self.store, locations=self._ec_shard_locations,
            codec=lambda: self.store.codec, loc_cache=self._ec_loc_cache,
            self_url=lambda: self.url,
            on_read=lambda s: metrics.DEGRADED_READ_HISTOGRAM.observe(
                s, trace_id=tracing.current_trace_id()),
            on_slabs=self._publish_slabs)
        # a shard mounted again (after a rebuild) is read from disk, not
        # from a cached reconstruction: the plane's or the engine's
        self.store.on_ec_mount = self._invalidate_reconstructions
        # the syndrome scrub: a paced background pass over every local EC
        # volume, each finding reported to the master's repair queue
        self.scrub = ScrubEngine(
            store=self.store, locations=self._ec_shard_locations,
            codec=lambda: self.store.codec, self_url=lambda: self.url,
            on_finding=self._report_scrub_finding,
            rate_mbps=scrub_rate_mbps, idle_s=scrub_idle_s)
        # a volume created or deleted, a shard mounted or unmounted: the
        # heartbeat loop wakes and sends the delta at once
        self._stop = threading.Event()
        self._hb_wake = threading.Event()
        self.store.on_change = self._hb_wake.set
        # the master and volume set of the newest collect acked; each
        # collect is numbered, and an answer is applied only if no later
        # collect was acked first, so a late loop pulse never rolls back
        # a route's newer ack. The lock covers a collect and an ack, never
        # a post. Each post carries (boot, seq), so the master too drops a
        # collect that arrives after a later one of this server's.
        self._hb_lock = make_lock("torch.volume_server._hb_lock")
        self._hb_boot = time.time_ns()
        self._hb_seq = 0
        self._hb_acked_seq = 0
        self._hb_acked_master = None
        self._hb_acked_volumes = None
        self._metrics_push = None
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True,
                                           name="volume-heartbeat")
        # the native plane on a second port (0 picks one, -1: none). It
        # speaks open HTTP, so a whitelist or TLS keeps it off; write tokens
        # keep every volume's lease with Python (_writer_acquire). A
        # plane that does not build or listen leaves the server without
        # one (the plane_build_failed gauge), as in JAX, unless
        # SW_HTTP_PLANE_LIB named the library
        self.fast_plane = None
        if fast_port >= 0 and not self.guard.enabled and \
                not tls_enabled() and native_plane.available():
            try:
                self.fast_plane = native_plane.NativeReadPlane(
                    host, fast_port, self.url)
            except RuntimeError:
                if config.env_is_set("SW_HTTP_PLANE_LIB"):
                    raise
        if self.fast_plane is not None:
            for loc in self.store.locations:
                for v in loc.volumes.values():
                    with v.lock:
                        self.fast_plane.register_volume(v)
                        self._writer_acquire(v)
                for vid in list(loc.ec_volumes):
                    self._fast_ec_sync(vid)

    def start(self) -> "VolumeServer":
        self.server.start()
        if self.master_url:
            try:
                self.heartbeat_once()
            except HttpError:
                pass    # no master yet: the loop keeps trying
            self._hb_thread.start()
        self.scrub.start()
        return self

    def stop(self):
        self._stop.set()
        self._hb_wake.set()
        self.scrub.stop()
        if self.master_url:
            try:
                # a clean stop: the master drops this server now
                post_json(f"http://{self.master_url}/cluster/goodbye",
                          {"url": self.url}, timeout=2)
            except HttpError:
                pass
        if self._metrics_push is not None:
            self._metrics_push.stop_event.set()
        if self.fast_plane is not None:
            self.fast_plane.stop()
        self.server.stop()
        self.degraded.close()
        self.store.close()

    @property
    def fast_url(self) -> str:
        """host:port of the native plane, or "" without one."""
        return f"{self.host}:{self.fast_plane.port}" \
            if self.fast_plane is not None else ""

    # -- the native plane: the volume mirror and the write lease -------------
    def _writer_acquire(self, v):
        """Hand the volume's write lease to the plane (caller holds
        v.lock, having just registered the mirror from the current map).
        Only a volume whose plain POSTs the plane serves exactly gets
        it: writable, unreplicated, without a TTL, v2/v3, on a server
        without write tokens."""
        if self.fast_plane is None or v.fast_writer is not None:
            return
        if v.readonly or v.version < 2 or self.jwt_signing_key or \
                v.super_block.ttl.to_uint32() or \
                v.super_block.replica_placement.copy_count != 1:
            return
        v.fast_writer = self.fast_plane.enable_writer(
            v, self.file_size_limit, accept_posts=True)

    def _writer_release(self, v, reload: bool = True):
        """Take the lease back: once the plane's disable (a mutex
        barrier) returns, no native append is in flight, and the needle
        map is replayed from the .idx the plane kept."""
        if self.fast_plane is None:
            return
        with v.lock:
            if v.fast_writer is None:
                return
            v.fast_writer = None
            self.fast_plane.disable_writer(v.id)
            if reload:
                v.reload_nm()

    def _fast_put(self, vid: int, nid: int):
        """Mirror a Python write of a leaseless volume (a leased one's
        append updated the mirror itself)."""
        if self.fast_plane is None:
            return
        v = self.store.find_volume(vid)
        if v is None or v.fast_writer is not None:
            return
        nv = v.nm.get(nid)
        if nv is not None:
            self.fast_plane.put(vid, nid, nv.offset, nv.size)

    def _fast_delete(self, vid: int, nid: int):
        if self.fast_plane is None:
            return
        v = self.store.find_volume(vid)
        if v is not None and v.fast_writer is not None:
            return
        self.fast_plane.delete(vid, nid)

    def _fast_sync(self, vid: int):
        """Register a volume again after a change to its files or its
        flags (create, mount, vacuum commit, copy, tail, decode, a tier
        move, readonly, replication), or drop it when it is gone; the
        lease goes back out when the volume qualifies."""
        if self.fast_plane is None:
            return
        v = self.store.find_volume(vid)
        if v is None:
            self.fast_plane.unregister_volume(vid)
            return
        with v.lock:
            self._writer_release(v)
            self.fast_plane.register_volume(v)
            self._writer_acquire(v)

    def _fast_unregister(self, vid: int):
        """Take a volume off the plane before its files go away or move,
        so no plane write lands in a removed file."""
        if self.fast_plane is None:
            return
        v = self.store.find_volume(vid)
        if v is not None:
            self._writer_release(v)
        self.fast_plane.unregister_volume(vid)

    # -- the native plane: EC volumes and the slab cache ---------------------
    def _fast_ec_sync(self, vid: int):
        """Register an EC volume's geometry, local shards and .ecx again
        (after every mount, unmount and rebuild), or drop it when it is
        gone: the plane learns of a local shard before the cached slabs
        of it are dropped."""
        if self.fast_plane is None:
            return
        ev = self.store.find_ec_volume(vid)
        if ev is None or not self.fast_plane.register_ec_volume(
                ev, self.degraded.slab):
            self.fast_plane.unregister_ec_volume(vid)

    def _fast_ec_delete(self, vid: int, nid: int):
        if self.fast_plane is not None:
            self.fast_plane.ec_delete(vid, nid)

    def _publish_slabs(self, vid: int, sid: int, slabs: dict):
        """The degraded engine's ``on_slabs``: fresh reconstructions go
        into the plane's cache, so the next read of these bytes is
        served there."""
        if self.fast_plane is None:
            return
        for idx, data in slabs.items():
            self.fast_plane.cache_put(vid, sid, int(idx), data)

    def _invalidate_reconstructions(self, vid: int, shard_ids):
        """Drop every cached reconstruction of these shards once a mount
        or a rebuild made them stale: the plane's shard set first, then
        its slabs, then the engine's. A read in between gets the fresh
        local bytes or a miss (Python reconstructs from the fresh
        shards), never stale ones."""
        self._fast_ec_sync(vid)
        if self.fast_plane is not None:
            for sid in shard_ids:
                self.fast_plane.cache_invalidate(vid, sid)
        self.degraded.invalidate(vid, shard_ids)

    # -- the heartbeat -------------------------------------------------------
    def _heartbeat_loop(self):
        while True:
            self._hb_wake.wait(self.pulse_seconds)
            self._hb_wake.clear()
            if self._stop.is_set():
                return
            try:
                self.heartbeat_once()
            except HttpError:
                pass    # every seed failed; the next pulse tries again

    def _heartbeat_payload(self, hb: dict, target: str) -> dict:
        """The full heartbeat, or a delta against the volumes the
        target master last acknowledged: only new, changed and deleted
        volumes ride it (the EC shard bits ride every heartbeat)."""
        if target != self._hb_acked_master or self._hb_acked_volumes is None:
            return hb
        current = {v["id"]: v for v in hb["volumes"]}
        previous = self._hb_acked_volumes
        delta = dict(hb)
        del delta["volumes"]
        delta["delta"] = True
        delta["new_volumes"] = [v for vid, v in current.items()
                                if previous.get(vid) != v]
        delta["deleted_volumes"] = [vid for vid in previous
                                    if vid not in current]
        return delta

    def _post_heartbeat(self, hb: dict, seq: int, target: str) -> dict:
        """Post collect ``seq`` (as a delta when the target acked an
        earlier one) and ack it. A collect that a later acked one has
        superseded is not sent: its state is older than the master's."""
        order = [self._hb_boot, seq]
        with self._hb_lock:
            if seq < self._hb_acked_seq:
                return {}
            payload = dict(self._heartbeat_payload(hb, target), seq=order)
        resp = post_json(f"http://{target}/cluster/heartbeat", payload,
                         timeout=10)
        if resp.get("resync"):
            # the master lost (or never had) this server: the whole state
            resp = post_json(f"http://{target}/cluster/heartbeat",
                             dict(hb, seq=order), timeout=10)
        if not resp.get("not_leader") and not resp.get("stale"):
            with self._hb_lock:
                if seq > self._hb_acked_seq:
                    self._hb_acked_seq = seq
                    self._hb_acked_master = target
                    self._hb_acked_volumes = {v["id"]: v
                                              for v in hb["volumes"]}
        return resp

    def heartbeat_once(self):
        """Heartbeat the current master, trying every seed before
        raising the last failure; then follow the answer's leader hint.
        Without a master, nothing. Heartbeats of the loop and of the
        admin routes run at once; only the collect and the ack are
        serialized."""
        if not self.master_url:
            return
        with self._hb_lock:
            hb = self.store.collect_heartbeat()
            if self.fast_plane is not None:
                hb["fast_url"] = self.fast_url
            self._hb_seq += 1
            seq = self._hb_seq
        last = None
        for _ in range(len(self._seed_masters)):
            try:
                resp = self._post_heartbeat(hb, seq, self.master_url)
                break
            except HttpError as e:
                last = e
                self._seed_i = (self._seed_i + 1) % len(self._seed_masters)
                self.master_url = self._seed_masters[self._seed_i]
        else:
            raise last
        self._maybe_start_metrics_push(resp)
        leader = resp.get("leader")
        if leader and leader != self.master_url:
            self.master_url = leader
            if resp.get("not_leader"):
                self._post_heartbeat(hb, seq, self.master_url)

    def _maybe_start_metrics_push(self, resp: dict):
        """The master names a push gateway and its interval in its
        heartbeat answers (reference LoopPushingMetric); one push loop
        starts when the address first appears."""
        addr = resp.get("metrics_address")
        if not addr or self._metrics_push is not None:
            return
        if "://" not in addr:   # the master sends a bare host:port
            addr = "http://" + addr
        self._metrics_push = metrics.start_push_loop(
            metrics.VOLUME_SERVER_GATHER, addr,
            job=f"volume_{self.host}_{self.port}",
            interval_s=max(1.0, float(
                resp.get("metrics_interval_seconds", 15) or 15)))

    # -- observability -------------------------------------------------------
    def metrics_handler(self, req: Request):
        """The Prometheus text exposition. Each scrape mirrors what the
        families read from elsewhere: the volume and disk gauges from
        the store (summed over every directory; a collection gone since
        the last scrape set to 0), the codec telemetry, the pool's
        churn, the device accounting (the card's memory only once CUDA
        is initialized), the plan caches, the engines' counters and the
        health board."""
        by_coll: Dict[str, list] = {}
        ec_by_coll: Dict[str, int] = {}
        for loc in self.store.locations:
            for v in loc.volumes.values():
                agg = by_coll.setdefault(v.collection, [0, 0])
                agg[0] += 1
                agg[1] += v.size()
            for ev in loc.ec_volumes.values():
                ec_by_coll[ev.collection] = \
                    ec_by_coll.get(ev.collection, 0) + len(ev.shards)
        seen_count, seen_disk = set(), set()
        for coll, (count, size) in by_coll.items():
            metrics.VOLUME_COUNT_GAUGE.set(count, coll, "normal")
            metrics.VOLUME_DISK_GAUGE.set(size, coll, "normal")
            seen_count.add((coll, "normal"))
            seen_disk.add((coll, "normal"))
        for coll, count in ec_by_coll.items():
            metrics.VOLUME_COUNT_GAUGE.set(count, coll, "ec")
            seen_count.add((coll, "ec"))
        # zero each gauge's own vanished series, never minting a series
        # in a gauge that never carried it
        for stale in getattr(self, "_count_series", set()) - seen_count:
            metrics.VOLUME_COUNT_GAUGE.set(0, *stale)
        for stale in getattr(self, "_disk_series", set()) - seen_disk:
            metrics.VOLUME_DISK_GAUGE.set(0, *stale)
        self._count_series = seen_count
        self._disk_series = seen_disk
        for kind, total in telemetry.STATS.snapshot().items():
            # the per-position byte map has its own family (observe_mesh)
            if isinstance(total, (int, float)):
                metrics.DEVICE_TELEMETRY_COUNTER.set_total(total, kind)
        for event, total in pool_stats_snapshot().items():
            metrics.HTTP_POOL_CHURN_COUNTER.set_total(total, event)
        # the port has no jit factories: ec_xla_jit_cache_* stays empty
        metrics.observe_device_stats(device_stats.DEVICE_STATS.snapshot(),
                                     None, device_stats.device_inventory())
        metrics.observe_plan_cache()
        metrics.observe_degraded(self.degraded.snapshot())
        metrics.observe_scrub(self.scrub.snapshot())
        plane = self.fast_plane
        if plane is not None:
            for outcome in ("served", "redirected", "written"):
                metrics.FAST_PLANE_COUNTER.set_total(getattr(plane, outcome),
                                                     outcome)
        metrics.observe_plane(plane.stats() if plane else None,
                              len(plane.slow_requests()) if plane else 0,
                              native_plane.build_failed())
        metrics.observe_plane_cache(plane.cache_stats() if plane else None)
        metrics.observe_plane_sync(plane.sync_stats() if plane else None)
        export_board()
        return Response(metrics.VOLUME_SERVER_GATHER.render().encode(),
                        content_type="text/plain; version=0.0.4")

    def stats_disk(self, req: Request):
        """Each directory's disk usage (reference statsDiskHandler)."""
        import shutil
        out = []
        for loc in self.store.locations:
            try:
                u = shutil.disk_usage(loc.directory)
                out.append({"dir": loc.directory, "all": u.total,
                            "used": u.used, "free": u.free})
            except OSError as e:
                out.append({"dir": loc.directory, "error": str(e)})
        return {"DiskStatuses": out}

    def stats_memory(self, req: Request):
        return process_memory_stats()

    def ui_handler(self, req: Request):
        """The status page (reference volume_server_ui/)."""
        from .status_ui import volume_status_page
        return Response(volume_status_page(self),
                        content_type="text/html; charset=utf-8")

    def status(self, req: Request):
        out = self.store.status()
        # the JAX shape: the engine's phase totals stand in for the JAX
        # package's trace spans and are read from ``snapshot()`` only
        degraded = self.degraded.snapshot()
        degraded.pop("phases")
        out["ec_degraded"] = degraded
        out["ec_scrub"] = self.scrub.snapshot()
        if self.fast_plane is not None:
            out["fast_plane"] = {"url": self.fast_url,
                                 "served": self.fast_plane.served,
                                 "redirected": self.fast_plane.redirected}
        return out

    def admin_plane_slow(self, req: Request):
        """The plane's slow-request ring, newest first (requests of
        SW_PLANE_SLOW_US or more, 64 at most), and its stats."""
        if self.fast_plane is None:
            return {"plane": False, "slow": []}
        return {"plane": True, "slow": self.fast_plane.slow_requests(),
                "stats": self.fast_plane.stats()}

    def admin_plane_cache(self, req: Request):
        """The plane's slab-cache counters and the EC reads' outcomes:
        served from the cache, redirected to Python, or local."""
        if self.fast_plane is None:
            return {"plane": False, "cache": None}
        return {"plane": True, "cache": self.fast_plane.cache_stats()}

    def admin_plane_durability(self, req: Request):
        """The group commit's mode, window and rider cap, its batches
        against riders, the fsync histogram, the pending appends and the
        failures (a poisoned batch)."""
        if self.fast_plane is None:
            return {"plane": False, "durability": None}
        return {"plane": True, "durability": self.fast_plane.sync_stats()}

    def query_handler(self, req: Request):
        """S3-Select-style query over JSON needles (reference Query,
        volume_grpc_query.go:12): a JSON body ``{"fids": [...], "sql":
        "SELECT ... FROM S3Object WHERE ...", "limit": N}``, answered
        with the matching rows as JSON lines. A needle of an EC volume
        is read as a GET reads it, through a lost shard too."""
        try:
            body = json.loads(req.body or b"{}")
        except ValueError:
            raise HttpError(400, "bad JSON body") from None
        sql = body.get("sql", "")
        fids = body.get("fids", [])
        if not sql or not fids:
            raise HttpError(400, "need sql and fids")
        limit = int(body.get("limit", 0))
        rows: List[dict] = []
        for fid in fids:
            try:
                vid, key, cookie = parse_file_id(fid)
            except ValueError:
                raise HttpError(400, f"bad fid {fid!r}") from None
            got = self._read_any_needle(vid, key, cookie, fid)
            try:
                rows.extend(query_json_lines(
                    got.data, sql,
                    limit=(limit - len(rows)) if limit else 0))
            except QueryError as e:
                raise HttpError(400, str(e)) from None
            if limit and len(rows) >= limit:
                break
        out = "\n".join(json.dumps(r, separators=(",", ":")) for r in rows)
        return Response((out + "\n").encode() if out else b"",
                        content_type="application/jsonl")

    def _read_any_needle(self, vid: int, key: int, cookie: int,
                         fid: str) -> Needle:
        """A needle of a local plain or EC volume."""
        if self.store.find_volume(vid) is not None:
            try:
                return self.store.read_needle(vid, Needle(cookie=cookie,
                                                          id=key))
            except NotFound:
                raise HttpError(404, f"{fid} not found") from None
        if self.store.find_ec_volume(vid) is None:
            raise HttpError(404, f"volume {vid} not local")
        return self._read_needle_local(vid, key, cookie, fid)

    # -- volumes -------------------------------------------------------------
    def admin_assign_volume(self, req: Request):
        vid = int(req.query["volume"])
        self.store.add_volume(vid, req.query.get("collection", ""),
                              req.query.get("replication", "000"),
                              req.query.get("ttl", ""))
        self._fast_sync(vid)
        self.heartbeat_once()
        return {"volume": vid}

    def admin_delete_volume(self, req: Request):
        vid = int(req.query["volume"])
        # off the plane before the unlink: a plane POST in between would
        # append to a deleted file and acknowledge a lost write
        self._fast_unregister(vid)
        if not self.store.delete_volume(vid):
            self._fast_sync(vid)
            raise HttpError(404, f"volume {vid} not found")
        self._lookup_cache.pop(vid, None)
        self.heartbeat_once()
        return {"deleted": vid}

    def _find_volume(self, req: Request):
        vid = int(req.query["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            raise HttpError(404, f"volume {vid} not found")
        return vid, v

    def admin_vacuum_check(self, req: Request):
        vid, v = self._find_volume(req)
        return {"volume": vid, "garbage": v.garbage_level()}

    def admin_vacuum_compact(self, req: Request):
        vid, v = self._find_volume(req)
        # the lease back first: the copy snapshots the needle map, which
        # is frozen while the plane owns the tails. Writes during the
        # copy take the Python path and the commit's makeup diff
        self._writer_release(v)
        v.compact(bytes_per_second=int(req.query.get("bytesPerSecond")
                                       or self.compaction_bps))
        return {"volume": vid, "compacted": True}

    def admin_vacuum_commit(self, req: Request):
        vid, v = self._find_volume(req)
        # off the plane while the files are swapped, so it serves no old
        # offset from the new .dat; then registered from the new map
        self._fast_unregister(vid)
        v.commit_compact()
        self._fast_sync(vid)
        return {"volume": vid, "committed": True}

    def admin_readonly(self, req: Request):
        vid = int(req.query["volume"])
        readonly = req.query.get("readonly", "true") == "true"
        was = self.store.mark_volume_readonly(vid, readonly)
        if was is None:
            raise HttpError(404, f"volume {vid} not found")
        if was != readonly:
            # the lease follows writability: a frozen volume hands it
            # back (an encode reads the .idx next), a thawed one may
            # qualify again
            self._fast_sync(vid)
        # was_readonly lets an orchestrator restore exactly the prior state
        return {"volume": vid, "readonly": readonly, "was_readonly": was}

    def admin_configure_replication(self, req: Request):
        """Rewrite a volume's replica placement in its superblock
        (reference VolumeConfigure); 409 on a readonly volume."""
        vid = int(req.query["volume"])
        try:
            rp = ReplicaPlacement.parse(req.query.get("replication", ""))
        except (ValueError, KeyError) as e:
            raise HttpError(400, f"bad replication: {e}") from None
        v = self.store.find_volume(vid)
        if v is None:
            raise HttpError(404, f"volume {vid} not found")
        try:
            v.configure_replication(rp)
        except VolumeError as e:
            raise HttpError(409, str(e)) from None
        # the lease's one-copy condition may have changed
        self._fast_sync(vid)
        self.heartbeat_once()
        return {"volume": vid, "replication": str(rp)}

    def admin_volume_mount(self, req: Request):
        """Serve an on-disk volume (reference VolumeMount)."""
        vid = int(req.query["volume"])
        if self.store.find_volume(vid) is not None:
            return {"volume": vid, "mounted": False}  # already serving
        for loc in self.store.locations:
            if loc.load_volume(vid) is not None:
                self._fast_sync(vid)
                self.heartbeat_once()
                return {"volume": vid, "mounted": True}
        raise HttpError(404, f"volume {vid} files not found")

    def admin_volume_unmount(self, req: Request):
        """Stop serving a volume and keep its files (reference
        VolumeUnmount)."""
        vid = int(req.query["volume"])
        if self.store.find_volume(vid) is not None:
            # off the plane first: it must not acknowledge writes to an
            # unmounted volume
            self._fast_unregister(vid)
        for loc in self.store.locations:
            if loc.unload_volume(vid):
                self.heartbeat_once()
                return {"volume": vid, "unmounted": True}
        self._fast_sync(vid)
        raise HttpError(404, f"volume {vid} not mounted")

    def admin_volume_copy(self, req: Request):
        """Pull a whole volume (.idx, then .dat) from ``source`` and serve
        it (reference VolumeCopy). The .idx comes first: the .dat only
        grows, so every entry of an earlier index snapshot lies inside
        the later .dat; an unindexed .dat tail is harmless."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        source = req.query["source"]
        if self.store.find_volume(vid) is not None:
            raise HttpError(409, f"volume {vid} already here")
        loc = self.store.find_free_location()
        if loc is None:
            raise HttpError(507, "no free disk location")
        base = volume_file_prefix(loc.directory, collection, vid)
        name = os.path.basename(base)
        for ext in (".idx", ".dat"):
            pull_file(source, name + ext, base + ext)
        loc.load_existing_volumes()
        self._fast_sync(vid)
        self.heartbeat_once()
        return {"volume": vid, "copied": True}

    def admin_volume_verify(self, req: Request):
        """Read and CRC-check every live needle the index lists, in .dat
        order, locking the volume per needle (volume.fsck -deep)."""
        vid, v = self._find_volume(req)
        checked = errors = 0
        with v.lock:
            snapshot = snapshot_live_items(v.nm, by_offset=True)
        for nid, nv in snapshot:
            checked += 1
            try:
                with v.lock:
                    blob = v._read_blob(nv.offset, nv.size)
                Needle.from_bytes(blob, v.version, expected_size=nv.size)
            except (CorruptNeedle, OSError, VolumeError):
                errors += 1
        return {"volume": vid, "checked": checked, "errors": errors}

    def admin_tier_upload(self, req: Request):
        """Ship a readonly volume's .dat to the backend ``dest``
        (reference VolumeTierMoveDatToRemote); 400 when the volume is
        writable or already remote, or the backend refuses."""
        vid, v = self._find_volume(req)
        # off the plane first: once the local .dat is gone its open fd
        # would go on serving (and holding the disk space)
        self._fast_unregister(vid)
        try:
            info = volume_tier.upload_dat(
                v, req.query["dest"],
                keep_local=req.query.get("keep_local") == "true")
        except (VolumeError, BackendError) as e:
            self._fast_sync(vid)
            raise HttpError(400, str(e)) from None
        if req.query.get("keep_local") == "true":
            self._fast_sync(vid)
        self.heartbeat_once()
        return info

    def admin_tier_download(self, req: Request):
        """Bring a tiered volume's .dat back to local disk (reference
        VolumeTierMoveDatFromRemote); 400 "no remote tier" for a volume
        that has none."""
        vid, v = self._find_volume(req)
        try:
            out = volume_tier.download_dat(
                v, delete_remote=req.query.get("delete_remote") == "true")
        except (VolumeError, BackendError) as e:
            raise HttpError(400, str(e)) from None
        self._fast_sync(vid)
        self.heartbeat_once()
        return out

    def admin_volume_sync_status(self, req: Request):
        """What an incremental copy needs to know of a volume (reference
        VolumeSyncStatus)."""
        vid, v = self._find_volume(req)
        try:
            last_ns = volume_backup.last_append_at_ns(v)
        except VolumeError as e:
            raise HttpError(400, str(e)) from None
        return {
            "volume": vid,
            "collection": v.collection,
            "tail_offset": v.size(),
            "compact_revision": v.super_block.compaction_revision,
            "replication": str(v.super_block.replica_placement),
            "ttl": str(v.super_block.ttl),
            "version": v.version,
            "last_append_at_ns": last_ns,
        }

    def admin_volume_tail(self, req: Request):
        """The raw records appended after ``since_ns``, at most
        ``max_bytes`` (the default page when 0) ending on a record
        (reference VolumeIncrementalCopy)."""
        vid, v = self._find_volume(req)
        max_bytes = int(req.query.get("max_bytes", 0)) \
            or volume_backup.DEFAULT_TAIL_PAGE_BYTES
        try:
            return Response(volume_backup.read_incremental(
                v, int(req.query.get("since_ns", 0)), max_bytes))
        except VolumeError as e:
            raise HttpError(400, str(e)) from None

    def admin_volume_tail_receive(self, req: Request):
        """Append the raw records a tail sender shipped and replay them
        into the needle map (reference VolumeTailReceiver)."""
        vid, v = self._find_volume(req)
        since = req.query.get("since_ns")
        # the records land through the volume's own files: the lease
        # comes back first, so the plane appends nothing meanwhile
        self._writer_release(v)
        try:
            applied, cursor = volume_backup.append_raw_records(
                v, req.body, int(since) if since is not None else None)
        except VolumeError as e:
            self._fast_sync(vid)
            raise HttpError(400, str(e)) from None
        self._fast_sync(vid)
        return {"applied": applied, "cursor_ns": cursor}

    def admin_ec_generate(self, req: Request):
        """Encode a readonly volume into shard files. Query only: every
        shard lands on this disk. When the POST body carries
        ``assignment`` ({shard: holder url}), the streaming encode+spread
        runs instead: each shard's slab ranges are pushed to its holder
        while later slabs encode, and shards bound for other holders
        never touch this disk."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        try:
            body = req.json()
        except ValueError:
            raise HttpError(400, "bad JSON body") from None
        if isinstance(body, dict) and body.get("assignment"):
            stats: dict = {}
            base, final = self.store.generate_ec_shards_streaming(
                vid, collection,
                assignment={int(s): u
                            for s, u in body["assignment"].items()},
                spares=body.get("spares") or [],
                window=int(body.get("window") or 0) or None,
                stats=stats,
                rate_mbps=float(body.get("rate_mbps") or 0.0))
            metrics.observe_spread(stats)
            metrics.observe_mesh(stats)
            return {"volume": vid, "base": os.path.basename(base),
                    "assignment": {str(s): u for s, u in final.items()},
                    "stats": stats,
                    "trace_id": tracing.current_trace_id()}
        base = self.store.generate_ec_shards(vid, collection)
        return {"volume": vid, "base": os.path.basename(base)}

    def _ec_stage_base(self, vid: int, collection: str) -> str:
        """Base path for incoming shard stages: the location already
        holding this volume's EC files if any (staged ranges, finalized
        shards and the later sidecar copy must all land at ONE base, or
        the mount will not see them), else a free location."""
        exts = [to_ext(s) for s in range(TOTAL_SHARDS)] + [".ecx"]
        for loc in self.store.locations:
            base = volume_file_prefix(loc.directory, collection, vid)
            if any(os.path.exists(base + e) or
                   os.path.exists(base + e + ".part") for e in exts):
                return base
        loc = self.store.find_free_location()
        if loc is None:
            raise HttpError(507, "no free disk location")
        return volume_file_prefix(loc.directory, collection, vid)

    def admin_ec_shard_write(self, req: Request):
        """Take one shard's ranges from a streaming encode+spread
        (ec/spread.py): chunked POSTs append at the expected offset into
        ``<shard>.part`` (a 409 carries the staged size on a mismatch, so
        a sender that lost an ack can tell delivered from diverged);
        ``action=finalize&size=`` checks the stage and renames it into
        place atomically; ``action=abort`` drops the stages. A failure
        never leaves a partial shard file."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        action = req.query.get("action", "append")
        if action == "abort":
            req.drain()
            removed = []
            for loc in self.store.locations:
                base = volume_file_prefix(loc.directory, collection, vid)
                for sid in range(TOTAL_SHARDS):
                    p = base + to_ext(sid) + ".part"
                    if os.path.exists(p):
                        os.remove(p)
                        removed.append(sid)
            return {"volume": vid, "aborted": removed}
        sid = int(req.query["shard"])
        base = self._ec_stage_base(vid, collection)
        part = base + to_ext(sid) + ".part"
        if action == "finalize":
            req.drain()
            size = int(req.query["size"])
            if not os.path.exists(part):
                raise HttpError(404, f"no staged shard {sid} for "
                                     f"volume {vid}")
            staged = os.path.getsize(part)
            if staged != size:
                raise HttpError(409, f"shard {sid} staged={staged} "
                                     f"expected={size}")
            os.replace(part, base + to_ext(sid))
            return {"volume": vid, "shard": sid, "size": size,
                    "finalized": True}
        off = int(req.query.get("offset", "0"))
        staged = os.path.getsize(part) if os.path.exists(part) else 0
        if off != staged and off != 0:
            # consume the (window-bounded) body, so the sender reads this
            # answer off a cleanly framed connection
            _ = req.body
            raise HttpError(409, f"shard {sid} offset mismatch: "
                                 f"staged={staged} offset={off}")
        data = req.body
        # offset 0 truncates: a replayed first range (failover to this
        # server, or a retry whose original died mid-body) starts clean
        with open(part, "wb" if off == 0 else "ab") as f:
            f.write(data)
            staged = f.tell()
        return {"volume": vid, "shard": sid, "staged": staged}

    def admin_ec_mount(self, req: Request):
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        shard_ids = self._shard_ids(req)
        mounted = self.store.mount_ec_shards(vid, collection, shard_ids)
        if not mounted and shard_ids:
            # tell "already mounted" from "files not found", so a wrong or
            # omitted collection fails loudly instead of doing nothing
            ev = self.store.find_ec_volume(vid)
            if ev is None or not set(shard_ids) & set(ev.shards):
                raise HttpError(
                    404, f"no shard files for volume {vid} "
                         f"collection={collection!r} here")
        self.heartbeat_once()
        return {"volume": vid, "mounted": mounted}

    def _shard_ids(self, req: Request) -> List[int]:
        return [int(x) for x in req.query.get("shards", "").split(",")
                if x != ""]

    def admin_ec_unmount(self, req: Request):
        vid = int(req.query["volume"])
        out = self.store.unmount_ec_shards(vid, self._shard_ids(req))
        self._fast_ec_sync(vid)  # the plane stops reading those files
        self._ec_loc_cache.invalidate(vid)
        self.heartbeat_once()
        return {"volume": vid, "unmounted": out}

    def admin_ec_rebuild(self, req: Request):
        """Rebuild lost shards: query only, from the shard files on this
        server's disks; with ``sources`` ({shard: [holders]}) in the POST
        body, streamed: survivor ranges are pulled and decoded in
        overlapped slabs and never land whole on disk. The rebuilt shards
        are not mounted."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        try:
            body = req.json()
        except ValueError:
            raise HttpError(400, "bad JSON body") from None
        stats: dict = {}
        if isinstance(body, dict) and body.get("sources"):
            hedge_ms = body.get("hedge_ms")
            rebuilt = self.store.rebuild_ec_shards_streaming(
                vid, collection, sources=body["sources"], stats=stats,
                slab=int(body.get("slab") or 0) or None,
                window=int(body.get("window") or 0) or None,
                hedge_ms=None if hedge_ms is None else float(hedge_ms),
                repair=str(body.get("repair") or "auto"))
            metrics.observe_gather(stats)
            metrics.observe_repair(stats)
            metrics.observe_mesh(stats)
        else:
            rebuilt = self.store.rebuild_ec_shards(vid, collection,
                                                   stats=stats)
        if rebuilt:
            self._invalidate_reconstructions(vid, rebuilt)
        return {"volume": vid, "rebuilt": rebuilt, "stats": stats,
                "trace_id": tracing.current_trace_id()}

    def admin_ec_scrub(self, req: Request):
        """A synchronous scrub: one volume (?volume=) or a pass over
        every local EC volume. A request bypasses the lowest-shard owner
        rule: an operator asking this server to scrub means this
        server."""
        vid = req.query.get("volume")
        if vid is not None:
            return self.scrub.scrub_volume(int(vid), force=True)
        return self.scrub.run_pass(force=True)

    def admin_ec_scrub_status(self, req: Request):
        return self.scrub.snapshot()

    def admin_ec_scrub_repair(self, req: Request):
        """Quarantine and rebuild one corrupt shard: unmount it and
        remove its file (and any stage), so it can neither serve a read
        nor feed a decode, then stream it back from the other shards'
        holders (the body's ``sources``, else the master's map) and
        mount it. The master's repair queue sends this to the holder a
        scrub finding names."""
        vid = int(req.query["volume"])
        sid = int(req.query["shard"])
        collection = req.query.get("collection", "")
        try:
            body = req.json()
        except ValueError:
            raise HttpError(400, "bad JSON body") from None
        body = body if isinstance(body, dict) else {}
        self.store.unmount_ec_shards(vid, [sid])
        # the plane drops its fd of the poisoned file now
        self._fast_ec_sync(vid)
        self._ec_loc_cache.invalidate(vid)
        for loc in self.store.locations:
            base = volume_file_prefix(loc.directory, collection, vid)
            for p in (base + to_ext(sid), base + to_ext(sid) + ".part"):
                if os.path.exists(p):
                    os.remove(p)
        sources = body.get("sources") or self._ec_shard_locations(vid)
        sources = {int(s): [u for u in urls if u != self.url]
                   for s, urls in (sources or {}).items()
                   if int(s) != sid}
        stats: dict = {}
        rebuilt = self.store.rebuild_ec_shards_streaming(
            vid, collection, sources=sources, stats=stats,
            repair=str(body.get("repair") or "auto"))
        metrics.observe_gather(stats)
        metrics.observe_repair(stats)
        metrics.observe_mesh(stats)
        mounted = self.store.mount_ec_shards(vid, collection, rebuilt) \
            if rebuilt else []
        self._invalidate_reconstructions(vid, rebuilt or [sid])
        self.heartbeat_once()
        return {"volume": vid, "shard": sid, "rebuilt": rebuilt,
                "mounted": mounted, "stats": stats,
                "trace_id": tracing.current_trace_id()}

    def _report_scrub_finding(self, finding: dict) -> bool:
        """A scrub finding to the master's repair queue; True only when
        the master took it (the engine counts the failures, and the
        finding stays in its snapshot)."""
        if not self.master_url:
            return False
        try:
            post_json(f"http://{self.master_url}/cluster/scrub_report",
                      finding, timeout=5)
            return True
        except HttpError:
            return False

    def admin_devices(self, req: Request):
        """``ops/device_stats.admin_snapshot()``: each kernel's launches,
        the builds and recompiles with the sentinel, sampled device
        seconds, the plan caches, the constant cache's occupancy and the
        card (CUDA initialized if it was not)."""
        return device_stats.admin_snapshot()

    def admin_ec_delete_shards(self, req: Request):
        """Unmount and remove shard files (and any spread stage beside
        them); the .ecx, .ecj, .vif and .scrub go once no shard file is
        left."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        shard_ids = self._shard_ids(req)
        self.store.unmount_ec_shards(vid, shard_ids)
        self._fast_ec_sync(vid)
        # the cached holders listed this server for these shards: a read
        # now asks the master where they went instead of reconstructing
        self._ec_loc_cache.invalidate(vid)
        removed = []
        for loc in self.store.locations:
            base = volume_file_prefix(loc.directory, collection, vid)
            for sid in shard_ids:
                for p in (base + to_ext(sid), base + to_ext(sid) + ".part"):
                    if os.path.exists(p):
                        os.remove(p)
                        if not p.endswith(".part"):
                            removed.append(sid)
            if not any(os.path.exists(base + to_ext(s))
                       for s in range(TOTAL_SHARDS)):
                for ext in (".ecx", ".ecj", ".vif", ".scrub"):
                    if os.path.exists(base + ext):
                        os.remove(base + ext)
        self.heartbeat_once()
        return {"volume": vid, "removed": removed}

    def admin_ec_to_volume(self, req: Request):
        """Decode the mounted EC volume back into a plain one: the
        .dat from the data shards (all must be here), the .idx from the
        .ecx and .ecj; the shards are unmounted, their files stay."""
        vid = int(req.query["volume"])
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            raise HttpError(404, f"ec volume {vid} not mounted")
        if len([s for s in ev.shard_ids() if s < DATA_SHARDS]) < DATA_SHARDS:
            raise HttpError(409, "need all data shards local to decode")
        base = ev.base_name
        dat_size = ec_decoder.find_dat_file_size(base)
        ec_decoder.write_dat_file(base, dat_size)
        ec_decoder.write_idx_file_from_ec_index(base)
        self.store.unmount_ec_shards(vid, list(range(TOTAL_SHARDS)))
        self._fast_ec_sync(vid)  # a plain volume again
        for loc in self.store.locations:
            if os.path.dirname(base) == loc.directory:
                loc.load_existing_volumes()
        self._fast_sync(vid)
        self.heartbeat_once()
        return {"volume": vid, "dat_size": dat_size}

    def admin_ec_copy(self, req: Request):
        """Pull shard files, and with ``copy_ecx`` the .ecx, from a source
        server's ``/admin/file``. The .vif and .ecj are optional: a 404
        on either is skipped, any other status fails the copy (a skipped
        .vif would turn into a wrong offset-width guess on a parity-only
        holder)."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        source = req.query["source"]
        shard_ids = self._shard_ids(req)
        copy_ecx = req.query.get("copy_ecx", "true") == "true"
        # land next to any EC files this volume already has here: a
        # streamed spread may have staged shards on this server, and the
        # sidecars must join them at the same base for the mount
        base = self._ec_stage_base(vid, collection)
        name = os.path.basename(base)
        exts = [to_ext(s) for s in shard_ids]
        optional = []
        if copy_ecx:
            exts.append(".ecx")
            optional = [".vif", ".ecj"]
        copied = []
        for ext in exts + optional:
            try:
                data = http_call(
                    "GET", f"http://{source}/admin/file?name={name}{ext}",
                    timeout=300)
            except HttpError as e:
                if ext in optional and e.status == 404:
                    continue
                raise
            with open(base + ext, "wb") as f:
                f.write(data)
            copied.append(ext)
        return {"volume": vid, "copied": copied}

    def _shard(self, req: Request):
        vid = int(req.query["volume"])
        sid = int(req.query["shard"])
        ev = self.store.find_ec_volume(vid)
        if ev is None or sid not in ev.shards:
            raise HttpError(404, f"shard {vid}.{sid} not here")
        return ev.shards[sid]

    def admin_ec_shard_read(self, req: Request):
        """Ranged shard reads for the streaming gather. Two forms:
        ``offset``/``size`` query parameters, or a ``Range: bytes=a-b``
        / ``bytes=-N`` header answered 206 with ``Content-Range`` (whose
        ``/total`` lets a rebuilder size a shard with a 1-byte probe)."""
        shard = self._shard(req)
        total = shard.size
        rng = parse_range(req.headers.get("Range", ""), total)
        if rng is None:
            offset = int(req.query.get("offset", 0))
            size = int(req.query.get("size", 0))
            return Response(shard.read_at(offset, size),
                            headers={"Accept-Ranges": "bytes"})
        offset, length = rng
        if length == 0:
            return Response(b"", headers={"Accept-Ranges": "bytes"})
        return Response(
            shard.read_at(offset, length), status=206,
            headers={
                "Accept-Ranges": "bytes",
                "Content-Range":
                    f"bytes {offset}-{offset + length - 1}/{total}",
            })

    def admin_ec_shard_repair_read(self, req: Request):
        """Projected shard read for trace repair: read the range of a
        local shard, apply the caller's GF(2^8) trace masks, and return
        only the packed symbol planes, ``len(masks)`` planes of
        ``ceil(size/8)`` bytes. The full range never leaves the
        holder."""
        shard = self._shard(req)
        try:
            offset = int(req.query.get("offset", 0))
            size = int(req.query["size"])
            masks = [int(x) for x in req.query["masks"].split(",")]
        except (KeyError, ValueError):
            raise HttpError(400, "need offset/size/masks query params")
        if offset < 0 or size <= 0:
            raise HttpError(400, f"bad range {offset}+{size}")
        if not masks or any(not (0 < x < 256) for x in masks):
            raise HttpError(400, f"masks must be 1..255, got {masks}")
        if offset + size > shard.size:
            raise HttpError(
                416, f"range {offset}+{size} beyond shard size {shard.size}")
        data = np.frombuffer(shard.read_at(offset, size), dtype=np.uint8)
        planes = ops_codec.project_slab(data, masks)
        return Response(
            planes.tobytes(),
            headers={
                "X-Repair-Planes": str(planes.shape[0]),
                "X-Repair-Stride": str(planes.shape[1]),
            })

    def admin_ec_shard_plane_read(self, req: Request):
        """Half-plane shard read for piggyback repair: read the
        window-aligned range of a local shard and return only the
        sub-chunks of the caller's repair plane, ``size/2`` bytes."""
        shard = self._shard(req)
        try:
            offset = int(req.query.get("offset", 0))
            size = int(req.query["size"])
            alpha = int(req.query["alpha"])
            window = int(req.query["window"])
            bit = int(req.query["bit"])
            side = int(req.query["side"])
        except (KeyError, ValueError):
            raise HttpError(
                400, "need offset/size/alpha/window/bit/side query params")
        if offset < 0 or size <= 0:
            raise HttpError(400, f"bad range {offset}+{size}")
        if alpha < 2 or alpha & (alpha - 1) or window % alpha:
            raise HttpError(
                400, f"bad sub-chunk geometry alpha={alpha} "
                     f"window={window}")
        if not (0 <= bit < alpha.bit_length() - 1) or side not in (0, 1):
            raise HttpError(400, f"bad plane bit={bit} side={side}")
        if offset % window or size % window:
            raise HttpError(
                400, f"range {offset}+{size} not aligned to "
                     f"window {window}")
        if offset + size > shard.size:
            raise HttpError(
                416, f"range {offset}+{size} beyond shard size {shard.size}")
        data = np.frombuffer(shard.read_at(offset, size), dtype=np.uint8)
        plane = ops_codec.pb_plane_slice(data, alpha, window, bit, side)
        return Response(
            plane.tobytes(),
            headers={
                "X-Plane-Alpha": str(alpha),
                "X-Plane-Window": str(window),
            })

    def admin_file(self, req: Request):
        """Serve a raw storage file (the index sidecars a rebuilder
        fetches). Restricted to the store's own directories and known
        extensions."""
        name = os.path.basename(req.query.get("name", ""))
        ok_ext = name.endswith((".ecx", ".ecj", ".vif", ".dat", ".idx")) \
            or ".ec" in name
        if not name or not ok_ext:
            raise HttpError(400, "bad file name")
        for loc in self.store.locations:
            path = os.path.join(loc.directory, name)
            if os.path.exists(path):
                if req.query.get("stat"):
                    return {"size": os.path.getsize(path)}
                offset = int(req.query.get("offset", 0))
                size = int(req.query.get("size", 0)) \
                    or os.path.getsize(path) - offset
                return Response(body_path=path, body_range=(offset, size))
        raise HttpError(404, f"{name} not found")

    # -- the guard -----------------------------------------------------------
    def _guard_check(self, req: Request):
        """Under mutual TLS the admin routes want a client certificate;
        the whitelist covers every route, the admin ones included."""
        if req.path.startswith("/admin/"):
            require_client_cert(req)
        if self.guard.enabled and \
                not self.guard.allows(req.handler.client_address[0]):
            raise HttpError(403, "ip not in whitelist")

    def _check_write_jwt(self, req: Request):
        """With a key, a write or delete needs a token signed for its
        fid."""
        if not self.jwt_signing_key:
            return
        token = jwt_from_request(req.headers, req.query)
        if not token:
            raise HttpError(401, "missing write jwt")
        try:
            verify_fid_jwt(self.jwt_signing_key, token,
                           req.path.lstrip("/"))
        except VerifyError as e:
            raise HttpError(401, f"jwt rejected: {e}") from None

    def _jwt_query(self, req: Request) -> str:
        """``&jwt=<the writer's token>`` for a fan-out hop (with a key)."""
        token = jwt_from_request(req.headers, req.query) \
            if self.jwt_signing_key else None
        return f"&jwt={token}" if token else ""

    # -- the data routes -----------------------------------------------------
    def data_handler(self, req: Request):
        if req.path == "/":
            return self.status(req)
        try:
            vid, key, cookie = parse_file_id(req.path.lstrip("/"))
        except ValueError:
            raise HttpError(404, f"invalid fid path {req.path}") from None
        if req.method in ("GET", "HEAD"):
            return self.read_needle(req, vid, key, cookie)
        if req.method in ("POST", "PUT"):
            self._check_write_jwt(req)
            return self.write_needle(req, vid, key, cookie)
        if req.method == "DELETE":
            self._check_write_jwt(req)
            return self.delete_needle(req, vid, key, cookie)
        raise HttpError(405, req.method)

    def write_needle(self, req: Request, vid, key, cookie):
        # an oversized upload is refused before its body is read; the
        # multipart envelope adds a little, so this is a coarse filter
        # and the check after the parse is exact
        if self.file_size_limit:
            try:
                clen = int(req.headers.get("Content-Length") or 0)
            except ValueError:
                clen = 0
            if clen > self.file_size_limit + 65536:
                raise HttpError(413, "file over the size limit")
        filename, ctype, data = req.upload_payload()
        if self.file_size_limit and len(data) > self.file_size_limit:
            raise HttpError(413, "file over the size limit")
        n = Needle(cookie=cookie, id=key, data=data)
        if filename:
            n.set_name(filename.encode())
        if not ctype:
            # the name's extension, when the upload names no type; an
            # explicit octet-stream is kept as it is
            ctype = mimetypes.guess_type(filename or "")[0] or ctype
        if ctype and ctype != "application/octet-stream":
            n.set_mime(ctype.encode())
        # ?ts= sets the modified time; the field is 5 bytes on disk, so
        # only 0 < ts < 2^40 is taken, anything else means now
        ts_raw = req.query.get("ts", "")
        ts_val = int(ts_raw) if ts_raw.isdigit() else 0
        if not 0 < ts_val < 1 << 40:
            ts_val = 0
        n.set_last_modified(ts_val)
        if req.query.get("cm") == "true":
            # the payload is a chunk manifest (client/chunked)
            n.set_is_chunk_manifest()
        # Seaweed-* headers ride with the needle as its pairs; the uint16
        # size field caps them, and past it the write fails rather than
        # drop them
        pairs = {k: v for k, v in req.headers.items()
                 if k.lower().startswith("seaweed-")}
        if pairs:
            blob = json.dumps(pairs).encode()
            if len(blob) >= 65536:
                raise HttpError(400, "Seaweed-* pairs exceed 64KB")
            n.set_pairs(blob)
        ttl = TTL.parse(req.query.get("ttl", ""))
        if ttl.to_uint32():
            n.set_ttl(ttl)
        try:
            self.store.write_needle(vid, n)
        except VolumeError as e:
            raise HttpError(500, str(e)) from None
        self._fast_put(vid, key)
        if req.query.get("type") != "replicate":
            self._replicate_write(req, vid, filename, ctype, data, ts_val)
        # the reference reports the data size, not the needle's Size
        return {"name": filename, "size": len(data), "eTag": n.etag}

    def _replicate_write(self, req: Request, vid, filename, ctype, data,
                         ts_val):
        """The write on every other replica, all at once; any failure
        fails the request, so the client knows the needle is
        under-replicated. The writer's token, ``cm``, ``ttl``, the checked
        ``ts`` and the Seaweed-* pairs go with it."""
        extra_q = self._jwt_query(req)
        if req.query.get("cm") == "true":
            extra_q += "&cm=true"
        if req.query.get("ttl"):
            extra_q += f"&ttl={req.query['ttl']}"
        if ts_val:
            extra_q += f"&ts={ts_val}"
        pair_headers = {k: v for k, v in req.headers.items()
                        if k.lower().startswith("seaweed-")} or None

        def replicate(node_url: str):
            post_multipart(
                f"http://{node_url}{req.path}?type=replicate{extra_q}",
                filename, data, ctype or "application/octet-stream",
                headers=pair_headers)

        failed = [
            f"{node_url}: {exc.message or exc.status}"
            if isinstance(exc, HttpError) else f"{node_url}: {exc}"
            for node_url, _, exc in fan_out(
                replicate, self._other_replicas(vid, self._copies(vid)))
            if exc is not None]
        if failed:
            raise HttpError(500, "replication failed on " + "; ".join(failed))

    def _copies(self, vid: int) -> int:
        """The local volume's replica count (its placement's copy count)."""
        v = self.store.find_volume(vid)
        return v.super_block.replica_placement.copy_count if v else 1

    def _other_replicas(self, vid: int, copies: int = 1) -> List[str]:
        """The volume's other holders: from the pushed location map,
        else a /dir/lookup kept LOOKUP_TTL_S; none without a master. A
        map that lists fewer than ``copies`` holders (a write's or a
        delete's copy count) may be behind the master: the map learns
        each replica of a grown volume from its own push, so a write
        just after the growth can find only the first one. Then the
        master's answer is used, whatever its length, since the master
        is the authority. A lookup that fails is kept LOOKUP_TTL_S as
        no answer: the map's list (none without one) stands meanwhile."""
        if not self.master_url:
            return []
        urls = self._vid_map.lookup(vid)
        if urls is None or len(urls) < copies:
            cached = self._lookup_cache.get(vid)
            if cached and time.time() - cached[0] < LOOKUP_TTL_S:
                answer = cached[1]
            else:
                try:
                    out = get_json(f"http://{self.master_url}/dir/lookup"
                                   f"?volumeId={vid}", timeout=10)
                    answer = [loc["url"]
                              for loc in out.get("locations", [])]
                except HttpError:
                    answer = None
                self._lookup_cache[vid] = (time.time(), answer)
            if answer is not None:
                urls = answer
        return [u for u in (urls or []) if u != self.url]

    def read_needle(self, req: Request, vid, key, cookie):
        if self.store.find_volume(vid) is None:
            if self.store.find_ec_volume(vid) is not None:
                got = self._read_needle_local(vid, key, cookie,
                                              f"{vid},{key:x}")
                return self._needle_response(got, req)
            # not held here: a replica has it
            others = self._other_replicas(vid) if self.read_redirect \
                else []
            if others:
                return Response(b"", 301, headers={
                    "Location": f"http://{others[0]}{req.path}"})
            raise HttpError(404, f"volume {vid} not found")
        try:
            got = self.store.read_needle(vid, Needle(id=key, cookie=cookie))
        except NotFound as e:
            raise HttpError(404, str(e)) from None
        return self._needle_response(got, req)

    def _needle_response(self, got: Needle, req: Request) -> Response:
        # a chunk manifest is resolved to its chunks unless ?cm=false
        if got.is_chunk_manifest() and req.query.get("cm") != "false":
            return self._chunk_manifest_response(got, req)
        ctype = got.mime.decode() if got.has_mime() \
            else "application/octet-stream"
        etag = f'"{got.etag}"'
        # Last-Modified and If-Modified-Since, checked before the ETag as
        # the reference does
        lm_header = None
        if got.has_last_modified() and got.last_modified:
            lm_header = formatdate(got.last_modified, usegmt=True)
            ims = req.headers.get("If-Modified-Since")
            if ims:
                try:
                    dt = parsedate_to_datetime(ims)
                    if dt.tzinfo is None:
                        # '-0000' parses naive and means UTC (RFC 5322)
                        dt = dt.replace(tzinfo=timezone.utc)
                    t = dt.timestamp()
                except (TypeError, ValueError):
                    t = None
                if t is not None and t >= got.last_modified:
                    return Response(b"", 304,
                                    headers={"Last-Modified": lm_header,
                                             "Etag": etag})
        # If-None-Match: a comma list of (possibly weak) validators, or *
        inm = (req.headers.get("If-None-Match") or "").strip()
        if inm:
            candidates = {c.strip().removeprefix("W/")
                          for c in inm.split(",")}
            if "*" in candidates or etag in candidates:
                return Response(b"", 304, headers={"Etag": etag})
        headers = {"Etag": etag, "Accept-Ranges": "bytes"}
        if lm_header:
            headers["Last-Modified"] = lm_header
        if got.has_pairs() and got.pairs:
            try:
                headers.update(json.loads(got.pairs.decode()))
            except (ValueError, AttributeError):
                pass
        if got.has_name():
            # the name is the uploader's: escape it for a quoted string
            name = got.name.decode("utf-8", "replace") \
                .replace("\\", "\\\\").replace('"', '\\"')
            headers["Content-Disposition"] = f'inline; filename="{name}"'
        body = got.data
        # a resize only on a whole-object read of an image: a Range read
        # (a chunk's slice) must get the stored bytes
        if ctype.startswith("image/") and not req.headers.get("Range"):
            width = int(req.query.get("width", 0) or 0)
            height = int(req.query.get("height", 0) or 0)
            if width or height:
                if ctype == "image/jpeg":
                    body = fix_orientation(body, ctype)
                body, ctype = resize_image(body, ctype, width, height,
                                           req.query.get("mode", ""))
        total = len(body)
        parsed = parse_range(req.headers.get("Range") or "", total)
        if parsed is not None:
            start, length = parsed
            headers["Content-Range"] = \
                f"bytes {start}-{start + length - 1}/{total}"
            return Response(body[start:start + length], 206, ctype, headers)
        return Response(body, 200, ctype, headers)

    def _chunk_manifest_response(self, got: Needle,
                                 req: Request) -> Response:
        """The file a manifest lists (reference chunked_file.go), or the
        Range of it asked for: each chunk's slice is fetched with a
        ranged GET, all at once, from its volume's holders."""
        manifest = ChunkManifest.from_json(got.data)
        ctype = manifest.mime or "application/octet-stream"
        headers = {"Accept-Ranges": "bytes"}
        if manifest.name:
            headers["Content-Disposition"] = \
                f'inline; filename="{manifest.name}"'
        parsed = parse_range(req.headers.get("Range") or "", manifest.size)
        start, length = parsed if parsed is not None else (0, manifest.size)
        jobs = []
        for c in manifest.chunks:
            lo = max(c.offset, start)
            hi = min(c.offset + c.size, start + length)
            if lo < hi:
                jobs.append((c, lo, hi))
        out = bytearray(length)
        for (c, lo, hi), seg, exc in fan_out(
                lambda job: self._fetch_fid_range(
                    job[0].fid, job[1] - job[0].offset, job[2] - job[1]),
                jobs, dedicated=True):
            if exc is not None:
                raise HttpError(502, f"chunk {c.fid} unavailable: {exc}")
            out[lo - start:lo - start + len(seg)] = seg
        if parsed is not None:
            headers["Content-Range"] = \
                f"bytes {start}-{start + length - 1}/{manifest.size}"
            return Response(bytes(out), 206, ctype, headers)
        return Response(bytes(out), 200, ctype, headers)

    def _fetch_fid_range(self, fid: str, offset: int, size: int) -> bytes:
        """``size`` bytes at ``offset`` of a needle, from the first of
        its volume's holders that answers (this server too)."""
        vid, _, _ = parse_file_id(fid)
        urls = self._vid_map.lookup(vid) if self._vid_map else None
        if not urls:
            urls = lookup(self.master_url, vid) if self.master_url \
                else [self.url]
        last = None
        for u in urls:
            try:
                return http_call("GET", f"http://{u}/{fid}", headers={
                    "Range": f"bytes={offset}-{offset + size - 1}"})
            except HttpError as e:
                last = e
        raise last or HttpError(404, f"no locations for {fid}")

    def _cascade_chunk_manifest_delete(self, vid: int, n: Needle):
        """A manifest's chunks are deleted before the manifest (reference
        DeleteHandler + operation.DeleteChunks): left, they would be
        unreachable garbage. The flag is read with two small reads, so a
        plain delete never reads its payload."""
        try:
            if not self.store.read_needle_flags(vid, n) & \
                    FLAG_IS_CHUNK_MANIFEST:
                return
            got = self.store.read_needle(vid, Needle(id=n.id,
                                                     cookie=n.cookie))
            manifest = ChunkManifest.from_json(got.data)
        except (NotFound, VolumeError, ValueError, KeyError):
            return
        fan_out(lambda c: delete_file(self.master_url, c.fid)
                if self.master_url else http_call(
                    "DELETE", f"http://{self.url}/{c.fid}"),
                manifest.chunks, dedicated=True)

    def delete_needle(self, req: Request, vid, key, cookie):
        if self.store.find_volume(vid) is None:
            ev = self.store.find_ec_volume(vid)
            if ev is not None:
                return self._delete_ec_needle(req, ev, vid, key)
            raise HttpError(404, f"volume {vid} not found")
        n = Needle(id=key, cookie=cookie)
        if req.query.get("type") != "replicate" and \
                req.query.get("cm") != "false":
            self._cascade_chunk_manifest_delete(vid, n)
        try:
            freed = self.store.delete_needle(vid, n)
        except VolumeError as e:
            raise HttpError(500, str(e)) from None
        self._fast_delete(vid, key)
        if req.query.get("type") != "replicate":
            # every replica must drop it, or a read redirect brings it
            # back; a 404 there is already the goal
            jwt_q = self._jwt_query(req)

            def replicate(node_url: str):
                http_call("DELETE", f"http://{node_url}{req.path}"
                                    f"?type=replicate{jwt_q}")

            failed = [f"{node_url}: {exc}" for node_url, _, exc in
                      fan_out(replicate,
                              self._other_replicas(vid, self._copies(vid)))
                      if exc is not None and not (
                          isinstance(exc, HttpError) and exc.status == 404)]
            if failed:
                raise HttpError(500, "delete replication failed on "
                                + "; ".join(failed))
        return {"size": freed}

    # -- needles of EC volumes -----------------------------------------------
    def _read_needle_local(self, vid: int, key: int, cookie: int,
                           fid: str) -> Needle:
        """A needle parsed out of a local EC volume's shards: a shard not
        here is read from its holders, and a lost one reconstructed."""
        ev = self.store.find_ec_volume(vid)
        try:
            blob = ev.read_needle_blob(
                key, remote_fetch=self._read_shard_from_holders,
                reconstruct_fetch=self._reconstruct_shard_range)
        except KeyError:
            raise HttpError(404, f"{fid} not found") from None
        except EcShardNotFound as e:
            raise HttpError(503, f"ec volume {vid}: {e}") from None
        got = Needle.from_bytes(blob, ev.version)
        if got.id != key:
            # a valid needle, but not the one asked for: never serve
            # another needle's bytes (cookies alone can collide)
            raise HttpError(
                500, f"ec read of {fid} assembled needle {got.id:x}")
        if got.cookie != cookie:
            raise HttpError(404, "cookie mismatch")
        return got

    def _fetch_ec_shard_locations(self, vid: int) -> Dict[int, List[str]]:
        if not self.master_url:
            return {}
        try:
            out = json.loads(http_call(
                "GET", f"http://{self.master_url}/cluster/ec_lookup"
                       f"?volumeId={vid}", timeout=10))
        except (HttpError, ValueError):
            return {}
        return {int(k): v for k, v in out.get("shards", {}).items()}

    def _ec_shard_locations(self, vid: int) -> Dict[int, List[str]]:
        """The master's answer, cached with tiered freshness and
        forgotten per holder on a failed read (shard_cache)."""
        return self._ec_loc_cache.lookup(vid)

    def _read_shard_from_holders(self, vid: int, sid: int, offset: int,
                                 size: int) -> Optional[bytes]:
        """One shard's range from the first of its holders that answers;
        a holder that fails is forgotten. None when none answers."""
        for holder in self._ec_shard_locations(vid).get(sid, []):
            if holder == self.url:
                continue
            t0 = time.perf_counter()
            try:
                data = http_call(
                    "GET", f"http://{holder}/admin/ec/shard_read?volume="
                           f"{vid}&shard={sid}&offset={offset}&size={size}",
                    timeout=READ_TIMEOUT_S)
            except (HttpError, OSError):
                BOARD.record_error(holder)
                self._ec_loc_cache.forget(vid, sid, holder)
                continue
            BOARD.record_latency(holder, "degraded_read",
                                 time.perf_counter() - t0)
            return data
        return None

    def _reconstruct_shard_range(self, vid, sid, offset, size) -> bytes:
        """A lost shard's range, reconstructed by the degraded-read
        engine, or with ``degraded_mode`` "naive" on its own."""
        if self.degraded_mode == "naive":
            return self._reconstruct_shard_range_naive(vid, sid, offset,
                                                       size)
        return self.degraded.read(vid, sid, offset, size)

    def _reconstruct_shard_range_naive(self, vid, sid, offset,
                                       size) -> bytes:
        """One read's reconstruction, unbatched: the first k survivors
        the decode plan names (local ones off disk, the rest from their
        holders), and the lost shard's one coefficient row
        (``lost_row_coeffs``) as one (1, k) product on the codec's
        device."""
        ev = self.store.find_ec_volume(vid)
        locations = self._ec_shard_locations(vid)
        codec = self.store.codec
        present = []
        for other in range(codec.total):
            if other == sid:
                present.append(False)
            elif ev is not None and other in ev.shards:
                present.append(True)
            else:
                present.append(any(h != self.url
                                   for h in locations.get(other, [])))
        if sum(present) < DATA_SHARDS:
            raise HttpError(
                503, f"cannot reconstruct {vid}.{sid}: "
                     f"{sum(present)} shards")
        src, row = codec.lost_row_coeffs(tuple(present), sid)

        def pad(data: bytes) -> np.ndarray:
            if len(data) < size:  # the shard's tail: zeros, as local reads
                data = data + b"\x00" * (size - len(data))
            return np.frombuffer(data, dtype=np.uint8)

        rows: List[Optional[np.ndarray]] = [None] * len(src)
        remote = []
        for pos, other in enumerate(src):
            if ev is not None and other in ev.shards:
                rows[pos] = pad(ev.shards[other].read_at(offset, size))
            else:
                remote.append(pos)
        for pos, data, exc in fan_out(
                lambda p: self._read_shard_from_holders(
                    vid, src[p], offset, size), remote, dedicated=True):
            if exc is None and data is not None:
                rows[pos] = pad(data)
        if any(r is None for r in rows):
            have = sum(r is not None for r in rows)
            raise HttpError(
                503, f"cannot reconstruct {vid}.{sid}: {have} of "
                     f"{len(src)} survivors answered")
        return codec._matmul(row, np.stack(rows, axis=0))[0].tobytes()

    def _delete_ec_needle(self, req: Request, ev, vid, key):
        """Tombstone the needle in the .ecx and journal it in the .ecj,
        then send the delete to every other holder the master lists (a
        holder that misses it would serve the needle again; 404 there is
        the goal state)."""
        found = ev.delete_needle(key)
        if found:
            # the plane's .ecx mirror too: it redirects (and Python
            # answers 404) instead of serving the needle
            self._fast_ec_delete(vid, key)
        if req.query.get("type") != "replicate":
            # a fresh lookup first: a holder that mounted shards after the
            # cache filled must not miss the delete
            locations = self._fetch_ec_shard_locations(vid) or \
                self._ec_shard_locations(vid)
            targets = sorted({h for holders in locations.values()
                              for h in holders if h != self.url})
            jwt_q = self._jwt_query(req)

            def broadcast(holder: str):
                http_call("DELETE", f"http://{holder}{req.path}"
                                    f"?type=replicate{jwt_q}")

            failed = []
            if targets:
                with ThreadPoolExecutor(len(targets)) as pool:
                    futs = [(h, pool.submit(broadcast, h)) for h in targets]
                for holder, fut in futs:
                    exc = fut.exception()
                    if exc is None:
                        found = True
                    elif not (isinstance(exc, HttpError)
                              and exc.status == 404):
                        failed.append(f"{holder}: {exc}")
            if failed:
                raise HttpError(500, "ec delete replication failed on "
                                + "; ".join(failed))
        if not found:
            raise HttpError(404, f"needle {key} not in ec volume {vid}")
        return {"size": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve the volumes and EC shards of the given "
                    "directories over the data and EC routes.")
    ap.add_argument("--dir", action="append", required=True,
                    help="a directory of volumes and EC volumes "
                         "(repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port")
    ap.add_argument("--device", default="cuda",
                    help="where encodes, rebuilds and degraded reads run "
                         "(cuda or cpu)")
    ap.add_argument("--master", default="",
                    help="host:port of the master to heartbeat and ask for "
                         "locations, or a comma list of a raft group's "
                         "masters (none by default)")
    ap.add_argument("--max", default="7",
                    help="volume slots of each --dir (comma list)")
    ap.add_argument("--pulse-seconds", type=float, default=PULSE_S,
                    help="the heartbeat's period")
    ap.add_argument("--scrub-idle-s", type=float, default=None,
                    help="seconds between background scrub passes (<= 0: "
                         "none; default the scrub engine's)")
    ap.add_argument("--scrub-rate-mbps", type=float, default=None,
                    help="the background scrub's pace (0: unpaced)")
    ap.add_argument("--degraded-mode", default="batch",
                    choices=("batch", "naive"),
                    help="reads through a lost shard: the batching engine "
                         "or one reconstruction per read")
    ap.add_argument("--device-timing", action="store_true",
                    help="time every Nth kernel call (ops/device_stats)")
    ap.add_argument("--device-timing-sample", type=int, default=1,
                    help="N of --device-timing")
    ap.add_argument("--ec.backend", dest="ec_backend", default="cuda",
                    choices=("cuda", "auto", "native", "numpy", "mesh"),
                    help="the EC codec: the kernel on --device, the card "
                         "when there is one else the host's codecs, the "
                         "host's AVX2 codec, the host oracle, or the "
                         "kernel at every mesh position")
    ap.add_argument("--mesh.devices", dest="mesh_devices", default="",
                    help="the mesh codec's positions, a comma list of "
                         "torch devices (every card by default)")
    ap.add_argument("--jwt-key", default="",
                    help="the HS256 key of the masters' write tokens (a "
                         "write or delete without one is refused)")
    ap.add_argument("--whitelist", default="",
                    help="comma-separated IPs, prefixes (10.0.) and CIDRs "
                         "allowed on every route (none: all)")
    ap.add_argument("-fastPort", type=int, default=0,
                    help="the native plane's port (0 picks one, -1: no "
                         "plane); plain needle GETs and POSTs are served "
                         "there without the GIL")
    ap.add_argument("-index", default="memory",
                    choices=("memory", "compact", "sortedfile", "disk"),
                    help="the needle map: a dict in memory, sorted arrays, "
                         "an mmap'd sorted file, or on disk (sqlite) for "
                         "indexes larger than RAM")
    ap.add_argument("-tierConfig", default="",
                    help="JSON file of remote tier backends, e.g. "
                         '{"s3": {"default": {"endpoint": ..., '
                         '"bucket": ...}}, "dir": {"cold": {"path": ...}}}')
    args = ap.parse_args(argv)
    if args.tierConfig:
        with open(args.tierConfig) as f:
            configure_backends(json.load(f))
    backend, where = ops_codec.resolve_backend(args.ec_backend)
    device = args.device if where == "cuda" else "cpu"
    positions = [d for d in args.mesh_devices.split(",") if d]
    mesh = None
    if backend == "mesh" and positions:
        from ..parallel.mesh import make_codec_mesh
        mesh = make_codec_mesh(positions)
    slots = [int(x) for x in args.max.split(",")]
    slots += slots[-1:] * (len(args.dir) - len(slots))
    vs = VolumeServer(port=args.port, host=args.host,
                      directories=args.dir, device=device,
                      master_url=args.master,
                      max_volume_counts=slots[:len(args.dir)],
                      pulse_seconds=args.pulse_seconds,
                      scrub_idle_s=args.scrub_idle_s,
                      scrub_rate_mbps=args.scrub_rate_mbps,
                      degraded_mode=args.degraded_mode,
                      device_timing=args.device_timing or None,
                      device_timing_sample=args.device_timing_sample,
                      ec_backend=backend, mesh=mesh,
                      jwt_signing_key=args.jwt_key,
                      whitelist=[w for w in args.whitelist.split(",")
                                 if w.strip()],
                      index_kind=args.index,
                      fast_port=args.fastPort).start()
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    print(f"listening {vs.url}", flush=True)
    while not done.wait(1.0):
        pass
    vs.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
