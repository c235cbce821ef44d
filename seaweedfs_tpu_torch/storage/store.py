"""Store — a volume server's volumes and EC shards across its
directories: the needle writes, reads and deletes of its plain volumes,
the EC encode (local, or streamed to the shards' holders), and the
rebuilder's routing of ``ec.rebuild -repair auto|trace|piggyback|full``.

The JAX package's ``storage/store.py`` and ``disk_location.py`` in the
parts the data and EC routes use: the directories (each a
``DiskLocation`` holding the plain ``Volume``s and the ``EcVolume``s it
finds there, with its volume slots), ``add_volume``, ``delete_volume``,
``find_volume``, ``find_ec_volume``, ``find_free_location``,
``mark_volume_readonly``, ``write_needle``, ``read_needle``,
``read_needle_flags``, ``delete_needle``, ``generate_ec_shards`` and
``generate_ec_shards_streaming`` (``ec.encode``: the readonly volume's
shards written here, or each pushed to its holder while later slabs
encode), ``mount_ec_shards`` (with its ``on_ec_mount`` callback),
``unmount_ec_shards``, ``_volume_layout``, ``rebuild_ec_shards`` (the
local rebuild from the shard files here) and
``rebuild_ec_shards_streaming`` with its trace, piggyback and full paths.
Survivors a store does not hold are pulled from their holders over HTTP
(``ec/gather``); only the KB-sized index sidecars are copied whole. Every
GF(2^8) product runs on the store's codec, ``TorchCodec`` on the card
unless the caller passes another codec or ``device="cpu"``; a holder,
which only serves and takes shards, never builds one.

The heartbeat a volume server sends its master is ``collect_heartbeat``
(every volume's info, the EC shard bits and collections, the largest
file key), and ``status`` adds the directories; ``on_change`` is called
after every volume create and delete and every EC mount and unmount
that changed something, so the server can send a delta at once.

The JAX package reads the new volumes' layout from SW_EC_LAYOUT; here it
is the ``layout`` argument ("flat" by default). The encodes and rebuilds
run in the JAX package's root spans (``ec.encode.local``,
``ec.encode.stream``, ``ec.rebuild.local``, ``ec.rebuild.stream``, the
.ecx rebuild as a ``write`` span), and each transport run is exported
to ``ec_transport_*`` (``observe_transport``). Left out: the needle-map
kinds but ``memory``.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List, Optional

from ..ec import decoder as ec_decoder
from ..ec import encoder as ec_encoder
from ..ec import gather
from ..ec import layout as ec_layout
from ..ec import spread
from ..ec.constants import (DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS,
                            SMALL_BLOCK_SIZE, TOTAL_SHARDS, to_ext)
from ..ec.ec_volume import EcVolume, ec_offset_width, rebuild_ecx_file
from ..ops import codec as ops_codec
from ..server.http_util import HttpError
from ..stats.health import BOARD
from ..stats.metrics import observe_transport
from ..util import tracing
from .needle import Needle
from .types import TTL, ReplicaPlacement, entry_size
from .volume import (NotFound, Volume, VolumeError,  # noqa: F401
                     volume_file_prefix)

_VOL_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.idx$")
_EC_SHARD_RE = re.compile(
    r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.ec(?P<shard>\d{2})$")


class DiskLocation:
    """One directory of a store: the plain volumes (a ``.idx`` with its
    ``.dat``) and the EC volumes (shard files with an ``.ecx``) it holds.
    ``max_volume_count`` is its slots, of which an EC shard takes a
    tenth."""

    def __init__(self, directory: str, max_volume_count: int = 7):
        self.directory = os.path.abspath(directory)
        self.max_volume_count = max_volume_count
        self.volumes: Dict[int, Volume] = {}
        self.ec_volumes: Dict[int, EcVolume] = {}
        self.lock = threading.RLock()
        os.makedirs(self.directory, exist_ok=True)

    def load_existing_volumes(self):
        with self.lock:
            for fname in sorted(os.listdir(self.directory)):
                m = _VOL_RE.match(fname)
                if not m:
                    continue
                vid = int(m.group("vid"))
                base = os.path.join(self.directory, fname[: -len(".idx")])
                # a tiered volume has no .dat here: its .vif names the
                # remote one
                if not os.path.exists(base + ".dat") and \
                        not os.path.exists(base + ".vif"):
                    continue
                if vid in self.volumes:
                    continue
                try:
                    self.volumes[vid] = Volume(
                        self.directory, m.group("collection") or "", vid)
                except Exception:  # noqa: BLE001 - quarantine the volume
                    continue

    def load_volume(self, vid: int) -> Optional[Volume]:
        """Mount one on-disk volume by id, whatever collection prefixes
        its files, under the location lock (so a concurrent mount cannot
        open it twice). Returns the (possibly already mounted) Volume, or
        None when no loadable files exist."""
        with self.lock:
            existing = self.volumes.get(vid)
            if existing is not None:
                return existing
            for fname in sorted(os.listdir(self.directory)):
                m = _VOL_RE.match(fname)
                if not m or int(m.group("vid")) != vid:
                    continue
                base = os.path.join(self.directory, fname[: -len(".idx")])
                if not os.path.exists(base + ".dat") and \
                        not os.path.exists(base + ".vif"):
                    continue  # orphaned .idx: the boot scan's quarantine
                v = Volume(self.directory, m.group("collection") or "", vid)
                self.volumes[vid] = v
                return v
            return None

    def get_volume(self, vid: int) -> Optional[Volume]:
        return self.volumes.get(vid)

    def add_volume(self, collection: str, vid: int, **kwargs) -> Volume:
        """Create a volume here (or return the one already mounted)."""
        with self.lock:
            if vid in self.volumes:
                return self.volumes[vid]
            v = Volume(self.directory, collection, vid, create=True,
                       **kwargs)
            self.volumes[vid] = v
            return v

    def delete_volume(self, vid: int) -> bool:
        """Unmount and remove a volume's files; False if not here."""
        with self.lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.destroy()
            return True

    def unload_volume(self, vid: int) -> bool:
        """Stop serving a volume, keeping its files."""
        with self.lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.close()
            return True

    def load_all_ec_shards(self):
        shard_sets: Dict[int, tuple] = {}
        for fname in sorted(os.listdir(self.directory)):
            m = _EC_SHARD_RE.match(fname)
            if not m:
                continue
            shard_sets.setdefault(
                int(m.group("vid")), (m.group("collection") or "", []))[1] \
                .append(int(m.group("shard")))
        for vid, (collection, shards) in shard_sets.items():
            base = volume_file_prefix(self.directory, collection, vid)
            if not os.path.exists(base + ".ecx"):
                continue
            ev = EcVolume(self.directory, collection, vid)
            for sid in sorted(shards):
                ev.add_shard(sid)
            self.ec_volumes[vid] = ev

    def close(self):
        with self.lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
            self.volumes.clear()
            self.ec_volumes.clear()


class Store:
    """``directories`` -> ``locations``, each loaded with its volumes and
    EC shards. ``codec`` defaults to RS(10,4) on ``device`` (the card),
    built on first use; ``routing`` turns health routing on for the
    remote readers, the full rebuild's survivor choice and the spread's
    spare choice (the JAX package's SW_EC_HEALTH_ROUTING, off by
    default); ``layout`` is the parity layout of new EC volumes, "flat"
    or "piggyback" (the JAX SW_EC_LAYOUT, flat by default);
    ``max_volume_counts`` the slots of each directory (7 each).
    ``ip``, ``port`` and ``public_url``, this server's address in a
    heartbeat and a shard assignment, are set by the server that owns the
    store, and so are ``on_ec_mount(vid, shard_ids)``, called after a
    mount registers shards (the degraded reads drop their reconstructions
    of them), and ``on_change()``."""

    def __init__(self, directories, codec=None, device="cuda",
                 routing: bool = False, layout: str = "flat",
                 max_volume_counts=None):
        if isinstance(directories, str):
            directories = [directories]
        max_volume_counts = max_volume_counts or [7] * len(directories)
        self.locations = [DiskLocation(d, n)
                          for d, n in zip(directories, max_volume_counts)]
        self._codec = codec
        self.device = device
        self.routing = bool(routing)
        self.layout = layout
        self.ip = "127.0.0.1"
        self.port = 0
        self.public_url = ""
        self.on_ec_mount = None
        self.on_change = None
        for loc in self.locations:
            loc.load_existing_volumes()
            loc.load_all_ec_shards()

    @property
    def codec(self):
        if self._codec is None:
            self._codec = ops_codec.get_codec(DATA_SHARDS,
                                              TOTAL_SHARDS - DATA_SHARDS,
                                              device=self.device)
        return self._codec

    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.get_volume(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def find_free_location(self) -> Optional[DiskLocation]:
        """The location with the most free slots (at least one); EC
        shards count as 1/10 of a volume."""
        best, best_free = None, 0.0
        for loc in self.locations:
            ec_shards = sum(len(ev.shards) for ev in loc.ec_volumes.values())
            free = loc.max_volume_count - len(loc.volumes) - ec_shards / 10.0
            if free >= 1 and free > best_free:
                best, best_free = loc, free
        return best

    # -- volumes and needles -----------------------------------------------
    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "000", ttl: str = "") -> Volume:
        """Create volume ``vid`` in the freest location, with the replica
        placement and TTL in its superblock; an existing one is returned
        as it is."""
        v = self.find_volume(vid)
        if v is not None:
            return v
        loc = self.find_free_location()
        if loc is None:
            raise VolumeError("no free volume slots")
        v = loc.add_volume(
            collection, vid,
            replica_placement=ReplicaPlacement.parse(replication),
            ttl=TTL.parse(ttl))
        self._changed()
        return v

    def delete_volume(self, vid: int) -> bool:
        for loc in self.locations:
            if loc.delete_volume(vid):
                self._changed()
                return True
        return False

    def _changed(self):
        cb = self.on_change
        if cb is not None:
            cb()

    def _volume(self, vid: int) -> Volume:
        v = self.find_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        return v

    def write_needle(self, vid: int, n: Needle) -> int:
        return self._volume(vid).write_needle(n)

    def read_needle(self, vid: int, n: Needle) -> Needle:
        return self._volume(vid).read_needle(n)

    def read_needle_flags(self, vid: int, n: Needle) -> int:
        return self._volume(vid).read_needle_flags(n)

    def delete_needle(self, vid: int, n: Needle) -> int:
        return self._volume(vid).delete_needle(n)

    def mark_volume_readonly(self, vid: int,
                             readonly: bool = True) -> Optional[bool]:
        """Set the flag; returns the PREVIOUS readonly state, or None when
        the volume is absent, so an orchestrator can restore exactly the
        prior state on failure."""
        v = self.find_volume(vid)
        if v is None:
            return None
        was, v.readonly = v.readonly, readonly
        return was

    # -- the heartbeat -------------------------------------------------------
    def collect_heartbeat(self) -> dict:
        """What the master is told: this server's address and place,
        its slots, the largest file key, every volume's info and, per EC
        volume, the bits of the shards mounted here and the
        collection."""
        volumes = []
        ec_shards: Dict[int, int] = {}
        ec_collections: Dict[int, str] = {}
        max_file_key = 0
        max_volume_count = 0
        for loc in self.locations:
            max_volume_count += loc.max_volume_count
            for vid, v in list(loc.volumes.items()):
                max_file_key = max(max_file_key, v.max_file_key())
                volumes.append({
                    "id": vid,
                    "collection": v.collection,
                    "size": v.size(),
                    "file_count": v.file_count(),
                    "delete_count": v.deleted_count(),
                    "deleted_byte_count": v.deleted_size(),
                    "read_only": v.readonly,
                    "replica_placement":
                        str(v.super_block.replica_placement),
                    "ttl": v.super_block.ttl.to_uint32(),
                    "version": v.version,
                    "compact_revision": v.super_block.compaction_revision,
                    "modified_at": v.last_modified,
                })
            for vid, ev in loc.ec_volumes.items():
                bits = 0
                for sid in ev.shard_ids():
                    bits |= 1 << sid
                ec_shards[vid] = bits
                ec_collections[vid] = ev.collection
        return {
            "ip": self.ip, "port": self.port, "public_url": self.public_url,
            # the default data center and rack
            "data_center": "", "rack": "",
            "max_volume_count": max_volume_count,
            "max_file_key": max_file_key,
            "volumes": volumes,
            "ec_shards": ec_shards,
            "ec_collections": ec_collections,
        }

    def status(self) -> dict:
        hb = self.collect_heartbeat()
        hb["directories"] = [loc.directory for loc in self.locations]
        return hb

    def close(self):
        for loc in self.locations:
            loc.close()

    # -- EC encode ---------------------------------------------------------
    def _encode_layout(self):
        """(layout name, plan, window) for NEW ec volumes, from
        ``self.layout``. An unsupported geometry (m < 2) raises rather
        than silently downgrading an explicit piggyback choice."""
        name = (self.layout or ec_layout.LAYOUT_FLAT).lower()
        if name == ec_layout.LAYOUT_FLAT:
            return ec_layout.LAYOUT_FLAT, None, None
        if name != ec_layout.LAYOUT_PIGGYBACK:
            raise VolumeError(f"unknown EC layout {name!r}")
        k = self._codec.k if self._codec is not None else DATA_SHARDS
        m = self._codec.m if self._codec is not None else PARITY_SHARDS
        if not ops_codec.piggyback_supported(k, m):
            raise VolumeError(
                f"EC layout piggyback unsupported for RS({k},{m})")
        pplan, window = ec_encoder.piggyback_geometry(
            self.codec, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)
        return ec_layout.LAYOUT_PIGGYBACK, pplan, window

    def _write_layout_sidecars(self, base, v, layout, pplan, window):
        """Record the volume metadata AND layout in one .vif/.ecx-tag
        write (ec/layout). offset_width rides along: a holder of only
        parity shards has no .ec00 superblock to infer the .ecx record
        width from."""
        ec_layout.write_layout_sidecars(
            base, layout, window=window,
            pairs=(pplan.npairs if pplan is not None else None),
            record_size=entry_size(v.offset_width),
            version=v.version, offset_width=v.offset_width)

    def _readonly_volume(self, vid: int) -> Volume:
        v = self.find_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        if not v.readonly:
            raise VolumeError(f"volume {vid} must be readonly for ec encode")
        return v

    def generate_ec_shards(self, vid: int, collection: str = "") -> str:
        """Volume .dat/.idx -> .ec00-13 + .ecx + .vif on the same disk,
        in ``self.layout``; the choice is stamped into the sidecars, so
        every later reader routes by the volume."""
        v = self._readonly_volume(vid)
        base = v.file_name()
        layout, pplan, window = self._encode_layout()
        with tracing.span("ec.encode.local", volume=vid, layout=layout):
            ec_encoder.write_sorted_file_from_idx(base)
            ec_encoder.write_ec_files(base, codec=self.codec,
                                      layout=layout)
        self._write_layout_sidecars(base, v, layout, pplan, window)
        return base

    def generate_ec_shards_streaming(self, vid: int, collection: str = "",
                                     assignment: Dict[int, str] = None,
                                     spares: List[str] = None,
                                     window: Optional[int] = None,
                                     stats: dict = None,
                                     rate_mbps: float = 0.0):
        """Streaming encode+spread: encode the readonly volume and push
        each shard's slab ranges to its assigned holder while later slabs
        are still encoding (ec/spread.py). ``assignment`` maps shard id
        -> holder url; shards assigned to this server (``public_url``) or
        unassigned are written locally. Returns ``(base, final)``, where
        ``final`` is the placement after failover ({sid: url, '' for
        local}). On ANY failure every holder's ``.part`` stage is aborted
        and the local shards, stages and .ecx removed: no partial shard
        survives. ``rate_mbps`` > 0 paces the producer."""
        v = self._readonly_volume(vid)
        base = v.file_name()
        assignment = {int(s): u for s, u in (assignment or {}).items()}
        total = self.codec.total
        # the streaming gather's slab policy: a near-slab-sized shard
        # still gives the spread several stripes to overlap with the
        # encode (the slab only batches device columns; shard bytes do
        # not depend on it)
        slab = gather.auto_slab(ec_encoder.ec_shard_base_size(
            os.path.getsize(base + ".dat")))
        layout, pplan, pb_window = self._encode_layout()
        sstats = spread.SpreadStats()
        with tracing.span("ec.encode.stream", volume=vid,
                          layout=layout) as root:
            ec_encoder.write_sorted_file_from_idx(base)
            sink = spread.StripedSpreadSink(
                vid, base, assignment, total, collection=collection,
                local_url=self.public_url, spares=spares, window=window,
                stats=sstats, rate_mbps=rate_mbps, routing=self.routing,
                parent_span=root)
            try:
                ec_encoder.write_ec_files_spread(
                    base, sink, codec=self.codec, slab=slab, stats=stats,
                    layout=layout)
            except BaseException:
                # the sink already aborted every holder's stage; drop
                # what the local fast path finalized, and the index
                for i in range(total):
                    for p in (base + to_ext(i),
                              base + to_ext(i) + ".part"):
                        try:
                            os.remove(p)
                        except OSError:
                            pass
                try:
                    os.remove(base + ".ecx")
                except OSError:
                    pass
                raise
            self._write_layout_sidecars(base, v, layout, pplan, pb_window)
        observe_transport("push", sstats, window=sink.window)
        return base, sink.assignment()

    def mount_ec_shards(self, vid: int, collection: str,
                        shard_ids: List[int]) -> List[int]:
        """Register the shard files of ``shard_ids`` found beside an .ecx
        in the first location that has one; returns the ids newly
        mounted."""
        mounted = []
        for loc in self.locations:
            base = volume_file_prefix(loc.directory, collection, vid)
            if not os.path.exists(base + ".ecx"):
                continue
            ev = loc.ec_volumes.get(vid)
            created = ev is None
            if created:
                ev = EcVolume(loc.directory, collection, vid)
            for sid in shard_ids:
                if os.path.exists(base + to_ext(sid)) and ev.add_shard(sid):
                    mounted.append(sid)
            if created:
                # never leave a shard-less EcVolume registered
                if ev.shards:
                    loc.ec_volumes[vid] = ev
                else:
                    ev.close()
            break
        if mounted:
            if self.on_ec_mount is not None:
                self.on_ec_mount(vid, mounted)
            self._changed()
        return mounted

    def unmount_ec_shards(self, vid: int, shard_ids: List[int]) -> List[int]:
        """Stop serving shards (their files stay); an EcVolume left with
        no shard is unregistered. Returns the ids unmounted."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            return []
        out = []
        for sid in shard_ids:
            shard = ev.delete_shard(sid)
            if shard is not None:
                shard.close()
                out.append(sid)
        if not ev.shards:
            for loc in self.locations:
                if loc.ec_volumes.get(vid) is ev:
                    loc.ec_volumes.pop(vid)
            ev.close()
        if out:
            self._changed()
        return out

    def rebuild_ec_shards(self, vid: int, collection: str = "",
                          stats: dict = None) -> List[int]:
        """Rebuild the shard files missing beside this store's .ecx from
        the survivors here (``ec/encoder.rebuild_ec_files``, on the
        store's codec), then the .ecx's tombstones from the .ecj. The
        rebuilt shards are not mounted. ``stats`` receives the rebuild's
        dispatch counters."""
        for loc in self.locations:
            base = volume_file_prefix(loc.directory, collection, vid)
            if not os.path.exists(base + ".ecx"):
                continue
            li = self._volume_layout(base)
            with tracing.span("ec.rebuild.local", volume=vid,
                              layout=li.layout):
                rebuilt = ec_encoder.rebuild_ec_files(
                    base, codec=self.codec, stats=stats,
                    layout=(li if li.piggyback else None))
                t0 = time.perf_counter()
                rebuild_ecx_file(base, ec_offset_width(base))
                ecx_s = time.perf_counter() - t0
                tracing.record_span("write", ecx_s, op="ec.rebuild.ecx")
            if stats is not None and "phases" in stats:
                stats["phases"]["write"] = round(
                    stats["phases"].get("write", 0.0) + ecx_s, 6)
            return rebuilt
        raise VolumeError(f"ec volume {vid} not found")

    def _volume_layout(self, base):
        """Resolve an existing volume's on-disk layout from its sidecars
        (ec/layout.volume_layout): the routing predicate of every
        layout-sensitive path below."""
        try:
            width = ec_offset_width(base)
        except Exception:  # noqa: BLE001 - no sidecars at all: flat
            width = 4
        return ec_layout.volume_layout(base, self.codec.k,
                                       record_size=entry_size(width))

    def rebuild_ec_shards_streaming(self, vid: int, collection: str = "",
                                    sources: Dict[int, List[str]] = None,
                                    stats: dict = None,
                                    slab: Optional[int] = None,
                                    window: Optional[int] = None,
                                    hedge_ms: Optional[float] = None,
                                    repair: str = "auto") -> List[int]:
        """Rebuild missing shards by streaming slab ranges of remote
        survivors straight into the decode: no whole-shard copy lands on
        this store's disks. ``sources`` maps shard id -> holder urls for
        survivors NOT local to this store; shards already here are read
        from disk. Only the index sidecars (.ecx/.vif/.ecj) are copied.

        ``repair`` picks the single-shard repair: ``trace`` gathers each
        survivor's projected symbols over ``/admin/ec/shard_repair_read``
        (ops/codec.repair_plan), ``piggyback`` half-plane sub-chunks over
        ``/admin/ec/shard_plane_read`` ((k+1)/2k of k·shard, piggyback
        volumes only), ``full`` is the full streaming decode, and
        ``auto`` routes by the volume's layout and falls back to the
        layout's full decode, bit-identically, for multi-shard loss,
        no-gain geometries, uncoupled shards, or holders without the
        repair routes (404, 405, 501). Forcing ``trace`` on a piggyback
        volume, or ``piggyback`` on a flat one, is an error."""
        sources = {int(s): list(urls) for s, urls in
                   (sources or {}).items() if urls}
        holders: List[str] = []
        for urls in sources.values():
            for u in urls:
                if u not in holders:
                    holders.append(u)
        # prefer a location that already has volume files; the rebuilt
        # shards and index live there
        loc = None
        for cand in self.locations:
            base = volume_file_prefix(cand.directory, collection, vid)
            if os.path.exists(base + ".ecx") or any(
                    os.path.exists(base + to_ext(i))
                    for i in range(TOTAL_SHARDS)):
                loc = cand
                break
        if loc is None:
            loc = self.locations[0]
        base = volume_file_prefix(loc.directory, collection, vid)
        with tracing.span("ec.rebuild.stream", volume=vid) as root:
            return self._rebuild_streaming(
                vid, base, sources, holders, stats, slab, window,
                hedge_ms, repair, root)

    def _rebuild_streaming(self, vid, base, sources, holders, stats, slab,
                           window, hedge_ms, repair, root) -> List[int]:
        """The body of ``rebuild_ec_shards_streaming``, under its
        ``ec.rebuild.stream`` span ``root``."""
        k, total = self.codec.k, self.codec.total
        if holders:
            gather.fetch_index_files(base, holders)
        local = [os.path.exists(base + to_ext(i)) for i in range(total)]
        present = [local[i] or i in sources for i in range(total)]
        missing = [i for i, p in enumerate(present) if not p]
        if not missing:
            return []
        if sum(present) < k:
            raise VolumeError(
                f"cannot rebuild {vid}: only {sum(present)} of "
                f"{total} shards reachable")
        mode = (repair or "auto").lower()
        if mode not in ("auto", "trace", "piggyback", "full"):
            raise VolumeError(f"unknown repair mode {mode!r}")
        # the sidecars are local now: the volume's layout routes below
        li = self._volume_layout(base)
        if mode == "trace" and li.piggyback:
            raise VolumeError(
                "-repair trace: volume has the piggyback layout "
                "(trace masks read flat parity bytes); use "
                "piggyback, auto or full")
        if mode == "piggyback" and not li.piggyback:
            raise VolumeError(
                "-repair piggyback: volume has the flat layout "
                "(no coupled parity planes); use trace, auto or "
                "full")
        # one wire probe per (vid, sid) for this whole rebuild
        size_cache = gather.ShardSizeCache()

        def sized(candidates) -> int:
            sz = None
            for i in candidates:
                if local[i]:
                    s = os.path.getsize(base + to_ext(i))
                    if sz is None:
                        sz = s
                    elif sz != s:
                        raise VolumeError("surviving shards differ in size")
            if sz is not None:
                return sz
            last = None
            for i in candidates:
                if i in sources:
                    try:
                        return size_cache.get(vid, i, sources[i])
                    except Exception as e:  # noqa: BLE001 - next holder
                        last = e
            raise last if last is not None else VolumeError(
                f"cannot size shards of volume {vid}")

        def readers_of(src, gstats):
            return [gather.LocalShardReader(base + to_ext(i), gstats)
                    if local[i] else gather.RemoteShardReader(
                        vid, i, sources[i], gstats, hedge_ms=hedge_ms,
                        routing=self.routing)
                    for i in src]

        ctx = (vid, base, local, present, missing, sources, sized, stats,
               slab, window, hedge_ms, mode, root)
        rebuilt = None
        if mode != "full":
            if li.piggyback:
                rebuilt = self._rebuild_streaming_piggyback(*ctx, li)
            else:
                rebuilt = self._rebuild_streaming_trace(*ctx)
        if rebuilt is None and li.piggyback:
            # full coupled decode: the readers follow the decode plan's
            # src order, and stripes clamp to sub-chunk windows
            src, _, _ = ops_codec.piggyback_decode_plan(
                k, self.codec.m, tuple(bool(p) for p in present),
                matrix_kind=self.codec.matrix_kind,
                matrix=self.codec.matrix, pairs=li.pairs)
            gstats = gather.GatherStats()
            shard_size = sized(src)
            eff_slab = slab or gather.auto_slab(
                shard_size, default=ec_encoder.DEFAULT_SLAB)
            eff_slab = max(li.window, eff_slab - eff_slab % li.window)
            source = gather.StripedGatherSource(
                readers_of(src, gstats), shard_size, slab=eff_slab,
                window=window, stats=gstats, parent_span=root)
            rebuilt = ec_encoder.rebuild_ec_files_streaming_piggyback(
                base, present, missing, source, li, codec=self.codec,
                stats=stats)
            observe_transport("pull", gstats, window=source.window)
            if stats is not None:
                stats["repair_mode"] = "full"
        elif rebuilt is None:
            gather_present = self._health_survivor_mask(
                present, local, sources, k, stats, self.routing)
            src = [i for i, p in enumerate(gather_present) if p][:k]
            gstats = gather.GatherStats()
            shard_size = sized(src)
            eff_slab = slab or gather.auto_slab(
                shard_size, default=ec_encoder.DEFAULT_SLAB)
            source = gather.StripedGatherSource(
                readers_of(src, gstats), shard_size, slab=eff_slab,
                window=window, stats=gstats, parent_span=root)
            rebuilt = ec_encoder.rebuild_ec_files_streaming(
                base, gather_present, missing, source, codec=self.codec,
                slab=eff_slab, stats=stats)
            observe_transport("pull", gstats, window=source.window)
            if stats is not None:
                stats["repair_mode"] = "full"
        t0 = time.perf_counter()
        rebuild_ecx_file(base, ec_offset_width(base))
        ecx_s = time.perf_counter() - t0
        tracing.record_span("write", ecx_s, op="ec.rebuild.ecx")
        if stats is not None and "phases" in stats:
            stats["phases"]["write"] = round(
                stats["phases"].get("write", 0.0) + ecx_s, 6)
        return rebuilt

    @staticmethod
    def _health_survivor_mask(present, local, sources, k, stats,
                              routing: bool = False):
        """Health-aware survivor choice for the full streaming gather:
        with routing on and more than k survivors reachable, the surplus
        is dropped worst-holder-first (a local shard scores 1.0), so a
        slow or failing holder leaves the gather when healthier
        survivors cover the k. Any k survivors decode exactly, so the
        rebuilt bytes do not change. Ties drop the highest shard ids,
        the un-routed first-k choice."""
        survivors = [i for i, p in enumerate(present) if p]
        surplus = len(survivors) - k
        if surplus <= 0 or not routing:
            return present

        def shard_score(i):
            if local[i] or not sources.get(i):
                return 1.0
            return max(BOARD.score(u) for u in sources[i])

        masked = list(present)
        drop_order = sorted(survivors, key=lambda i: (shard_score(i), -i))
        demoted = sorted(drop_order[:surplus])
        for i in demoted:
            masked[i] = False
        if stats is not None:
            stats["health_demoted_shards"] = demoted
        return masked

    def _rebuild_streaming_piggyback(self, vid, base, local, present,
                                     missing, sources, sized, stats, slab,
                                     window, hedge_ms, mode, root, li):
        """Attempt the half-plane piggyback repair; returns the rebuilt
        shard list, or None for "use the full coupled decode". A forced
        ``piggyback`` turns every fallback into an error; ``auto``
        records the reason in stats and falls through."""

        def bail(reason: str):
            if mode == "piggyback":
                raise VolumeError(f"-repair piggyback: {reason}")
            if stats is not None:
                stats["repair_fallback"] = reason
            return None

        if len(missing) != 1:
            return bail(f"{len(missing)} shards lost, piggyback repairs one")
        lost = missing[0]
        codec = self.codec
        k, m = codec.k, codec.m
        try:
            pplan = ops_codec.piggyback_plan(
                k, m, matrix_kind=codec.matrix_kind, matrix=codec.matrix,
                pairs=li.pairs)
        except ValueError as e:
            return bail(f"no piggyback scheme: {e}")
        if lost >= pplan.coupled:
            return bail(f"shard {lost} not coupled "
                        f"(coupled prefix is 0..{pplan.coupled - 1})")
        par = [k + j for j in range(m) if present[k + j]]
        if len(par) < 2:
            return bail(f"{len(par)} surviving parities, plane repair "
                        f"needs 2")
        if any(not present[i] for i in range(k) if i != lost):
            return bail("a data helper is unreachable")
        try:
            rplan = ops_codec.piggyback_repair_plan(
                k, m, lost, parity_sids=tuple(par[:2]),
                matrix_kind=pplan.matrix_kind, matrix=codec.matrix,
                pairs=li.pairs)
        except ValueError as e:
            return bail(f"no repair plan: {e}")
        shard_size = sized(rplan.helpers)
        if shard_size % li.window:
            return bail(f"shard size {shard_size} not aligned to sidecar "
                        f"window {li.window}")
        gstats = gather.GatherStats()
        readers = [
            gather.LocalPlaneReader(base + to_ext(i), li.alpha, li.window,
                                    rplan.plane_bit, rplan.plane_side,
                                    gstats)
            if local[i] else gather.RemotePlaneReader(
                vid, i, sources[i], li.alpha, li.window, rplan.plane_bit,
                rplan.plane_side, gstats, hedge_ms=hedge_ms,
                routing=self.routing)
            for i in rplan.helpers]
        eff_slab = slab or gather.auto_slab(
            shard_size, default=ec_encoder.DEFAULT_SLAB)
        source = gather.PlaneGatherSource(
            readers, shard_size, rplan, li.window, slab=eff_slab,
            gather_window=window, stats=gstats, parent_span=root)
        rstats: dict = {}
        try:
            rebuilt = ec_decoder.rebuild_ec_file_piggyback(
                base, lost, source, rplan, li.window, codec=codec,
                slab=source.slab, stats=rstats)
        except HttpError as e:
            if e.status in (404, 405, 501):
                # a holder predates /admin/ec/shard_plane_read (or never
                # had the shard): the repair output is already removed,
                # rerun as the full coupled decode
                return bail(f"holder refused plane read ({e.status})")
            raise
        observe_transport("pull", gstats, window=source.window)
        if stats is not None:
            stats.update(rstats)
        return rebuilt

    def _rebuild_streaming_trace(self, vid, base, local, present, missing,
                                 sources, sized, stats, slab, window,
                                 hedge_ms, mode, root):
        """Attempt trace repair; returns the rebuilt shard list, or None
        for "use the full streaming gather". A forced ``trace`` turns
        every fallback into an error; ``auto`` records the reason in
        stats and falls through."""

        def bail(reason: str):
            if mode == "trace":
                raise VolumeError(f"-repair trace: {reason}")
            if stats is not None:
                stats["repair_fallback"] = reason
            return None

        if len(missing) != 1:
            return bail(f"{len(missing)} shards lost, trace repairs one")
        lost = missing[0]
        codec = self.codec
        helpers = [i for i, p in enumerate(present) if p and i != lost]
        try:
            plan = ops_codec.repair_plan(
                codec.k, codec.m, lost, survivors=helpers,
                matrix_kind=codec.matrix_kind, matrix=codec.matrix)
        except ValueError as e:
            return bail(f"no repair scheme: {e}")
        if mode == "auto" and plan.frac >= 1.0:
            return bail(f"no trace gain (frac={plan.frac:.3f})")
        shard_size = sized(plan.helpers)
        gstats = gather.GatherStats()
        readers = [
            gather.LocalRepairReader(base + to_ext(i), plan.masks[i],
                                     gstats)
            if local[i] else gather.RemoteRepairReader(
                vid, i, sources[i], plan.masks[i], gstats,
                hedge_ms=hedge_ms, routing=self.routing)
            for i in plan.helpers]
        eff_slab = slab or gather.auto_slab(
            shard_size, default=ec_encoder.DEFAULT_SLAB)
        source = gather.RepairGatherSource(
            readers, shard_size, plan, slab=eff_slab, window=window,
            stats=gstats, parent_span=root)
        rstats: dict = {}
        try:
            rebuilt = ec_decoder.rebuild_ec_file_repair(
                base, lost, source, plan, codec=codec, slab=eff_slab,
                stats=rstats)
        except HttpError as e:
            if e.status in (404, 405, 501):
                # a holder predates /admin/ec/shard_repair_read (or never
                # had the shard): the repair output is already removed,
                # rerun as the plain streaming gather
                return bail(f"holder refused repair read ({e.status})")
            raise
        observe_transport("pull", gstats, window=source.window)
        if stats is not None:
            stats.update(rstats)
        return rebuilt
