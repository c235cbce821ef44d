"""Topology — the master's cluster state: volume servers registered from
their heartbeats (full, or a delta against the state last acknowledged),
a writable-volume layout per (collection, replication, ttl), the EC shard
map, the file-key sequencer, node expiry, and the location events a watch
hub pushes to clients, and the vacuum scan. The JAX package's
``topology/topology.py``. File keys come from one of three sequencers:
``Sequencer`` (in memory, one master), ``RaftSequencer`` (blocks granted
through the masters' raft log, so that a new leader never issues a key
again) and ``EtcdSequencer`` (blocks granted by compare-and-swap on an
etcd every master shares). Every random draw (the layout's pick, a file
id's cookie, placement) comes from ``rng``, which the master seeds; the
JAX package draws the same values in the same order from the
module-global ``random``."""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ..ec.constants import TOTAL_SHARDS
from ..storage.types import TTL, ReplicaPlacement, format_file_id
from .node import DataCenter, DataNode, VolumeInfo
from .volume_layout import VolumeLayout


class Sequencer:
    """In-memory, monotonically increasing file keys."""

    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int):
        with self._lock:
            if seen >= self._counter:
                self._counter = seen + 1


class RaftSequencer(Sequencer):
    """File keys whose grants survive a master failover. Keys are granted
    in blocks: one raft round trip commits a rising "sequence ceiling"
    for ``block`` keys, and every master applies it, so a new leader
    starts above every key an earlier leader could have handed out.

    ``propose_fn`` blocks until the commit, and the raft apply calls
    ``apply_ceiling`` (on another thread, or on this one in a group of
    one), so the lock is never held across a propose. A node hands out
    keys only from grants it proposed itself (``_grant_end``): a ceiling
    applied from another master raises ``_ceiling`` but opens no window
    here. The grant's base is decided when the entry is applied, in
    commit order: a fresh leader may propose before it applied the
    former leader's last ceiling."""

    def __init__(self, propose_fn, block: int = 10000):
        super().__init__()
        self._propose = propose_fn
        self._block = int(block)
        self._ceiling = 0     # the highest committed ceiling, any master
        self._grant_end = 0   # the top of this node's own grants
        self._nonce = 0
        # nonces ride the replicated log: a prefix unique to the process
        # keeps two masters' counters from minting one nonce (a foreign
        # entry taken for a local grant would collide keys)
        self._nonce_prefix = uuid.uuid4().hex
        self._pending: set = set()  # nonces of my proposals in flight

    def next_file_id(self, count: int = 1) -> int:
        while True:
            with self._lock:
                if self._counter + count - 1 <= self._grant_end:
                    start = self._counter
                    self._counter += count
                    return start
                need = max(self._block, count)
                target = max(self._ceiling, self._grant_end,
                             self._counter - 1) + need
                self._nonce += 1
                nonce = f"{self._nonce_prefix}-{self._nonce}"
                self._pending.add(nonce)
            # outside the lock: the propose waits for the apply, which
            # takes it. NotLeaderError on a follower.
            try:
                self._propose({"type": "sequence_ceiling",
                               "value": target, "nonce": nonce})
            finally:
                with self._lock:
                    self._pending.discard(nonce)
            # the apply granted room (allocate), or a foreign ceiling
            # swallowed the whole range (propose again above it)

    def apply_ceiling(self, value: int, nonce: str = None):
        """A committed ceiling from any master. When ``nonce`` is one of
        this node's proposals in flight, (ceiling before the apply,
        value] becomes its own grant."""
        with self._lock:
            if nonce is not None and nonce in self._pending:
                base = self._ceiling
                if base < value:
                    if base > self._grant_end:
                        # past a foreign ceiling: skip the keys another
                        # leader may have issued
                        self._counter = max(self._counter, base + 1)
                    self._grant_end = max(self._grant_end, value)
            if value > self._ceiling:
                self._ceiling = value

    def ceiling(self) -> int:
        with self._lock:
            return self._ceiling


class EtcdSequencer(Sequencer):
    """File keys granted in blocks by compare-and-swap of one counter key
    on an etcd that every master shares, so no two masters mint one key
    (one etcd round trip a ``block``). Each grant's ceiling is written to
    ``<meta_dir>/sequencer.dat``, and at start etcd is raised to the
    file's value, so an etcd wiped under a surviving master cannot roll
    keys back."""

    KEY = b"/seaweedfs/master/sequence"
    DEFAULT_BLOCK = 500

    def __init__(self, addr: str, user: str = "", password: str = "",
                 meta_dir: str = "", block: int = DEFAULT_BLOCK,
                 api_prefix: str = "/v3"):
        super().__init__()
        from ..filer.etcd_store import EtcdClient
        self._client = EtcdClient.from_addr(addr, user=user,
                                            password=password,
                                            api_prefix=api_prefix)
        if user:
            self._client.authenticate()
        self._block = max(1, int(block))
        self._window_end = 0  # the exclusive top of our grant
        self._seq_file = os.path.join(meta_dir, "sequencer.dat") \
            if meta_dir else ""
        seed = 0
        if self._seq_file and os.path.exists(self._seq_file):
            try:
                with open(self._seq_file) as f:
                    seed = int(f.read().strip() or "0")
            except ValueError:
                seed = 0
        if seed:
            self._raise_etcd_to(seed)

    def _read_current(self) -> Optional[int]:
        kvs = self._client.range(self.KEY)
        if not kvs:
            return None
        try:
            return int(kvs[0][1])
        except ValueError:
            raise RuntimeError(
                f"etcd sequence key {self.KEY!r} holds non-integer "
                f"{kvs[0][1]!r}") from None

    def _raise_etcd_to(self, floor: int):
        """Swap the shared counter up to at least ``floor`` (no grant)."""
        while True:
            cur = self._read_current()
            if cur is not None and cur >= floor:
                return
            expect = None if cur is None else str(cur).encode()
            if self._client.put_if(self.KEY, expect, str(floor).encode()):
                return

    def _grant(self, need: int) -> int:
        """Swap a block of ``need`` keys; the window's exclusive base (we
        own (base, base + need])."""
        while True:
            cur = self._read_current()
            base = cur or 0
            expect = None if cur is None else str(cur).encode()
            if self._client.put_if(self.KEY, expect,
                                   str(base + need).encode()):
                if self._seq_file:
                    tmp = self._seq_file + ".tmp"
                    with open(tmp, "w") as f:
                        f.write(str(base + need))
                    os.replace(tmp, self._seq_file)
                return base

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            if self._counter + count - 1 < self._window_end:
                start = self._counter
                self._counter += count
                return start
            need = max(self._block, count)
            base = self._grant(need)
            start = max(base + 1, self._counter)
            if start + count - 1 > base + need:
                # the local counter (set_max) is above even the fresh
                # grant: raise etcd and grant again from there
                self._raise_etcd_to(start - 1)
                base = self._grant(need)
                start = max(base + 1, self._counter)
            self._counter = start + count
            self._window_end = base + need + 1
            return start

    def set_max(self, seen: int):
        with self._lock:
            if seen < self._counter:
                return
            if seen < self._window_end - 1:
                self._counter = seen + 1
                return
            self._counter = seen + 1
            self._window_end = 0  # grant again above ``seen``
        self._raise_etcd_to(seen)

    def close(self):
        self._client.close()


class Topology:
    def __init__(self, volume_size_limit: int = 30 * 1024 * 1024 * 1024,
                 pulse_seconds: float = 5, sequencer: Sequencer = None,
                 rng: Optional[random.Random] = None):
        self.data_centers: Dict[str, DataCenter] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.sequencer = sequencer or Sequencer()
        self.rng = rng or random.Random()
        self.layouts: Dict[Tuple[str, str, int], VolumeLayout] = {}
        # vid -> shard id -> [DataNode]
        self.ec_shard_map: Dict[int, List[List[DataNode]]] = {}
        self.ec_collections: Dict[int, str] = {}
        self.max_volume_id = 0
        # ("new" | "deleted", vid, url, public_url, fast_url): the master
        # wires its watch hub here to push location events
        self.location_listener = None
        self.lock = threading.RLock()

    # -- the tree ------------------------------------------------------------
    def get_or_create_dc(self, dc_id: str) -> DataCenter:
        with self.lock:
            dc = self.data_centers.get(dc_id)
            if dc is None:
                dc = DataCenter(dc_id)
                self.data_centers[dc_id] = dc
            return dc

    def all_nodes(self) -> List[DataNode]:
        return [n for dc in self.data_centers.values()
                for n in dc.all_nodes()]

    def find_node(self, url: str) -> Optional[DataNode]:
        for n in self.all_nodes():
            if n.url == url:
                return n
        return None

    # -- layouts -------------------------------------------------------------
    def get_layout(self, collection: str, replication: str,
                   ttl: int) -> VolumeLayout:
        key = (collection, replication, ttl)
        with self.lock:
            layout = self.layouts.get(key)
            if layout is None:
                layout = VolumeLayout(ReplicaPlacement.parse(replication),
                                      ttl, self.volume_size_limit)
                self.layouts[key] = layout
            return layout

    def _publish(self, etype: str, vid: int, node: DataNode):
        if self.location_listener is not None:
            self.location_listener(etype, vid, node.url, node.public_url,
                                   node.fast_url)

    # -- heartbeats ----------------------------------------------------------
    def register_heartbeat(self, dc_id: str, rack_id: str, ip: str,
                           port: int, public_url: str,
                           max_volume_count: int,
                           volumes: List[dict],
                           ec_shards: Dict[int, int] = None,
                           ec_collections: Dict[int, str] = None,
                           max_file_key: int = 0,
                           fast_url: str = "") -> DataNode:
        """A full heartbeat: the node's whole volume list replaces what
        the master held; its EC shard bits replace its part of the map."""
        with self.lock:
            dc = self.get_or_create_dc(dc_id or "DefaultDataCenter")
            rack = dc.get_or_create_rack(rack_id or "DefaultRack")
            node = rack.get_or_create_node(ip, port, public_url,
                                           max_volume_count)
            node.last_seen = time.time()
            node.fast_url = fast_url
            self.sequencer.set_max(max_file_key)

            infos = [VolumeInfo.from_dict(v) for v in volumes]
            old_vids = set(node.volumes)
            new_vids = {vi.id for vi in infos}
            node.update_volumes(infos)
            for vi in infos:
                self.max_volume_id = max(self.max_volume_id, vi.id)
                layout = self.get_layout(vi.collection, vi.replica_placement,
                                         vi.ttl)
                layout.register_volume(vi, node)
            for vid in old_vids - new_vids:
                for layout in self.layouts.values():
                    layout.unregister_volume(vid, node)
            for vid in new_vids - old_vids:
                self._publish("new", vid, node)
            for vid in old_vids - new_vids:
                self._publish("deleted", vid, node)

            if ec_shards is not None:
                node.update_ec_shards(ec_shards, ec_collections or {})
                self._sync_ec_shards(node)
            return node

    def apply_heartbeat_delta(self, url: str, new_volumes: List[dict],
                              deleted_volumes: List[int],
                              ec_shards: Dict[int, int] = None,
                              ec_collections: Dict[int, str] = None,
                              max_file_key: int = 0) -> bool:
        """A delta heartbeat: only new, changed and deleted volumes.
        False when the node is unknown: the caller then asks for a full
        resync."""
        with self.lock:
            node = self.find_node(url)
            if node is None:
                return False
            node.last_seen = time.time()
            self.sequencer.set_max(max_file_key)
            for v in new_volumes:
                vi = VolumeInfo.from_dict(v)
                was_known = vi.id in node.volumes
                node.volumes[vi.id] = vi
                self.max_volume_id = max(self.max_volume_id, vi.id)
                layout = self.get_layout(vi.collection,
                                         vi.replica_placement, vi.ttl)
                layout.register_volume(vi, node)
                if not was_known:
                    self._publish("new", vi.id, node)
            for vid in deleted_volumes:
                was_present = node.volumes.pop(vid, None) is not None
                for layout in self.layouts.values():
                    layout.unregister_volume(vid, node)
                # a delta whose answer was lost comes again: only a volume
                # the master knew announces its deletion
                if was_present:
                    self._publish("deleted", vid, node)
            if ec_shards is not None:
                node.update_ec_shards(ec_shards, ec_collections or {})
                self._sync_ec_shards(node)
            return True

    def _sync_ec_shards(self, node: DataNode):
        """Rebuild this node's part of the EC shard map."""
        for per_shard in self.ec_shard_map.values():
            for holders in per_shard:
                if node in holders:
                    holders.remove(node)
        self._drop_empty_ec_volumes()
        for vid, bits in node.ec_shards.items():
            per_shard = self.ec_shard_map.setdefault(
                vid, [[] for _ in range(TOTAL_SHARDS)])
            self.ec_collections[vid] = \
                node.ec_shard_collections.get(vid, "")
            self.max_volume_id = max(self.max_volume_id, vid)
            for sid in bits.shard_ids():
                if node not in per_shard[sid]:
                    per_shard[sid].append(node)

    def _drop_empty_ec_volumes(self):
        for vid in [v for v, per_shard in self.ec_shard_map.items()
                    if not any(per_shard)]:
            del self.ec_shard_map[vid]
            self.ec_collections.pop(vid, None)

    def unregister_node(self, node: DataNode):
        """Drop a node (gone, or silent past the timeout) with its volumes
        and shards, and announce its locations as deleted."""
        with self.lock:
            for layout in self.layouts.values():
                for vid in list(node.volumes):
                    layout.set_volume_unavailable(vid, node)
            for vid in list(node.volumes):
                self._publish("deleted", vid, node)
            for per_shard in self.ec_shard_map.values():
                for holders in per_shard:
                    if node in holders:
                        holders.remove(node)
            self._drop_empty_ec_volumes()
            if node.rack:
                node.rack.nodes.pop(node.url, None)

    def prune_dead_nodes(self, timeout: float = None) -> List[DataNode]:
        """Unregister every node not heard from in ``timeout`` seconds
        (five pulses by default)."""
        timeout = timeout or self.pulse_seconds * 5
        dead = [n for n in self.all_nodes()
                if time.time() - n.last_seen > timeout]
        for n in dead:
            self.unregister_node(n)
        return dead

    # -- assignment ----------------------------------------------------------
    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def pick_for_write(self, collection: str, replication: str,
                       ttl: TTL, count: int = 1) -> Optional[tuple]:
        """(fid, count, node, every replica node) or None."""
        layout = self.get_layout(collection, replication, ttl.to_uint32())
        picked = layout.pick_for_write(self.rng)
        if picked is None:
            return None
        vid, locs = picked
        key = self.sequencer.next_file_id(count)
        cookie = self.rng.getrandbits(32)
        return format_file_id(vid, key, cookie), count, locs[0], locs

    def lookup(self, collection: str, vid: int) -> Optional[List[DataNode]]:
        with self.lock:
            for (coll, _, _), layout in self.layouts.items():
                if collection and coll != collection:
                    continue
                locs = layout.lookup(vid)
                if locs:
                    return locs
        # an EC volume resolves through the shard map
        per_shard = self.ec_shard_map.get(vid)
        if per_shard:
            nodes = []
            for holders in per_shard:
                for n in holders:
                    if n not in nodes:
                        nodes.append(n)
            return nodes or None
        return None

    def lookup_ec_shards(self, vid: int) -> Optional[dict]:
        with self.lock:
            per_shard = self.ec_shard_map.get(vid)
            if not per_shard:
                return None
            return {sid: [n.url for n in holders]
                    for sid, holders in enumerate(per_shard) if holders}

    # -- the vacuum scan (reference topology_vacuum.go) ----------------------
    def vacuum_candidates(self, garbage_threshold: float = 0.3
                          ) -> List[Tuple[int, List[DataNode]]]:
        """(vid, every replica's node) of each writable volume whose
        deleted bytes exceed ``garbage_threshold`` of its size on some
        replica, in the order the nodes and their volumes are met."""
        out = []
        with self.lock:
            seen = set()
            for node in self.all_nodes():
                for vi in node.volumes.values():
                    if vi.id in seen or vi.read_only:
                        continue
                    if vi.size > 0 and \
                            vi.deleted_byte_count / max(vi.size, 1) \
                            > garbage_threshold:
                        layout = self.get_layout(
                            vi.collection, vi.replica_placement, vi.ttl)
                        out.append((vi.id, layout.lookup(vi.id) or [node]))
                        seen.add(vi.id)
        return out

    def to_dict(self) -> dict:
        with self.lock:
            return {
                "max_volume_id": self.max_volume_id,
                "data_centers": {
                    dc.id: {
                        rack.id: {n.url: n.to_dict()
                                  for n in rack.all_nodes()}
                        for rack in dc.racks.values()
                    } for dc in self.data_centers.values()
                },
                "layouts": [layout.to_dict()
                            for layout in self.layouts.values()],
                "ec_volumes": sorted(self.ec_shard_map),
            }
