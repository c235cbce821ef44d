"""The topology tree's nodes: a volume replica's info as the master sees
it, a volume server (``DataNode``), a rack and a data center. A node's
capacity is its volume slots; an EC shard takes a tenth of one. The JAX
package's ``topology/node.py``."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..ec.constants import DATA_SHARDS
from ..ec.shard_bits import ShardBits

_VOLUME_KEYS = ("id", "collection", "size", "file_count", "delete_count",
                "deleted_byte_count", "read_only", "replica_placement",
                "ttl", "version", "compact_revision", "modified_at")


class VolumeInfo:
    """The master's view of one volume replica on one node."""

    __slots__ = _VOLUME_KEYS

    def __init__(self, id: int, collection: str = "", size: int = 0,
                 file_count: int = 0, delete_count: int = 0,
                 deleted_byte_count: int = 0, read_only: bool = False,
                 replica_placement: str = "000", ttl: int = 0,
                 version: int = 3, compact_revision: int = 0,
                 modified_at: float = 0):
        self.id = id
        self.collection = collection
        self.size = size
        self.file_count = file_count
        self.delete_count = delete_count
        self.deleted_byte_count = deleted_byte_count
        self.read_only = read_only
        self.replica_placement = replica_placement
        self.ttl = ttl
        self.version = version
        self.compact_revision = compact_revision
        self.modified_at = modified_at

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeInfo":
        return cls(**{k: d[k] for k in _VOLUME_KEYS if k in d})

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class DataNode:
    """One volume server."""

    def __init__(self, ip: str, port: int, public_url: str = "",
                 max_volume_count: int = 7):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        # a native read plane's address, where a server advertises one
        # (the port's servers have none)
        self.fast_url = ""
        self.max_volume_count = max_volume_count
        self.volumes: Dict[int, VolumeInfo] = {}
        self.ec_shards: Dict[int, ShardBits] = {}
        self.ec_shard_collections: Dict[int, str] = {}
        self.last_seen = time.time()
        self.rack: Optional["Rack"] = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def id(self) -> str:
        return self.url

    def volume_count(self) -> int:
        return len(self.volumes)

    def ec_shard_count(self) -> int:
        return sum(b.shard_id_count() for b in self.ec_shards.values())

    def free_space(self) -> float:
        """Free volume slots, an EC shard counted as a tenth."""
        return self.max_volume_count - len(self.volumes) \
            - self.ec_shard_count() / DATA_SHARDS

    def update_volumes(self, infos: List[VolumeInfo]) -> None:
        self.volumes = {vi.id: vi for vi in infos}

    def add_or_update_volume(self, vi: VolumeInfo) -> bool:
        is_new = vi.id not in self.volumes
        self.volumes[vi.id] = vi
        return is_new

    def delete_volume(self, vid: int) -> None:
        self.volumes.pop(vid, None)

    def update_ec_shards(self, shards: Dict[int, int],
                         collections: Dict[int, str]) -> None:
        self.ec_shards = {vid: ShardBits(bits)
                          for vid, bits in shards.items() if bits}
        self.ec_shard_collections = dict(collections)

    def to_dict(self) -> dict:
        rack = self.rack
        return {
            "url": self.url, "public_url": self.public_url,
            "volumes": len(self.volumes),
            "ec_shards": self.ec_shard_count(),
            "max": self.max_volume_count,
            "free": self.free_space(),
            "last_seen": self.last_seen,
            # where the node stands, for the shell's rack-aware balance
            "rack": rack.id if rack else "",
            "dataCenter": rack.data_center.id
            if rack and rack.data_center else "",
        }


class Rack:
    def __init__(self, rack_id: str):
        self.id = rack_id
        self.nodes: Dict[str, DataNode] = {}
        self.data_center: Optional["DataCenter"] = None

    def get_or_create_node(self, ip: str, port: int, public_url: str = "",
                           max_volume_count: int = 7) -> DataNode:
        key = f"{ip}:{port}"
        node = self.nodes.get(key)
        if node is None:
            node = DataNode(ip, port, public_url, max_volume_count)
            node.rack = self
            self.nodes[key] = node
        node.max_volume_count = max_volume_count
        if public_url:
            node.public_url = public_url
        return node

    def free_space(self) -> float:
        return sum(n.free_space() for n in self.nodes.values())

    def all_nodes(self) -> List[DataNode]:
        return list(self.nodes.values())


class DataCenter:
    def __init__(self, dc_id: str):
        self.id = dc_id
        self.racks: Dict[str, Rack] = {}

    def get_or_create_rack(self, rack_id: str) -> Rack:
        rack = self.racks.get(rack_id)
        if rack is None:
            rack = Rack(rack_id)
            rack.data_center = self
            self.racks[rack_id] = rack
        return rack

    def free_space(self) -> float:
        return sum(r.free_space() for r in self.racks.values())

    def all_nodes(self) -> List[DataNode]:
        return [n for r in self.racks.values() for n in r.all_nodes()]
