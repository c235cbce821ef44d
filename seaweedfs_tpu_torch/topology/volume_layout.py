"""VolumeLayout — for one (collection, replication, ttl), which volumes
are writable and where every replica lives; ``pick_for_write`` serves
``/dir/assign``. The JAX package's ``topology/volume_layout.py``, with
the pick drawn from the caller's ``random.Random`` (the JAX one draws
from the module-global ``random``, in the same order)."""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..storage.types import ReplicaPlacement
from ..util.locks import make_rlock
from .node import DataNode, VolumeInfo


class VolumeLayout:
    def __init__(self, replica_placement: ReplicaPlacement, ttl: int,
                 volume_size_limit: int):
        self.rp = replica_placement
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: Dict[int, List[DataNode]] = {}
        self.writables: List[int] = []
        self.readonly: set = set()
        self.oversized: set = set()
        self.lock = make_rlock("torch.volume_layout.lock")

    def register_volume(self, vi: VolumeInfo, node: DataNode):
        with self.lock:
            locs = self.locations.setdefault(vi.id, [])
            if node not in locs:
                locs.append(node)
            if vi.read_only:
                self.readonly.add(vi.id)
            else:
                # heartbeats carry the truth: a volume thawed on its server
                # is writable again
                self.readonly.discard(vi.id)
            if vi.size >= self.volume_size_limit:
                self.oversized.add(vi.id)
                self._set_unwritable(vi.id)
            elif len(locs) >= self.rp.copy_count and \
                    vi.id not in self.readonly:
                # writable only when every replica is there
                self._set_writable(vi.id)

    def unregister_volume(self, vid: int, node: DataNode):
        with self.lock:
            locs = self.locations.get(vid)
            if locs and node in locs:
                locs.remove(node)
            if not locs:
                self.locations.pop(vid, None)
                self._set_unwritable(vid)
            elif len(locs) < self.rp.copy_count:
                self._set_unwritable(vid)

    def _set_writable(self, vid: int):
        if vid not in self.writables:
            self.writables.append(vid)

    def _set_unwritable(self, vid: int):
        if vid in self.writables:
            self.writables.remove(vid)

    def set_volume_readonly(self, vid: int, readonly: bool = True):
        with self.lock:
            if readonly:
                self.readonly.add(vid)
                self._set_unwritable(vid)
            else:
                self.readonly.discard(vid)
                locs = self.locations.get(vid, [])
                if len(locs) >= self.rp.copy_count:
                    self._set_writable(vid)

    def set_volume_unavailable(self, vid: int, node: DataNode):
        self.unregister_volume(vid, node)

    def pick_for_write(self, rng: random.Random) -> Optional[tuple]:
        """(vid, replica nodes) of a writable volume drawn with ``rng``,
        or None."""
        with self.lock:
            if not self.writables:
                return None
            vid = rng.choice(self.writables)
            locs = self.locations.get(vid)
            if not locs:
                self._set_unwritable(vid)
                return None
            return vid, locs

    def lookup(self, vid: int) -> Optional[List[DataNode]]:
        with self.lock:
            locs = self.locations.get(vid)
            return list(locs) if locs else None

    def active_volume_count(self) -> int:
        return len(self.writables)

    def to_dict(self) -> dict:
        with self.lock:
            return {
                "replication": str(self.rp),
                "ttl": self.ttl,
                "writables": list(self.writables),
                "readonly": sorted(self.readonly),
                "volumes": {str(v): [n.url for n in locs]
                            for v, locs in self.locations.items()},
            }
