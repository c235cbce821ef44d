"""Replica placement and volume growth: pick servers that satisfy a
placement "xyz" (x other data centers, y other racks in the main data
center, z more servers in the main rack), each drawn weighted by its free
slots, then create the volume on each. The JAX package's
``topology/volume_growth.py``; every draw takes an explicit
``random.Random`` (the topology's own unless the caller passes one)."""

from __future__ import annotations

import random
from typing import Callable, List, Optional

from ..storage.types import ReplicaPlacement
from .node import DataNode


class NoFreeSlots(Exception):
    pass


def _weighted_pick(candidates, weight_fn, rng: random.Random):
    weights = [max(weight_fn(c), 0.0) for c in candidates]
    total = sum(weights)
    if total <= 0:
        return None
    x = rng.uniform(0, total)
    acc = 0.0
    for c, w in zip(candidates, weights):
        acc += w
        if x <= acc:
            return c
    return candidates[-1]


def find_empty_slots(topo, rp: ReplicaPlacement, preferred_dc: str = "",
                     rng: Optional[random.Random] = None) -> List[DataNode]:
    """``rp.copy_count`` data nodes honouring the placement, drawn with
    ``rng`` (``topo.rng`` by default). Raises NoFreeSlots when the
    topology cannot satisfy it."""
    rng = rng or topo.rng

    dcs = list(topo.data_centers.values())
    if preferred_dc:
        dcs = [dc for dc in dcs if dc.id == preferred_dc] or dcs

    def rack_feasible(dc, rack) -> bool:
        """Can ``rack`` be the main rack in ``dc``: 1 + same_rack free
        servers here, and diff_rack other racks of the data center with a
        free server each?"""
        free_nodes = [n for n in rack.all_nodes() if n.free_space() >= 1]
        if len(free_nodes) < 1 + rp.same_rack:
            return False
        other_racks = [
            r for r in dc.racks.values() if r is not rack
            and any(n.free_space() >= 1 for n in r.all_nodes())]
        return len(other_racks) >= rp.diff_rack

    def dc_ok(dc):
        others = [
            o for o in dcs if o is not dc
            and any(n.free_space() >= 1 for n in o.all_nodes())]
        if len(others) < rp.diff_data_center:
            return False
        return any(rack_feasible(dc, r) for r in dc.racks.values())

    main_dcs = [dc for dc in dcs if dc_ok(dc)]
    if not main_dcs:
        raise NoFreeSlots(f"no data center can host placement {rp}")
    main_dc = _weighted_pick(main_dcs, lambda d: d.free_space(), rng)

    main_racks = [r for r in main_dc.racks.values()
                  if rack_feasible(main_dc, r)]
    if not main_racks:
        raise NoFreeSlots(f"no rack in {main_dc.id} can host placement {rp}")
    main_rack = _weighted_pick(main_racks, lambda r: r.free_space(), rng)

    free_nodes = [n for n in main_rack.all_nodes() if n.free_space() >= 1]
    main_node = _weighted_pick(free_nodes, lambda n: n.free_space(), rng)
    chosen = [main_node]

    # z: more servers in the main rack
    pool = [n for n in free_nodes if n is not main_node]
    for _ in range(rp.same_rack):
        pick = _weighted_pick(pool, lambda n: n.free_space(), rng)
        if pick is None:
            raise NoFreeSlots("not enough servers in main rack")
        chosen.append(pick)
        pool.remove(pick)

    # y: other racks of the main data center
    rack_pool = [r for r in main_dc.racks.values()
                 if r is not main_rack and r.free_space() >= 1]
    for _ in range(rp.diff_rack):
        rack = _weighted_pick(rack_pool, lambda r: r.free_space(), rng)
        if rack is None:
            raise NoFreeSlots("not enough racks in main data center")
        node = _weighted_pick(
            [n for n in rack.all_nodes() if n.free_space() >= 1],
            lambda n: n.free_space(), rng)
        if node is None:
            raise NoFreeSlots("no free server in chosen rack")
        chosen.append(node)
        rack_pool.remove(rack)

    # x: other data centers
    dc_pool = [d for d in dcs if d is not main_dc and d.free_space() >= 1]
    for _ in range(rp.diff_data_center):
        dc = _weighted_pick(dc_pool, lambda d: d.free_space(), rng)
        if dc is None:
            raise NoFreeSlots("not enough data centers")
        node = _weighted_pick(
            [n for n in dc.all_nodes() if n.free_space() >= 1],
            lambda n: n.free_space(), rng)
        if node is None:
            raise NoFreeSlots("no free server in chosen data center")
        chosen.append(node)
        dc_pool.remove(dc)

    return chosen


class VolumeGrowth:
    """Grows a layout by creating volumes on placed nodes through
    ``allocate_fn(node, vid, collection, replication, ttl) -> bool`` (the
    volume servers' admin API, or a test's fake)."""

    def __init__(self, allocate_fn: Callable):
        self.allocate_fn = allocate_fn

    def grow_by_count(self, topo, count: int, collection: str,
                      rp: ReplicaPlacement, ttl, preferred_dc: str = ""
                      ) -> int:
        grown = 0
        for _ in range(count):
            nodes = find_empty_slots(topo, rp, preferred_dc)
            vid = topo.next_volume_id()
            ok = all(self.allocate_fn(n, vid, collection, str(rp),
                                      str(ttl)) for n in nodes)
            if ok:
                grown += 1
        return grown
