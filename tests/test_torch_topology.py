"""The port's topology against the JAX package's (pure logic, no servers).

The same heartbeat sequences (full, delta, a delta from an unknown
server that asks for a resync, EC shard bits riding every one) go
through a port ``Topology`` and a JAX one; then ``to_dict()`` (each
node's ``last_seen`` aside: both read the clock), ``lookup``,
``lookup_ec_shards``, the EC shard map, the location events, the
sequencer and the prune must be equal. Placement (``find_empty_slots``)
runs over the cases of the JAX package's ``tests/test_topology.py`` with
one seeded ``random.Random`` on each side and must pick the same nodes;
``pick_for_write`` draws from the port topology's ``rng`` what the JAX
one draws from the module-global ``random`` (patched here to a
``random.Random`` of the same seed). ``ShardBits`` must agree bit for
bit. Tolerances: none."""

import random

import pytest

from seaweedfs_tpu.ec.shard_bits import ShardBits as RefShardBits
from seaweedfs_tpu.storage.types import ReplicaPlacement as RefRP
from seaweedfs_tpu.storage.types import TTL as RefTTL
from seaweedfs_tpu.topology import topology as ref_topology_mod
from seaweedfs_tpu.topology import volume_layout as ref_layout_mod
from seaweedfs_tpu.topology.topology import Topology as RefTopology
from seaweedfs_tpu.topology.volume_growth import \
    NoFreeSlots as RefNoFreeSlots
from seaweedfs_tpu.topology.volume_growth import \
    find_empty_slots as ref_find_empty_slots
from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.storage.types import TTL, ReplicaPlacement
from seaweedfs_tpu_torch.topology import (NoFreeSlots, Topology,
                                          find_empty_slots)

THREE_DC = {
    "dc1": {"r11": [("10.0.1.1", 8080, 10), ("10.0.1.2", 8080, 10)],
            "r12": [("10.0.1.3", 8080, 10)]},
    "dc2": {"r21": [("10.0.2.1", 8080, 10)]},
    "dc3": {"r31": [("10.0.3.1", 8080, 10), ("10.0.3.2", 8080, 10)]},
}
ONE_NODE = {"dc1": {"r1": [("10.0.0.1", 8080, 10)]}}
ONE_FULL = {"dc1": {"r1": [("10.0.0.1", 8080, 0), ("10.0.0.2", 8080, 5)]}}


def _build(cls, spec, **kw):
    topo = cls(**kw)
    for dc_id, racks in spec.items():
        for rack_id, nodes in racks.items():
            for ip, port, maxc in nodes:
                topo.register_heartbeat(dc_id, rack_id, ip, port, "", maxc,
                                        [])
    return topo


def _pair(spec=THREE_DC, **kw):
    return _build(RefTopology, spec, **kw), _build(Topology, spec, **kw)


def _vol(vid, size=100, collection="", rp="000", read_only=False, ttl=0):
    return {"id": vid, "collection": collection, "size": size,
            "file_count": 1, "delete_count": 0, "deleted_byte_count": 0,
            "read_only": read_only, "replica_placement": rp, "ttl": ttl,
            "version": 3, "compact_revision": 0, "modified_at": 0}


def _state(topo):
    """Everything a topology exposes, ``last_seen`` aside."""
    d = topo.to_dict()
    for racks in d["data_centers"].values():
        for nodes in racks.values():
            for node in nodes.values():
                node.pop("last_seen")
    urls = {n.url for n in topo.all_nodes()}
    vids = set(range(0, topo.max_volume_id + 2))
    return {
        "dict": d,
        "lookup": {(coll, vid): [n.url for n in
                                 topo.lookup(coll, vid) or []]
                   for vid in vids for coll in ("", "c", "other")},
        "ec": {vid: topo.lookup_ec_shards(vid) for vid in vids},
        "ec_map": {vid: [[n.url for n in holders] for holders in per_shard]
                   for vid, per_shard in topo.ec_shard_map.items()},
        "ec_collections": dict(topo.ec_collections),
        "free": {u: topo.find_node(u).free_space() for u in urls},
        "layouts": {k: (v.writables, sorted(v.readonly),
                        sorted(v.oversized))
                    for k, v in topo.layouts.items()},
    }


@pytest.mark.parametrize("rp,spec", [
    ("000", THREE_DC), ("001", THREE_DC), ("010", THREE_DC),
    ("100", THREE_DC), ("200", THREE_DC), ("000", ONE_FULL),
    ("011", THREE_DC), ("110", THREE_DC)])
def test_find_empty_slots_same_nodes(rp, spec):
    ref, port = _pair(spec)
    for seed in range(10):
        want = ref_find_empty_slots(ref, RefRP.parse(rp),
                                    rng=random.Random(seed))
        got = find_empty_slots(port, ReplicaPlacement.parse(rp),
                               rng=random.Random(seed))
        assert [n.url for n in got] == [n.url for n in want], (rp, seed)
    # the port's default draws come from the topology's own rng
    port.rng = random.Random(7)
    got = find_empty_slots(port, ReplicaPlacement.parse(rp))
    want = ref_find_empty_slots(ref, RefRP.parse(rp),
                                rng=random.Random(7))
    assert [n.url for n in got] == [n.url for n in want]


@pytest.mark.parametrize("rp,spec", [
    ("001", ONE_NODE), ("100", ONE_NODE), ("010", ONE_NODE),
    ("300", THREE_DC), ("002", THREE_DC)])
def test_find_empty_slots_same_refusals(rp, spec):
    ref, port = _pair(spec)
    with pytest.raises(RefNoFreeSlots) as want:
        ref_find_empty_slots(ref, RefRP.parse(rp), rng=random.Random(0))
    with pytest.raises(NoFreeSlots) as got:
        find_empty_slots(port, ReplicaPlacement.parse(rp),
                         rng=random.Random(0))
    assert str(got.value) == str(want.value)


def _heartbeats():
    """(kind, args) of a sequence both topologies take in turn."""
    full = "full"
    return [
        (full, ("dc1", "r11", "10.0.1.1", 8080, "", 10,
                [_vol(1), _vol(2, collection="c"), _vol(5, rp="001")],
                {7: 0b111}, {7: "c"}, 40)),
        (full, ("dc1", "r11", "10.0.1.2", 8080, "pub:1", 10,
                [_vol(5, rp="001"), _vol(3, read_only=True)],
                {7: 0b111000}, {7: "c"}, 12)),
        (full, ("dc2", "r21", "10.0.2.1", 8080, "", 4,
                [_vol(4, size=1 << 30)],
                {7: (1 << 14) - 1 - 0b111111, 9: 0b1}, {7: "c", 9: ""},
                0)),
        ("delta", ("10.0.1.1:8080", [_vol(1, size=5000), _vol(6)], [2],
                   {7: 0b101}, {7: "c"}, 90)),
        # a delta from a node the master does not know: resync
        ("delta", ("10.9.9.9:8080", [_vol(8)], [], {}, {}, 0)),
        ("delta", ("10.0.1.2:8080", [_vol(3)], [], {7: 0b111000},
                   {7: "c"}, 0)),
        # a resent delta of a deletion already applied
        ("delta", ("10.0.1.1:8080", [], [2], {7: 0b101}, {7: "c"}, 0)),
        (full, ("dc2", "r21", "10.0.2.1", 8080, "", 4, [_vol(4)],
                {9: 0b11}, {9: ""}, 0)),
    ]


def _apply(topo, kind, args):
    if kind == "full":
        dc, rack, ip, port, pub, maxc, vols, ec, ecc, mfk = args
        topo.register_heartbeat(dc, rack, ip, port, pub, maxc, vols,
                                ec_shards=ec, ec_collections=ecc,
                                max_file_key=mfk)
        return True
    url, new, deleted, ec, ecc, mfk = args
    return topo.apply_heartbeat_delta(url, new, deleted, ec_shards=ec,
                                      ec_collections=ecc, max_file_key=mfk)


def test_heartbeat_sequences_equal_state():
    ref, port = RefTopology(pulse_seconds=1), Topology(pulse_seconds=1)
    events = {"ref": [], "port": []}
    ref.location_listener = lambda *a: events["ref"].append(a)
    port.location_listener = lambda *a: events["port"].append(a)
    for kind, args in _heartbeats():
        assert _apply(port, kind, args) == _apply(ref, kind, args)
        assert _state(port) == _state(ref), (kind, args[:3])
        assert events["port"] == events["ref"]
    assert ref.sequencer.next_file_id(3) == port.sequencer.next_file_id(3)
    assert ref.sequencer.next_file_id() == port.sequencer.next_file_id()
    assert ref.next_volume_id() == port.next_volume_id()


def test_prune_and_unregister_equal():
    ref, port = RefTopology(pulse_seconds=1), Topology(pulse_seconds=1)
    events = {"ref": [], "port": []}
    ref.location_listener = lambda *a: events["ref"].append(a)
    port.location_listener = lambda *a: events["port"].append(a)
    for kind, args in _heartbeats()[:3]:
        _apply(ref, kind, args)
        _apply(port, kind, args)
    for topo in (ref, port):
        topo.find_node("10.0.1.2:8080").last_seen -= 6
    dead_ref = [n.url for n in ref.prune_dead_nodes()]
    dead_port = [n.url for n in port.prune_dead_nodes()]
    assert dead_port == dead_ref == ["10.0.1.2:8080"]
    assert _state(port) == _state(ref)
    assert events["port"] == events["ref"]
    for topo in (ref, port):
        topo.unregister_node(topo.find_node("10.0.2.1:8080"))
    assert _state(port) == _state(ref)
    assert events["port"] == events["ref"]
    # nothing is pruned within the timeout
    assert port.prune_dead_nodes() == [] and ref.prune_dead_nodes() == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_for_write_same_fids(seed, monkeypatch):
    rng = random.Random(seed)
    monkeypatch.setattr(ref_layout_mod, "random", rng)
    monkeypatch.setattr(ref_topology_mod, "random", rng)
    ref = RefTopology()
    port = Topology(rng=random.Random(seed))
    for kind, args in _heartbeats()[:3]:
        _apply(ref, kind, args)
        _apply(port, kind, args)
    for coll, rp, count in (("", "000", 1), ("c", "000", 3),
                            ("", "001", 1), ("", "000", 2),
                            ("nothing", "000", 1)):
        for _ in range(4):
            want = ref.pick_for_write(coll, rp, RefTTL.parse(""), count)
            got = port.pick_for_write(coll, rp, TTL.parse(""), count)
            if want is None:
                assert got is None
                continue
            assert (got[0], got[1], got[2].url, [n.url for n in got[3]]) \
                == (want[0], want[1], want[2].url,
                    [n.url for n in want[3]])


@pytest.mark.parametrize("bits", [0, 1, 0b10110, (1 << 14) - 1, 0x2A5A])
def test_shard_bits_agree(bits):
    ref, port = RefShardBits(bits), ShardBits(bits)
    assert port.shard_ids() == ref.shard_ids()
    assert port.shard_id_count() == ref.shard_id_count()
    assert port.minus_parity_shards() == ref.minus_parity_shards()
    for sid in range(14):
        assert port.has_shard_id(sid) == ref.has_shard_id(sid)
        assert port.add_shard_id(sid) == ref.add_shard_id(sid)
        assert port.remove_shard_id(sid) == ref.remove_shard_id(sid)
    for other in (0, 0b111, 0x3FFF):
        assert port.plus(ShardBits(other)) == ref.plus(RefShardBits(other))
        assert port.minus(ShardBits(other)) == \
            ref.minus(RefShardBits(other))
        assert isinstance(port.plus(ShardBits(other)), ShardBits)
