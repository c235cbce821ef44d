"""The port's master against the JAX package's, route by route.

A port ``MasterServer`` and a JAX one take the same heartbeat POSTs for
the same volume servers: stubs on 127.0.0.1 that answer
``/admin/assign_volume`` and record what each master asked them to
create. Every ported route's JSON must be equal between the two masters,
once the master's own address and each server's ``last_seen`` (both
read the clock) are taken out: the heartbeat answers (full, delta, and
the resync a delta from an unknown server gets), ``/dir/assign`` with
its volume growth (the stubs must be asked for the same volumes),
``/vol/grow``, ``/dir/lookup``, ``/cluster/watch`` snapshots and
deltas, ``/cluster/ec_lookup``, ``/cluster/ec_status``,
``/cluster/volumes``, ``/dir/status``, ``/vol/status``,
``/cluster/status``, the goodbye, a prune, and the ``GET /<fid>``
redirect. The JAX master draws from the module-global ``random`` and
places volumes with an unseeded ``random.Random``; here both draw from a
``random.Random`` of each of the test's seeds (patched in on the JAX side), so
file ids, growth and redirects are equal. Tolerances: none."""

import http.client
import json
import random

import pytest

from seaweedfs_tpu_torch.server.http_util import HttpServer, Router
from seaweedfs_tpu_torch.server.master import MasterServer

SEEDS = (11, 23, 37)
BIG = 3600.0      # a pulse long enough that nothing is pruned on its own


def seed_jax(monkeypatch, seed):
    """Route the JAX master's draws through one seeded random.Random, in
    the order the port's master draws from its own."""
    import seaweedfs_tpu.server.master as ref_master
    from seaweedfs_tpu.topology import topology as ref_topology
    from seaweedfs_tpu.topology import volume_layout as ref_layout
    rng = random.Random(seed)
    monkeypatch.setattr(ref_layout, "random", rng)
    monkeypatch.setattr(ref_topology, "random", rng)
    monkeypatch.setattr(random, "choice", rng.choice)
    place = ref_master.find_empty_slots
    monkeypatch.setattr(ref_master, "find_empty_slots",
                        lambda topo, rp, dc="", rng_=None:
                        place(topo, rp, dc, rng=rng))
    return rng


class Stub:
    """A volume server that only records the volumes a master asks it
    to create."""

    def __init__(self):
        self.calls = []
        router = Router()
        router.add("POST", "/admin/assign_volume", self._assign)
        self.server = HttpServer(0, router).start()
        self.port = self.server.port

    def _assign(self, req):
        self.calls.append(dict(req.query))
        return {"volume": int(req.query["volume"])}


def _call(url, method, path, body=None):
    host, p = url.split(":")
    conn = http.client.HTTPConnection(host, int(p), timeout=30)
    try:
        headers = {"Content-Type": "application/json"} if body else {}
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        loc = resp.getheader("Location")
    finally:
        conn.close()
    out = json.loads(data) if data else None
    return resp.status, out, loc


def _strip(obj, master_url):
    """The JSON with the master's own address and every ``last_seen``
    taken out."""
    if isinstance(obj, dict):
        return {k: _strip(v, master_url) for k, v in obj.items()
                if k != "last_seen"}
    if isinstance(obj, list):
        return [_strip(v, master_url) for v in obj]
    if isinstance(obj, str):
        return obj.replace(master_url, "MASTER")
    return obj


class Both:
    def __init__(self, ref, port, stubs):
        self.ref, self.port, self.stubs = ref, port, stubs

    def __call__(self, method, path, body=None, want=None):
        """The same request to both masters: JSON, status, the redirect's
        Location, and what each asked the stubs, all equal."""
        out = []
        for m in (self.ref, self.port):
            for s in self.stubs:
                s.calls.clear()
            status, data, loc = _call(m.url, method, path, body)
            out.append((status, _strip(data, m.url), loc,
                        [list(s.calls) for s in self.stubs]))
        assert out[1] == out[0], (method, path)
        if want is not None:
            assert out[1][0] == want, (method, path, out[1])
        return out[1]


def _hb(stub, vols=(), ec=None, ecc=None, rack="", dc="", maxc=10,
        mfk=0, delta=None):
    body = {"ip": "127.0.0.1", "port": stub.port, "public_url": "",
            "data_center": dc, "rack": rack, "max_volume_count": maxc,
            "max_file_key": mfk, "ec_shards": ec or {},
            "ec_collections": ecc or {}}
    if delta is None:
        body["volumes"] = list(vols)
    else:
        body.update(delta=True, new_volumes=list(vols),
                    deleted_volumes=list(delta))
    return body


def _vol(vid, collection="", rp="000", size=100, read_only=False):
    return {"id": vid, "collection": collection, "size": size,
            "file_count": 2, "delete_count": 0, "deleted_byte_count": 0,
            "read_only": read_only, "replica_placement": rp, "ttl": 0,
            "version": 3, "compact_revision": 0, "modified_at": 0}


@pytest.fixture(params=SEEDS)
def masters(request, monkeypatch):
    from seaweedfs_tpu.server.master import MasterServer as RefMaster
    seed = request.param
    seed_jax(monkeypatch, seed)
    stubs = [Stub() for _ in range(4)]
    ref = RefMaster(port=0, pulse_seconds=BIG, volume_size_limit_mb=64,
                    vacuum_interval=0).start()
    port = MasterServer(port=0, pulse_seconds=BIG, volume_size_limit_mb=64,
                        seed=seed).start()
    yield Both(ref, port, stubs)
    port.stop()
    ref.stop()
    for s in stubs:
        s.server.stop()


def _watch(both, since):
    return both("GET", f"/cluster/watch?since={since}&timeout=0")


def _reads(both, vids):
    """Every read route's answer, equal."""
    for path in ("/dir/status", "/vol/status", "/cluster/status",
                 "/cluster/volumes", "/cluster/ec_status"):
        both("GET", path, want=200)
    for vid in vids:
        both("GET", f"/dir/lookup?volumeId={vid}")
        both("GET", f"/dir/lookup?volumeId={vid},0a01&collection=c")
        both("GET", f"/cluster/ec_lookup?volumeId={vid}")
    both("GET", "/dir/lookup", want=400)


def test_master_routes_match_jax(masters):
    both = masters
    s0, s1, s2, s3 = both.stubs
    # full heartbeats: volumes, a 001 pair, EC shards, racks
    both("POST", "/cluster/heartbeat",
         _hb(s0, [_vol(1), _vol(2, "c"), _vol(3, rp="001")],
             ec={"9": 0b1111}, ecc={"9": "e"}, rack="r1", mfk=30),
         want=200)
    both("POST", "/cluster/heartbeat",
         _hb(s1, [_vol(3, rp="001"), _vol(4, read_only=True)],
             ec={"9": 0b11110000}, ecc={"9": "e"}, rack="r1"), want=200)
    both("POST", "/cluster/heartbeat",
         _hb(s2, [_vol(5, size=70 << 20)], ec={"9": 0x3F00},
             ecc={"9": "e"}, rack="r2", maxc=3), want=200)
    seq = _watch(both, 0)[1]["seq"]
    _reads(both, range(0, 11))
    # a delta: volume 6 new, 2 deleted, 1 grown; EC bits ride it
    both("POST", "/cluster/heartbeat",
         _hb(s0, [_vol(6), _vol(1, size=9000)], delta=[2],
             ec={"9": 0b1011}, ecc={"9": "e"}), want=200)
    assert _watch(both, seq)[1]["events"]
    # a delta from a server the master does not know: resync
    out = both("POST", "/cluster/heartbeat", _hb(s3, [_vol(8)], delta=[]))
    assert out[1]["resync"] is True
    both("POST", "/cluster/heartbeat", _hb(s3, [_vol(8)], rack="r2"))
    _reads(both, range(0, 11))
    # assigns: writable volumes first, then growth on the stubs
    for q in ("", "?count=3", "?collection=c", "?replication=001",
              "?collection=new", "?collection=new&count=2",
              "?collection=r&replication=001", "?replication=200",
              "?collection=new&replication=010"):
        both("GET", f"/dir/assign{q}")
    out = both("POST", "/vol/grow?collection=g&count=2")
    assert out[0] == 200 and any(out[3])
    # what the stubs were asked to create now heartbeats in
    grown = {}
    for path in ("/dir/assign?collection=new",
                 "/vol/grow?collection=g&replication=001&count=2"):
        for stub, calls in zip(both.stubs, both(
                "POST" if "grow" in path else "GET", path)[3]):
            grown.setdefault(stub, []).extend(calls)
    for stub, calls in grown.items():
        vols = [_vol(int(c["volume"]), c["collection"], c["replication"])
                for c in calls]
        both("POST", "/cluster/heartbeat",
             _hb(stub, vols, delta=[]), want=200)
    for q in ("?collection=new", "?collection=new&count=5",
              "?collection=g&replication=001", "?collection=g"):
        both("GET", f"/dir/assign{q}")
    _reads(both, range(0, 40))
    # the redirect: a 301 to a holder drawn with the master's rng
    for fid in ("3,0a0000002a", "3,0b0000002a?collection=&x=1",
                "1,0c00000001", "6,0d00000001"):
        out = both("GET", f"/{fid}")
        assert out[0] == 301 and out[2], out
    both("GET", "/77,0c00000001", want=404)
    both("GET", "/favicon.ico", want=404)
    # goodbye, then a prune of a silent server
    seq = _watch(both, 0)[1]["seq"]
    both("POST", "/cluster/goodbye", {"url": f"127.0.0.1:{s1.port}"},
         want=200)
    both("POST", "/cluster/goodbye", {"url": "127.0.0.1:1"}, want=200)
    assert _watch(both, seq)[1]["events"]
    for m in (both.ref, both.port):
        m.topology.find_node(f"127.0.0.1:{s2.port}").last_seen -= 10
        assert [n.port for n in m.topology.prune_dead_nodes(timeout=5)] \
            == [s2.port]
    _reads(both, range(0, 40))
    _watch(both, seq)
    _watch(both, 10 ** 6)            # another epoch: a reset snapshot


def test_watch_long_poll_wakes_on_event(masters):
    """A parked /cluster/watch answers as soon as a heartbeat publishes,
    on both masters."""
    import threading
    both = masters
    s0 = both.stubs[0]
    seq = _watch(both, 0)[1]["seq"]
    answers = []
    for m in (both.ref, both.port):
        got = []
        t = threading.Thread(target=lambda: got.append(_call(
            m.url, "GET", f"/cluster/watch?since={seq}&timeout=20")))
        t.start()
        _call(m.url, "POST", "/cluster/heartbeat", _hb(s0, [_vol(12)]))
        t.join(25)
        assert not t.is_alive() and got
        answers.append(_strip(got[0][1], m.url))
    assert answers[1] == answers[0]
    assert answers[1]["events"][0]["vid"] == 12
