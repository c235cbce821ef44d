"""A port cluster against a JAX one: one master and three volume servers
each, through the shell's EC flow with replicated writes.

Each package runs its own cluster on 127.0.0.1 (the port's servers on
``device="cpu"``, the JAX ones on their numpy codec, no native plane),
and the same flow, with its own client: seeded kilobyte needles uploaded
through ``/dir/assign`` into a collection (the master grows 000
volumes); two ``001`` volumes grown with ``/vol/grow``, needles written
to them (the server fans each write out to the other replica), read
from both holders, from the server that holds neither (a 301 to a
replica) and through the master's ``GET /<fid>`` redirect, then half of
them deleted (the delete fans out; 404 on both holders after); then
``ec.encode`` of the fullest volume, reads through a server, four of one
server's shards lost, ``ec.rebuild``, ``ec.balance``, reads,
``ec.decode`` and reads through ``/dir/lookup``. Both masters draw from
``random.Random`` of one seed (patched in on the JAX side), so the file
ids, the growth and the placements are the same; ``time.time`` and
``time.time_ns``, which needles carry, are fixed for both, and each
cluster's servers are started in the order of their urls (the shell
breaks ties by url, the master by registration). The shell's printed
lines (servers named by their index, timings taken out), the volume and
shard placement, every shard file's bytes after the encode and after the
rebuild, and every read must be equal between the two clusters.

Mixed clusters: a port volume server heartbeats to a JAX master beside a
JAX one, and a JAX volume server to a port master beside a port one;
each server must be registered, looked up, and replicated to by the
other kind. A port server's deltas, the resync after the master forgets
it, and the immediate push of a change (with a 30 s pulse) are checked
against a port master and a JAX one. No test waits across a pulse: each
polls with ``wait_until``. Tolerances: none."""

import hashlib
import io
import os
import random
import re
import socket
import time

import numpy as np
import pytest

from conftest import wait_until

SEED = 5
SERVERS = 3


def seed_jax(monkeypatch, seed):
    """The JAX master's draws through one seeded random.Random, in the
    order the port's master draws from its own."""
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


@pytest.fixture
def torch_one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Cluster:
    """A master and volume servers of one package, and its client and
    shell modules."""

    def __init__(self, kind, root, n=SERVERS, pulse=1.0, kinds=None):
        self.kind = kind
        if kind == "ref":
            from seaweedfs_tpu.client import operation as op
            from seaweedfs_tpu.server.master import MasterServer
            from seaweedfs_tpu.shell.command_env import (CommandEnv,
                                                         run_command)
            self.master = MasterServer(port=0, pulse_seconds=pulse,
                                       vacuum_interval=0).start()
        else:
            from seaweedfs_tpu_torch.client import operation as op
            from seaweedfs_tpu_torch.server.master import MasterServer
            from seaweedfs_tpu_torch.shell import CommandEnv, run_command
            # no repair loop: the flow's lost shards are ec.rebuild's
            self.master = MasterServer(port=0, pulse_seconds=pulse,
                                       seed=SEED, repair_interval=0).start()
        self.op, self.CommandEnv, self.run_command = \
            op, CommandEnv, run_command
        kinds = kinds or [kind] * n
        self.servers = [new_server(k, str(root / f"{kind}-v{i}"),
                                   self.master.url, pulse, port)
                        for i, (k, port) in enumerate(
                            zip(kinds, _ordered_ports(len(kinds))))]

    def names(self):
        out = {vs.url: f"S{i}" for i, vs in enumerate(self.servers)}
        out[self.master.url] = "M"
        return out

    def shell(self, line):
        out = io.StringIO()
        self.run_command(self.CommandEnv(self.master.url, out=out), line)
        return out.getvalue()

    def master_json(self, path):
        from seaweedfs_tpu_torch.server.http_util import get_json
        return get_json(f"http://{self.master.url}{path}")

    def volumes(self):
        return self.master_json("/cluster/volumes")["volumes"]

    def ec_volumes(self):
        return self.master_json("/cluster/ec_status")["volumes"]

    def stop(self):
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def _ordered_ports(n):
    """``n`` free ports on 127.0.0.1 whose ``host:port`` strings sort in
    the order of the list: the shell breaks ties between servers by their
    url (``ec.balance``) and the master by registration order, so each
    cluster's servers are started in their urls' order."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted((s.getsockname()[1] for s in socks), key=str)
    finally:
        for s in socks:
            s.close()


def new_server(kind, d, master_url, pulse, port=0):
    if kind == "ref":
        from seaweedfs_tpu.server.volume_server import VolumeServer
        return VolumeServer(port=port, directories=[d],
                            master_url=master_url, pulse_seconds=pulse,
                            max_volume_counts=[30], ec_backend="numpy",
                            fast_port=-1).start()
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(port=port, directories=[d], master_url=master_url,
                        pulse_seconds=pulse, max_volume_counts=[30],
                        device="cpu", fast_port=-1).start()


def _named(text, names):
    """Servers by index, timings out."""
    for url, name in names.items():
        text = text.replace(url, name)
    return re.sub(r"\d+\.\d+(e-?\d+)?", "T", text).splitlines()


def _get(url):
    from seaweedfs_tpu_torch.server.http_util import http_call
    return http_call("GET", url)


def _status(url):
    from seaweedfs_tpu_torch.server.http_util import HttpError
    try:
        _get(url)
    except HttpError as e:
        return e.status
    return 200


def _shard_files(c):
    """{(server index, file name): sha256} of every EC file."""
    out = {}
    for i, vs in enumerate(c.servers):
        for loc in vs.store.locations:
            for name in sorted(os.listdir(loc.directory)):
                if ".ec" in name:
                    with open(os.path.join(loc.directory, name), "rb") as f:
                        out[(i, name)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _replicas_known(c, vids):
    """Every server's pushed location map lists both replicas of each
    volume."""
    return all(len(vs._vid_map.lookup(v) or []) == 2
               for vs in c.servers for v in vids)


def flow(c):
    """The shell flow with replicated writes; returns what the two
    clusters must agree on."""
    op, names, murl = c.op, c.names(), c.master.url
    rec = {}
    rng = np.random.default_rng(SEED)
    payloads = {}
    for i in range(12):
        data = rng.bytes(12_000 + 500 * i)
        payloads[op.upload_data(murl, data, filename=f"f{i}.bin",
                                collection="shelltest")] = data
    rec["fids"] = list(payloads)

    # two 001 volumes, every write fanned out to the other replica
    from seaweedfs_tpu_torch.server.http_util import post_json
    assert post_json(f"http://{murl}/vol/grow?collection=rep"
                     f"&replication=001&count=2")["count"] == 2
    rep_vids = sorted(int(v) for v, reps in c.volumes().items()
                      if reps[0]["collection"] == "rep")
    assert len(rep_vids) == 2
    assert wait_until(lambda: _replicas_known(c, rep_vids))
    replicated = {}
    for i in range(8):
        data = rng.bytes(3000 + 97 * i)
        replicated[op.upload_data(murl, data, filename=f"r{i}.txt",
                                  collection="rep",
                                  replication="001")] = data
    rec["replicated"] = list(replicated)
    placement = []
    for fid, data in replicated.items():
        vid = int(fid.split(",")[0])
        holders = op.lookup(murl, vid)
        assert len(holders) == 2
        placement.append(sorted(names[u] for u in holders))
        for vs in c.servers:
            # a holder serves it, the other server redirects to one
            assert _get(f"http://{vs.url}/{fid}") == data
        assert _get(f"http://{murl}/{fid}") == data
        assert op.read_file(murl, fid) == data
    rec["replica_placement"] = placement
    gone = list(replicated)[::2]
    for fid in gone:
        assert op.delete_file(murl, fid)
        for holder in op.lookup(murl, int(fid.split(",")[0])):
            assert _status(f"http://{holder}/{fid}") == 404
    for fid in list(replicated)[1::2]:
        assert op.read_file(murl, fid) == replicated[fid]

    # ec.encode, a loss, ec.rebuild, ec.balance, ec.decode
    by_vid = {}
    for fid in payloads:
        by_vid.setdefault(fid.split(",")[0], []).append(fid)
    vid = int(max(sorted(by_vid), key=lambda v: len(by_vid[v])))
    mine = {f: payloads[f] for f in by_vid[str(vid)]}
    rec["shell"] = [_named(c.shell(f"ec.encode -volumeId {vid}"), names)]
    for fid, data in mine.items():
        assert _get(f"http://{c.servers[0].url}/{fid}") == data
    rec["encoded"] = _shard_files(c)
    rec["placement"] = _ec_placement(c, vid, names)
    assert len(rec["placement"]) == 14

    victim = c.servers[0]
    lost = victim.store.find_ec_volume(vid).shard_ids()[:4]
    victim.store.unmount_ec_shards(vid, lost)
    for loc in victim.store.locations:
        for sid in lost:
            for name in os.listdir(loc.directory):
                if name.endswith(f".ec{sid:02d}"):
                    os.remove(os.path.join(loc.directory, name))
    victim.heartbeat_once()
    rec["lost"] = lost
    rec["shell"].append(_named(c.shell("ec.rebuild"), names))
    rec["rebuilt"] = _shard_files(c)
    rec["shell"].append(_named(c.shell("ec.balance"), names))
    rec["balanced"] = _ec_placement(c, vid, names)
    assert len(rec["balanced"]) == 14
    for fid, data in mine.items():
        assert _get(f"http://{c.servers[1].url}/{fid}") == data
    rec["shell"].append(_named(c.shell(f"ec.decode -volumeId {vid}"),
                               names))
    for fid, data in mine.items():
        assert op.read_file(murl, fid) == data
    assert str(vid) not in c.ec_volumes()
    rec["volumes"] = {
        v: sorted(names[r["url"]] for r in reps)
        for v, reps in c.volumes().items()}
    return rec


def _ec_placement(c, vid, names):
    shards = c.ec_volumes()[str(vid)]["shards"]
    return {sid: sorted(names[u] for u in urls)
            for sid, urls in shards.items()}


def test_cluster_flow_matches_jax(tmp_path, monkeypatch, torch_one_thread):
    seed_jax(monkeypatch, SEED)
    # needles carry their write time: one clock for both clusters
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_250_000_000)
    ref = Cluster("ref", tmp_path)
    try:
        want = flow(ref)
    finally:
        ref.stop()
    port = Cluster("port", tmp_path)
    try:
        got = flow(port)
    finally:
        port.stop()
    assert got["fids"] == want["fids"]
    assert got["replicated"] == want["replicated"]
    assert got["replica_placement"] == want["replica_placement"]
    assert got["placement"] == want["placement"]
    assert got["lost"] == want["lost"]
    assert got["shell"] == want["shell"]
    assert got["balanced"] == want["balanced"]
    assert got["volumes"] == want["volumes"]
    assert got["encoded"] == want["encoded"]
    assert got["rebuilt"] == want["rebuilt"]
    assert "ec encoded, original removed" in got["shell"][0][-1]
    assert any("rebuilt shards" in line for line in got["shell"][1])


@pytest.mark.parametrize("master_kind", ["ref", "port"])
def test_mixed_cluster(tmp_path, master_kind, torch_one_thread):
    """Both kinds of volume server under one master of either package:
    registered, looked up, and each replicating to the other."""
    c = Cluster(master_kind, tmp_path, kinds=["ref", "port"])
    try:
        murl = c.master.url
        nodes = {n["url"] for n in
                 c.master_json("/cluster/status")["nodes"]}
        assert nodes == {vs.url for vs in c.servers}
        from seaweedfs_tpu_torch.server.http_util import post_json
        assert post_json(f"http://{murl}/vol/grow?collection=mix"
                         f"&replication=001&count=1")["count"] == 1
        (vid,) = [int(v) for v in c.volumes()]
        assert wait_until(lambda: _replicas_known(c, [vid]))
        rng = np.random.default_rng(3)
        written = {}
        for vs in c.servers:
            # a write to each server lands on both
            a = c.op.assign(murl, collection="mix", replication="001")
            data = rng.bytes(2000)
            c.op.upload(vs.url, a["fid"], data, filename="m.bin")
            written[a["fid"]] = data
        for fid, data in written.items():
            assert sorted(c.op.lookup(murl, vid)) == \
                sorted(vs.url for vs in c.servers)
            for vs in c.servers:
                assert _get(f"http://{vs.url}/{fid}") == data
        for fid in written:
            assert c.op.delete_file(murl, fid)
            for vs in c.servers:
                assert _status(f"http://{vs.url}/{fid}") == 404
    finally:
        c.stop()


@pytest.mark.parametrize("master_kind", ["ref", "port"])
def test_port_server_heartbeats(tmp_path, master_kind, torch_one_thread):
    """A port server's deltas carry growth and deletion; a master that
    forgot it gets the full state on the next heartbeat (resync); a
    volume created or an EC shard mounted reaches the master at once,
    with a 30 s pulse."""
    from seaweedfs_tpu_torch.server.http_util import post_json
    c = Cluster(master_kind, tmp_path, pulse=30.0, kinds=["port"])
    vs = c.servers[0]
    try:
        murl = c.master.url
        a = c.op.assign(murl)
        vid = int(a["fid"].split(",")[0])
        vs.heartbeat_once()
        payload = vs._heartbeat_payload(vs.store.collect_heartbeat(),
                                        vs.master_url)
        assert payload["delta"] is True and payload["new_volumes"] == []
        c.op.upload(a["url"], a["fid"], b"grow" * 3000, filename="g.bin")
        vs.heartbeat_once()
        assert c.volumes()[str(vid)][0]["size"] > 12000
        # amnesia: the delta is answered resync, the full state follows
        c.master.topology.unregister_node(
            c.master.topology.find_node(vs.url))
        vs.heartbeat_once()
        assert vid in c.master.topology.find_node(vs.url).volumes
        # the immediate push: an EC mount, then a volume deletion
        post_json(f"http://{vs.url}/admin/volume/readonly?volume={vid}")
        post_json(f"http://{vs.url}/admin/ec/generate?volume={vid}")
        vs.store.mount_ec_shards(vid, "", list(range(14)))
        assert wait_until(lambda: str(vid) in c.ec_volumes(), timeout=5.0)
        vs.store.delete_volume(vid)
        assert wait_until(lambda: str(vid) not in c.volumes(),
                          timeout=5.0)
    finally:
        c.stop()


def test_replicated_write_behind_the_location_map(tmp_path,
                                                  torch_one_thread):
    """A write to a grown 001 volume reaches the other replica even when
    the primary's pushed location map still lists only itself (each
    replica's registration is its own push, so a write just after the
    growth can arrive before the second one): the primary asks the
    master again instead of replicating to nobody. The same for the
    delete."""
    from seaweedfs_tpu_torch.server.http_util import HttpError, post_json
    c = Cluster("port", tmp_path, n=2, pulse=30.0)
    try:
        murl = c.master.url
        assert post_json(f"http://{murl}/vol/grow?collection=r"
                         f"&replication=001")["count"] == 1
        a = c.op.assign(murl, collection="r", replication="001")
        vid = int(a["fid"].split(",")[0])
        primary = next(vs for vs in c.servers if vs.url == a["url"])
        other = next(vs for vs in c.servers if vs is not primary)
        primary._vid_map.lookup = lambda v: [primary.url]
        primary._lookup_cache.pop(vid, None)
        body = b"replica" * 700
        c.op.upload(a["url"], a["fid"], body, filename="r.bin")
        assert _get(f"http://{other.url}/{a['fid']}") == body
        from seaweedfs_tpu_torch.server.http_util import http_call
        http_call("DELETE", f"http://{primary.url}/{a['fid']}")
        with pytest.raises(HttpError) as err:
            _get(f"http://{other.url}/{a['fid']}")
        assert err.value.status == 404
        assert vid in other.store.locations[0].volumes
    finally:
        c.stop()


def test_replica_lookup_when_the_master_fails(tmp_path, torch_one_thread,
                                              monkeypatch):
    """At copy count 3, a primary whose location map knows one of its two
    replicas still writes to that one when the master's lookup fails;
    the failure is kept LOOKUP_TTL_S as no answer (one lookup for two
    writes) and never replaces the map's list. A fresh master answer is
    then used whatever its length, with no new lookup."""
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.http_util import HttpError, post_json
    c = Cluster("port", tmp_path, n=3, pulse=30.0)
    try:
        murl = c.master.url
        assert post_json(f"http://{murl}/vol/grow?collection=t"
                         f"&replication=002")["count"] == 1
        a = c.op.assign(murl, collection="t", replication="002")
        vid = int(a["fid"].split(",")[0])
        primary = next(vs for vs in c.servers if vs.url == a["url"])
        known, unknown = [vs for vs in c.servers if vs is not primary]
        primary._vid_map.lookup = lambda v: [primary.url, known.url]
        primary._lookup_cache.pop(vid, None)
        lookups = []
        real_get_json = vsmod.get_json

        def get_json(url, *args, **kwargs):
            if "/dir/lookup" in url:
                lookups.append(url)
                raise HttpError(503, "master unreachable")
            return real_get_json(url, *args, **kwargs)

        monkeypatch.setattr(vsmod, "get_json", get_json)
        url = f"http://{a['url']}/{a['fid']}"
        for body in (b"first" * 300, b"second" * 300):
            c.op.upload(a["url"], a["fid"], body, filename="t.bin")
            assert _get(f"http://{known.url}/{a['fid']}") == body
        assert len(lookups) == 1
        with pytest.raises(HttpError) as err:
            _get(f"http://{unknown.url}/{a['fid']}")
        assert err.value.status == 404
        primary._vid_map.lookup = lambda v: [primary.url]
        primary._lookup_cache[vid] = (time.time(),
                                      [primary.url, unknown.url])
        body = b"third" * 300
        c.op.upload(a["url"], a["fid"], body, filename="t.bin")
        assert _get(f"http://{unknown.url}/{a['fid']}") == body
        assert _get(url) == body
        assert len(lookups) == 1
    finally:
        c.stop()
