"""The volume control plane of a port cluster against the JAX package's.

Each package runs a master and three volume servers on 127.0.0.1 (the
port's on ``device="cpu"``, the JAX ones on their numpy codec, no native
plane) with ``Cluster`` of ``test_torch_cluster.py``: one seed for both
masters' draws, ``time.time``/``time.time_ns`` fixed (needles carry
them), servers started in the order of their urls. One flow runs on
each: seeded kilobyte needles into a collection, then ``volume.list``,
``volume.fsck`` and ``-deep``, ``volume.balance``, the
``volume.unmount``/``volume.mount`` cycle, ``volume.copy`` (the source
kept and thawed, a frozen replica left frozen), ``volume.move``,
``volume.configure.replication`` and ``volume.fix.replication``, deletes
and ``volume.vacuum``, a ``/vol/vacuum`` reply, ``/submit`` into a
second collection, ``collection.list``, ``collection.delete`` and
``volume.delete``. Before every shell line each server heartbeats
synchronously, so both masters read the servers' state (no wait across
a pulse). The shell's lines (servers by index, numbers with a point
out), the master's replies, the vacuumed volume's .dat and .idx bytes
and the final volume map must be equal between the packages.

Beside the flow: the non-heartbeating admin routes of a port server and
a JAX one over copies of one volume; compaction of one .dat/.idx pair by
each package's ``Volume`` (both methods) to equal bytes; the vacuum loop
(garbage removed unattended), the TTL reap (by the loop, never by a
manual ``/vol/vacuum``), the maintenance runner, a second replica's
compact failing once and healed by the next pass, and ``/col/delete``
with a failed delete (the JAX master orphans the volume, the port keeps
it looked up). Then the JAX ``test_backup_tools.py`` cases, each run by
both packages' ``volume_backup`` and ``volume_tools`` on files made under
one counting clock (``time.time_ns`` steps 1 us a call, restarted for
each package), with equal results, bytes and printed lines; and the
backup of a live volume, full then incremental and again after a
compaction, from a port cluster and a JAX one. Tolerances: none."""

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import tarfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import wait_until
from test_torch_cluster import (SEED, Cluster, _named, seed_jax,  # noqa: F401
                                torch_one_thread)


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_250_000_000)


def _settle(c):
    """Every server heartbeats now: its master reads its state."""
    for vs in c.servers:
        vs.heartbeat_once()


def _http():
    from seaweedfs_tpu_torch.server import http_util
    return http_util


def _status(url, method="GET"):
    hu = _http()
    try:
        hu.http_call(method, url)
    except hu.HttpError as e:
        return e.status
    return 200


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _vol_files(c, vid):
    """{(server index, file name): sha256} of a plain volume's files."""
    out = {}
    for i, vs in enumerate(c.servers):
        for loc in vs.store.locations:
            for name in sorted(os.listdir(loc.directory)):
                stem = name.rsplit(".", 1)[0].rsplit("_", 1)[-1]
                if stem == str(vid) and name.endswith((".dat", ".idx")):
                    out[(i, name)] = _sha(os.path.join(loc.directory, name))
    return out


def _named_json(obj, names):
    """A reply with the cluster's urls replaced by S0.. and M."""
    text = json.dumps(obj, sort_keys=True)
    for url, name in names.items():
        text = text.replace(url, name)
    return json.loads(text)


def _volume_map(c, names):
    """vid -> [replica info without its mtime, holder by index]."""
    out = {}
    for vid, reps in sorted(c.volumes().items(), key=lambda kv: int(kv[0])):
        out[vid] = sorted(
            (names[r["url"]], {k: v for k, v in r.items()
                               if k not in ("url", "modified_at")})
            for r in reps)
    return out


def vflow(c):
    """The volume and collection flow; what the two clusters must agree
    on."""
    hu = _http()
    op, names, murl = c.op, c.names(), c.master.url
    rec = {"shell": {}}

    def shell(key, line):
        _settle(c)
        rec["shell"][key] = _named(c.shell(line), names)
        return rec["shell"][key]

    def holders(vid):
        return [r["url"] for r in c.volumes().get(str(vid), [])]

    def server(url):
        return next(vs for vs in c.servers if vs.url == url)

    rng = np.random.default_rng(SEED)
    payloads = {}
    for i in range(14):
        data = rng.bytes(2000 + 300 * i)
        payloads[op.upload_data(murl, data, filename=f"f{i}.bin",
                                collection="shelltest")] = data
    rec["fids"] = list(payloads)
    by_vid = {}
    for fid in payloads:
        by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
    vids = sorted(by_vid, key=lambda v: (-len(by_vid[v]), v))
    assert len(vids) >= 5
    shell("list", "volume.list")
    shell("fsck", "volume.fsck")
    deep = shell("fsck_deep", "volume.fsck -deep")
    assert deep[-1].endswith("0 with errors"), deep
    moved = shell("balance", "volume.balance")
    assert moved[-1] != "volume.balance: 0 moves", moved
    for fid, data in payloads.items():
        assert op.read_file(murl, fid) == data

    # unmount and mount on the holder: files kept, 404 in between
    v0 = vids[0]
    fid0 = by_vid[v0][0]
    h0 = server(holders(v0)[0])
    assert shell("unmount", f"volume.unmount -volumeId {v0} "
                 f"-node {h0.url}")[-1].endswith("unmounted=True")
    assert h0.store.find_volume(v0) is None
    rec["unmounted_get"] = _status(f"http://{h0.url}/{fid0}")
    assert rec["unmounted_get"] == 404
    assert shell("mount", f"volume.mount -volumeId {v0} "
                 f"-node {h0.url}")[-1].endswith("mounted=True")
    assert hu.http_call("GET", f"http://{h0.url}/{fid0}") == payloads[fid0]

    # copy keeps the source, thawed; a frozen replica stays frozen
    v1 = vids[1]
    source = holders(v1)[0]
    target = next(n["url"] for n in c.master_json(
        "/cluster/status")["nodes"] if n["url"] != source)
    shell("copy", f"volume.copy -volumeId {v1} -target {target}")
    _settle(c)
    assert set(holders(v1)) == {source, target}
    for fid in by_vid[v1]:
        for u in (source, target):
            assert hu.http_call("GET", f"http://{u}/{fid}") == payloads[fid]
    rec["thawed_write"] = hu.post_multipart(
        f"http://{source}/{v1},fe00000000aa", "thaw.bin", b"post-copy")
    hu.post_json(f"http://{source}/admin/volume/readonly?volume={v1}")
    other = next(vs.url for vs in c.servers
                 if vs.url not in (source, target))
    shell("copy_frozen", f"volume.copy -volumeId {v1} -source {source} "
          f"-target {other}")
    assert server(source).store.find_volume(v1).readonly
    assert not server(other).store.find_volume(v1).readonly

    # move: the source's replica goes, the target serves every needle
    v2 = vids[2]
    src2 = holders(v2)[0]
    dst2 = next(vs.url for vs in c.servers if vs.url != src2)
    shell("move", f"volume.move -volumeId {v2} -target {dst2}")
    _settle(c)
    assert holders(v2) == [dst2]
    assert server(src2).store.find_volume(v2) is None
    for fid in by_vid[v2]:
        assert op.read_file(murl, fid) == payloads[fid]

    # configure.replication to 001, then fix.replication copies it
    v3 = vids[3]
    h3 = server(holders(v3)[0])
    shell("configure", f"volume.configure.replication -volumeId {v3} "
          f"-replication 001")
    v = h3.store.find_volume(v3)
    with open(v.dat_path, "rb") as f:
        assert f.read(2)[1] == 1
    shell("fix", "volume.fix.replication")
    _settle(c)
    assert len(holders(v3)) == 2
    for fid in by_vid[v3]:
        for u in holders(v3):
            assert hu.http_call("GET", f"http://{u}/{fid}") == payloads[fid]

    # deletes, then volume.vacuum and /vol/vacuum
    for fid in by_vid[v0][: len(by_vid[v0]) // 2 + 1]:
        assert op.delete_file(murl, fid)
        payloads.pop(fid)
    shell("vacuum", "volume.vacuum -garbageThreshold 0.1")
    rec["vacuumed_files"] = _vol_files(c, v0)
    for fid in by_vid[vids[4]][:1]:
        assert op.delete_file(murl, fid)
        payloads.pop(fid)
    _settle(c)
    rec["vol_vacuum"] = hu.post_json(
        f"http://{murl}/vol/vacuum?garbageThreshold=0.01")
    rec["vol_vacuum_again"] = hu.post_json(f"http://{murl}/vol/vacuum")
    _settle(c)
    for fid, data in payloads.items():
        assert op.read_file(murl, fid) == data


    # /submit into a second collection, then collection.* commands
    submitted = {}
    for i in range(3):
        data = rng.bytes(1500 + 100 * i)
        out = hu.post_multipart(f"http://{murl}/submit?collection=tmpcol",
                                f"s{i}.txt", data, "text/plain")
        submitted[out["fid"]] = data
        rec.setdefault("submit", []).append(_named_json(out, names))
    for fid, data in submitted.items():
        assert op.read_file(murl, fid) == data
    tmp_vids = sorted(int(v) for v, reps in c.volumes().items()
                      if reps[0]["collection"] == "tmpcol")
    shell("collection_list", "collection.list")
    shell("collection_delete", "collection.delete -collection tmpcol")
    _settle(c)
    for vid in tmp_vids:
        assert str(vid) not in c.volumes()
        assert _status(f"http://{murl}/dir/lookup?volumeId={vid}") == 404
        for vs in c.servers:
            assert vs.store.find_volume(vid) is None
    rec["col_delete_none"] = hu.post_json(
        f"http://{murl}/col/delete?collection=nosuch")
    rec["col_delete_400"] = _status(f"http://{murl}/col/delete", "POST")
    for fid, data in payloads.items():
        assert op.read_file(murl, fid) == data

    vlast = vids[-1]
    shell("delete", f"volume.delete -volumeId {vlast}")
    _settle(c)
    assert str(vlast) not in c.volumes()
    rec["volumes"] = _volume_map(c, names)
    return rec


def test_volume_flow_matches_jax(tmp_path, monkeypatch, fixed_clock,
                                 torch_one_thread):
    seed_jax(monkeypatch, SEED)
    recs = {}
    for kind in ("ref", "port"):
        c = Cluster(kind, tmp_path)
        try:
            recs[kind] = vflow(c)
        finally:
            c.stop()
    want, got = recs["ref"], recs["port"]
    assert got["fids"] == want["fids"]
    assert sorted(got["shell"]) == sorted(want["shell"])
    for key in want["shell"]:
        assert got["shell"][key] == want["shell"][key], key
    for key in ("unmounted_get", "thawed_write", "vol_vacuum",
                "vol_vacuum_again", "submit", "col_delete_none",
                "col_delete_400", "vacuumed_files", "volumes"):
        assert got[key] == want[key], key
    assert any("vacuumed" in ln for ln in got["shell"]["vacuum"])
    assert got["vol_vacuum"]["vacuumed"] and all(
        r["ok"] for r in got["vol_vacuum"]["vacuumed"])


# -- the admin routes of one server, each package over the same files -------

def _seeded_volume(Volume, Needle, d, vid=7, count=12, deletes=(3, 8)):
    os.makedirs(d, exist_ok=True)
    v = Volume(d, "", vid, create=True)
    rng = np.random.default_rng(vid)
    for i in range(count):
        n = Needle(cookie=0x100 + i, id=i + 1,
                   data=rng.bytes(400 + 37 * i))
        n.set_name(f"file-{i}.bin".encode())
        v.write_needle(n)
    for nid in deletes:
        v.delete_needle(Needle(cookie=0x100 + nid - 1, id=nid))
    v.close()


def _servers(tmp_path, root_files):
    """A port server and a JAX one, each over its own copy of
    ``root_files``; neither has a master."""
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    dirs = []
    for kind in ("ref", "port"):
        d = tmp_path / f"srv-{kind}"
        shutil.copytree(root_files, d)
        dirs.append(str(d))
    ref = RefServer(port=0, directories=[dirs[0]], master_url="127.0.0.1:1",
                    ec_backend="numpy", fast_port=-1).start()
    port = VolumeServer(port=0, directories=[dirs[1]], device="cpu",
                        fast_port=-1).start()
    return ref, port


def test_admin_routes_match_jax(tmp_path, fixed_clock):
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    hu = _http()
    _seeded_volume(Volume, Needle, str(tmp_path / "files"))
    _seeded_volume(Volume, Needle, str(tmp_path / "files"), vid=8,
                   count=3, deletes=())
    ref, port = _servers(tmp_path, tmp_path / "files")
    try:
        got = {}
        for kind, vs in (("ref", ref), ("port", port)):
            u = f"http://{vs.url}"
            r = got[kind] = {}
            r["verify"] = hu.post_json(f"{u}/admin/volume/verify?volume=7")
            r["sync"] = hu.get_json(f"{u}/admin/volume/sync_status?volume=7")
            r["tail"] = hu.http_call(
                "GET", f"{u}/admin/volume/tail?volume=7&since_ns=0")
            r["page"] = hu.http_call(
                "GET", f"{u}/admin/volume/tail?volume=7&since_ns=0"
                       f"&max_bytes=2000")
            # volume 8 takes volume 7's records past its own
            r["receive"] = json.loads(hu.http_call(
                "POST", f"{u}/admin/volume/tail_receive?volume=8"
                        f"&since_ns=0", r["tail"]))
            r["configure"] = hu.post_json(
                f"{u}/admin/volume/configure_replication?volume=7"
                f"&replication=010")
            r["bad_rp"] = _status(
                f"{u}/admin/volume/configure_replication?volume=7"
                f"&replication=9x", "POST")
            hu.post_json(f"{u}/admin/volume/readonly?volume=7")
            r["readonly_rp"] = _status(
                f"{u}/admin/volume/configure_replication?volume=7"
                f"&replication=001", "POST")
            r["missing"] = [_status(f"{u}{p}?volume=99", m) for m, p in (
                ("POST", "/admin/volume/verify"),
                ("GET", "/admin/volume/sync_status"),
                ("GET", "/admin/volume/tail"),
                ("POST", "/admin/volume/configure_replication"))]
            r["files"] = {name: _sha(os.path.join(
                vs.store.locations[0].directory, name))
                for name in ("7.dat", "8.dat", "8.idx")}
        assert got["port"] == got["ref"]
        assert got["port"]["verify"] == {"volume": 7, "checked": 10,
                                         "errors": 0}
        assert 0 < len(got["port"]["page"]) < len(got["port"]["tail"])
    finally:
        ref.stop()
        port.stop()


# -- compaction: one pair of files, each package's Volume ---------------------

@pytest.mark.parametrize("method", [0, 1])
def test_compaction_bytes_match_jax(tmp_path, fixed_clock, method):
    """``compact_volume`` (``compact_scan`` for method 0, ``compact``
    for 1) of copies of one .dat/.idx pair: equal files and replies."""
    from seaweedfs_tpu.command import volume_tools as ref_tools
    from seaweedfs_tpu_torch.command import volume_tools
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    _seeded_volume(Volume, Needle, str(tmp_path / "files"), count=20,
                   deletes=(1, 2, 5, 9, 14, 20))
    out, files = {}, {}
    for kind, tools in (("ref", ref_tools), ("port", volume_tools)):
        d = tmp_path / kind
        shutil.copytree(tmp_path / "files", d)
        out[kind] = tools.compact_volume(str(d), 7, method=method)
        files[kind] = [_sha(d / name) for name in ("7.dat", "7.idx")]
    assert out["port"] == out["ref"]
    assert out["port"]["after"] < out["port"]["before"]
    assert files["port"] == files["ref"]


# -- the master's loops --------------------------------------------------------

def _port_cluster(tmp_path, n=1, **master_kwargs):
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    m = MasterServer(port=0, pulse_seconds=1, seed=1, repair_interval=0,
                     **master_kwargs).start()
    servers = [VolumeServer(port=0, directories=[str(tmp_path / f"v{i}")],
                            master_url=m.url, pulse_seconds=1,
                            max_volume_counts=[10], device="cpu",
                            fast_port=-1).start()
               for i in range(n)]
    return m, servers


def _garbage(m, vs, n=8, size=3000, drop=6, replication="", rng_seed=0):
    """``n`` needles on one volume, ``drop`` of them deleted; (vid,
    fids, payloads of the live ones)."""
    from seaweedfs_tpu_torch.client import operation as op
    a = op.assign(m.url, replication=replication)
    vid = int(a["fid"].split(",")[0])
    rng = np.random.default_rng(rng_seed)
    fids, live = [], {}
    for i in range(1, n + 1):
        fid = f"{vid},{i:x}00000001"
        data = rng.bytes(size)
        op.upload(a["url"], fid, data, filename=f"f{i}")
        fids.append(fid)
        live[fid] = data
    for fid in fids[:drop]:
        assert op.delete_file(m.url, fid)
        live.pop(fid)
    for s in vs:
        s.heartbeat_once()
    return vid, fids, live


def test_vacuum_loop_removes_garbage(tmp_path):
    from seaweedfs_tpu_torch.client import operation as op
    m, (vs,) = _port_cluster(tmp_path, vacuum_interval=0.2,
                             garbage_threshold=0.3)
    try:
        vid, _, live = _garbage(m, [vs])
        v = vs.store.find_volume(vid)
        assert wait_until(lambda: v.garbage_level() == 0.0, timeout=10), \
            "the vacuum loop never compacted the volume"
        for fid, data in live.items():
            assert op.read_file(m.url, fid) == data
    finally:
        vs.stop()
        m.stop()


def test_ttl_expired_volumes_match_jax():
    """The TTL scan of both masters over one registered state: 1m
    volumes written an hour ago expire; a fresh one, one without a TTL
    and an empty one do not."""
    from seaweedfs_tpu.server.master import MasterServer as RefMaster
    from seaweedfs_tpu_torch.server.master import MasterServer
    old = time.time() - 3600
    volumes = [
        {"id": 1, "collection": "", "size": 500, "ttl": (1 << 8) | 1,
         "modified_at": old, "replica_placement": "000"},
        {"id": 2, "collection": "", "size": 500, "ttl": (1 << 8) | 1,
         "modified_at": time.time(), "replica_placement": "000"},
        {"id": 3, "collection": "", "size": 500, "ttl": 0,
         "modified_at": old, "replica_placement": "000"},
        {"id": 4, "collection": "", "size": 0, "ttl": (1 << 8) | 1,
         "modified_at": old, "replica_placement": "000"},
        {"id": 5, "collection": "", "size": 9, "ttl": (1 << 8) | 1,
         "modified_at": old, "replica_placement": "000"},
    ]
    got = []
    for master in (RefMaster(port=0, vacuum_interval=0),
                   MasterServer(port=0, vacuum_interval=0)):
        for ip in ("9.9.9.9", "9.9.9.8"):
            master.topology.register_heartbeat(
                dc_id="", rack_id="", ip=ip, port=1, public_url="",
                max_volume_count=10, volumes=volumes)
        got.append(master._ttl_expired_volumes())
        master.server.stop()
    assert got[1] == got[0] == [(1, ["9.9.9.9:1", "9.9.9.8:1"]),
                                (5, ["9.9.9.9:1", "9.9.9.8:1"])]


def test_ttl_reap_by_the_loop_only(tmp_path, monkeypatch):
    """A manual /vol/vacuum leaves an expired TTL volume alone; the loop
    marks it readonly and deletes it on its holder. The empty volumes
    grown beside it (a superblock only) stay: the JAX master, which
    tests a size of 0, would reap them too."""
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.server import master as master_mod
    hu = _http()
    m, (vs,) = _port_cluster(tmp_path, vacuum_interval=0)
    try:
        fid = op.upload_data(m.url, b"short-lived" * 100, filename="t",
                             ttl="1m")
        vid = int(fid.split(",")[0])
        grown = sorted(vs.store.locations[0].volumes)
        assert len(grown) == 7
        vs.heartbeat_once()
        real = time.time

        class Later:
            @staticmethod
            def time():
                return real() + 7200

        monkeypatch.setattr(master_mod, "time", Later)
        assert m._ttl_expired_volumes() == [(vid, [vs.url])]
        out = hu.post_json(f"http://{m.url}/vol/vacuum")
        assert out == {"vacuumed": [], "ttl_expired": []}
        assert vs.store.find_volume(vid) is not None
        assert op.read_file(m.url, fid) == b"short-lived" * 100
        m.vacuum_interval = 0.1
        threading.Thread(target=m._vacuum_loop, daemon=True).start()
        assert wait_until(lambda: vs.store.find_volume(vid) is None,
                          timeout=10), "the loop never reaped the volume"
        # the holder's heartbeat after the delete tells the master
        assert wait_until(lambda: _status(
            f"http://{m.url}/dir/lookup?volumeId={vid}") == 404, timeout=10)
        assert sorted(vs.store.locations[0].volumes) == \
            [v for v in grown if v != vid]
    finally:
        vs.stop()
        m.stop()


def test_maintenance_runner(tmp_path):
    """The master runs its scripts' lines on an interval: a probe
    command, a failing line, and a volume.vacuum that compacts a
    volume."""
    from seaweedfs_tpu_torch.shell import command_env
    runs = []

    @command_env.command("test.torch.maintenance.probe", "test only")
    def probe(env, args):
        runs.append(list(args))

    try:
        m, (vs,) = _port_cluster(
            tmp_path, vacuum_interval=0, maintenance_interval=0.2,
            maintenance_scripts="test.torch.maintenance.probe a; "
                                "no.such.command; "
                                "volume.vacuum -garbageThreshold 0.3")
        try:
            assert m.maintenance_scripts == [
                "test.torch.maintenance.probe a", "no.such.command",
                "volume.vacuum -garbageThreshold 0.3"]
            vid, _, _ = _garbage(m, [vs])
            v = vs.store.find_volume(vid)
            assert wait_until(lambda: v.garbage_level() == 0.0,
                              timeout=10), "volume.vacuum never ran"
            assert runs and runs[0] == ["a"]
            assert wait_until(lambda: m._maintenance_runs >= 1)
        finally:
            vs.stop()
            m.stop()
    finally:
        command_env.COMMANDS.pop("test.torch.maintenance.probe", None)
        command_env.HELP.pop("test.torch.maintenance.probe", None)


def test_second_replica_compact_fails_once(tmp_path):
    """Compact on the first replica, fail on the second: no commit
    anywhere and the first keeps its .cpd/.cpx; the next pass compacts
    over them and commits on both."""
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.storage.volume import VolumeError
    hu = _http()
    m, servers = _port_cluster(tmp_path, n=2, vacuum_interval=0)
    try:
        assert hu.post_json(f"http://{m.url}/vol/grow?replication=001"
                            )["count"] == 1
        assert wait_until(lambda: all(
            len(vs._vid_map.lookup(1) or []) == 2 for vs in servers))
        vid, _, live = _garbage(m, servers, replication="001")
        first, second = (next(vs for vs in servers if vs.url == u)
                         for u in op.lookup(m.url, vid))
        v2 = second.store.find_volume(vid)
        calls = []
        compact = v2.compact

        def fail_once(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise VolumeError("disk full")
            return compact(*args, **kwargs)

        v2.compact = fail_once
        out = hu.post_json(f"http://{m.url}/vol/vacuum")
        assert out == {"vacuumed": [{"volume": vid, "ok": False}],
                       "ttl_expired": []}
        base1 = first.store.find_volume(vid).file_name()
        assert os.path.exists(base1 + ".cpd")
        assert os.path.exists(base1 + ".cpx")
        for vs in servers:
            assert vs.store.find_volume(vid).garbage_level() > 0.3
        out = hu.post_json(f"http://{m.url}/vol/vacuum")
        assert out == {"vacuumed": [{"volume": vid, "ok": True}],
                       "ttl_expired": []}
        for vs in servers:
            v = vs.store.find_volume(vid)
            assert v.garbage_level() == 0.0
            assert not os.path.exists(v.file_name() + ".cpd")
            for fid, data in live.items():
                assert hu.http_call("GET", f"http://{vs.url}/{fid}") == data
    finally:
        for vs in servers:
            vs.stop()
        m.stop()


def test_col_delete_keeps_a_volume_whose_delete_failed(tmp_path, monkeypatch,
                                                       torch_one_thread):
    """One holder refuses the delete of one volume of the collection.
    The JAX master drops the collection's layouts anyway, so the volume
    is no longer looked up even after its holder heartbeats (nothing
    changed, so no delta re-registers it). The port master keeps that
    volume's layout: it is still looked up, and a second
    ``collection.delete`` takes it."""
    seed_jax(monkeypatch, SEED)
    hu = _http()
    looked_up = {}
    for kind in ("ref", "port"):
        c = Cluster(kind, tmp_path, n=2)
        try:
            fids = [c.op.upload_data(c.master.url, b"x" * 1000,
                                     filename=f"c{i}", collection="gone")
                    for i in range(4)]
            vids = sorted({int(f.split(",")[0]) for f in fids})
            stuck = vids[0]
            holder = next(vs for vs in c.servers
                          if vs.store.find_volume(stuck) is not None)
            delete = holder.store.delete_volume
            monkeypatch.setattr(holder.store, "delete_volume",
                                lambda v: False if v == stuck
                                else delete(v))
            _settle(c)
            assert "deleted volumes" in c.shell(
                "collection.delete -collection gone")
            _settle(c)
            assert str(stuck) in c.volumes()
            looked_up[kind] = _status(
                f"http://{c.master.url}/dir/lookup?volumeId={stuck}")
            if kind == "port":
                monkeypatch.setattr(holder.store, "delete_volume", delete)
                c.shell("collection.delete -collection gone")
                _settle(c)
                assert str(stuck) not in c.volumes()
                assert _status(f"http://{c.master.url}/dir/lookup"
                               f"?volumeId={stuck}") == 404
        finally:
            c.stop()
    assert looked_up == {"ref": 404, "port": 200}


# -- the backup tools (the JAX test_backup_tools.py cases) --------------------

class Clock:
    """``time.time_ns`` stepping 1 us a call from a fixed start, and
    ``time.time`` reading it: needles written in the same order get the
    same stamps in both packages. A thread that was already running when
    the clock was made (a server loop an earlier test left in this
    process) reads it without moving it."""

    def __init__(self):
        self._foreign = set(threading.enumerate()) - \
            {threading.current_thread()}
        self.reset()

    def reset(self):
        self.n = 1_700_000_000_000_000_000

    def ns(self):
        if threading.current_thread() not in self._foreign:
            self.n += 1000
        return self.n

    def s(self):
        return self.n / 1e9


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time_ns", c.ns)
    monkeypatch.setattr(time, "time", c.s)
    return c


def _mods(kind):
    if kind == "ref":
        from seaweedfs_tpu.command import volume_tools as tools
        from seaweedfs_tpu.storage import volume_backup as vb
        from seaweedfs_tpu.storage.needle import Needle
        from seaweedfs_tpu.storage.volume import NotFound, Volume
    else:
        from seaweedfs_tpu_torch.command import volume_tools as tools
        from seaweedfs_tpu_torch.storage import volume_backup as vb
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.storage.volume import NotFound, Volume
    return SimpleNamespace(tools=tools, vb=vb, Needle=Needle,
                           NotFound=NotFound, Volume=Volume)


def _make(m, d, vid=7, count=20):
    os.makedirs(str(d), exist_ok=True)
    v = m.Volume(str(d), "", vid, create=True)
    for i in range(count):
        n = m.Needle(cookie=0x100 + i, id=i + 1,
                     data=bytes([i % 251]) * (100 + i))
        n.set_name(f"file-{i}.bin".encode())
        v.write_needle(n)
    return v


def _files(d):
    return {name: _sha(os.path.join(d, name))
            for name in sorted(os.listdir(d))}


def case_search(m, d):
    v = _make(m, d)
    stamps = [m.vb._read_append_at_ns(v, nv.offset) for _, nv in
              sorted(v.nm.items(), key=lambda kv: kv[1].offset)]
    assert stamps == sorted(stamps)
    last = m.vb.last_append_at_ns(v)
    assert last == stamps[-1]
    offsets = sorted(nv.offset for _, nv in v.nm.items())
    found = [m.vb.binary_search_append_at_ns(v, stamps[k] - 1)
             for k in (0, 5, 19)]
    assert found == [offsets[k] for k in (0, 5, 19)]
    end = m.vb.binary_search_append_at_ns(v, stamps[-1])
    assert end == v.size()
    v.close()
    return stamps, last, found, end


def case_tombstones(m, d):
    v = _make(m, d, count=10)
    before = m.vb.last_append_at_ns(v)
    for nid in (8, 9, 10):
        v.delete_needle(m.Needle(cookie=0x100 + nid - 1, id=nid))
    after = m.vb.last_append_at_ns(v)
    assert after > before
    v.close()
    return before, after, _files(d)


def case_tail_runs(m, d):
    src = _make(m, os.path.join(d, "src"), count=4)
    os.makedirs(os.path.join(d, "dst"))
    dst = m.Volume(os.path.join(d, "dst"), "", 7, create=True)
    first = m.vb.append_raw_records(dst, m.vb.read_incremental(src, 0))
    assert first[0] == 4
    src.delete_needle(m.Needle(cookie=0x100 + 1, id=2))
    delta = m.vb.read_incremental(src, first[1])
    second = m.vb.append_raw_records(dst, delta, first[1])
    assert second[0] == 1 and second[1] > first[1]
    with pytest.raises(m.NotFound):
        dst.read_needle(m.Needle(cookie=0x100 + 1, id=2))
    again = m.vb.append_raw_records(
        dst, m.vb.read_incremental(src, first[1]), second[1])
    assert again[0] == 0
    src.close()
    dst.close()
    return first, second, again, hashlib.sha256(delta).hexdigest(), \
        _files(os.path.join(d, "dst"))


def case_max_bytes(m, d):
    v = _make(m, d, count=6)
    full = m.vb.read_incremental(v, 0)
    page = m.vb.read_incremental(v, 0, max_bytes=len(full) // 2)
    assert 0 < len(page) < len(full)
    os.makedirs(os.path.join(d, "dst"))
    dst = m.Volume(os.path.join(d, "dst"), "", 7, create=True)
    applied, cursor = m.vb.append_raw_records(dst, page, 0)
    assert applied > 0
    rest = m.vb.read_incremental(v, cursor)
    applied2, _ = m.vb.append_raw_records(dst, rest, cursor)
    assert applied + applied2 == 6
    v.close()
    dst.close()
    return len(full), len(page), applied, applied2, \
        _files(os.path.join(d, "dst"))


def case_roundtrip(m, d):
    src = _make(m, os.path.join(d, "src"), count=5)
    os.makedirs(os.path.join(d, "dst"))
    dst = m.Volume(os.path.join(d, "dst"), "", 7, create=True)
    assert m.vb.append_raw_records(
        dst, m.vb.read_incremental(src, 0))[0] == 5
    for i in range(5):
        got = dst.read_needle(m.Needle(cookie=0x100 + i, id=i + 1))
        assert got.data == bytes([i % 251]) * (100 + i)
    since = m.vb.last_append_at_ns(dst)
    src.write_needle(m.Needle(cookie=0xAB, id=99, data=b"late-arrival"))
    src.delete_needle(m.Needle(cookie=0x100, id=1))
    delta = m.vb.read_incremental(src, since)
    applied = m.vb.append_raw_records(dst, delta, since)
    assert applied[0] == 2
    assert dst.read_needle(m.Needle(cookie=0xAB, id=99)).data == \
        b"late-arrival"
    with pytest.raises(m.NotFound):
        dst.read_needle(m.Needle(cookie=0x100, id=1))
    src.close()
    dst.close()
    return since, applied, _files(os.path.join(d, "dst"))


def case_garbage(m, d):
    v = _make(m, d, count=2)
    before = v.size()
    blob = m.vb.read_incremental(v, 0)
    with pytest.raises(Exception) as err:
        m.vb.append_raw_records(v, blob[:-3])
    assert v.size() == before
    v.close()
    return before, str(err.value), _files(d)


def case_fix(m, d):
    v = _make(m, d, count=12)
    v.delete_needle(m.Needle(cookie=0x100 + 3, id=4))
    want = {nid: (nv.offset, nv.size) for nid, nv in v.nm.items()}
    v.close()
    os.remove(os.path.join(d, "7.idx"))
    walked = m.tools.fix_volume(d, 7)
    v2 = m.Volume(d, "", 7)
    got = {nid: (nv.offset, nv.size) for nid, nv in v2.nm.items()}
    assert got == want
    v2.close()
    return walked, _files(d)


def case_export(m, d):
    v = _make(m, d, count=6)
    v.delete_needle(m.Needle(cookie=0x100 + 2, id=3))
    v.close()
    tar_path = os.path.join(d, "out.tar")
    listed = m.tools.export_volume(d, 7, tar_path=tar_path)
    assert len(listed) == 5
    with tarfile.open(tar_path) as tf:
        names = tf.getnames()
        assert "file-0.bin" in names and "file-2.bin" not in names
        assert tf.extractfile("file-4.bin").read() == bytes([4]) * 104
    return listed, _files(d)


def case_compact(m, d):
    v = _make(m, d, count=10)
    for i in range(5):
        v.delete_needle(m.Needle(cookie=0x100 + i, id=i + 1))
    v.close()
    out = m.tools.compact_volume(d, 7)
    assert out["after"] < out["before"]
    v2 = m.Volume(d, "", 7)
    assert v2.file_count() == 5
    assert v2.read_needle(m.Needle(cookie=0x100 + 7, id=8)).data == \
        bytes([7]) * 107
    v2.close()
    return out, _files(d)


def case_see(m, d):
    v = m.Volume(d, "", 9, create=True)
    n1 = m.Needle(id=1, cookie=0xAB, data=b"first")
    n1.set_name(b"a.txt")
    n1.set_mime(b"text/plain")
    v.write_needle(n1)
    v.write_needle(m.Needle(id=2, cookie=0xCD, data=b"second"))
    v.delete_needle(m.Needle(id=2, cookie=0xCD))
    v.close()
    with open(os.path.join(d, "9.dat"), "ab") as f:
        # a torn append: a whole header, a short body
        f.write(bytes.fromhex("000000ef0000000000000003000000ff") + b"x")
    out = io.StringIO()
    n_dat = m.tools.see_dat(os.path.join(d, "9.dat"), out=out)
    dat = out.getvalue()
    assert "superblock: version" in dat and "TORN" in dat
    assert "name 'a.txt'" in dat and "mime text/plain" in dat
    out = io.StringIO()
    n_idx = m.tools.see_idx(os.path.join(d, "9.idx"), out=out)
    assert "key 1 " in out.getvalue() and "tombstone" in out.getvalue()
    limited = io.StringIO()
    m.tools.see_dat(os.path.join(d, "9.dat"), out=limited, limit=1)
    return n_dat, dat, n_idx, out.getvalue(), limited.getvalue()


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backup_tools_match_jax(tmp_path, clock, case):
    got = {}
    for kind in ("ref", "port"):
        d = str(tmp_path / kind)
        os.makedirs(d)
        clock.reset()
        got[kind] = CASES[case](_mods(kind), d)
    assert got["port"] == got["ref"]


def test_volume_tools_cli_matches_jax(tmp_path, clock):
    """``python3 -m seaweedfs_tpu_torch.command.volume_tools`` prints what
    the JAX CLI's subcommands print, over copies of one volume."""
    from seaweedfs_tpu.command import cli
    from seaweedfs_tpu_torch.command import volume_tools
    m = _mods("port")
    v = _make(m, tmp_path / "files", count=8)
    for nid in (2, 5):
        v.delete_needle(m.Needle(cookie=0x100 + nid - 1, id=nid))
    v.close()
    printed = {}
    for kind in ("ref", "port"):
        d = str(tmp_path / kind)
        shutil.copytree(tmp_path / "files", d)
        lines = []
        for sub, flags in (
                ("see_idx", [os.path.join(d, "7.idx"), "-limit", "5"]),
                ("see_dat", [os.path.join(d, "7.dat")]),
                ("export", ["-dir", d, "-volumeId", "7", "-o",
                            os.path.join(d, "x.tar")]),
                ("fix", ["-dir", d, "-volumeId", "7"]),
                ("compact", ["-dir", d, "-volumeId", "7", "-method", "0"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                if kind == "port":
                    assert volume_tools.main([sub] + flags) == 0
                else:
                    ns = dict(dir=d, volumeId=7, collection="",
                              o=os.path.join(d, "x.tar"), method=0,
                              file=flags[0], offsetWidth=4,
                              limit=5 if sub == "see_idx" else 0)
                    getattr(cli, "cmd_" + sub.split("_")[0])(
                        argparse.Namespace(**ns))
            lines.append(out.getvalue().replace(d, "D"))
        printed[kind] = (lines, _files(d))
    assert printed["port"] == printed["ref"]


def _live_backup(kind, tmp_path):
    """The JAX live backup cases on one master and one server of
    ``kind``: a full backup, uploads, an incremental one, a compaction
    of the source, a full resync. The tool's answers, and each time
    the backup's files against the server's."""
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        master = MasterServer(port=0, volume_size_limit_mb=64,
                              pulse_seconds=1, vacuum_interval=0).start()
        vs = VolumeServer(port=0, directories=[str(tmp_path / "srv")],
                          master_url=master.url, pulse_seconds=1,
                          max_volume_counts=[10], ec_backend="numpy",
                          fast_port=-1).start()
    else:
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        master = MasterServer(port=0, volume_size_limit_mb=64,
                              pulse_seconds=1, seed=SEED,
                              repair_interval=0).start()
        vs = VolumeServer(port=0, directories=[str(tmp_path / "srv")],
                          master_url=master.url, pulse_seconds=1,
                          max_volume_counts=[10], device="cpu",
                          fast_port=-1).start()
    tools = _mods(kind).tools
    try:
        fids = [op.upload_data(master.url, f"payload-{i}".encode() * 50,
                               filename=f"f{i}") for i in range(8)]
        vid = int(fids[0].split(",")[0])
        bdir = str(tmp_path / "backup")
        v = vs.store.find_volume(vid)
        outs = [tools.backup_volume(master.url, vid, bdir)]
        same = [_sha(os.path.join(bdir, f"{vid}.dat")) == _sha(v.dat_path)]
        for i in range(6):
            op.upload_data(master.url, b"x" * 100, filename="late")
        fid = next(f for f in fids if int(f.split(",")[0]) == vid)
        assert op.delete_file(master.url, fid)
        outs.append(tools.backup_volume(master.url, vid, bdir))
        same.append(_sha(os.path.join(bdir, f"{vid}.dat"))
                    == _sha(v.dat_path))
        v.compact()
        v.commit_compact()
        outs.append(tools.backup_volume(master.url, vid, bdir))
        same.append(_sha(os.path.join(bdir, f"{vid}.dat"))
                    == _sha(v.dat_path))
        return outs, same
    finally:
        vs.stop()
        master.stop()


def test_live_backup_matches_jax(tmp_path, monkeypatch, torch_one_thread):
    seed_jax(monkeypatch, SEED)
    got = {kind: _live_backup(kind, tmp_path / kind)
           for kind in ("ref", "port")}
    assert got["port"] == got["ref"]
    outs, same = got["port"]
    assert [o["mode"] for o in outs] == ["full", "incremental", "full"]
    assert outs[1]["applied"] >= 1 and same == [True, True, True]


def test_master_cli_flags(tmp_path):
    """``python3 -m seaweedfs_tpu_torch.server.master`` with the JAX
    master's vacuum and maintenance flags: a maintenance line vacuums a
    volume of a server heartbeating to it."""
    import subprocess
    import sys
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.server.master",
         "-port", "0", "-pulseSeconds", "1", "-repairInterval", "0",
         "-vacuumIntervalSeconds", "0", "-garbageThreshold", "0.9",
         "-maintenanceScripts", "volume.vacuum -garbageThreshold 0.3",
         "-maintenanceIntervalSeconds", "0.2"],
        cwd=root, stdout=subprocess.PIPE, text=True)
    vs = None
    try:
        line = proc.stdout.readline()
        assert line.startswith("master listening on "), line
        murl = line.split()[-1]
        m = SimpleNamespace(url=murl)
        vs = VolumeServer(port=0, directories=[str(tmp_path / "v")],
                          master_url=murl, pulse_seconds=1,
                          max_volume_counts=[10], device="cpu",
                          fast_port=-1).start()
        vid, _, _ = _garbage(m, [vs])
        v = vs.store.find_volume(vid)
        assert wait_until(lambda: v.garbage_level() == 0.0, timeout=15), \
            "the maintenance line never vacuumed the volume"
        hu = _http()
        # -garbageThreshold is the manual /vol/vacuum's default: 0.9
        # leaves a volume with garbage alone
        _garbage(m, [vs], drop=2, rng_seed=1)
        out = hu.post_json(f"http://{murl}/vol/vacuum")
        assert out == {"vacuumed": [], "ttl_expired": []}
    finally:
        if vs is not None:
            vs.stop()
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
