"""The port's tier backends and tier moves against the JAX package's
(the JAX ``tests/test_tier.py`` cases, held between the packages).

- ``MemoryFile``, ``DirBackend`` and the registry behave alike, errors
  included (the counterpart exception of each package).
- Both packages' ``Volume``s are written from the same seeded needles
  (``append_at_ns`` given), so their .dat files are byte-equal; each is
  tiered onto its own ``dir`` backend: the uploaded object equals the
  .dat byte for byte, the .vif keys are equal (``modified_at`` aside),
  every needle read through ``RemoteFile`` equals the other package's
  read, a write raises ``VolumeError``, a cold reopen and a
  ``DiskLocation`` scan serve the tiered volume, and the download
  restores the .dat byte for byte; keep-local serves locally and stays
  frozen; a stale .vif (an object truncated or gone) refuses the load.
- ``volume.tier.upload`` / ``volume.tier.download`` through each
  package's shell on its own cluster (one seed, one clock; the port's
  servers on ``device="cpu"``): equal lines (servers by name), the
  public read path equal before, during and after.
- The port's ``S3Backend`` against the JAX package's own S3 gateway
  (``S3ApiServer`` over a ``FilerServer``), and against the port's:
  PUT, ranged GET, GET, HEAD, DELETE; the signature equal to the JAX
  ``authorization_header_v4``; a port volume tiered onto it reads back.

Every test clears both packages' process-global backend registries
around it. Tolerances: none."""

import os
import time

import numpy as np
import pytest

from test_torch_cluster import SEED, Cluster, _named, seed_jax  # noqa: F401

import seaweedfs_tpu.storage.backend as ref_backend
import seaweedfs_tpu_torch.storage.backend as backend


@pytest.fixture(autouse=True)
def _clean_registries():
    ref_backend.clear_backends()
    backend.clear_backends()
    yield
    ref_backend.clear_backends()
    backend.clear_backends()


def _packages():
    """(volume module, volume_tier module, Needle, DiskLocation) of each
    package: the JAX one first."""
    from seaweedfs_tpu.storage import volume as ref_volume
    from seaweedfs_tpu.storage import volume_tier as ref_tier
    from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLoc
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle
    from seaweedfs_tpu_torch.storage import volume, volume_tier
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import DiskLocation
    return ((ref_volume, ref_tier, RefNeedle, RefLoc),
            (volume, volume_tier, Needle, DiskLocation))


def _needles(seed, count):
    rng = np.random.default_rng(seed)
    return [(0x20 + i, i + 1, rng.bytes(int(rng.integers(40, 3000))))
            for i in range(count)]


def make_volume(pkg, dirname, vid, needles):
    volume, _, Needle, _ = pkg
    os.makedirs(str(dirname), exist_ok=True)
    v = volume.Volume(str(dirname), "", vid, create=True)
    for cookie, nid, data in needles:
        n = Needle(cookie=cookie, id=nid, data=data,
                   append_at_ns=1_700_000_000_000_000_000 + nid)
        n.set_name(f"t{nid}.bin".encode())
        v.write_needle(n)
    return v


def _read_all(pkg, v, needles):
    Needle = pkg[2]
    return [v.read_needle(Needle(cookie=c, id=nid)).data
            for c, nid, _ in needles]


def _vif(v):
    import json
    with open(v.file_name() + ".vif") as f:
        info = json.load(f)
    info["remote"].pop("modified_at")
    return info


def test_memory_file_roundtrip():
    got = []
    for mod in (ref_backend, backend):
        mf = mod.MemoryFile(b"hello")
        mf.seek(0, os.SEEK_END)
        pos = mf.tell()
        mf.write(b"!")
        mf.seek(1)
        got.append((pos, mf.read(), mf.name))
    assert got[0] == got[1] == (5, b"ello!", "<memory>")


def test_dir_backend_roundtrip(tmp_path):
    src = tmp_path / "x.bin"
    src.write_bytes(bytes(range(256)) * 7 + b"tail")
    results = []
    for name, mod in (("ref", ref_backend), ("port", backend)):
        b = mod.DirBackend("cold", str(tmp_path / f"{name}-tier"))
        out = tmp_path / f"{name}-y.bin"
        results.append((
            b.spec(), b.kind,
            b.upload_file(str(src), "a/x.bin"),
            b.size("a/x.bin"),
            b.read_range("a/x.bin", 250, 12),
            b.download_file("a/x.bin", str(out)),
            out.read_bytes() == src.read_bytes(),
            sorted(os.listdir(b.path))))
        b.delete("a/x.bin")
        b.delete("a/x.bin")          # a second delete is a no-op
        with pytest.raises(FileNotFoundError):
            b.read_range("a/x.bin", 0, 1)
        with pytest.raises(mod.BackendError) as e:
            b.size("a/x.bin")
        assert e.value.status == 404
    assert results[0] == results[1]
    assert results[1][2] == src.stat().st_size
    assert results[1][7] == ["a_x.bin"]


def test_registry(tmp_path):
    for mod in (ref_backend, backend):
        mod.configure_backends(
            {"dir": {"cold": {"path": str(tmp_path / "reg")}},
             "s3": {"default": {"endpoint": "127.0.0.1:1",
                                "bucket": "b"}}})
        assert mod.get_backend("dir.cold").kind == "dir"
        s3 = mod.get_backend("s3.default")
        assert (s3.kind, s3.endpoint, s3.region) == \
            ("s3", "http://127.0.0.1:1", "us-east-1")
        with pytest.raises(mod.BackendError):
            mod.get_backend("dir.other")
        with pytest.raises(mod.BackendError):
            mod.configure_backends({"ftp": {"x": {}}})
        mod.clear_backends()
        with pytest.raises(mod.BackendError):
            mod.get_backend("dir.cold")
    assert sorted(backend._KINDS) == sorted(ref_backend._KINDS)


def test_tier_upload_download_cycle(tmp_path, monkeypatch):
    needles = _needles(3, 12)
    pkgs = _packages()
    vols, reads = [], []
    for name, pkg, mod in zip(("ref", "port"), pkgs,
                              (ref_backend, backend)):
        mod.configure_backends(
            {"dir": {"cold": {"path": str(tmp_path / f"{name}-tier")}}})
        v = make_volume(pkg, tmp_path / f"{name}-vol", 3, needles)
        reads.append(_read_all(pkg, v, needles))
        vols.append(v)
    with open(vols[0].dat_path, "rb") as f:
        dat = f.read()
    with open(vols[1].dat_path, "rb") as f:
        assert f.read() == dat
    assert reads[0] == reads[1] == [d for _, _, d in needles]

    # one second for both uploads' modified_at, which the reopenings
    # below read back as last_modified
    pinned = float(int(time.time()))
    monkeypatch.setattr(time, "time", lambda: pinned)
    infos = []
    for name, pkg, v in zip(("ref", "port"), pkgs, vols):
        volume, tier, Needle, _ = pkg
        with pytest.raises(volume.VolumeError):
            tier.upload_dat(v, "dir.cold")       # must be readonly first
        v.readonly = True
        with pytest.raises(
                (ref_backend if name == "ref" else backend).BackendError):
            tier.upload_dat(v, "dir.nowhere")
        infos.append(tier.upload_dat(v, "dir.cold"))
        assert not os.path.exists(v.dat_path)
        with open(tmp_path / f"{name}-tier" / "3.dat", "rb") as f:
            assert f.read() == dat              # the object is the .dat
        with pytest.raises(volume.VolumeError):
            tier.upload_dat(v, "dir.cold")       # already remote
        with pytest.raises(volume.VolumeError):
            v.write_needle(Needle(cookie=1, id=99, data=b"x"))
        with pytest.raises(volume.VolumeError):
            v.delete_needle(Needle(cookie=0x20, id=1))
    for info in infos:
        info["remote"].pop("modified_at")
    assert infos[0] == infos[1]
    assert _vif(vols[0]) == _vif(vols[1])
    assert isinstance(vols[1].dat, backend.RemoteFile)
    got = [_read_all(pkg, v, needles) for pkg, v in zip(pkgs, vols)]
    assert got[0] == got[1] == reads[1]
    assert vols[1].size() == len(dat)
    for v in vols:
        v.close()

    # a cold boot finds the tiered volume through its .vif
    reopened = []
    for name, pkg in zip(("ref", "port"), pkgs):
        volume = pkg[0]
        v2 = volume.Volume(str(tmp_path / f"{name}-vol"), "", 3)
        assert v2.readonly
        reopened.append(v2)
    assert reopened[1].last_modified == reopened[0].last_modified
    got = [_read_all(pkg, v, needles) for pkg, v in zip(pkgs, reopened)]
    assert got[0] == got[1] == reads[1]

    outs = []
    for name, pkg, v in zip(("ref", "port"), pkgs, reopened):
        tier = pkg[1]
        outs.append(tier.download_dat(v, delete_remote=True))
        assert not os.path.exists(tier.vif_path(v))
        assert not os.path.exists(v.dat_path + ".tierdl")
        assert os.listdir(tmp_path / f"{name}-tier") == []
        with open(v.dat_path, "rb") as f:
            assert f.read() == dat
        with pytest.raises(pkg[0].VolumeError):
            tier.download_dat(v)                 # no remote tier left
    assert outs[0] == outs[1] == {"volume": 3, "size": len(dat)}
    got = [_read_all(pkg, v, needles) for pkg, v in zip(pkgs, reopened)]
    assert got[0] == got[1] == reads[1]
    for v in reopened:
        v.close()


def test_tier_upload_keep_local_serves_locally(tmp_path):
    needles = _needles(5, 4)
    results = []
    for name, pkg, mod in zip(("ref", "port"), _packages(),
                              (ref_backend, backend)):
        volume, tier, _, _ = pkg
        mod.configure_backends(
            {"dir": {"cold": {"path": str(tmp_path / f"{name}-tier")}}})
        v = make_volume(pkg, tmp_path / f"{name}-vol", 5, needles)
        v.readonly = True
        tier.upload_dat(v, "dir.cold", keep_local=True)
        assert os.path.exists(v.dat_path)
        assert not isinstance(v.dat, mod.RemoteFile)
        v.close()
        # the local .dat wins over the .vif, frozen so that the parked
        # copy cannot diverge
        v2 = volume.Volume(str(tmp_path / f"{name}-vol"), "", 5)
        assert not isinstance(v2.dat, mod.RemoteFile) and v2.readonly
        data = _read_all(pkg, v2, needles)
        # un-tiering only drops the pointer (and the parked object)
        out = tier.download_dat(v2, delete_remote=True)
        assert os.listdir(tmp_path / f"{name}-tier") == []
        assert not os.path.exists(tier.vif_path(v2))
        results.append((data, out))
        v2.close()
    assert results[0] == results[1]
    assert results[1][1]["already_local"] is True


def test_disk_location_discovers_tiered_volume(tmp_path):
    needles = _needles(9, 3)
    found = []
    for name, pkg, mod in zip(("ref", "port"), _packages(),
                              (ref_backend, backend)):
        _, tier, Needle, Loc = pkg
        mod.configure_backends(
            {"dir": {"cold": {"path": str(tmp_path / f"{name}-tier")}}})
        v = make_volume(pkg, tmp_path / f"{name}-vol", 9, needles)
        v.readonly = True
        tier.upload_dat(v, "dir.cold")
        v.close()
        # an orphaned .idx (neither .dat nor .vif) stays quarantined
        open(tmp_path / f"{name}-vol" / "4.idx", "wb").close()
        loc = Loc(str(tmp_path / f"{name}-vol"))
        loc.load_existing_volumes()
        assert sorted(loc.volumes) == [9]
        assert loc.load_volume(4) is None
        found.append(_read_all(pkg, loc.volumes[9], needles))
        loc.close()
    assert found[0] == found[1] == [d for _, _, d in needles]


@pytest.mark.parametrize("fault", ["truncated", "gone"])
def test_stale_vif_refuses_the_load(tmp_path, fault):
    needles = _needles(11, 3)
    for name, pkg, mod in zip(("ref", "port"), _packages(),
                              (ref_backend, backend)):
        volume, tier, _, _ = pkg
        mod.configure_backends(
            {"dir": {"cold": {"path": str(tmp_path / f"{name}-tier")}}})
        v = make_volume(pkg, tmp_path / f"{name}-vol", 2, needles)
        v.readonly = True
        tier.upload_dat(v, "dir.cold")
        v.close()
        obj = tmp_path / f"{name}-tier" / "2.dat"
        if fault == "truncated":
            with open(obj, "r+b") as f:
                f.truncate(obj.stat().st_size - 8)
        else:
            obj.unlink()
        with pytest.raises(volume.VolumeError,
                           match="is .* bytes but|unreachable"):
            volume.Volume(str(tmp_path / f"{name}-vol"), "", 2)


def _tier_flow(c, tier_dir, configure):
    """volume.tier.upload and .download of the volume one needle landed
    in, the needle read through the master before, between and after;
    the shell's lines with servers by name."""
    configure({"dir": {"cold": {"path": tier_dir}}})
    payload = b"tiered-payload" * 100
    fid = c.op.upload_data(c.master.url, payload, filename="t.bin")
    vid = int(fid.split(",")[0])
    for vs in c.servers:
        vs.heartbeat_once()
    names = c.names()
    names[str(vid)] = "V"
    reads = [c.op.read_file(c.master.url, fid)]
    lines = _named(c.shell(f"volume.tier.upload -volumeId {vid} "
                           f"-dest dir.cold"), names)
    reads.append(c.op.read_file(c.master.url, fid))
    holder = next(vs for vs in c.servers if vs.store.find_volume(vid))
    remote = not os.path.exists(holder.store.find_volume(vid).dat_path)
    lines += _named(c.shell(f"volume.tier.download -volumeId {vid}"),
                    names)
    lines += _named(c.shell(f"volume.tier.download -volumeId {vid}"),
                    names)
    reads.append(c.op.read_file(c.master.url, fid))
    return {"lines": lines, "reads": reads, "remote": remote,
            "tier": sorted(os.listdir(tier_dir))}


def test_shell_tier_upload_download(tmp_path, monkeypatch):
    seed_jax(monkeypatch, SEED)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_250_000_000)
    got = {}
    for kind, mod in (("ref", ref_backend), ("port", backend)):
        c = Cluster(kind, tmp_path, n=2)
        try:
            got[kind] = _tier_flow(c, str(tmp_path / f"{kind}-tier"),
                                   mod.configure_backends)
        finally:
            c.stop()
    assert got["port"] == got["ref"]
    assert got["port"]["reads"] == [b"tiered-payload" * 100] * 3
    assert got["port"]["remote"]
    lines = got["port"]["lines"]
    assert "-> dir.cold/" in lines[0] and "local again" in lines[1]
    assert lines[2] == "volume V: no replica is tiered"


def _s3_gateway(tmp_path, ak, sk, kind="ref"):
    """One package's S3 gateway over its filer, master and volume
    server (the port's on the CPU); returns (url, stop)."""
    if kind == "ref":
        from seaweedfs_tpu.s3.auth import Iam, Identity
        from seaweedfs_tpu.s3.s3_server import S3ApiServer
        from seaweedfs_tpu.server.filer_server import FilerServer
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        master = MasterServer(port=0, volume_size_limit_mb=64,
                              pulse_seconds=1).start()
        vol = VolumeServer(port=0, directories=[str(tmp_path / "s3-v0")],
                           master_url=master.url, pulse_seconds=1,
                           max_volume_counts=[20], ec_backend="numpy",
                           fast_port=-1).start()
    else:
        from seaweedfs_tpu_torch.s3.auth import Iam, Identity
        from seaweedfs_tpu_torch.s3.s3_server import S3ApiServer
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        master = MasterServer(port=0, volume_size_limit_mb=64,
                              pulse_seconds=1, repair_interval=0).start()
        vol = VolumeServer(port=0, directories=[str(tmp_path / "s3-v0")],
                           master_url=master.url, pulse_seconds=1,
                           max_volume_counts=[20], device="cpu",
                           fast_port=-1).start()
    filer = FilerServer(port=0, master_url=master.url).start()
    s3 = S3ApiServer(filer.filer, master.url, port=0,
                     iam=Iam([Identity("tier", ak, sk)])).start()

    def stop():
        s3.stop()
        filer.stop()
        vol.stop()
        master.stop()
    return s3.url, stop


def test_s3_signature_matches_jax():
    from seaweedfs_tpu.s3.auth import authorization_header_v4 as ref_sign
    headers = {"host": "127.0.0.1:8333",
               "x-amz-content-sha256": backend.EMPTY_SHA256,
               "x-amz-date": "20261018T010203Z",
               "range": "bytes=0-  15"}
    for path in ("/b/3.dat", "/pre/b/a%20b.dat", ""):
        args = ("GET", path, headers, backend.EMPTY_SHA256, "AK", "SK",
                "us-east-1", "s3", "20261018T010203Z")
        assert backend.authorization_header_v4(*args) == ref_sign(*args)


def test_s3_backend_against_jax_gateway(tmp_path):
    _s3_backend_round_trip(tmp_path, "ref")


def test_s3_backend_against_port_gateway(tmp_path):
    """The same round trip against the port's own gateway: the port's
    tier backend and S3 gateway, nothing of the JAX package on the
    wire."""
    _s3_backend_round_trip(tmp_path, "port")


def _s3_backend_round_trip(tmp_path, kind):
    ak, sk = "TIERKEY", "TIERSECRET"
    url, stop = _s3_gateway(tmp_path, ak, sk, kind)
    try:
        b = backend.S3Backend("default", f"http://{url}", "tier-bucket",
                              access_key=ak, secret_key=sk)
        ref = ref_backend.S3Backend("default", url, "tier-bucket",
                                    access_key=ak, secret_key=sk)
        b._request("PUT", "")                 # the bucket
        src = tmp_path / "vol.dat"
        payload = bytes(range(256)) * 64 + b"odd"
        src.write_bytes(payload)
        assert b.upload_file(str(src), "3.dat") == len(payload)
        assert b.size("3.dat") == ref.size("3.dat") == len(payload)
        assert b.read_range("3.dat", 256, 256) == bytes(range(256)) == \
            ref.read_range("3.dat", 256, 256)
        out = tmp_path / "back.dat"
        assert b.download_file("3.dat", str(out)) == len(payload)
        assert out.read_bytes() == payload
        b.delete("3.dat")
        for mod, client in ((backend, b), (ref_backend, ref)):
            with pytest.raises(mod.BackendError) as e:
                client.read_range("3.dat", 0, 16)
            assert e.value.status == 404
        bad = backend.S3Backend("default", url, "tier-bucket",
                                access_key=ak, secret_key="wrong")
        with pytest.raises(backend.BackendError) as e:
            bad.upload_file(str(src), "4.dat")
        assert e.value.status == 403

        # a port volume parked on the gateway reads back through it
        backend.configure_backends({"s3": {"default": {
            "endpoint": url, "bucket": "tier-bucket", "access_key": ak,
            "secret_key": sk}}})
        pkg = _packages()[1]
        needles = _needles(13, 6)
        v = make_volume(pkg, tmp_path / "vol", 6, needles)
        want = _read_all(pkg, v, needles)
        v.readonly = True
        info = pkg[1].upload_dat(v, "s3.default")
        assert info["remote"]["backend"] == "s3.default"
        assert isinstance(v.dat, backend.RemoteFile)
        assert _read_all(pkg, v, needles) == want
        v.close()
        v2 = pkg[0].Volume(str(tmp_path / "vol"), "", 6)
        assert _read_all(pkg, v2, needles) == want
        pkg[1].download_dat(v2, delete_remote=True)
        assert _read_all(pkg, v2, needles) == want
        with pytest.raises(backend.BackendError):
            b.size("6.dat")
        v2.close()
    finally:
        stop()


def test_remote_file_reads_and_refuses_writes(tmp_path):
    for mod in (ref_backend, backend):
        b = mod.DirBackend("cold", str(tmp_path / "t"))
        (tmp_path / "o.bin").write_bytes(b"0123456789")
        b.upload_file(str(tmp_path / "o.bin"), "o")
        rf = mod.RemoteFile(b, "o", 10)
        assert rf.name == "dir.cold/o"
        assert rf.seek(0, os.SEEK_END) == 10 and rf.read() == b""
        rf.seek(-4, os.SEEK_END)
        assert rf.read(2) == b"67" and rf.tell() == 8
        rf.seek(-3, os.SEEK_CUR)
        assert rf.read(100) == b"56789"
        rf.seek(2)
        assert rf.read() == b"23456789"
        for call in (lambda: rf.write(b"x"), lambda: rf.truncate(1)):
            with pytest.raises(mod.BackendError):
                call()
        rf.flush()
        rf.close()


def test_volume_server_tier_config_flag(tmp_path):
    """``python -m seaweedfs_tpu_torch.server.volume_server -tierConfig
    tier.json`` configures its process's backends: the tier routes move a
    volume onto the named ``dir`` backend and back, with the JAX
    handlers' status codes (404 an unknown volume, 400 a writable one or
    an unknown backend, 400 "no remote tier")."""
    import http.client
    import json
    import subprocess
    import sys
    needles = _needles(17, 5)
    pkg = _packages()[1]
    make_volume(pkg, tmp_path / "vol", 7, needles).close()
    cfg = tmp_path / "tier.json"
    cfg.write_text(json.dumps({"dir": {"cold": {"path":
                                                str(tmp_path / "cold")}}}))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.server.volume_server",
         "--dir", str(tmp_path / "vol"), "--port", "0", "--device", "cpu",
         "--scrub-idle-s", "0", "-tierConfig", str(cfg), "-fastPort", "-1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)

    def call(path, method="POST"):
        host, port = url.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        try:
            conn.request(method, path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        line = proc.stdout.readline()
        assert line.startswith("listening "), line + proc.stdout.read()
        url = line.split()[1]
        up = "/admin/volume/tier_upload?volume=7&dest=dir.cold"
        assert call("/admin/volume/tier_upload?volume=9&dest=dir.cold")[0] \
            == 404
        status, body = call(up)
        assert status == 400 and b"readonly" in body
        assert call("/admin/volume/readonly?volume=7")[0] == 200
        status, body = call(
            "/admin/volume/tier_upload?volume=7&dest=dir.nowhere")
        assert status == 400 and b"not configured" in body
        status, body = call(up)
        assert status == 200, body
        info = json.loads(body)
        assert info["remote"]["backend"] == "dir.cold" and \
            info["remote"]["key"] == "7.dat"
        assert os.listdir(tmp_path / "cold") == ["7.dat"]
        assert not (tmp_path / "vol" / "7.dat").exists()
        cookie, nid, data = needles[2]
        status, body = call(f"/7,{nid:x}{cookie:08x}", "GET")
        assert (status, body) == (200, data)
        status, body = call("/admin/volume/tier_download?volume=7"
                            "&delete_remote=true")
        assert status == 200 and json.loads(body)["volume"] == 7
        assert os.listdir(tmp_path / "cold") == []
        status, body = call("/admin/volume/tier_download?volume=7")
        assert status == 400 and b"no remote tier" in body
        assert call(f"/7,{nid:x}{cookie:08x}", "GET") == (200, data)
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
