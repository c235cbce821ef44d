"""The port's volume server on the needle data plane against the JAX
package's (CPU, a volume of about 1.2 MiB, so that its last needles lie in
EC shard 1).

Both servers answer the same requests, in order, over HTTP on localhost:
create a volume; needle POSTs and PUTs (multipart and raw bodies, the
name, the mime guessed from the name or given, octet-stream kept, ``ts``,
``ttl``, Seaweed-* pairs, their 64 KB 400, the size limit's 413, an empty
body, a wrong cookie, an unknown volume); GET and HEAD, Range (206 and
416), If-None-Match and If-Modified-Since (304), wrong cookies, unknown
keys and volumes, an expired TTL (served again from the EC volume, whose
read checks none, by both); DELETE; the vacuum (check, compact,
commit); readonly, ``/admin/ec/generate``, mount and delete_volume in the
order ``ec.encode`` uses; GETs from the EC volume; unmount and mount;
``/admin/ec/delete_shards`` of shard 1, then GETs through the lost shard
(reconstructed by each server's degraded-read engine); the query form of
``/admin/ec/rebuild`` and the mount of the rebuilt shard; an EC DELETE.
Status, JSON, body and the Etag, Content-Type, Content-Length,
Last-Modified, Content-Range, Content-Disposition, Accept-Ranges and
Seaweed-* headers must be equal on every reply (the rebuild's ``stats``,
timings, and the JAX ``trace_id`` aside: the port has no tracing). Then
the shard files, the .ecx and the .vif must be equal, and the .ecj: the
JAX package removes the .ecj in the rebuild and journals the later EC
delete into the unlinked file, the port into a new .ecj (ROADMAP §3).

Both servers heartbeat one fake master and ask it for EC shard locations
and replicas (it lists none, so every survivor is local and no write or
delete goes to another server). The port runs on ``device="cpu"``, the
JAX one on its numpy codec. ``time.time_ns``, which v3 needles and
tombstones carry, is fixed for both; every write passes ``ts``.

Then both servers run with a master that does not answer (a closed
localhost port): every admin route that heartbeats (assign and delete a
volume, EC mount, unmount, delete_shards, to_volume) does its work and
answers 503 with the heartbeat's error, equal between the two; and
``/status`` (the store's heartbeat, the directories, and the
degraded-read and scrub counters) must be equal once each server's own
address and directory are taken out, and the degraded reads' measured
p50/p99 (the host/device split of their dispatches is each codec's:
their sum is held). Tolerances: none."""

import http.client
import json
import os
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.ec import to_ext
from seaweedfs_tpu_torch.server.http_util import (HttpError, HttpServer,
                                                  Router)
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.types import format_file_id

VID = 5
TS = 1_650_000_000            # every write's ?ts= (Last-Modified)
BOUNDARY = "b0undaryZ"
HEADERS = ("content-type", "content-length", "etag", "last-modified",
           "content-range", "content-disposition", "accept-ranges")


def _fake_master():
    """Answers a JAX volume server's heartbeats and lookups with empty
    maps; its vid-map watch gets a 404 and parks."""
    def fallback(req):
        if req.path == "/cluster/watch":
            raise HttpError(404, "no watch here")
        return {}
    router = Router()
    router.set_fallback(fallback)
    return HttpServer(0, router).start()


@pytest.fixture
def servers(tmp_path, monkeypatch):
    import torch
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    master = _fake_master()
    murl = f"127.0.0.1:{master.port}"
    ref = RefVolumeServer(port=0, directories=[str(tmp_path / "ref")],
                          master_url=murl, ec_backend="numpy", fast_port=-1,
                          file_size_limit_mb=1).start()
    port = VolumeServer(port=0, directories=[str(tmp_path / "port")],
                        device="cpu", master_url=murl,
                        file_size_limit_mb=1).start()
    yield ref, port, tmp_path
    port.stop()
    ref.stop()
    master.stop()
    torch.set_num_threads(threads)


def _call(url, method, path, body=None, headers=None):
    """(status, {header: value} of HEADERS and Seaweed-*, body or JSON)
    on a fresh connection."""
    host, p = url.split(":")
    conn = http.client.HTTPConnection(host, int(p), timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        got = {k.lower(): v for k, v in resp.getheaders()
               if k.lower() in HEADERS or k.lower().startswith("seaweed-")}
    finally:
        conn.close()
    # JSON answers: the admin routes, writes and deletes, and errors; a
    # needle GET returns its bytes whatever their type
    if got.get("content-type") == "application/json" and data and (
            method not in ("GET", "HEAD") or resp.status >= 400):
        data = json.loads(data)
    return resp.status, got, data


def _multipart(filename, ctype, data):
    part = f'Content-Disposition: form-data; name="file"; ' \
           f'filename="{filename}"\r\n'
    if ctype:
        part += f"Content-Type: {ctype}\r\n"
    body = (f"--{BOUNDARY}\r\n{part}\r\n").encode() + data + \
        f"\r\n--{BOUNDARY}--\r\n".encode()
    return body, {"Content-Type":
                  f"multipart/form-data; boundary={BOUNDARY}"}


class _Both:
    """Sends each request to both servers and holds the replies equal."""

    def __init__(self, ref, port):
        self.urls = (ref.url, port.url)
        self.log = []

    def __call__(self, method, path, body=None, headers=None, want=None,
                 compare=None):
        ref, got = (_call(u, method, path, body, headers)
                    for u in self.urls)
        if compare is not None:
            ref, got = compare(ref), compare(got)
        assert got == ref, (method, path)
        if want is not None:
            assert got[0] == want, (method, path, got)
        self.log.append((method, path, got[0]))
        return got


def _needles(rng):
    """(fid, how, filename, ctype, data, query, headers)."""
    fid = lambda key, cookie: "/" + format_file_id(VID, key, cookie)
    big = lambda n: rng.bytes(n)
    now = int(time.time())
    return [
        (fid(1, 0x11), "mp", "a.txt", "", big(3000), f"ts={TS}", {}),
        (fid(2, 0x22), "mp", "b.png", "image/png", big(700),
         f"ts={TS}", {"Seaweed-Color": "red", "Seaweed-Owner": "x"}),
        (fid(3, 0x33), "mp", "c.bin", "application/octet-stream", big(5),
         f"ts={TS}", {}),
        (fid(4, 0x44), "raw", "", "application/json", b'{"k": [1, 2]}',
         f"ts={TS}", {}),
        (fid(5, 0x55), "raw", "", "", big(129), f"ts={TS}", {}),
        (fid(6, 0x66), "mp", "expired.txt", "", big(64),
         f"ts={TS}&ttl=3m", {}),
        (fid(7, 0x77), "mp", "fresh.txt", "", big(64),
         f"ts={now}&ttl=3m", {}),
        (fid(8, 0x88), "put", "put.txt", "text/plain", big(90),
         f"ts={TS}", {}),
        (fid(0x1a2b3c, 0xdeadbeef), "mp", "big1.dat", "application/x-big",
         big(600_000), f"ts={TS}", {}),
        (fid(0x1a2b3d, 0xdeadbeef), "mp", "big2.dat", "", big(500_000),
         f"ts={TS}", {"Seaweed-Part": "2"}),
        (fid(11, 0xBB), "mp", "q\"uote.txt", "", big(40), f"ts={TS}", {}),
    ]


def _post(both, fid, how, filename, ctype, data, query, headers):
    if how == "raw":
        hdrs = dict(headers)
        if ctype:
            hdrs["Content-Type"] = ctype
        return both("POST", f"{fid}?{query}", data, hdrs)
    body, hdrs = _multipart(filename, ctype, data)
    hdrs.update(headers)
    return both("PUT" if how == "put" else "POST", f"{fid}?{query}", body,
                hdrs)


def _reads(both, needles, deleted=(), expired=()):
    for fid, _, _, _, data, _, _ in needles:
        status, hdrs, body = both("GET", fid)
        if fid in deleted or fid in expired:
            assert status == 404
            continue
        assert status == 200 and body == data
        assert both("HEAD", fid)[2] == b""
    live = [n for n in needles if n[0] not in deleted and n[0] not in expired]
    fid, data = live[0][0], live[0][4]
    etag = both("GET", fid)[1]["etag"]
    both("GET", fid, headers={"Range": "bytes=10-99"}, want=206)
    both("GET", fid, headers={"Range": "bytes=-5"}, want=206)
    both("GET", fid, headers={"Range": "bytes=999999999-"}, want=416)
    both("GET", fid, headers={"If-None-Match": etag}, want=304)
    both("GET", fid, headers={"If-None-Match": f"W/{etag}, \"x\""}, want=304)
    both("GET", fid, headers={"If-None-Match": "*"}, want=304)
    both("GET", fid, headers={"If-None-Match": '"0000"'}, want=200)
    both("GET", fid, headers={
        "If-Modified-Since": "Wed, 01 Jan 2031 00:00:00 GMT"}, want=304)
    both("GET", fid, headers={
        "If-Modified-Since": "Wed, 01 Jan 2020 00:00:00 -0000"}, want=200)
    both("GET", fid, headers={"If-Modified-Since": "yesterday"}, want=200)
    both("GET", live[-2][0], headers={"Range": "bytes=499990-500010"},
         want=206)


def test_data_plane_matches_jax(servers):
    ref, port, root = servers
    both = _Both(ref, port)
    rng = np.random.default_rng(23)
    both("POST", f"/admin/assign_volume?volume={VID}&replication=000",
         want=200)
    both("POST", "/admin/assign_volume?volume=6&replication=0x1", want=500)
    needles = _needles(rng)
    for fid, how, name, ctype, data, query, headers in needles:
        status, _, out = _post(both, fid, how, name, ctype, data, query,
                               headers)
        assert status == 200 and out["size"] == len(data), (fid, out)
    # refused writes
    pairs = {f"Seaweed-P{i}": "v" * 25_000 for i in range(3)}
    _post(both, "/5,0901010101", "mp", "p.txt", "", b"xyz", f"ts={TS}",
          pairs)
    both("POST", f"/5,0a01010101?ts={TS}", b"z" * (1200 << 10),
         want=413)
    both("POST", f"/5,0b01010101?ts={TS}", b"", want=500)
    both("POST", f"/77,0b01010101?ts={TS}", b"abc", want=500)
    both("POST", f"/5,0100000099?ts={TS}", b"wrong cookie", want=500)
    both("PATCH", "/5,0100000011")
    assert both.log[-6][2] == 400
    expired = {needles[5][0]}
    _reads(both, needles, expired=expired)
    for path in ("/5,0100000012", "/5,ff00000011", "/99,0100000011",
                 "/favicon.ico", "/5,1"):
        both("GET", path, want=404)

    # deletes, then the vacuum
    deleted = {needles[3][0], needles[10][0]}
    for fid in deleted:
        both("DELETE", fid, want=200)
    both("DELETE", "/5,0200000099", want=500)
    both("DELETE", "/5,7700000011", want=200)
    both("DELETE", "/88,7700000011", want=404)
    _reads(both, needles, deleted, expired)
    garbage = both("POST", f"/admin/vacuum/check?volume={VID}")[2]
    assert garbage["garbage"] > 0
    both("POST", f"/admin/vacuum/compact?volume={VID}", want=200)
    both("POST", f"/admin/vacuum/commit?volume={VID}", want=200)
    assert both("POST", f"/admin/vacuum/check?volume={VID}")[2][
        "garbage"] == 0
    both("POST", "/admin/vacuum/check?volume=42", want=404)
    _reads(both, needles, deleted, expired)

    # ec.encode: freeze, encode here, mount, drop the plain volume
    both("POST", f"/admin/volume/readonly?volume={VID}", want=200)
    both("POST", f"/5,0c01010101?ts={TS}", b"frozen", want=500)
    both("POST", f"/admin/ec/generate?volume={VID}", want=200)
    all14 = ",".join(map(str, range(14)))
    both("POST", f"/admin/ec/mount?volume={VID}&shards={all14}", want=200)
    both("POST", f"/admin/delete_volume?volume={VID}", want=200)
    both("POST", f"/admin/delete_volume?volume={VID}", want=404)
    # an EC volume's read checks no TTL: both serve the expired needle
    expired = ()
    _reads(both, needles, deleted, expired)
    both("POST", f"/admin/ec/unmount?volume={VID}&shards=13", want=200)
    both("POST", f"/admin/ec/mount?volume={VID}&shards=13", want=200)

    # shard 1 lost: its needles are reconstructed on read
    out = both("POST", f"/admin/ec/delete_shards?volume={VID}&shards=1")
    assert out[2]["removed"] == [1]
    _reads(both, needles, deleted, expired)
    assert port.degraded.snapshot()["reads"] > 0

    rebuilt = both("POST", f"/admin/ec/rebuild?volume={VID}",
                   compare=lambda r: (r[0], {k: v for k, v in r[2].items()
                                             if k in ("volume", "rebuilt")}))
    assert rebuilt[1]["rebuilt"] == [1]
    both("POST", f"/admin/ec/mount?volume={VID}&shards=1", want=200)
    reads = port.degraded.snapshot()["reads"]
    _reads(both, needles, deleted, expired)
    assert port.degraded.snapshot()["reads"] == reads

    # an EC delete: the .ecx tombstone and the journal
    gone = needles[1][0]
    both("DELETE", gone, want=200)
    both("GET", gone, want=404)
    both("DELETE", gone, want=200)           # found again: tombstoned
    both("DELETE", "/5,0900000022", want=404)

    ref_dir, port_dir = root / "ref", root / "port"
    for ext in [to_ext(i) for i in range(14)] + [".ecx", ".vif"]:
        with open(port_dir / f"{VID}{ext}", "rb") as f, \
                open(ref_dir / f"{VID}{ext}", "rb") as g:
            assert f.read() == g.read(), ext
    assert not (ref_dir / f"{VID}.ecj").exists()
    with open(port_dir / f"{VID}.ecj", "rb") as f:
        assert f.read() == (2).to_bytes(8, "big") * 2
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)
                                                  + [f"{VID}.ecj"])


def test_no_card_raises_unless_cpu(tmp_path):
    """A port server left on its default device ("cuda") on a machine
    with no card answers 500 with the device error on an encode, a GET
    through a lost shard and a rebuild: nothing falls back to the CPU.
    The same volume on a ``device="cpu"`` server does all three."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    d = str(tmp_path / "v")
    rng = np.random.default_rng(5)
    cpu = VolumeServer(port=0, directories=[d], device="cpu").start()
    try:
        for path in ("/admin/assign_volume?volume=3",
                     "/admin/assign_volume?volume=4"):
            assert _call(cpu.url, "POST", path)[0] == 200
        data = rng.bytes(5000)
        for vid in (3, 4):
            body, hdrs = _multipart("x.bin", "", data)
            assert _call(cpu.url, "POST", f"/{vid},0100000011?ts={TS}",
                         body, hdrs)[0] == 200
        for path in ("/admin/volume/readonly?volume=3",
                     "/admin/ec/generate?volume=3",
                     "/admin/ec/mount?volume=3&shards="
                     + ",".join(map(str, range(14))),
                     "/admin/delete_volume?volume=3",
                     "/admin/ec/delete_shards?volume=3&shards=0"):
            assert _call(cpu.url, "POST", path)[0] == 200, path
    finally:
        cpu.stop()
    card = VolumeServer(port=0, directories=[d]).start()   # device="cuda"
    try:
        assert _call(card.url, "POST",
                     "/admin/volume/readonly?volume=4")[0] == 200
        for method, path in (("GET", "/3,0100000011"),
                             ("POST", "/admin/ec/rebuild?volume=3"),
                             ("POST", "/admin/ec/generate?volume=4")):
            status, _, out = _call(card.url, method, path)
            assert status == 500 and "RuntimeError" in out["error"] and \
                "CUDA" in out["error"], (path, out)
        # what needs no codec still serves: a plain volume's needle
        assert _call(card.url, "GET", "/4,0100000011")[2] == data
    finally:
        card.stop()
    cpu = VolumeServer(port=0, directories=[d], device="cpu").start()
    try:
        assert _call(cpu.url, "GET", "/3,0100000011")[2] == data
        assert _call(cpu.url, "POST", "/admin/ec/rebuild?volume=3")[2][
            "rebuilt"] == [0]
    finally:
        cpu.stop()


def _own(obj, server, root, key=None):
    """JSON with a server's own address, port and directory taken out:
    its url and directory inside strings, and its port where a ``port``
    key carries it. Any other number is kept, one equal to the port
    too (a count or a shard mask is no address)."""
    if isinstance(obj, dict):
        return {k: _own(v, server, root, k) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_own(v, server, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(server.url, "SELF").replace(root, "DIR")
    if key == "port" and obj == server.port:
        return "PORT"
    return obj


def test_no_master_503_after_work_and_status(tmp_path, monkeypatch):
    """With a master that does not answer, the heartbeating admin routes
    do their work and answer 503, as the JAX server's; /status is the
    JAX server's."""
    import torch
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    gone = "127.0.0.1:1"
    dirs = (str(tmp_path / "ref"), str(tmp_path / "port"))
    ref = RefVolumeServer(port=0, directories=[dirs[0]], master_url=gone,
                          ec_backend="numpy", fast_port=-1).start()
    port = VolumeServer(port=0, directories=[dirs[1]], device="cpu",
                        master_url=gone).start()
    # the test configuration turns the JAX scrub's background pass off
    port.scrub.idle_s = ref.scrub.idle_s
    try:
        both = _Both(ref, port)

        def status():
            out = [_own(json.loads(_call(vs.url, "GET", "/status")[2]),
                        vs, d)
                   for vs, d in ((ref, dirs[0]), (port, dirs[1]))]
            for o in out:
                # measured latencies; and the host/device split is the
                # codec's (the JAX numpy codec runs every product on the
                # host), so the dispatches are held as a sum
                eng = o["ec_degraded"]
                del eng["p50_ms"], eng["p99_ms"]
                eng["dispatches"] = eng.pop("host_dispatches") + \
                    eng.pop("device_dispatches")
            assert out[1] == out[0]
            return out[1]

        assert status()["volumes"] == []
        # a number that equals a server's port is no address: kept
        for vs, d in ((ref, dirs[0]), (port, dirs[1])):
            reply = json.loads(_call(vs.url, "GET", "/status")[2])
            reply["ec_shards"] = {str(VID): vs.port}
            own = _own(reply, vs, d)
            assert (own["port"], own["public_url"], own["directories"]) \
                == ("PORT", "SELF", ["DIR"])
            assert own["ec_shards"] == {str(VID): vs.port}
        out = both("POST", f"/admin/assign_volume?volume={VID}"
                           f"&replication=000", want=503)
        assert "cluster/heartbeat" in out[2]["error"]
        assert port.store.find_volume(VID) is not None
        rng = np.random.default_rng(29)
        needles = _needles(rng)[:5] + _needles(rng)[8:10]
        for fid, how, name, ctype, data, query, headers in needles:
            assert _post(both, fid, how, name, ctype, data, query,
                         headers)[0] == 200
        both("DELETE", needles[2][0], want=200)
        assert [v["file_count"] for v in status()["volumes"]] == [7]
        both("POST", f"/admin/volume/readonly?volume={VID}", want=200)
        both("POST", f"/admin/ec/generate?volume={VID}", want=200)
        all14 = ",".join(map(str, range(14)))
        both("POST", f"/admin/ec/mount?volume={VID}&shards={all14}",
             want=503)
        both("POST", f"/admin/delete_volume?volume={VID}", want=503)
        assert status()["ec_shards"] == {str(VID): (1 << 14) - 1}
        both("POST", f"/admin/ec/unmount?volume={VID}&shards=13", want=503)
        both("POST", f"/admin/ec/delete_shards?volume={VID}&shards=1",
             want=503)
        _reads(both, needles, deleted={needles[2][0]})
        assert status()["ec_degraded"]["reads"] > 0
        both("POST", f"/admin/ec/mount?volume={VID}&shards=13", want=503)
        both("POST", f"/admin/ec/to_volume?volume={VID}", want=409)
        both("POST", f"/admin/ec/rebuild?volume={VID}", want=200,
             compare=lambda r: (r[0], r[2]["rebuilt"]))
        both("POST", f"/admin/ec/mount?volume={VID}&shards=1", want=503)
        both("POST", f"/admin/ec/to_volume?volume={VID}", want=503)
        both("POST", "/admin/ec/to_volume?volume=42", want=404)
        after = status()
        assert after["ec_shards"] == {} and \
            [v["id"] for v in after["volumes"]] == [VID]
        _reads(both, needles, deleted={needles[2][0]})
    finally:
        port.stop()
        ref.stop()
        torch.set_num_threads(threads)
