"""The port's native data plane (server/native_plane over
csrc/http_plane.cc) against the JAX package's, on the CPU.

* The ABI: every function csrc/http_plane.cc exports is bound, the
  exports are the JAX library's, and the latency buckets are
  ``stats/metrics.PLANE_LAT_BUCKETS_S`` and the JAX plane's.
* Replies and bytes: a JAX and a port VolumeServer, each with its plane
  (one fake master, ``time.time_ns`` fixed), take the same writes: plain
  multipart POSTs to the plane (appended by the plane under the write
  lease), POSTs with ``?ts=`` to the plane (redirected 307, then
  appended by Python through the lease), a POST with a Seaweed-* pair,
  DELETEs on both ports. The .idx files are equal, and so are the .dat
  files, but for the modified time and append stamp the plane gives its
  own records. GET, HEAD, Range and conditional GETs of the plane equal
  the JAX plane's (status, body, the headers of the JAX TestParity) and
  the port's Python server's.
* The lease: readonly, a vacuum with writes between its phases, a cold
  restart, replicated and write-token volumes; each server's .dat and
  .idx equal after the same Python writes.
* The slab cache: one sequence of puts and invalidations on both
  packages' planes, equal counts after each step, under the budget.
* Degraded serving: a volume encoded and its shard 0 lost on each
  server; cold GETs through the plane redirect and are reconstructed on
  the CPU codec (numpy on the JAX side), warm ones are served in the
  plane with no Python read; the cache counts equal.
* Durability: ``always`` fsyncs once per append on both, ``group``
  amortizes concurrent appends, and a Python append fdatasyncs the .dat
  and .idx once each under the knob and never with it off, as JAX's.
Tolerances: none."""

import http.client
import json
import os
import re
import threading
import time
from pathlib import Path

import pytest

from seaweedfs_tpu_torch.server import native_plane
from seaweedfs_tpu_torch.server.http_util import (HttpError, HttpServer,
                                                  Router, http_call,
                                                  http_get_with_headers)
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.types import (TOMBSTONE_FILE_SIZE,
                                               format_file_id)

ROOT = Path(__file__).resolve().parents[1]
VID = 6
TS = 1_650_000_000
BOUNDARY = "planeboundary"
PARITY_HEADERS = ("content-type", "etag", "content-disposition",
                  "content-range", "accept-ranges", "last-modified")
DURABILITY = ("SW_PLANE_FSYNC_MODE", "SW_PLANE_FSYNC_BATCH_US",
              "SW_PLANE_FSYNC_MAX_PENDING", "SW_PLANE_CACHE_BYTES")


def _fake_master():
    """Answers heartbeats and lookups with empty maps (every survivor
    local, no replica); a watch gets a 404."""
    def fallback(req):
        if req.path == "/cluster/watch":
            raise HttpError(404, "no watch here")
        return {}
    router = Router()
    router.set_fallback(fallback)
    return HttpServer(0, router).start()


def _raw(hostport, method, path, body=None, headers=None):
    """(status, lowercased headers, body) on a fresh connection, no
    redirect followed."""
    host, port = hostport.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def _multipart(filename, data, ctype="application/octet-stream"):
    body = (f"--{BOUNDARY}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="{filename}"\r\n'
            f"Content-Type: {ctype}\r\n\r\n").encode() + data + \
        f"\r\n--{BOUNDARY}--\r\n".encode()
    return body, {"Content-Type":
                  f"multipart/form-data; boundary={BOUNDARY}"}


def _post(hostport, path, filename, data, ctype="application/octet-stream",
          extra=None, follow=True):
    body, headers = _multipart(filename, data, ctype)
    headers.update(extra or {})
    st, h, out = _raw(hostport, "POST", path, body, headers)
    if st == 307 and follow:
        loc = h["location"].split("//", 1)[1]
        target, rest = loc.split("/", 1)
        st, h, out = _raw(target, "POST", "/" + rest, body, headers)
    return st, out


def _fid(key, cookie=0x1234ABCD):
    return format_file_id(VID, key, cookie)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """A JAX and a port VolumeServer, each with its plane, over one fake
    master, with ``time.time_ns`` fixed."""
    import torch
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    for knob in DURABILITY:
        monkeypatch.delenv(knob, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    master = _fake_master()
    murl = f"127.0.0.1:{master.port}"
    ref = RefVolumeServer(port=0, directories=[str(tmp_path / "ref")],
                          master_url=murl, ec_backend="numpy").start()
    port = VolumeServer(port=0, directories=[str(tmp_path / "port")],
                        device="cpu", master_url=murl).start()
    assert ref.fast_plane is not None and port.fast_plane is not None
    yield ref, port
    port.stop()
    ref.stop()
    master.stop()
    torch.set_num_threads(threads)


def _files(vs, vid=VID):
    v = vs.store.find_volume(vid)
    with open(v.dat_path, "rb") as f:
        dat = f.read()
    with open(v.idx_path, "rb") as f:
        idx = f.read()
    return dat, idx


def _records(dat, version=3):
    """(offset, id, cookie, size, data, name, mime, pairs, flags) of each
    record of a .dat, and its last-modified and append stamp apart."""
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    out, off = [], SUPER_BLOCK_SIZE
    while off + 16 <= len(dat):
        head = Needle.parse_header(dat[off:off + 16])
        size = 0 if head.size == TOMBSTONE_FILE_SIZE else head.size
        actual = get_actual_size(size, version)
        n = Needle.from_bytes(dat[off:off + actual], version,
                              verify_crc=False)
        out.append(((off, n.id, n.cookie, head.size, n.data, n.name,
                     n.mime, n.pairs, n.flags),
                    (n.last_modified, n.append_at_ns)))
        off += actual
    return out


# -- the ABI ----------------------------------------------------------------

def _exports(cc: Path):
    src = cc.read_text(encoding="utf-8")
    block = src[src.index('extern "C" {'):]
    return set(re.findall(r'^[A-Za-z_][A-Za-z0-9_* ]*?\b(swhp_[a-z0-9_]+)\s*\(',
                          block, re.M))


def test_abi_manifest_complete_and_bound():
    from seaweedfs_tpu.server import native_plane as ref_plane
    lib = native_plane._load()
    assert lib is not None and not native_plane.build_failed()
    bound = {name for name, _, _ in native_plane.ABI}
    assert all(hasattr(lib, name) for name in bound)
    assert _exports(native_plane.SOURCE) == bound
    assert _exports(ROOT / "seaweedfs_tpu/server/native/http_plane.cc") \
        == bound
    bounds = native_plane.lat_bounds_us()
    assert bounds == tuple(round(b * 1e6)
                           for b in metrics.PLANE_LAT_BUCKETS_S)
    assert bounds == ref_plane.lat_bounds_us()
    assert "seaweedfs_tpu/server/native" not in \
        native_plane.SOURCE.read_text(encoding="utf-8")


# -- replies and bytes ------------------------------------------------------

def test_plane_writes_and_replies_match_jax(pair):
    ref, port = pair
    for vs in pair:
        assert http_call("POST", f"http://{vs.url}/admin/assign_volume"
                                 f"?volume={VID}")
        assert vs.store.find_volume(VID).fast_writer is not None
    writes = [
        # (key, filename, data, ctype, query, headers): "" query = the
        # plane appends; ?ts= redirects and Python appends via the lease
        (1, "plain.bin", b"hello-plane" * 300, "application/octet-stream",
         "", None),
        (2, "named.txt", b"x" * 4097, "text/plain", "", None),
        (3, "stamped.bin", bytes(range(256)) * 40, "application/octet-stream",
         f"?ts={TS}", None),
        (4, 'we"ird.txt', b"quoted" * 50, "text/plain", f"?ts={TS}", None),
        (5, "paired.bin", b"pairs" * 100, "application/octet-stream",
         f"?ts={TS}", {"Seaweed-Tag": "v1"}),
        (6, "doomed.bin", b"doomed" * 64, "application/octet-stream", "",
         None),
        (7, "also.bin", b"also" * 99, "application/octet-stream",
         f"?ts={TS}", None),
    ]
    for key, name, data, ctype, query, extra in writes:
        replies = [_post(vs.fast_url, f"/{_fid(key)}{query}", name, data,
                         ctype, extra) for vs in pair]
        assert replies[0] == replies[1]
        assert replies[1][0] == 200, replies[1]
    # a plain POST to the plane is served there, a query is redirected
    body, headers = _multipart("q", b"q")
    assert _raw(port.fast_url, "POST", f"/{_fid(9)}?ts={TS}", body,
                headers)[0] == 307
    # DELETEs: on the plane (a plane tombstone) and on Python (a
    # delegated append)
    for path, where in ((f"/{_fid(6)}", "fast_url"), (f"/{_fid(7)}", "url")):
        got = [_raw(getattr(vs, where), "DELETE", path)[:3:2] for vs in pair]
        assert got[0] == got[1] and got[1][0] == 200
    assert port.fast_plane.written == ref.fast_plane.written >= 3
    (ref_dat, ref_idx), (dat, idx) = _files(ref), _files(port)
    assert idx == ref_idx
    ref_recs, recs = _records(ref_dat), _records(dat)
    assert [r for r, _ in recs] == [r for r, _ in ref_recs]
    # the records Python appended carry the fixed clock on both sides
    for (r, stamps), (_, ref_stamps) in zip(recs, ref_recs):
        if stamps[0] == TS:
            assert stamps == ref_stamps
    assert sum(s[0] == TS for _, s in recs) >= 4
    # reads: the port plane against the JAX plane (needles Python wrote,
    # whose Last-Modified is the fixed ?ts=) and against its own Python
    for key in (1, 2, 3, 4, 5, 7, 404):
        path = f"/{_fid(key)}"
        for headers in (None, {"Range": "bytes=3-40"}, {"Range": "bytes=-7"},
                        {"If-None-Match": '"nope", W/"x"'}):
            for method in ("GET", "HEAD"):
                fast = _raw(port.fast_url, method, path, None, headers)
                py = _raw(port.url, method, path, None, headers)
                if fast[0] == 307:   # pairs, a miss: Python answers
                    fast = py
                assert fast[0] == py[0]
                if py[0] < 400:
                    assert fast[2] == py[2]
                    for h in PARITY_HEADERS:
                        assert fast[1].get(h) == py[1].get(h), (key, h)
                if key in (3, 4, 5, 7, 404):
                    theirs = _raw(ref.fast_url, method, path, None, headers)
                    if theirs[0] == 307:
                        theirs = _raw(ref.url, method, path, None, headers)
                    assert fast[0] == theirs[0], (key, headers)
                    if fast[0] < 400:
                        assert fast[2] == theirs[2]
                        for h in PARITY_HEADERS:
                            assert fast[1].get(h) == theirs[1].get(h)
    etag = _raw(port.fast_url, "GET", f"/{_fid(3)}")[1]["etag"]
    got = [_raw(vs.fast_url, "GET", f"/{_fid(3)}", None,
                {"If-None-Match": etag})[0] for vs in pair]
    assert got == [304, 304]
    # a cookie that does not match is 404 on both planes
    wrong = format_file_id(VID, 1, 0x0BAD0BAD)
    assert [_raw(vs.fast_url, "GET", f"/{wrong}")[0] for vs in pair] == \
        [404, 404]
    assert port.fast_plane.served > 0
    view = json.loads(_raw(port.url, "GET", "/status")[2])
    assert view["fast_plane"]["url"] == port.fast_url


def test_lease_follows_the_volume(pair, tmp_path):
    """readonly takes the lease back and thawing gives it out again; a
    vacuum with a write between its phases; replicated volumes and a
    server with write tokens get none; after a cold restart the port's
    counters are the lease's. Every write here goes through Python with
    ``?ts=``, so both servers' files are byte-equal."""
    ref, port = pair
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID + 1}&replication=001")
        assert vs.store.find_volume(VID + 1).fast_writer is None

    def write(key, data):
        for vs in pair:
            assert _post(vs.url, f"/{_fid(key)}?ts={TS}", "g", data)[0] \
                == 200

    for i in range(1, 13):
        write(i, f"gen-{i}".encode() * (20 + i))
    for i in range(2, 13, 2):
        for vs in pair:
            http_call("DELETE", f"http://{vs.url}/{_fid(i)}")
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/volume/readonly"
                          f"?volume={VID}")
        assert vs.store.find_volume(VID).fast_writer is None
        body, headers = _multipart("r", b"r")
        assert _raw(vs.fast_url, "POST", f"/{_fid(40)}", body,
                    headers)[0] == 307
        http_call("POST", f"http://{vs.url}/admin/volume/readonly"
                          f"?volume={VID}&readonly=false")
        assert vs.store.find_volume(VID).fast_writer is not None
        http_call("POST", f"http://{vs.url}/admin/vacuum/compact"
                          f"?volume={VID}")
        assert vs.store.find_volume(VID).fast_writer is None
    write(20, b"between-phases")
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/vacuum/commit"
                          f"?volume={VID}")
        assert vs.store.find_volume(VID).fast_writer is not None
    write(21, b"after-commit")
    assert _files(port) == _files(ref)
    v = port.store.find_volume(VID)
    counters = (v.file_count(), v.deleted_count(), v.content_size(),
                v.deleted_size(), v.max_file_key())
    r = ref.store.find_volume(VID)
    assert counters == (r.file_count(), r.deleted_count(), r.content_size(),
                        r.deleted_size(), r.max_file_key())
    for key in (1, 3, 20, 21):
        assert http_call("GET", f"http://{port.fast_url}/{_fid(key)}") == \
            http_call("GET", f"http://{ref.url}/{_fid(key)}")
    d = port.store.locations[0].directory
    port.stop()
    again = VolumeServer(port=0, directories=[d], device="cpu").start()
    try:
        v = again.store.find_volume(VID)
        assert v.fast_writer is not None
        assert (v.file_count(), v.deleted_count(), v.content_size(),
                v.deleted_size(), v.max_file_key()) == counters
        assert http_call("GET", f"http://{again.fast_url}/{_fid(21)}") == \
            b"after-commit"
    finally:
        again.stop()
    secured = VolumeServer(port=0, directories=[str(tmp_path / "jwt")],
                           device="cpu", jwt_signing_key="k").start()
    try:
        secured.store.add_volume(3)
        secured._fast_sync(3)
        assert secured.fast_plane is not None
        assert secured.store.find_volume(3).fast_writer is None
    finally:
        secured.stop()
    walled = VolumeServer(port=0, directories=[str(tmp_path / "wl")],
                          device="cpu", whitelist=["127.0.0.1"]).start()
    try:
        assert walled.fast_plane is None and walled.fast_url == ""
    finally:
        walled.stop()
    # a plane that cannot listen leaves the server without one, as JAX's
    import socket
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    try:
        busy = VolumeServer(port=0, directories=[str(tmp_path / "busy")],
                            device="cpu",
                            fast_port=taken.getsockname()[1]).start()
        try:
            assert busy.fast_plane is None and busy.fast_url == ""
        finally:
            busy.stop()
    finally:
        taken.close()


# -- the slab cache ---------------------------------------------------------

def test_slab_cache_counts_match_jax(monkeypatch):
    from seaweedfs_tpu.server.native_plane import \
        NativeReadPlane as RefPlane
    monkeypatch.setenv("SW_PLANE_CACHE_BYTES", "8192")
    planes = [RefPlane("127.0.0.1", 0, "127.0.0.1:1"),
              native_plane.NativeReadPlane("127.0.0.1", 0, "127.0.0.1:1")]
    steps = [("put", 1, 0, 0, b"a" * 4096), ("put", 1, 0, 1, b"b" * 4096),
             ("put", 1, 0, 2, b"c" * 4096), ("put", 1, 0, 3, b"x" * 9000),
             ("put", 1, 0, 4, b""), ("put", 1, 0, 2, b"d" * 1024),
             ("put", 2, 1, 0, b"e" * 512), ("inv", 1, 0),
             ("inv", 2, -1), ("inv", 3, -1)]
    try:
        for step in steps:
            if step[0] == "put":
                got = [p.cache_put(*step[1:]) for p in planes]
            else:
                got = [p.cache_invalidate(*step[1:]) for p in planes]
            assert got[0] == got[1], step
            stats = [p.cache_stats() for p in planes]
            assert stats[0] == stats[1], step
            assert stats[1]["bytes"] <= stats[1]["max_bytes"] == 8192
        assert stats[1]["evictions"] == 1 and stats[1]["entries"] == 0
    finally:
        for p in planes:
            p.stop()
    monkeypatch.setenv("SW_PLANE_CACHE_BYTES", "0")
    plane = native_plane.NativeReadPlane("127.0.0.1", 0, "127.0.0.1:1")
    try:
        assert not plane.cache_put(1, 0, 0, b"zz")
        assert plane.cache_stats()["max_bytes"] == 0
    finally:
        plane.stop()


# -- degraded serving -------------------------------------------------------

def test_lost_shard_cold_redirect_then_warm_in_plane(pair):
    """Twelve 150,000-byte needles, the volume encoded (readonly,
    generate, mount, delete_volume) and shard 0 lost on each server:
    each needle through the plane, cold, then three warm rounds."""
    import numpy as np
    ref, port = pair
    rng = np.random.default_rng(23)
    payloads = {}
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
    for i in range(12):
        data = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
        payloads[_fid(i + 1)] = data
        for vs in pair:
            assert _post(vs.url, f"/{_fid(i + 1)}?ts={TS}", f"p{i}",
                         data)[0] == 200
    for vs in pair:
        for route in ("volume/readonly", "ec/generate"):
            http_call("POST", f"http://{vs.url}/admin/{route}?volume={VID}")
        http_call("POST", f"http://{vs.url}/admin/ec/mount?volume={VID}"
                          f"&shards={','.join(map(str, range(14)))}")
        http_call("POST", f"http://{vs.url}/admin/delete_volume"
                          f"?volume={VID}")
        http_call("POST", f"http://{vs.url}/admin/ec/delete_shards"
                          f"?volume={VID}&shards=0")
    flows = []
    for vs in pair:
        cs0 = vs.fast_plane.cache_stats()
        degraded = []
        for fid, want in payloads.items():
            before = vs.degraded.snapshot()["reads"]
            data, _ = http_get_with_headers(f"http://{vs.fast_url}/{fid}")
            assert data == want, fid
            if vs.degraded.snapshot()["reads"] > before:
                degraded.append(fid)
        cs1 = vs.fast_plane.cache_stats()
        assert degraded and cs1["puts"] > 0
        assert cs1["degraded_redirected"] > cs0["degraded_redirected"]
        warm = [f for f in degraded
                if _raw(vs.fast_url, "GET", f"/{f}")[0] == 200]
        assert warm
        base = vs.fast_plane.cache_stats()
        reads = vs.degraded.snapshot()["reads"]
        for _ in range(3):
            for f in warm:
                st, _, body = _raw(vs.fast_url, "GET", f"/{f}")
                assert st == 200 and body == payloads[f]
        snap = vs.fast_plane.cache_stats()
        assert snap["degraded_served"] - base["degraded_served"] == \
            3 * len(warm)
        assert snap["degraded_redirected"] == base["degraded_redirected"]
        assert snap["hits"] > base["hits"]
        assert vs.degraded.snapshot()["reads"] == reads
        flows.append((degraded, warm, snap))
    assert flows[0] == flows[1]
    # a remount of the lost shard drops the plane's reconstructions of it
    assert port.fast_plane.cache_invalidate(VID) > 0


# -- durability ---------------------------------------------------------------

def _plane_server(tmp_path, name, monkeypatch, mode, ref=False, **env):
    monkeypatch.setenv("SW_PLANE_FSYNC_MODE", mode)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if ref:
        from seaweedfs_tpu.server.volume_server import \
            VolumeServer as RefVolumeServer
        master = _fake_master()
        vs = RefVolumeServer(port=0, directories=[str(tmp_path / name)],
                             master_url=f"127.0.0.1:{master.port}",
                             ec_backend="numpy").start()
        vs._fake = master
    else:
        vs = VolumeServer(port=0, directories=[str(tmp_path / name)],
                          device="cpu").start()
    http_call("POST", f"http://{vs.url}/admin/assign_volume?volume={VID}")
    return vs


def test_always_fsyncs_each_append_like_jax(tmp_path, monkeypatch):
    snaps = []
    for ref in (True, False):
        vs = _plane_server(tmp_path, f"always-{ref}", monkeypatch, "always",
                           ref=ref)
        try:
            assert vs.fast_plane.sync_stats()["mode"] == "always"
            for i in range(8):
                assert _post(vs.fast_url, f"/{_fid(i + 1)}", "a",
                             f"solo-{i}".encode())[0] == 200
            for i in range(8):
                assert http_call("GET", f"http://{vs.url}/{_fid(i + 1)}") \
                    == f"solo-{i}".encode()
            s = vs.fast_plane.sync_stats()
            snaps.append((s["batches"], s["riders"], s["failures"],
                          s["pending"]))
        finally:
            vs.stop()
            if ref:
                vs._fake.stop()
    assert snaps[0] == snaps[1] == (8, 8, 0, 0)


def test_group_commit_amortizes_concurrent_appends(tmp_path, monkeypatch):
    vs = _plane_server(tmp_path, "group", monkeypatch, "group",
                       SW_PLANE_FSYNC_BATCH_US="20000")
    try:
        s0 = vs.fast_plane.sync_stats()
        assert (s0["mode"], s0["batch_us"]) == ("group", 20000)
        written, errors = {}, []
        lock = threading.Lock()

        def writer(tid):
            for i in range(4):
                fid = _fid(1 + tid * 4 + i)
                data = f"durable-{tid}-{i}".encode() * 20
                st, _ = _post(vs.fast_url, f"/{fid}", "g", data)
                with lock:
                    if st == 200:
                        written[fid] = data
                    else:
                        errors.append(st)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(written) == 64
        s1 = vs.fast_plane.sync_stats()
        riders = s1["riders"] - s0["riders"]
        batches = s1["batches"] - s0["batches"]
        assert riders == 64 and 1 <= batches < riders
        assert (s1["failures"], s1["pending"]) == (0, 0)
        assert sum(c for _, c in s1["buckets"]) == s1["batches"]
        for fid, data in written.items():
            assert http_call("GET", f"http://{vs.fast_url}/{fid}") == data
        view = json.loads(_raw(vs.url, "GET", "/admin/plane/durability")[2])
        assert view["plane"] and view["durability"]["riders"] == 64
        text = _raw(vs.url, "GET", "/metrics")[2].decode()
        assert re.search(r"^SeaweedFS_volumeServer_plane_fsync_riders_total "
                         r"64(\.0)?$", text, re.M)
        assert re.search(r"^SeaweedFS_volumeServer_plane_build_failed 0",
                         text, re.M)
        # a lease torn from under the volume: the next append demotes to
        # the Python path, which fsyncs under the same knob
        v = vs.store.find_volume(VID)
        assert vs.fast_plane.disable_writer(VID) >= 0
        assert _post(vs.url, f"/{_fid(99)}", "t", b"post-tear")[0] == 200
        assert v.fast_writer is None
        assert http_call("GET", f"http://{vs.url}/{_fid(99)}") == \
            b"post-tear"
    finally:
        vs.stop()


@pytest.mark.parametrize("package", ["ref", "port"])
def test_python_append_fsyncs_under_the_knob(tmp_path, monkeypatch, package):
    if package == "ref":
        from seaweedfs_tpu.storage.needle import Needle as N
        from seaweedfs_tpu.storage.volume import Volume
    else:
        from seaweedfs_tpu_torch.storage.volume import Volume
        N = Needle
    synced = []
    real = os.fdatasync
    monkeypatch.setattr(os, "fdatasync",
                        lambda fd: (synced.append(fd), real(fd))[1])
    v = Volume(str(tmp_path / package), "", 9, create=True)
    counts = []
    try:
        monkeypatch.setenv("SW_PLANE_FSYNC_MODE", "group")
        v.write_needle(N(cookie=1, id=1, data=b"d" * 64))
        counts.append(len(synced))
        v.delete_needle(N(cookie=1, id=1))
        counts.append(len(synced))
        monkeypatch.setenv("SW_PLANE_FSYNC_MODE", "off")
        v.write_needle(N(cookie=2, id=2, data=b"e" * 64))
        counts.append(len(synced))
    finally:
        v.close()
    assert counts == [2, 4, 4]


def test_plane_admin_routes_match_jax(pair, tmp_path):
    """/admin/plane/{cache,durability,slow} on both servers after the
    same writes and reads: the cache and durability views equal, the
    slow ring's and the stats' shapes equal; without a plane, equal
    answers too."""
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
        for key in (1, 2):
            assert _post(vs.fast_url, f"/{_fid(key)}?ts={TS}", "a",
                         b"admin" * key)[0] == 200
            assert _raw(vs.fast_url, "GET", f"/{_fid(key)}")[0] == 200

    def view(vs, route):
        return json.loads(_raw(vs.url, "GET", f"/admin/plane/{route}")[2])

    for route in ("cache", "durability"):
        assert view(pair[0], route) == view(pair[1], route)
    slow = [view(vs, "slow") for vs in pair]
    assert [sorted(v) for v in slow] == [["plane", "slow", "stats"]] * 2
    assert sorted(slow[0]["stats"]) == sorted(slow[1]["stats"])
    assert slow[1]["stats"]["status_2xx"] >= 2
    off = [RefVolumeServer(port=0, directories=[str(tmp_path / "r-off")],
                           master_url="127.0.0.1:1", ec_backend="numpy",
                           fast_port=-1),
           VolumeServer(port=0, directories=[str(tmp_path / "p-off")],
                        device="cpu", fast_port=-1)]
    try:
        for vs in off:
            vs.server.start()
        for route in ("cache", "durability", "slow"):
            assert view(off[0], route) == view(off[1], route)
    finally:
        for vs in off:
            vs.stop()
