"""The port's filer server against the JAX package's, over HTTP.

Each package runs a master, a volume server (the port's on the CPU, the
JAX one on its numpy codec; no native plane) and a ``FilerServer`` with
1 KiB chunks, and the same flows go through both: small, empty and
chunked uploads, GETs whole and ranged (across chunk edges), a bad
range, HEAD, directory listings in pages, ``?op=mkdir`` and ``POST
/dir/`` with a file, ``?mode=``, an overwrite (its dropped chunks
deleted on the volume server), ``mv.to``, DELETE of a non-empty
directory (409) and ``?recursive=true`` (every chunk deleted),
``?skipChunkDeletion=true``, the metadata API
(``/filer/meta/{lookup,list,create,update,rename,delete,delete_chunks}``),
``/filer/events`` with a prefix, ``/filer/status``, ``/metrics`` and
404s. Replies must be equal once file ids, times, ports and the
master's url are normalized, and every body equal byte for byte.

The deletion race: with the background loop held inside
``operation.delete_file`` (on an event) after it drained the queue, the
port's ``flush_deletions`` must not return until that drain's deletes
are done; the JAX package's returns at once, which is the likely cause
of its ``test_delete_recursive_cleans_chunks`` flake.

Tolerances: none.
"""

import json
import re
import threading
import time

import pytest

from conftest import wait_until

CHUNK = 1024


def _stack(kind, root):
    if kind == "ref":
        from seaweedfs_tpu.server.filer_server import FilerServer
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        m = MasterServer(port=0, volume_size_limit_mb=64,
                         pulse_seconds=1).start()
        vs = VolumeServer(port=0, directories=[str(root / "ref-v")],
                          master_url=m.url, pulse_seconds=1,
                          max_volume_counts=[20], ec_backend="numpy",
                          fast_port=-1).start()
    else:
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        m = MasterServer(port=0, volume_size_limit_mb=64, pulse_seconds=1,
                         repair_interval=0).start()
        vs = VolumeServer(port=0, directories=[str(root / "port-v")],
                          master_url=m.url, pulse_seconds=1,
                          max_volume_counts=[20], device="cpu",
                          fast_port=-1).start()
    f = FilerServer(port=0, master_url=m.url, chunk_size=CHUNK).start()
    return m, vs, f


def _stop(stack):
    m, vs, f = stack
    f.stop()
    vs.stop()
    m.stop()


_TIME_KEYS = {"Mtime", "Crtime", "mtime", "ts", "tsNs", "cursor",
              "LastModified"}


def _norm(obj, urls):
    """File ids, times and this stack's urls out of a JSON reply."""
    if isinstance(obj, dict):
        return {k: ("T" if k in _TIME_KEYS else
                    "FID" if k == "fid" and obj[k] else _norm(v, urls))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v, urls) for v in obj]
    if isinstance(obj, str):
        for u, name in urls.items():
            obj = obj.replace(u, name)
        return re.sub(r"\b\d+,[0-9a-f]{9,}\b", "FID", obj)
    return obj


def _call(method, url, body=None, headers=None):
    """(status, headers that matter, body) of a request on a fresh
    connection."""
    import http.client
    import urllib.parse
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.netloc, timeout=30)
    try:
        path = u.path + (f"?{u.query}" if u.query else "")
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        keep = {k: r.getheader(k) for k in (
            "Content-Type", "Content-Length", "Content-Range",
            "Accept-Ranges", "Etag") if r.getheader(k) is not None}
        return r.status, keep, data
    finally:
        conn.close()


def _multipart(name, data, ctype="application/octet-stream"):
    boundary = "----port-filer-test"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="{name}"\r\nContent-Type: {ctype}'
            f"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _fid_gone(vs_url, fid):
    return _call("GET", f"http://{vs_url}/{fid}")[0] == 404


def _flow(stack):
    m, vs, f = stack
    urls = {m.url: "M", vs.url: "V", f.url: "F"}
    base = f"http://{f.url}"
    out = []

    def rec(label, method, path, body=None, headers=None, as_json=None):
        status, hdrs, data = _call(method, base + path, body, headers)
        if as_json is None:
            as_json = hdrs.get("Content-Type", "").startswith(
                "application/json")
        shown = data
        if as_json and data:
            # a JSON body's length moves with its ids and times
            shown = _norm(json.loads(data), urls)
            hdrs.pop("Content-Length", None)
        out.append((label, status, hdrs, shown))
        return status, data

    rng_data = bytes((i * 7919 + 13) % 251 for i in range(5000))
    rec("small", "POST", "/docs/hello.txt",
        *_multipart("hello.txt", b"hello filer world", "text/plain"))
    rec("small get", "GET", "/docs/hello.txt")
    rec("empty", "POST", "/docs/empty.txt",
        *_multipart("empty.txt", b"", "text/plain"))
    rec("empty get", "GET", "/docs/empty.txt")
    rec("chunked", "PUT", "/docs/big.bin", rng_data,
        {"Content-Type": "application/octet-stream"})
    rec("chunked get", "GET", "/docs/big.bin")
    rec("range", "GET", "/docs/big.bin", headers={"Range": "bytes=1000-3000"})
    rec("suffix range", "GET", "/docs/big.bin",
        headers={"Range": "bytes=-100"})
    rec("bad range", "GET", "/docs/big.bin",
        headers={"Range": "bytes=9000-9100"}, as_json=False)
    rec("head", "HEAD", "/docs/big.bin")
    rec("mkdir", "POST", "/docs/sub?op=mkdir", b"")
    rec("into dir", "POST", "/docs/sub/", *_multipart("in.txt", b"inside"))
    rec("mode", "POST", "/docs/sub/m.bin?mode=0755", b"moded")
    rec("bad mode", "POST", "/docs/sub/n.bin?mode=-7", b"x")
    for i in range(5):
        rec(f"page file {i}", "POST", f"/list/f{i}", b"p%d" % i)
    rec("list p1", "GET", "/list?limit=2")
    rec("list p2", "GET", "/list?limit=2&lastFileName=f1")
    rec("list dir", "GET", "/docs")

    # an overwrite drops the old chunks; the flush deletes them
    old = f.filer.find_entry("/docs/big.bin").chunks
    rec("overwrite", "PUT", "/docs/big.bin", b"short now")
    # (polled: the JAX flush can return while its loop still deletes)
    f.flush_deletions()
    out.append(("old chunks gone", wait_until(
        lambda: all(_fid_gone(vs.url, c.fid) for c in old))))
    rec("overwrite get", "GET", "/docs/big.bin")

    rec("move", "POST", "/docs/hello.txt?mv.to=/moved/hello.txt", b"")
    rec("move old", "GET", "/docs/hello.txt", as_json=False)
    rec("move new", "GET", "/moved/hello.txt")
    rec("move missing", "POST", "/nope?mv.to=/x", b"", as_json=False)

    held = [c.fid for e in ("/docs/sub/in.txt", "/docs/sub/m.bin")
            for c in f.filer.find_entry(e).chunks]
    rec("delete non-empty", "DELETE", "/docs", as_json=False)
    rec("delete recursive", "DELETE", "/docs?recursive=true")
    f.flush_deletions()
    out.append(("recursive chunks gone", wait_until(
        lambda: all(_fid_gone(vs.url, fid) for fid in held))))
    rec("deleted get", "GET", "/docs/sub/in.txt", as_json=False)

    keep = f.filer.find_entry("/list/f0").chunks[0].fid
    rec("skip chunk deletion", "DELETE", "/list/f0?skipChunkDeletion=true")
    f.flush_deletions()
    out.append(("skipped chunk kept", not _fid_gone(vs.url, keep)))

    # the metadata API
    rec("meta lookup", "GET", "/filer/meta/lookup?path=/list/f1")
    rec("meta lookup missing", "GET", "/filer/meta/lookup?path=/zz",
        as_json=False)
    rec("meta list", "GET", "/filer/meta/list?path=/list&limit=2"
        "&lastFileName=f1&inclusive=true")
    entry = {"FullPath": "/meta/made/x", "Mtime": 5.0, "Crtime": 5.0,
             "Mode": 0o644, "Mime": "text/x", "chunks": [],
             "extended": {"k": "00ff"}}
    rec("meta create", "POST", "/filer/meta/create",
        json.dumps({"entry": entry}).encode())
    entry["Mime"] = "text/y"
    rec("meta update", "POST", "/filer/meta/update",
        json.dumps({"entry": entry}).encode())
    rec("meta rename", "POST", "/filer/meta/rename",
        json.dumps({"old": "/meta/made", "new": "/meta/moved"}).encode())
    rec("meta lookup moved", "GET", "/filer/meta/lookup?path=/meta/moved/x")
    rec("meta create over dir", "POST", "/filer/meta/create",
        json.dumps({"entry": dict(entry, FullPath="/meta/moved")}).encode(),
        as_json=False)
    rec("meta delete", "POST", "/filer/meta/delete",
        json.dumps({"path": "/meta", "recursive": True}).encode())
    rec("meta delete missing", "POST", "/filer/meta/delete",
        json.dumps({"path": "/meta"}).encode(), as_json=False)
    rec("meta delete_chunks", "POST", "/filer/meta/delete_chunks",
        json.dumps({"chunks": [{"fid": keep, "offset": 0,
                                "size": 2}]}).encode())
    f.flush_deletions()
    out.append(("queued chunk gone",
                wait_until(lambda: _fid_gone(vs.url, keep))))

    rec("events", "GET", "/filer/events?since=0&prefix=/list&timeout=1")
    rec("events none", "GET",
        "/filer/events?since=0&prefix=/nothing&timeout=0.2")
    rec("status", "GET", "/filer/status")
    rec("missing", "GET", "/no/such", as_json=False)
    status, _, body = _call("GET", base + "/metrics")
    out.append(("metrics", status,
                "SeaweedFS_filer_request_total" in body.decode()))
    return out


def test_filer_server_flows_match_jax(tmp_path):
    got = {}
    for kind in ("ref", "port"):
        stack = _stack(kind, tmp_path)
        try:
            got[kind] = _flow(stack)
        finally:
            _stop(stack)
    ref, port = got["ref"], got["port"]
    assert [r[0] for r in port] == [r[0] for r in ref]
    for r, p in zip(ref, port):
        assert p == r, r[0]
    checks = {r[0]: r[1:] for r in port}
    assert checks["old chunks gone"] == (True,)
    assert checks["recursive chunks gone"] == (True,)
    assert checks["skipped chunk kept"] == (True,)
    assert checks["range"][0] == 206
    assert checks["delete non-empty"][0] == 409


@pytest.mark.parametrize("kind", ("ref", "port"))
def test_flush_waits_for_inflight_drain(monkeypatch, kind):
    """The background loop drains [A, B] and is held inside the delete
    of A; a caller queues C and flushes. The port's flush returns only
    after A, B and C were tried; the JAX package's returns at once with
    A and B still pending."""
    if kind == "ref":
        from seaweedfs_tpu.filer.entry import FileChunk
        from seaweedfs_tpu.server import filer_server as mod
    else:
        from seaweedfs_tpu_torch.filer.entry import FileChunk
        from seaweedfs_tpu_torch.server import filer_server as mod
    entered, release = threading.Event(), threading.Event()
    tried = []

    def delete_file(master_url, fid, cache=None, jwt=""):
        if threading.current_thread().name == "filer-deleter" and \
                not entered.is_set():
            entered.set()
            assert release.wait(20)
        tried.append(fid)
        return True
    monkeypatch.setattr(mod.operation, "delete_file", delete_file)
    f = mod.FilerServer(port=0, master_url="127.0.0.1:1").start()
    try:
        f.filer.queue_chunk_deletion([FileChunk("1,a", 0, 1),
                                      FileChunk("1,b", 0, 1)])
        assert entered.wait(10)
        f.filer.queue_chunk_deletion([FileChunk("1,c", 0, 1)])
        done = threading.Event()
        at_return = []

        def flush():
            f.flush_deletions()
            at_return.extend(tried)
            done.set()
        t = threading.Thread(target=flush)
        t.start()
        if kind == "port":
            assert not done.wait(0.5)      # held behind the drain
            release.set()
            assert done.wait(10)
            assert sorted(at_return) == ["1,a", "1,b", "1,c"]
        else:
            assert done.wait(10)           # returned during the drain
            assert "1,a" not in at_return and "1,b" not in at_return
            release.set()
        t.join(10)
        assert wait_until(lambda: sorted(tried) == ["1,a", "1,b", "1,c"])
    finally:
        release.set()
        f.stop()
