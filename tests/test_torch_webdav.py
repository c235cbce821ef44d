"""The port's WebDAV gateway against the JAX package's, on the CPU.

Each package runs a master, a volume server (the port's on the CPU, the
JAX one on its numpy codec), a filer and its ``WebDavServer`` (1 KiB
chunks), in process over the ``Filer`` and standalone over a
``FilerClient``. One request script goes through both: OPTIONS; PUT of a
file across chunks; GET whole, ranged and out of range; HEAD; PROPFIND at
depth 0 and 1 (a file, a directory, the root, a missing path); MKCOL
twice; COPY and MOVE (overwrite refused with ``Overwrite: F``, into the
source's own subtree, onto itself, a missing source, no
``Destination``); LOCK with an owner and a timeout, a PUT refused (423)
without the token and accepted with it, an ancestor's LOCK and DELETE
refused over the locked child, a refresh, UNLOCK with a wrong and the
right token; a lock left to expire under the clock; PROPPATCH; DELETE; a
directory GET; an unknown method. Statuses, headers (less ``Date``) and
bodies (multistatus XML included) must be equal, with lock tokens
numbered in order of issue. The WebDAV and filer modules read one fake
clock, so ``getlastmodified``, ``creationdate`` and lock expiry are the
same in both.

Tolerances: none (bytes compared exactly).
"""

import http.client
import re
import time
import types

import pytest

from test_torch_filer_server import _stack, _stop

T0 = 1_760_000_000.0
DATA = bytes(range(256)) * 10 + b"tail"


def _modules(kind):
    if kind == "ref":
        import seaweedfs_tpu.filer.entry as entry
        import seaweedfs_tpu.filer.filer as filer
        import seaweedfs_tpu.server.webdav_server as dav
        from seaweedfs_tpu.filer.filer_client import FilerClient
    else:
        import seaweedfs_tpu_torch.filer.entry as entry
        import seaweedfs_tpu_torch.filer.filer as filer
        import seaweedfs_tpu_torch.server.webdav_server as dav
        from seaweedfs_tpu_torch.filer.filer_client import FilerClient
    return entry, filer, dav, FilerClient


@pytest.fixture
def clock(monkeypatch):
    """``time`` of the WebDAV and filer modules: ``time()`` reads
    ``now[0]``; everything else is the real module."""
    now = [T0]
    fake = types.SimpleNamespace(time=lambda: now[0],
                                 strftime=time.strftime, gmtime=time.gmtime,
                                 monotonic=time.monotonic)
    for kind in ("ref", "port"):
        for mod in _modules(kind)[:3]:
            monkeypatch.setattr(mod, "time", fake)
    return now


class Dav:
    def __init__(self, url):
        self.url = url
        self.tokens = []

    def __call__(self, method, path, body=b"", headers=None):
        h = dict(headers or {})
        for k, v in h.items():
            for i, tok in enumerate(self.tokens):
                v = v.replace(f"TOKEN{i}", tok)
            v = v.replace("DAVURL", f"http://{self.url}")
            h[k] = v
        conn = http.client.HTTPConnection(self.url, timeout=30)
        try:
            conn.request(method, path, body=body or None, headers=h)
            r = conn.getresponse()
            data = r.read()
            hdrs = {k: v for k, v in r.getheaders() if k != "Date"}
        finally:
            conn.close()
        tok = hdrs.get("Lock-Token")
        if tok and tok.strip("<>") not in self.tokens:
            self.tokens.append(tok.strip("<>"))
        return r.status, self._norm(hdrs), self._norm(data)

    def _norm(self, obj):
        if isinstance(obj, dict):
            return {k: self._norm(v) for k, v in obj.items()}
        raw = obj if isinstance(obj, bytes) else obj.encode()
        for i, tok in enumerate(self.tokens):
            raw = raw.replace(tok.encode(), b"TOKEN%d" % i)
        raw = raw.replace(self.url.encode(), b"DAVURL")
        raw = re.sub(rb"opaquelocktoken:[0-9a-f-]{36}", b"UNSEEN", raw)
        return raw if isinstance(obj, bytes) else raw.decode()


LOCK_BODY = (b'<?xml version="1.0" encoding="utf-8"?>'
             b'<D:lockinfo xmlns:D="DAV:"><D:lockscope><D:exclusive/>'
             b'</D:lockscope><D:locktype><D:write/></D:locktype>'
             b'<D:owner><D:href>mailto:ops@example.com</D:href></D:owner>'
             b'</D:lockinfo>')


def _script(dav, now):
    out = []

    def r(*a, **kw):
        out.append((a[0], a[1], dav(*a, **kw)))
    r("OPTIONS", "/")
    r("PUT", "/a/b/file.bin", DATA, {"Content-Type": "application/x-bin"})
    r("PUT", "/a/b/file.bin", DATA[:1500])
    r("GET", "/a/b/file.bin")
    r("GET", "/a/b/file.bin", headers={"Range": "bytes=1000-1400"})
    r("GET", "/a/b/file.bin", headers={"Range": "bytes=-10"})
    r("GET", "/a/b/file.bin", headers={"Range": "bytes=9000-9100"})
    r("HEAD", "/a/b/file.bin")
    r("GET", "/missing.bin")
    for path, depth in (("/", "0"), ("/a", "1"), ("/a/b/file.bin", "0"),
                        ("/a/b", "1"), ("/missing", "1"), ("/a", None)):
        r("PROPFIND", path, headers={"Depth": depth} if depth else {})
    r("MKCOL", "/col")
    r("MKCOL", "/col")
    r("PUT", "/col/x.txt", b"x-content", {"Content-Type": "text/plain"})
    r("COPY", "/col/x.txt", headers={"Destination": "DAVURL/col/y.txt"})
    r("COPY", "/col/x.txt", headers={"Destination": "DAVURL/col/y.txt",
                                     "Overwrite": "F"})
    r("COPY", "/col", headers={"Destination": "DAVURL/col/sub"})
    r("COPY", "/col", headers={"Destination": "DAVURL/col2"})
    r("MOVE", "/col/y.txt", headers={"Destination": "DAVURL/col/z.txt"})
    r("MOVE", "/col/ghost.txt", headers={"Destination": "DAVURL/col/x.txt"})
    r("MOVE", "/col/x.txt", headers={"Destination": "DAVURL/col/x.txt"})
    r("MOVE", "/col/x.txt")
    r("PROPFIND", "/col", headers={"Depth": "1"})
    r("PROPFIND", "/col2", headers={"Depth": "1"})
    # class-2 locks
    r("LOCK", "/col/x.txt", LOCK_BODY, {"Timeout": "Second-100"})
    r("PUT", "/col/x.txt", b"refused")
    r("PUT", "/col/x.txt", b"with-token", {"If": "(<TOKEN0>)"})
    r("LOCK", "/col", LOCK_BODY, {"Timeout": "Infinite"})
    r("DELETE", "/col")
    r("MOVE", "/col/x.txt", headers={"Destination": "DAVURL/col/w.txt"})
    now[0] += 50
    r("LOCK", "/col/x.txt", b"", {"If": "(<TOKEN0>)",
                                  "Timeout": "Second-300, Infinite"})
    r("LOCK", "/col/x.txt", b"", {"If": "(<nope>)"})
    r("UNLOCK", "/col/x.txt", headers={"Lock-Token": "<opaquelocktoken:x>"})
    r("UNLOCK", "/col/x.txt", headers={"Lock-Token": "<TOKEN0>"})
    r("UNLOCK", "/col/x.txt")
    r("PUT", "/col/x.txt", b"unlocked")
    r("LOCK", "/col", b"<D:lockinfo", {"Timeout": "Second-5"})
    r("LOCK", "/col", LOCK_BODY, {"Timeout": "Second-5"})
    r("PUT", "/col/z.txt", b"under-ancestor-lock")
    now[0] += 6
    r("PUT", "/col/z.txt", b"lock-expired")
    r("PROPPATCH", "/col/z.txt", b"<D:propertyupdate xmlns:D='DAV:'/>")
    r("GET", "/col")
    r("GET", "/col/z.txt")
    r("DELETE", "/col/z.txt")
    r("DELETE", "/col/z.txt")
    r("DELETE", "/col2")
    r("PROPFIND", "/", headers={"Depth": "1"})
    r("TRACE", "/")
    return out


@pytest.mark.parametrize("standalone", [False, True],
                         ids=["in_process", "over_filer_client"])
def test_webdav_script_matches_jax(tmp_path, clock, standalone):
    got = {}
    for kind in ("ref", "port"):
        clock[0] = T0
        stack = _stack(kind, tmp_path / kind)
        _, _, dav_mod, FilerClient = _modules(kind)
        m, _, f = stack
        meta = FilerClient(f.url) if standalone else f.filer
        server = dav_mod.WebDavServer(meta, m.url, port=0,
                                      chunk_size=1024).start()
        try:
            got[kind] = _script(Dav(f"127.0.0.1:{server.port}"), clock)
        finally:
            server.stop()
            _stop(stack)
    for ref, port in zip(got["ref"], got["port"]):
        assert port == ref, ref[:2]
    assert len(got["port"]) == len(got["ref"])
    codes = [s for _, _, (s, _, _) in got["ref"]]
    assert 423 in codes and 207 in codes and 206 in codes and 412 in codes
    body = dict(((m, p), b) for m, p, (_, _, b) in got["ref"])
    assert body[("GET", "/col/z.txt")] == b"lock-expired"


def test_lock_manager_matches_jax(clock):
    """Depth, expiry and ``If:`` tokens on the two LockManagers."""
    mgrs = [_modules(k)[2].LockManager() for k in ("ref", "port")]
    outs = []
    for mgr in mgrs:
        clock[0] = T0
        toks, res = [], []

        def step(fn):
            try:
                v = fn()
                res.append(("ok", toks.index(v) if v in toks else v))
            except Exception as e:  # noqa: BLE001 - HttpError, compared
                res.append((type(e).__name__, e.status, str(e)))
        for path in ("/a/b", "/a", "/a/b/c", "/x"):
            def acq(path=path):
                t = mgr.acquire(path, 10, "me")
                toks.append(t)
                return t
            step(acq)
        step(lambda: mgr.require("/a/b/c/d", ""))
        step(lambda: mgr.require("/a/b/c/d", f"(<{toks[0]}>)"))
        step(lambda: mgr.require("/a", "", descendants=False))
        step(lambda: mgr.require("/a", "", descendants=True))
        step(lambda: mgr.require("/", f"<{toks[0]}> <{toks[1]}>",
                                 descendants=True))
        clock[0] += 5
        step(lambda: mgr.refresh("/a/b/x", f"<{toks[0]}>", 20))
        clock[0] += 11
        step(lambda: mgr.require("/x", ""))
        step(lambda: mgr.require("/a/b", ""))
        step(lambda: mgr.release("/a/b/q", toks[0]))
        step(lambda: mgr.release("/a/b", toks[0]))
        mgr.forget("/a")
        step(lambda: mgr.refresh("/a/b", "", 1))
        outs.append(res)
    assert outs[0] == outs[1]
