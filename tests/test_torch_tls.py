"""TLS and mutual TLS in the port's ``server/http_util`` and servers,
against the JAX package's (the flows of JAX ``test_aux_subsystems.py``'s
and ``test_security.py``'s TLS tests, on port servers beside JAX ones):

- end to end: a server made after ``configure_tls`` serves https, a
  plain-looking cluster URL is upgraded and verified, and after
  ``reset_tls`` plain HTTP works again;
- a redirect to a plain ``http://`` Location is followed over TLS;
- the mutual-TLS gates on status codes: ``/dir/status`` and a fid GET
  stay public, ``/cluster/status`` and a volume server's ``/admin/*``
  answer 403 to a certificate-less client and 200 to a CA-signed one,
  and a self-signed certificate fails the handshake;
- ``configure_tls`` refuses mutual TLS without a CA, and a cert without
  its key; ``external=True`` keeps a URL's plain scheme;
- the native plane stays off under TLS;
- a connection that never sends its handshake stalls the JAX server's
  accept loop but not the port's (ROADMAP §3);
- a degraded read through a lost shard whose survivors come from two
  port holders over mutual TLS: the port's and the JAX package's
  engines read the same bytes with the same counters, and a client
  without a certificate is refused.

TLS is process-wide in both packages: every case configures both and a
fixture always resets both. The PKI (a CA, a server and a peer
certificate it signed, a self-signed rogue) is made once a module with
the ``openssl`` CLI; the cases skip only if it is missing.

Tolerances: none.
"""

import http.client
import shutil
import socket
import ssl
import subprocess
import time

import pytest

from seaweedfs_tpu.server import http_util as ref_http
from seaweedfs_tpu_torch.server import http_util

KINDS = ["ref", "port"]


def _run(*cmd):
    try:
        out = subprocess.run(cmd, capture_output=True)
    except FileNotFoundError:
        pytest.skip("openssl unavailable")
    if out.returncode != 0:
        pytest.skip(f"openssl unavailable: {out.stderr[:120]}")


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """(ca, (srv cert, key), (peer cert, key), (rogue cert, key))."""
    d = tmp_path_factory.mktemp("pki")
    ca, cakey = str(d / "ca.pem"), str(d / "ca.key")
    _run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", cakey, "-out", ca, "-days", "1", "-subj", "/CN=testca")
    out = {}
    for name, cn in (("srv", "127.0.0.1"), ("peer", "peer")):
        key, csr, crt = (str(d / f"{name}.{x}") for x in ("key", "csr",
                                                          "pem"))
        _run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout",
             key, "-out", csr, "-subj", f"/CN={cn}")
        _run("openssl", "x509", "-req", "-in", csr, "-CA", ca, "-CAkey",
             cakey, "-CAcreateserial", "-out", crt, "-days", "1")
        out[name] = (crt, key)
    rcrt, rkey = str(d / "rogue.pem"), str(d / "rogue.key")
    _run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", rkey, "-out", rcrt, "-days", "1", "-subj", "/CN=rogue")
    return ca, out["srv"], out["peer"], (rcrt, rkey)


@pytest.fixture
def tls():
    """``tls(*args, **kw)`` configures both packages; both are reset
    after the test whatever happens."""
    def configure(*args, **kw):
        ref_http.configure_tls(*args, **kw)
        http_util.configure_tls(*args, **kw)
    try:
        yield configure
    finally:
        ref_http.reset_tls()
        http_util.reset_tls()


def _pkg(kind):
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        return ref_http, op, MasterServer, VolumeServer, {
            "ec_backend": "numpy"}, {}
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return http_util, op, MasterServer, VolumeServer, {"device": "cpu"}, {
        "repair_interval": 0}


def _https(port, method, path, ca=None, client_cert=None):
    """One HTTPS round trip with a TLS identity of its own (not the
    process's): (status, body)."""
    ctx = ssl.create_default_context(cafile=ca)
    ctx.check_hostname = False
    if ca is None:
        ctx.verify_mode = ssl.CERT_NONE
    if client_cert:
        ctx.load_cert_chain(*client_cert)
    c = http.client.HTTPSConnection("127.0.0.1", port, timeout=10,
                                    context=ctx)
    try:
        c.request(method, path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.mark.parametrize("kind", KINDS)
def test_tls_end_to_end_and_reset(pki, tls, kind):
    hu = _pkg(kind)[0]
    ca, srv, _, _ = pki
    router = hu.Router()
    router.add("GET", "/ping", lambda req: {"pong": True})
    tls(*srv, ca)
    s = hu.HttpServer(0, router, "127.0.0.1").start()
    try:
        assert hu.tls_enabled() and not hu.mtls_enabled()
        assert hu.get_json(f"http://127.0.0.1:{s.port}/ping") == \
            {"pong": True}
        assert _https(s.port, "GET", "/ping", ca=ca) == \
            (200, b'{"pong": true}')
        # a plain client reaches no answer
        c = http.client.HTTPConnection("127.0.0.1", s.port, timeout=5)
        with pytest.raises((ConnectionError, http.client.HTTPException,
                            OSError)):
            c.request("GET", "/ping")
            c.getresponse().read()
        c.close()
    finally:
        s.stop()
    hu.reset_tls()
    assert not hu.tls_enabled()
    s = hu.HttpServer(0, router, "127.0.0.1").start()
    try:
        assert hu.get_json(f"http://127.0.0.1:{s.port}/ping") == \
            {"pong": True}
    finally:
        s.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_tls_redirect_rewrites_scheme(pki, tls, kind):
    hu = _pkg(kind)[0]
    ca, srv, _, _ = pki
    hits = []
    tls(*srv, ca)
    t_router = hu.Router()
    t_router.add("GET", "/data", lambda req: hits.append("target") or
                 {"ok": True})
    target = hu.HttpServer(0, t_router, "127.0.0.1").start()
    router = hu.Router()
    router.add("GET", "/hop", lambda req: hits.append("redirector") or
               hu.Response(b"", 301, headers={
                   "Location": f"http://127.0.0.1:{target.port}/data"}))
    s = hu.HttpServer(0, router, "127.0.0.1").start()
    try:
        assert hu.get_json(f"http://127.0.0.1:{s.port}/hop") == {"ok": True}
        assert hits == ["redirector", "target"]
    finally:
        s.stop()
        target.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_external_call_keeps_its_scheme(pki, tls, kind):
    """``external=True``: an endpoint outside the cluster keeps its
    plain http:// under TLS; a cluster call to it is upgraded and
    fails."""
    hu = _pkg(kind)[0]
    ca, srv, _, _ = pki
    router = hu.Router()
    router.add("GET", "/hook", lambda req: {"hook": True})
    plain = hu.HttpServer(0, router, "127.0.0.1").start()
    try:
        tls(*srv, ca)
        url = f"http://127.0.0.1:{plain.port}/hook"
        assert hu.http_call("GET", url, external=True) == b'{"hook": true}'
        with pytest.raises(hu.HttpError) as e:
            hu.http_call("GET", url, timeout=5)
        assert e.value.status == 503 and "https://" in str(e.value)
    finally:
        plain.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_configure_tls_refusals(pki, tls, kind):
    hu = _pkg(kind)[0]
    _, (cert, key), _, _ = pki
    with pytest.raises(ValueError, match="CA"):
        hu.configure_tls(cert, key, "", mutual=True)
    with pytest.raises(ValueError, match="BOTH"):
        hu.configure_tls(cert, "", "")
    assert not hu.tls_enabled()


def test_mutual_tls_gates_match_jax(pki, tls, tmp_path):
    """The JAX flow of ``test_mutual_tls_admin_routes`` on a cluster of
    each package: every status code equal, and as the reference wants."""
    ca, srv, peer, rogue = pki
    tls(*srv, ca, mutual=True)
    got = {}
    for kind in KINDS:
        hu, op, Master, Volume, vkw, mkw = _pkg(kind)
        assert hu.mtls_enabled()
        m = Master(port=0, pulse_seconds=1, **mkw).start()
        vs = Volume(port=0, directories=[str(tmp_path / kind)],
                    master_url=m.url, pulse_seconds=1, fast_port=-1,
                    **vkw).start()
        try:
            vs.heartbeat_once()
            # this process's client presents the server pair: the
            # heartbeat (a /cluster/ route) went through
            assert m.topology.find_node(vs.url) is not None
            a = op.assign(m.url)
            op.upload(a["url"], a["fid"], b"mtls-payload", filename="m")
            assert op.read_file(m.url, a["fid"]) == b"mtls-payload"
            vid = int(a["fid"].split(",")[0])
            mp, vp = m.port, vs.port
            sync = f"/admin/volume/sync_status?volume={vid}"
            codes = [
                _https(mp, "GET", "/dir/status", ca=ca)[0],
                _https(vp, "GET", f"/{a['fid']}", ca=ca)[0],
                _https(mp, "GET", "/cluster/status", ca=ca),
                _https(mp, "GET", "/vol/status", ca=ca)[0],
                _https(vp, "GET", sync, ca=ca),
                _https(vp, "GET", "/admin/devices", ca=ca)[0],
                _https(mp, "GET", "/cluster/status", ca=ca,
                       client_cert=peer)[0],
                _https(vp, "GET", sync, ca=ca, client_cert=peer)[0],
            ]
            with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
                _https(mp, "GET", "/cluster/status", ca=ca,
                       client_cert=rogue)
            with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
                _https(vp, "GET", f"/{a['fid']}", ca=ca, client_cert=rogue)
        finally:
            vs.stop()
            m.stop()
        got[kind] = [(c[0], b"certificate" in c[1]) if isinstance(c, tuple)
                     else c for c in codes]
    # /admin/devices is the port's; JAX answers it too
    assert got["port"] == got["ref"]
    assert got["port"] == [200, 200, (403, True), 403, (403, True), 403,
                           200, 200]


@pytest.mark.parametrize("kind", KINDS)
def test_native_plane_off_under_tls(pki, tls, tmp_path, kind):
    _, _, _, Volume, vkw, _ = _pkg(kind)
    ca, srv, _, _ = pki
    tls(*srv, ca)
    vs = Volume(port=0, directories=[str(tmp_path)],
                master_url="127.0.0.1:1", fast_port=0, **vkw)
    try:
        assert vs.fast_plane is None
    finally:
        vs.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_silent_client_and_the_accept_loop(pki, tls, kind):
    """A client that connects and sends nothing: the JAX server runs the
    handshake in its accept loop, so a second client's handshake times
    out behind it; the port's runs each on its connection's thread."""
    hu = _pkg(kind)[0]
    ca, srv, _, _ = pki
    tls(*srv, ca)
    router = hu.Router()
    router.add("GET", "/ping", lambda req: {"pong": True})
    s = hu.HttpServer(0, router, "127.0.0.1").start()
    silent = socket.create_connection(("127.0.0.1", s.port))
    try:
        time.sleep(0.2)  # the server has accepted it
        t0 = time.monotonic()
        try:
            out = hu.get_json(f"http://127.0.0.1:{s.port}/ping", timeout=1)
        except hu.HttpError as e:
            out = e.status
        took = time.monotonic() - t0
    finally:
        silent.close()
        s.stop()
    if kind == "ref":
        assert out == 503 and took >= 0.9
    else:
        assert out == {"pong": True} and took < 0.9


def test_degraded_read_over_mutual_tls_matches_jax(pki, tls, tmp_path):
    """Two port holders serve a volume's shards under mutual TLS; the
    JAX and the port engines reconstruct a lost shard's ranges from them
    (no survivor local): the same bytes, the lost shard's, and the same
    counters. A client that presents no certificate is refused."""
    import test_torch_degraded as td
    from seaweedfs_tpu.ec import degraded as ref_degraded
    from seaweedfs_tpu_torch.ec import DegradedReadEngine
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    ca, srv, _, _ = pki
    tls(*srv, ca, mutual=True)
    (tmp_path / "mine").mkdir()
    shards, base = td._seed(tmp_path / "mine", "flat")
    hdir = tmp_path / "holder"
    shutil.copytree(tmp_path / "mine", hdir)
    open(hdir / "1.ecx", "wb").close()
    lost = 3
    holders = [VolumeServer(port=0, directories=[str(hdir)], device="cpu",
                            fast_port=-1).start() for _ in range(2)]
    try:
        locs = {i: [h.url for h in holders] for i in range(td.TOTAL)
                if i != lost}
        ev = td._Ev({})
        ref_c, port_c = td._codecs("numpy")
        engines = [cls(store=td._Store(ev), locations=lambda vid: locs,
                       codec=lambda c=c: c, slab=4096, batch_ms=0.0)
                   for cls, c in ((ref_degraded.DegradedReadEngine, ref_c),
                                  (DegradedReadEngine, port_c))]
        w = shards.shape[1]
        for off, size in [(0, 100), (4000, 9000), (w - 50, 200)]:
            want = td._expect(shards, lost, off, size)
            for eng in engines:
                assert eng.read(1, lost, off, size) == want, (off, size)
        a, b = (eng.snapshot() for eng in engines)
        assert {k: b[k] for k in td.REMOTE_KEYS} == \
            {k: a[k] for k in td.REMOTE_KEYS}
        assert b["remote_bytes"] > 0
        served = sum(h.store.find_ec_volume(1) is not None for h in holders)
        assert served == 2
        # the peers' shard reads are admin routes: a client without a
        # certificate is refused there, not on the public /status
        port = int(holders[0].url.rsplit(":", 1)[1])
        st, body = _https(port, "GET", "/admin/ec/shard_read?volume=1"
                          "&shard=0&offset=0&size=16", ca=ca)
        assert (st, b"certificate" in body) == (403, True)
        assert _https(port, "GET", "/status", ca=ca)[0] == 200
    finally:
        for h in holders:
            h.stop()
