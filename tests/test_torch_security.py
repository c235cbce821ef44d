"""The port's write tokens, whitelist guard and etcd sequencer against the
JAX package's.

* ``Guard`` of both packages over seeded rule sets (exact IPs, "10.0."
  prefixes, CIDRs, blanks) and seeded addresses (v4, v6, malformed):
  ``enabled`` and every ``allows`` equal.
* Tokens: ``encode_jwt`` and ``GenJwt`` of seeded keys, fids and claims,
  with ``time.time`` fixed for both modules, byte-identical;
  ``decode_jwt`` / ``verify_fid_jwt`` reject the same wrong-key,
  expired, other-fid and malformed tokens with the same message, and
  ``jwt_from_request`` reads the same header and query forms.
* A secured cluster of each package (a master and two volume servers
  with one key; the JAX servers without their native plane): the cases
  of the JAX ``test_security.py`` (an unauthenticated write, another
  fid's token, a write with its token, a 001 write on both replicas, a
  delete without and with ``GenJwt``, ``upload_data`` sending its
  assign's token), each answer's status equal between the packages; and
  a whitelist that leaves the caller out: 403 on the client routes,
  heartbeats still taken.
* A JAX ``EtcdSequencer`` and a port one sharing one fake etcd (the JAX
  tests' ``test_filer.fake_etcd()``) never mint one key twice;
  ``sequencer.dat`` raises etcd before the first grant and takes each
  grant's ceiling; both packages' ``EtcdClient`` answer the same KV
  calls alike.

Tolerances: none (equal)."""

import json
import random
import time

import numpy as np
import pytest

from seaweedfs_tpu.security import guard as ref_guard
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu_torch.security import guard as port_guard
from seaweedfs_tpu_torch.security import jwt as port_jwt

KEY = "test-signing-key"


# -- the guard -------------------------------------------------------------

def _rules(rng):
    pool = ["127.0.0.1", "10.0.", "10.1.2.3", "192.168.0.0/16",
            "172.16.5.0/24", "::1", "fe80::/10", " ", "", "8.8.8.8",
            "10.", "2001:db8::/32"]
    return [pool[i] for i in rng.choice(len(pool), int(rng.integers(0, 6)),
                                        replace=False)]


def _ips(rng, n=60):
    out = ["127.0.0.1", "::1", "not-an-ip", "", "10.0.5.6", "fe80::1"]
    for _ in range(n):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(".".join(str(int(x)) for x in
                                rng.choice([10, 127, 172, 192, 8], 1).tolist()
                                + rng.integers(0, 256, 3).tolist()))
        elif kind == 1:
            out.append("192.168.%d.%d" % tuple(rng.integers(0, 256, 2)))
        else:
            out.append("2001:db8::%x" % int(rng.integers(0, 65536)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_guard_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rules = _rules(rng)
    ref, port = ref_guard.Guard(rules), port_guard.Guard(rules)
    assert port.enabled == ref.enabled
    ips = _ips(rng)
    assert [port.allows(ip) for ip in ips] == [ref.allows(ip) for ip in ips]


# -- tokens ----------------------------------------------------------------

@pytest.fixture
def fixed_clock(monkeypatch):
    now = [1_700_000_000.25]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


def test_tokens_are_byte_identical(fixed_clock):
    rng = random.Random(3)
    for _ in range(40):
        key = "".join(rng.choice("abcxyz0189-_") for _ in range(
            rng.randint(1, 24)))
        fid = f"{rng.randint(1, 999)},{rng.getrandbits(40):x}"
        exp = rng.randint(1, 100)
        assert port_jwt.GenJwt(key, fid, exp) == ref_jwt.GenJwt(key, fid, exp)
        assert port_jwt.GenJwt(key, fid) == ref_jwt.GenJwt(key, fid)
        claims = {"fid": fid, "n": rng.randint(0, 9), "x": [1, "é"]}
        assert port_jwt.encode_jwt(key, claims) == \
            ref_jwt.encode_jwt(key, claims)


def _verdict(mod, fn, *args):
    try:
        return ("ok", fn(*args))
    except mod.VerifyError as e:
        return ("refused", str(e))


def test_decode_refuses_alike(fixed_clock):
    good = ref_jwt.GenJwt(KEY, "3,01ab", expires_seconds=60)
    expired = ref_jwt.encode_jwt(KEY, {"fid": "3,01ab",
                                       "exp": int(fixed_clock[0]) - 1})
    no_exp = ref_jwt.encode_jwt(KEY, {"fid": "3,01ab"})
    cases = [
        ("decode", KEY, good), ("decode", "other-key", good),
        ("decode", KEY, expired), ("decode", KEY, no_exp),
        ("decode", KEY, "garbage"), ("decode", KEY, "a.b"),
        ("decode", KEY, good[:-3] + "AAA"),
        ("fid", KEY, good, "3,01ab"), ("fid", KEY, good, "4,02cd"),
        ("fid", "other-key", good, "3,01ab"),
    ]
    for case in cases:
        out = []
        for mod in (ref_jwt, port_jwt):
            fn = mod.decode_jwt if case[0] == "decode" else mod.verify_fid_jwt
            out.append(_verdict(mod, fn, *case[1:]))
        assert out[1] == out[0], case
    assert [_verdict(port_jwt, port_jwt.decode_jwt, *c[1:])[0]
            for c in cases[:5]] == ["ok", "refused", "refused", "ok",
                                    "refused"]
    for headers, query in (({"Authorization": "Bearer abc "}, {}),
                           ({"Authorization": "Basic abc"}, {"jwt": "q"}),
                           ({}, {"jwt": "q"}), ({}, {}),
                           ({"Authorization": "Bearer a"}, {"jwt": "q"})):
        assert port_jwt.jwt_from_request(headers, query) == \
            ref_jwt.jwt_from_request(headers, query)


# -- secured clusters ------------------------------------------------------

def _secured(kind, root, whitelist=()):
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        skw = {"ec_backend": "numpy", "fast_port": -1}
        mkw = {}
    else:
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        skw = {"device": "cpu"}
        mkw = {"seed": 1}
    master = MasterServer(port=0, volume_size_limit_mb=64, pulse_seconds=1,
                          jwt_signing_key=KEY, whitelist=whitelist,
                          vacuum_interval=0, **mkw).start()
    servers = [VolumeServer(port=0, directories=[str(root / f"{kind}-v{i}")],
                            master_url=master.url, pulse_seconds=1,
                            max_volume_counts=[20], jwt_signing_key=KEY,
                            **skw).start() for i in range(2)]
    return op, master, servers


def _status(fn):
    from seaweedfs_tpu_torch.server.http_util import HttpError as PortError
    from seaweedfs_tpu.server.http_util import HttpError as RefError
    try:
        out = fn()
        return ("ok", out if isinstance(out, (bool, bytes)) else None)
    except (PortError, RefError) as e:
        return ("http", e.status)


def _secured_flow(kind, root):
    from seaweedfs_tpu_torch.server.http_util import http_call, post_multipart
    op, master, servers = _secured(kind, root)
    mod = ref_jwt if kind == "ref" else port_jwt
    out = {}
    try:
        a = op.assign(master.url)
        out["auth handed out"] = bool(a.get("auth"))
        out["no token"] = _status(lambda: post_multipart(
            f"http://{a['url']}/{a['fid']}", "f", b"data"))
        b = op.assign(master.url)
        out["other fid's token"] = _status(lambda: op.upload(
            a["url"], a["fid"], b"data", jwt=b["auth"]))
        out["token in the query"] = _status(lambda: post_multipart(
            f"http://{b['url']}/{b['fid']}?jwt={b['auth']}", "f", b"q"))
        out["with its token"] = _status(lambda: op.upload(
            a["url"], a["fid"], b"data", jwt=a["auth"]))
        out["read needs none"] = _status(lambda: op.read_file(master.url,
                                                              a["fid"]))
        r = op.assign(master.url, replication="001")
        out["001 write"] = _status(lambda: op.upload(
            r["url"], r["fid"], b"replicated", jwt=r["auth"]))
        urls = op.lookup(master.url, int(r["fid"].split(",")[0]))
        out["both replicas"] = [http_call("GET", f"http://{u}/{r['fid']}")
                                for u in sorted(urls)]
        out["delete without a token"] = op.delete_file(master.url, r["fid"])
        out["001 delete with GenJwt"] = op.delete_file(
            master.url, r["fid"], jwt=mod.GenJwt(KEY, r["fid"]))
        out["gone on both"] = [_status(lambda u=u: http_call(
            "GET", f"http://{u}/{r['fid']}")) for u in sorted(urls)]
        fid = op.upload_data(master.url, b"auto-jwt")
        out["upload_data"] = op.read_file(master.url, fid)
        out["submit"] = _status(lambda: post_multipart(
            f"http://{master.url}/submit", "s.bin", b"s")["size"] == 1)
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
    return out


def test_secured_cluster_matches_jax(tmp_path):
    ref = _secured_flow("ref", tmp_path)
    port = _secured_flow("port", tmp_path)
    assert port == ref
    assert port["no token"] == ("http", 401)
    assert port["other fid's token"] == ("http", 401)
    assert port["with its token"] == ("ok", None)
    assert port["both replicas"] == [b"replicated"] * 2
    assert port["delete without a token"] is False
    assert port["gone on both"] == [("http", 404)] * 2


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_whitelist_leaves_the_cluster_channels_open(tmp_path, kind):
    """A master and volume servers whose whitelist leaves the caller out:
    403 on the client routes, yet the servers' heartbeats register
    them; the port's answers are the JAX one's."""
    from seaweedfs_tpu_torch.server.http_util import (HttpError, get_json,
                                                      post_json)
    op, master, servers = _secured(kind, tmp_path, whitelist=["10.9.9.9"])
    try:
        with pytest.raises(HttpError) as e:
            get_json(f"http://{master.url}/dir/assign")
        assert e.value.status == 403 and "whitelist" in e.value.message
        assert post_json(f"http://{master.url}/cluster/heartbeat",
                         {"ip": "127.0.0.1", "port": servers[0].port,
                          "max_volume_count": 20, "volumes": []}
                         )["volume_size_limit"] == 64 << 20
        assert {n.url for n in master.topology.all_nodes()} == \
            {vs.url for vs in servers}
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def test_volume_server_whitelist(tmp_path):
    from seaweedfs_tpu_torch.server.http_util import HttpError, get_json
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    shut = VolumeServer(port=0, directories=[str(tmp_path / "a")],
                        device="cpu", whitelist=["10.0."]).start()
    open_ = VolumeServer(port=0, directories=[str(tmp_path / "b")],
                         device="cpu", whitelist=["127.0.0.0/8"]).start()
    try:
        with pytest.raises(HttpError) as e:
            get_json(f"http://{shut.url}/status")
        assert e.value.status == 403
        assert "volumes" in get_json(f"http://{open_.url}/status")
    finally:
        shut.stop()
        open_.stop()


# -- the etcd sequencer ----------------------------------------------------

def _etcd_seqs(srv, **kw):
    from seaweedfs_tpu.topology.topology import EtcdSequencer as Ref
    from seaweedfs_tpu_torch.topology.topology import EtcdSequencer as Port
    addr = f"127.0.0.1:{srv.port}"
    return (Ref(addr, user=srv.USER, password=srv.PASSWORD, **kw),
            Port(addr, user=srv.USER, password=srv.PASSWORD, **kw))


def test_etcd_sequencers_never_collide():
    from test_filer import fake_etcd
    srv = fake_etcd()
    ref, port = _etcd_seqs(srv, block=10)
    rng = random.Random(5)
    seen = set()
    try:
        for _ in range(150):
            s = ref if rng.random() < 0.5 else port
            if rng.random() < 0.05:
                s.set_max(max(seen or {0}) + rng.randint(0, 30))
                continue
            n = rng.randint(1, 4)
            start = s.next_file_id(n)
            ids = set(range(start, start + n))
            assert not ids & seen, "a key minted twice"
            seen |= ids
    finally:
        ref.close()
        port.close()


def test_sequencer_dat_seeds_etcd(tmp_path):
    from test_filer import fake_etcd
    from seaweedfs_tpu_torch.topology.topology import EtcdSequencer
    srv = fake_etcd()
    (tmp_path / "sequencer.dat").write_text("12345")
    s = EtcdSequencer(f"127.0.0.1:{srv.port}", user=srv.USER,
                      password=srv.PASSWORD, block=10,
                      meta_dir=str(tmp_path))
    try:
        first = s.next_file_id()
        assert first > 12345
        assert int((tmp_path / "sequencer.dat").read_text()) >= first
        assert int(srv.kv[b"/seaweedfs/master/sequence"]) == \
            int((tmp_path / "sequencer.dat").read_text())
    finally:
        s.close()
    # a JAX sequencer on the same etcd grants above the port's window
    ref, _ = _etcd_seqs(srv, block=10)
    try:
        assert ref.next_file_id() > first + 9
    finally:
        ref.close()


def test_etcd_clients_match_jax():
    from test_filer import fake_etcd
    from seaweedfs_tpu.filer import etcd_store as ref_etcd
    from seaweedfs_tpu_torch.filer import etcd_store as port_etcd
    got = []
    for mod in (ref_etcd, port_etcd):
        srv = fake_etcd()
        c = mod.EtcdClient.from_addr(f"127.0.0.1:{srv.port}", user=srv.USER,
                                     password=srv.PASSWORD)
        c.authenticate()
        out = [c.put_if(b"/k", None, b"1"), c.put_if(b"/k", None, b"2"),
               c.put_if(b"/k", b"1", b"3"), c.range(b"/k")]
        for i in range(5):
            c.put(b"/d\x00%d" % i, b"v%d" % i)
        out += [c.range(b"/d\x00", mod.prefix_end(b"/d\x00")),
                c.range(b"/d\x00", mod.prefix_end(b"/d\x00"), limit=2),
                c.delete_range(b"/d\x002", mod.prefix_end(b"/d\x00")),
                c.range(b"/d", mod.prefix_end(b"/d"))]
        srv.expire_tokens()
        out.append(c.range(b"/k"))
        try:
            mod.EtcdClient("127.0.0.1", srv.port).put(b"/x", b"y")
        except mod.EtcdError as e:
            out.append(str(e))
        c.close()
        got.append(json.loads(json.dumps(out, default=repr)))
    assert got[1] == got[0]
    for key in (b"/a\x00", b"a", b"a\xff", b"\xff\xff"):
        assert port_etcd.prefix_end(key) == ref_etcd.prefix_end(key)
    with pytest.raises(ValueError):
        port_etcd.EtcdClient.from_addr("no-port")
