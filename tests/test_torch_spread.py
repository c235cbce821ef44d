"""The port's streaming EC encode+spread (ec/spread.py, the push role of
ec/transport.py, encoder.write_ec_files_spread, the source's
``/admin/ec/generate`` and the holders' ``/admin/ec/shard_write``,
``copy`` and ``mount``) against the JAX package's, over HTTP on
localhost (CPU, small shards).

* Both packages' sinks spread the same .dat, flat and piggyback, RS(6,3)
  and RS(10,4), the port's sync and pipelined on ``device="cpu"`` (the
  plain K1); the JAX one runs NumpyCodec, as tests/test_streaming_spread.py
  does. Every shard lands at its holder byte-identical to the JAX local
  encode's, and the counters both report agree; with one shard a target
  and a window of 1 the sends and per-holder counts are deterministic and
  agree too.
* The drills of tests/test_streaming_spread.py and tests/test_transport.py
  run through both packages over the JAX package's fake holder
  (``FakeTarget``): the bounded window, mid-stream death (no partials,
  no ``ec-push-*`` thread), failover onto a spare, the hedged first run,
  and the producer's pacing.
* The port's ``shard_write`` route answers as a JAX ``VolumeServer``
  does, and chunked bodies go both ways between the packages' clients
  and servers.
* A readonly → generate → copy → mount round trip between port servers
  gives the shards and sidecars of the JAX ``Store.generate_ec_shards``
  and ``generate_ec_shards_streaming``.

Tolerances: none; every comparison is exact (bytes, counts, statuses).
"""

import json
import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

from conftest import wait_until
from seaweedfs_tpu.ec import spread as ref_spread
from seaweedfs_tpu.ec import transport as ref_transport
from seaweedfs_tpu.ec import write_ec_files as ref_write_ec_files
from seaweedfs_tpu.ec.encoder import \
    write_ec_files_spread as ref_write_ec_files_spread
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.server import http_util as ref_http
from seaweedfs_tpu_torch.ec import spread, to_ext, transport
from seaweedfs_tpu_torch.ec.encoder import write_ec_files_spread
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
from seaweedfs_tpu_torch.server import http_util
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from test_streaming_spread import ENC, LOCAL, FakeTarget

#: remote shards of each geometry, by holder a / b
REMOTE = {(6, 3): {1: "a", 4: "a", 7: "a", 2: "b", 8: "b"},
          (10, 4): {1: "a", 4: "a", 7: "a", 11: "a", 2: "b", 8: "b",
                    13: "b"}}
#: spread stats both packages report with the same meaning
SPREAD_KEYS = ("spread_bytes", "spread_stripes", "spread_retries",
               "spread_failovers", "spread_remote_shards", "shard_size",
               "hedges_fired", "hedges_won", "hedges_lost", "holder_errors")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain K1 runs many small torch ops a stripe; with the suite's
    workers sharing the cores, intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _dat(directory, nbytes, seed=7):
    """Volume 1's .dat of seeded bytes in ``directory``; returns the base."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(str(directory), "1")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    return base


def _oracle(src_base, directory, k, m, layout):
    """The JAX package's local encode of the same .dat: {sid: bytes}."""
    base = _dat(directory, 0)
    shutil.copy(src_base + ".dat", base + ".dat")
    ref_write_ec_files(base, codec=RefNumpyCodec(k, m), layout=layout, **ENC)
    return {i: _read(base + to_ext(i)) for i in range(k + m)}


def _parts(*dirs):
    return [f for d in dirs for f in os.listdir(str(d))
            if f.endswith(".part")]


def _push_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("ec-push-")]


def _port_holder(directory):
    return VolumeServer(port=0, directories=[str(directory)],
                        device="cpu").start()


# -- the spread, both packages, byte for byte --------------------------------

@pytest.mark.parametrize("mode", ["sync", "pipelined"])
@pytest.mark.parametrize("km", [(6, 3), (10, 4)], ids=["rs6_3", "rs10_4"])
@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_spread_matches_jax(tmp_path, layout, km, mode):
    k, m = km
    nbytes = k * (64 << 10) + 70_001
    ref_base = _dat(tmp_path / "ref", nbytes)
    port_base = _dat(tmp_path / "port", nbytes)
    want = _oracle(ref_base, tmp_path / "oracle", k, m, layout)
    for n in "ab":
        os.makedirs(tmp_path / f"ref_{n}")
    ref_t = {n: FakeTarget(str(tmp_path / f"ref_{n}")) for n in "ab"}
    port_h = {n: _port_holder(tmp_path / f"port_{n}") for n in "ab"}
    try:
        runs = {}
        for name, base, urls in (("ref", ref_base, ref_t), ("port", port_base,
                                                              port_h)):
            remote = {sid: urls[h].url for sid, h in REMOTE[km].items()}
            assignment = {sid: remote.get(sid, LOCAL) for sid in range(k + m)}
            stats = {}
            if name == "ref":
                sink = ref_spread.StripedSpreadSink(
                    1, base, assignment, k + m, local_url=LOCAL, window=2)
                ref_write_ec_files_spread(base, sink, codec=RefNumpyCodec(k, m),
                                          stats=stats, layout=layout, **ENC)
            else:
                sink = spread.StripedSpreadSink(
                    1, base, assignment, k + m, local_url=LOCAL, window=2)
                write_ec_files_spread(
                    base, sink, codec=TorchCodec(k, m, device="cpu"),
                    stats=stats, layout=layout,
                    pipelined=mode == "pipelined", **ENC)
            runs[name] = (stats, sink.assignment())
            for sid in range(k + m):
                holder = {"a": f"{name}_a", "b": f"{name}_b"}.get(
                    REMOTE[km].get(sid), name)
                assert _read(str(tmp_path / holder / f"1{to_ext(sid)}")) \
                    == want[sid], f"{name} shard {sid}"
                assert (sid in REMOTE[km]) != \
                    os.path.exists(base + to_ext(sid))
        assert not _parts(*(tmp_path / d for d in os.listdir(tmp_path)))
        (ref, ref_final), (got, final) = runs["ref"], runs["port"]
        for key in SPREAD_KEYS:
            assert got[key] == ref[key], key
        assert got["spread_bytes"] == got["shard_size"] * (k + m)
        assert got["dispatches"] >= 1    # the port's plain K1 ran
        assert got["spread_sends"] >= got["spread_stripes"]
        assert sum(got["holder_fetches"].values()) <= got["spread_sends"]
        assert 0.0 <= got["overlap_frac"] <= 1.0
        telemetry_only = {"mesh_dispatches", "mesh_device_bytes",
                          "dispatch_width_devices", "device_busy_frac"}
        assert set(ref) - telemetry_only <= set(got)
        assert {s: bool(u) for s, u in final.items()} == \
            {s: bool(u) for s, u in ref_final.items()}
    finally:
        for t in list(ref_t.values()) + list(port_h.values()):
            t.stop()


@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_spread_counts_match_jax(tmp_path, layout):
    """One shard a target and a window of 1: every queued row is its own
    run, so the sends and the per-holder counts are the same in both
    packages (stripes x shards; stripes per holder)."""
    k, m = 6, 3
    nbytes = k * (64 << 10) + 70_001
    ref_base = _dat(tmp_path / "ref", nbytes)
    port_base = _dat(tmp_path / "port", nbytes)
    targets = {}
    for name in ("ref", "port"):
        targets[name] = []
        for sid in range(k + m):
            d = tmp_path / f"{name}_{sid}"
            d.mkdir()
            targets[name].append(FakeTarget(str(d)) if name == "ref"
                                 else _port_holder(d))
    try:
        out = {}
        for name, base in (("ref", ref_base), ("port", port_base)):
            urls = [t.url for t in targets[name]]
            assignment = dict(enumerate(urls))
            stats = {}
            if name == "ref":
                sink = ref_spread.StripedSpreadSink(1, base, assignment,
                                                    k + m, window=1)
                ref_write_ec_files_spread(base, sink, codec=RefNumpyCodec(k, m),
                                          stats=stats, layout=layout, **ENC)
            else:
                sink = spread.StripedSpreadSink(1, base, assignment, k + m,
                                                window=1)
                write_ec_files_spread(base, sink,
                                      codec=TorchCodec(k, m, device="cpu"),
                                      stats=stats, layout=layout, **ENC)
            stats["by_shard"] = [stats["holder_fetches"].get(u, 0)
                                 for u in urls]
            out[name] = stats
        for key in SPREAD_KEYS + ("spread_sends", "by_shard"):
            assert out["port"][key] == out["ref"][key], key
        assert out["port"]["spread_sends"] == \
            out["port"]["spread_stripes"] * (k + m)
        assert out["port"]["spread_remote_shards"] == k + m
    finally:
        for ts in targets.values():
            for t in ts:
                t.stop()


def test_merge_runs_matches_jax():
    rng = np.random.default_rng(4)
    batch, offs = [], {}
    for _ in range(60):
        sid = int(rng.integers(0, 5))
        n = int(rng.integers(1, 9))
        off = offs.get(sid, 0)
        if rng.random() < 0.15:
            off += 3             # a gap starts a new run
        batch.append((sid, off, bytes([sid]) * n))
        offs[sid] = off + n
    assert transport.merge_runs(batch) == ref_transport.merge_runs(batch)


def test_defaults_match_jax(monkeypatch):
    monkeypatch.delenv("SW_EC_SPREAD_WINDOW", raising=False)
    monkeypatch.delenv("SW_EC_HEDGE_MS", raising=False)
    assert spread.spread_window() == ref_spread.spread_window() == 4
    assert transport.push_window() == ref_transport.push_window()
    assert issubclass(spread.StripedSpreadSink, transport.StripedPush)
    assert spread.SpreadStats().snapshot().keys() == \
        ref_spread.SpreadStats().snapshot().keys()
    assert transport.GatherStats().snapshot().keys() == \
        ref_transport.GatherStats().snapshot().keys()


# -- the drills, both packages over the JAX fake holder ---------------------

def _sink(pkg, *args, **kwargs):
    return (ref_spread if pkg == "ref" else spread).StripedSpreadSink(
        *args, **kwargs)


def _spread(pkg, base, sink, k, m, **kw):
    if pkg == "ref":
        return ref_write_ec_files_spread(base, sink, codec=RefNumpyCodec(k, m),
                                         **ENC, **kw)
    return write_ec_files_spread(base, sink,
                                 codec=TorchCodec(k, m, device="cpu"),
                                 pipelined=False, **ENC, **kw)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_bounded_send_window(tmp_path, pkg):
    k, m, window, n_stripes = 6, 3, 1, 10
    base = _dat(tmp_path / "src", k * (16 << 10) * n_stripes)
    want = _oracle(base, tmp_path / "oracle", k, m, "flat")
    (tmp_path / "t").mkdir()
    tgt = FakeTarget(str(tmp_path / "t"))
    tgt.delay = 0.02         # a slow holder: the encode waits, not buffers
    try:
        stats = {}
        sink = _sink(pkg, 1, base, {sid: tgt.url for sid in range(k + m)},
                     k + m, local_url=LOCAL, window=window)
        _spread(pkg, base, sink, k, m, stats=stats)
        for sid in range(k + m):
            assert _read(str(tmp_path / "t" / f"1{to_ext(sid)}")) == want[sid]
        # queued + in-hand batch + the stripe being routed, never the
        # whole volume
        assert stats["peak_spread_buffer"] <= \
            (2 * window + 1) * (k + m) * ENC["slab"]
        assert stats["peak_spread_buffer"] < stats["spread_bytes"] // 2
        assert stats["spread_stripes"] == n_stripes
        assert sink.blocked_s > 0
    finally:
        tgt.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_midstream_failure_leaves_no_partials(tmp_path, pkg):
    k, m = 6, 3
    base = _dat(tmp_path / "src", k * (16 << 10) * 8)
    (tmp_path / "t").mkdir()
    tgt = FakeTarget(str(tmp_path / "t"))
    tgt.fail_after = 2       # dies after acking two appends: unreplayable
    try:
        sink = _sink(pkg, 1, base, {sid: tgt.url if sid in (3, 5) else LOCAL
                                    for sid in range(k + m)},
                     k + m, local_url=LOCAL, window=1)
        err = ref_transport.SpreadError if pkg == "ref" \
            else transport.SpreadError
        with pytest.raises(err):
            _spread(pkg, base, sink, k, m)
        for d in (tmp_path / "src", tmp_path / "t"):
            leftovers = [f for f in os.listdir(str(d))
                         if ".ec" in f or f.endswith(".part")]
            assert leftovers == [], f"{d}: {leftovers}"
        assert tgt.aborted >= 1
        assert wait_until(lambda: not _push_threads(), timeout=5)
    finally:
        tgt.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_failover_reassigns_dead_target(tmp_path, pkg):
    k, m = 6, 3
    base = _dat(tmp_path / "src", k * (16 << 10) * 6)
    want = _oracle(base, tmp_path / "oracle", k, m, "flat")
    (tmp_path / "dead").mkdir()
    (tmp_path / "spare").mkdir()
    dead, spare = FakeTarget(str(tmp_path / "dead")), \
        FakeTarget(str(tmp_path / "spare"))
    dead.fail = True
    try:
        stats = {}
        sink = _sink(pkg, 1, base, {sid: dead.url if sid in (7, 8) else LOCAL
                                    for sid in range(k + m)},
                     k + m, local_url=LOCAL, spares=[spare.url], window=2)
        _spread(pkg, base, sink, k, m, stats=stats)
        for sid in (7, 8):
            assert _read(str(tmp_path / "spare" / f"1{to_ext(sid)}")) \
                == want[sid]
            assert sink.assignment()[sid] == spare.url
        assert stats["spread_failovers"] == 1
        assert stats["spread_retries"] == 1
        assert stats["holder_errors"] == {dead.url: 2}
        assert not os.listdir(str(tmp_path / "dead"))
    finally:
        dead.stop()
        spare.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_push_hedge_spare_wins(tmp_path, pkg, monkeypatch):
    k, m = 6, 3
    base = _dat(tmp_path / "src", k * (16 << 10) * 4)
    want = _oracle(base, tmp_path / "oracle", k, m, "flat")
    (tmp_path / "slow").mkdir()
    (tmp_path / "fast").mkdir()
    slow, fast = FakeTarget(str(tmp_path / "slow")), \
        FakeTarget(str(tmp_path / "fast"))
    try:
        slow.delay = 0.6
        kw = {}
        if pkg == "ref":
            monkeypatch.setenv("SW_EC_HEDGE_MS", "60")
        else:
            kw["hedge_ms"] = 60
        stats = (ref_transport if pkg == "ref" else transport).SpreadStats()
        sink = _sink(pkg, 1, base, {sid: slow.url if sid == 8 else LOCAL
                                    for sid in range(k + m)},
                     k + m, local_url=LOCAL, spares=[fast.url], window=2,
                     stats=stats, **kw)
        t0 = time.perf_counter()
        _spread(pkg, base, sink, k, m)
        wall = time.perf_counter() - t0
        assert stats.hedges_fired >= 1 and stats.hedges_won >= 1
        assert sink.assignment()[8] == fast.url
        assert _read(str(tmp_path / "fast" / f"1{to_ext(8)}")) == want[8]
        assert wall < 2.0    # hedged, not waited out
        # the straggler's duplicate stage is aborted once it drains
        assert wait_until(lambda: not any(
            f.endswith(to_ext(8)) or f.endswith(".part")
            for f in os.listdir(str(tmp_path / "slow"))), timeout=5)
    finally:
        slow.stop()
        fast.stop()


def test_push_rate_cap_paces_producer(tmp_path):
    total, w, n_stripes = 2, 64 << 10, 8
    writers = [transport.LocalShardWriter(str(tmp_path / f"s{i}.ec0{i}"))
               for i in range(total)]
    rate = 2.0  # MB/s; 2 shards x 8 x 64 KiB = 1 MiB -> ~0.52 s floor
    sink = transport.StripedPush(writers, {None: list(range(total))},
                                 window=4, rate_mbps=rate)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    for _ in range(n_stripes):
        row = rng.integers(0, 256, (1, w), dtype=np.uint8)
        sink.write_stripe(row, row)
    sink.finish()
    elapsed = time.perf_counter() - t0
    expected = total * n_stripes * w / (rate * 1e6)
    assert elapsed >= 0.8 * expected
    for i in range(total):
        assert os.path.getsize(str(tmp_path / f"s{i}.ec0{i}")) \
            == n_stripes * w


def test_rate_zero_means_unpaced(tmp_path):
    sink = transport.StripedPush(
        [transport.LocalShardWriter(str(tmp_path / "s0.ec00"))], {None: [0]},
        window=4)
    row = np.zeros((1, 4096), dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(4):
        sink.write_stripe(row, row[:0])
    sink.finish()
    assert time.perf_counter() - t0 < 1.0
    assert sink.stats.bytes == 4 * 4096 and sink.stats.local_shards == 1


# -- the shard_write route and chunked bodies against a JAX VolumeServer ----

@pytest.fixture
def servers(tmp_path):
    """(JAX VolumeServer, port VolumeServer) over empty directories."""
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    ref = RefVolumeServer(port=0, directories=[str(tmp_path / "ref")],
                          master_url="127.0.0.1:1", ec_backend="numpy",
                          fast_port=-1, max_volume_counts=[5]).start()
    port = VolumeServer(port=0, directories=[str(tmp_path / "port")],
                        device="cpu").start()
    yield ref, port
    port.stop()
    ref.stop()


def _outcome(fn):
    """(status, JSON body) of a client call, an HttpError's included."""
    try:
        return 200, json.loads(fn())
    except (http_util.HttpError, ref_http.HttpError) as e:
        return e.status, json.loads(str(e).split(": ", 1)[1])


def test_shard_write_route_matches_jax(servers):
    p1, p2 = b"x" * 70_000, b"y" * 30_000
    seen = {}
    for name, vs in zip(("ref", "port"), servers):
        url = f"http://{vs.url}/admin/ec/shard_write?volume=77&shard=0"
        url1 = url.replace("shard=0", "shard=1")
        post = http_util.post_chunked
        call = http_util.http_call
        steps = [
            lambda: post(f"{url}&offset=0", [p1[:40_000], p1[40_000:]]),
            lambda: post(f"{url}&offset=10", [b"z"]),
            lambda: post(f"{url}&offset={len(p1)}", [p2]),
            lambda: post(f"{url}&offset={len(p1)}", [p2]),
            lambda: call("POST", f"{url}&action=finalize&size=1"),
            lambda: call("POST",
                         f"{url}&action=finalize&size={len(p1) + len(p2)}"),
            lambda: call("POST", f"{url}&action=finalize&size=5"),
            lambda: post(f"{url1}&offset=0", [b"a" * 100]),
            lambda: post(f"{url1}&offset=0", [b"b" * 60]),
            lambda: call("POST", f"http://{vs.url}/admin/ec/shard_write"
                                 f"?volume=77&action=abort"),
            lambda: call("POST", f"http://{vs.url}/admin/ec/shard_write"
                                 f"?volume=77&action=abort"),
        ]
        seen[name] = [_outcome(fn) for fn in steps]
        loc = vs.store.locations[0].directory
        seen[name].append(sorted(os.listdir(loc)))
        seen[name].append(_read(os.path.join(loc, f"77{to_ext(0)}")))
    assert seen["port"] == seen["ref"]
    statuses = [s for s, _ in seen["port"][:11]]
    assert statuses == [200, 409, 200, 409, 409, 200, 404, 200, 200, 200,
                        200]
    assert "staged=70000" in seen["port"][1][1]["error"]
    assert seen["port"][-1] == p1 + p2


def _raw(url, head: bytes, body: bytes):
    """Send a hand-framed request; -> (status, JSON body)."""
    host, port = url.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(head + body)
        s.shutdown(socket.SHUT_WR)
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    status = int(data.split(b" ", 2)[1])
    return status, json.loads(data.split(b"\r\n\r\n", 1)[1])


@pytest.mark.parametrize("body", [
    b"5\r\nhello\r\n3;ext=1\r\nabc\r\n0\r\nX-Trailer: 1\r\n\r\n",
    b"zz\r\nhello\r\n0\r\n\r\n",
    b"10\r\nabc",
    b"5\r\nhel",
], ids=["trailer", "bad size", "truncated chunk", "no chunk end"])
def test_read_chunked_matches_jax(servers, body):
    target = b"/admin/ec/shard_write?volume=5&shard=2&offset=0"
    outs = []
    for vs in servers:
        host = vs.url.encode()
        head = (b"POST " + target + b" HTTP/1.1\r\nHost: " + host +
                b"\r\nTransfer-Encoding: chunked\r\nConnection: close"
                b"\r\n\r\n")
        outs.append(_raw(vs.url, head, body))
    assert outs[1] == outs[0]


def test_post_chunked_both_ways(servers):
    ref, port = servers
    chunks = [bytes([i]) * (1000 + 37 * i) for i in range(9)]
    for client, vs in ((http_util, ref), (ref_http, port),
                       (http_util, port), (ref_http, ref)):
        out = json.loads(client.post_chunked(
            f"http://{vs.url}/admin/ec/shard_write?volume=9&shard=3"
            f"&offset=0", iter(chunks)))
        assert out == {"volume": 9, "shard": 3,
                       "staged": sum(map(len, chunks))}
        path = os.path.join(vs.store.locations[0].directory,
                            f"9{to_ext(3)}.part")
        assert _read(path) == b"".join(chunks)
        os.remove(path)


# -- ec.encode between port servers: readonly -> generate -> copy -> mount --

def _volume(directory, nbytes, seed):
    """Plain volume 1: a .dat with a superblock and needles every 64 KiB,
    and its .idx."""
    from seaweedfs_tpu_torch.storage import SuperBlock, entry_to_bytes
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(str(directory), "1")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(SuperBlock().to_bytes())
        f.write(rng.integers(0, 256, nbytes - 8, dtype=np.uint8).tobytes())
    with open(base + ".idx", "wb") as f:
        for i in range((nbytes - 8) >> 16):
            f.write(entry_to_bytes(int(rng.integers(1, 1 << 40)),
                                   8 + (i << 16), (1 << 16) - 64))
    return base


def _post(url, target, body=None):
    return _outcome(lambda: http_util.http_call(
        "POST", f"http://{url}{target}",
        None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"} if body is not None else None))


@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_generate_copy_mount_matches_jax(tmp_path, layout, monkeypatch):
    from seaweedfs_tpu.storage import store as ref_store
    k, m = 6, 3
    # shards of 2 MiB; the slab is auto_slab of the RS(10,4) shard size, as
    # in the JAX Store, so one 8 MiB stripe
    nbytes = 6 * (1 << 20) + 300_000
    src = _volume(tmp_path / "src", nbytes, 3)
    # the JAX Store's local encode, and its streaming one to fake holders
    monkeypatch.setenv("SW_EC_LAYOUT", layout)
    want = {}
    for mode in ("local", "stream"):
        d = tmp_path / f"ref_{mode}"
        d.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(src + ext, str(d / f"1{ext}"))
        st = ref_store.Store([str(d)], codec=RefNumpyCodec(k, m))
        st.mark_volume_readonly(1)
        if mode == "local":
            st.generate_ec_shards(1)
        else:
            (tmp_path / "ref_t").mkdir()
            tgt = FakeTarget(str(tmp_path / "ref_t"))
            try:
                st.generate_ec_shards_streaming(
                    1, assignment={sid: tgt.url for sid in range(2, k + m)})
            finally:
                tgt.stop()
            for sid in range(2, k + m):
                shutil.move(str(tmp_path / "ref_t" / f"1{to_ext(sid)}"),
                            str(d / f"1{to_ext(sid)}"))
        want[mode] = {ext: _read(str(d / f"1{ext}")) for ext in
                      [to_ext(i) for i in range(k + m)] + [".ecx", ".vif"]}
        for loc in st.locations:
            loc.close()
    assert want["stream"] == want["local"]

    source = VolumeServer(port=0, directories=[str(tmp_path / "src")],
                          device="cpu", codec=TorchCodec(k, m, device="cpu"),
                          layout=layout).start()
    holders = {n: _port_holder(tmp_path / f"h{n}") for n in "ab"}
    place = {0: source.url, 1: source.url}
    place.update({sid: holders["a"].url for sid in (2, 3, 4)})
    place.update({sid: holders["b"].url for sid in (5, 6, 7, 8)})
    try:
        assert _post(source.url, "/admin/ec/generate?volume=1",
                     {"assignment": place})[0] == 500   # not readonly yet
        assert _post(source.url, "/admin/volume/readonly?volume=1") == (
            200, {"volume": 1, "readonly": True, "was_readonly": False})
        status, out = _post(source.url, "/admin/ec/generate?volume=1",
                            {"assignment": {str(s): u
                                            for s, u in place.items()}})
        assert status == 200, out
        assert out["base"] == "1"
        assert out["assignment"] == {str(s): "" if u == source.url else u
                                     for s, u in place.items()}
        st = out["stats"]
        assert st["spread_remote_shards"] == 7
        assert st["spread_bytes"] == (k + m) * st["shard_size"]
        assert st["shard_size"] == 2 << 20
        assert st["spread_stripes"] == 1 and st["layout"] == layout
        assert set(st["holder_fetches"]) == {h.url for h in holders.values()}
        for name, h in holders.items():
            sids = sorted(s for s, u in place.items() if u == h.url)
            assert _post(h.url, f"/admin/ec/copy?volume=1&source="
                                f"{source.url}&copy_ecx=true&shards=") == (
                200, {"volume": 1, "copied": [".ecx", ".vif"]})
            assert _post(h.url, "/admin/ec/mount?volume=1&shards=" +
                         ",".join(map(str, sids))) == (
                200, {"volume": 1, "mounted": sids})
            assert h.store.find_ec_volume(1).shard_ids() == sids
        got = {}
        for d, sids in ((tmp_path / "src", (0, 1)), (tmp_path / "ha",
                                                     (2, 3, 4)),
                        (tmp_path / "hb", (5, 6, 7, 8))):
            for sid in sids:
                got[to_ext(sid)] = _read(str(d / f"1{to_ext(sid)}"))
            for ext in (".ecx", ".vif"):
                assert _read(str(d / f"1{ext}")) == want["local"][ext], ext
            assert not _parts(d)
        for ext, data in got.items():
            assert data == want["local"][ext], ext
        for sid in range(2, k + m):
            assert not os.path.exists(str(tmp_path / "src" /
                                          f"1{to_ext(sid)}"))
    finally:
        for vs in [source] + list(holders.values()):
            vs.stop()


def test_generate_local_and_errors_match_jax(tmp_path, monkeypatch):
    """Query-only generate writes every shard on the source, as the JAX
    server's does; the error answers (absent volume, not readonly, bad
    JSON, nothing to mount) and a copy whose source lacks the optional
    sidecars match. (A JAX mount that succeeds then fails on its master
    heartbeat, which this JAX server has not, so the port's mounts are
    checked on their own.)"""
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    monkeypatch.delenv("SW_EC_LAYOUT", raising=False)
    src = _volume(tmp_path / "v", 10 * (1 << 20) + 5000, 9)
    shutil.copytree(tmp_path / "v", tmp_path / "ref")
    shutil.copytree(tmp_path / "v", tmp_path / "port")
    ref = RefVolumeServer(port=0, directories=[str(tmp_path / "ref")],
                          master_url="127.0.0.1:1", ec_backend="numpy",
                          fast_port=-1).start()
    port = VolumeServer(port=0, directories=[str(tmp_path / "port")],
                        device="cpu").start()
    try:
        seen = {}
        for name, vs in (("ref", ref), ("port", port)):
            seen[name] = [
                _post(vs.url, "/admin/volume/readonly?volume=99"),
                _post(vs.url, "/admin/ec/generate?volume=99"),
                _post(vs.url, "/admin/ec/generate?volume=1"),
                _outcome(lambda: http_util.http_call(
                    "POST", f"http://{vs.url}/admin/ec/generate?volume=1",
                    b"{not json")),
                _post(vs.url, "/admin/volume/readonly?volume=1"),
                _post(vs.url, "/admin/volume/readonly?volume=1"),
                _post(vs.url, "/admin/ec/mount?volume=1&shards=0"),
                _post(vs.url, "/admin/ec/generate?volume=1"),
                _post(vs.url, "/admin/ec/mount?volume=1&shards=0&"
                              "collection=other"),
                _post(vs.url, f"/admin/ec/copy?volume=1&source={vs.url}"
                              f"&shards=&copy_ecx=false"),
            ]
        assert seen["port"] == seen["ref"]
        assert [s for s, _ in seen["port"]] == \
            [404, 500, 500, 400, 200, 200, 404, 200, 404, 200]
        assert _post(port.url, "/admin/ec/mount?volume=1&shards=0,3,13") \
            == (200, {"volume": 1, "mounted": [0, 3, 13]})
        assert _post(port.url, "/admin/ec/mount?volume=1&shards=3") \
            == (200, {"volume": 1, "mounted": []})
        names = [to_ext(i) for i in range(14)] + [".ecx", ".vif"]
        for ext in names:
            assert _read(str(tmp_path / "port" / f"1{ext}")) == \
                _read(str(tmp_path / "ref" / f"1{ext}")), ext
        assert _read(src + ".dat") == _read(str(tmp_path / "port" / "1.dat"))
    finally:
        port.stop()
        ref.stop()


def test_generate_failure_leaves_nothing(tmp_path):
    """A holder that dies after acking a run: the source's
    /admin/ec/generate fails, and no shard, stage or .ecx is left on the
    source or the holder, and no push worker survives."""
    k, m = 6, 3
    _volume(tmp_path / "src", 6 * (1 << 20) + 300_000, 5)
    (tmp_path / "t").mkdir()
    tgt = FakeTarget(str(tmp_path / "t"))
    tgt.fail_after = 1       # acks shard 4's run, then dies
    source = VolumeServer(port=0, directories=[str(tmp_path / "src")],
                          device="cpu",
                          codec=TorchCodec(k, m, device="cpu")).start()
    try:
        assert _post(source.url, "/admin/volume/readonly?volume=1")[0] == 200
        status, out = _post(source.url, "/admin/ec/generate?volume=1",
                            {"assignment": {"4": tgt.url, "7": tgt.url}})
        assert status == 500 and "SpreadError" in out["error"]
        assert sorted(os.listdir(str(tmp_path / "src"))) == ["1.dat",
                                                             "1.idx"]
        assert not os.listdir(str(tmp_path / "t"))
        assert wait_until(lambda: not _push_threads(), timeout=5)
    finally:
        source.stop()
        tgt.stop()
