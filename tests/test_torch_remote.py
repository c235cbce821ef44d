"""The port's remote shard readers and EC holder routes against the JAX
package's, over HTTP on localhost (CPU, small RS(10,4) shards).

* The port's readers over the JAX package's fake holder (an
  ``http_util.HttpServer`` serving ``/admin/ec/shard_read``, as in
  tests/test_streaming_gather.py): rotation by ``stripe_idx``, failover
  with retries, the straggler hedge, ``probe_shard_size`` in its suffix
  and 416 forms and ``ShardSizeCache.probes``; the port and JAX readers
  run over the same holders and every counter both report agrees.
* The port's holder (``server/volume_server.VolumeServer``) against a JAX
  ``VolumeServer`` over copies of the same shard files: each route's
  status, headers and body, bad parameters included (400/404/416), and
  the JAX and port readers, ``probe_shard_size`` and ``fetch_index_files``
  get the same bytes from either holder.
"""

import http.client
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import gather as ref_gather
from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.server import http_util as ref_http
from seaweedfs_tpu_torch.ec import gather, to_ext
from seaweedfs_tpu_torch.ops import codec as port_codec
from seaweedfs_tpu_torch.server import http_util
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

K, M = 10, 4
TOTAL = K + M
W = 40_003           # flat shard width (volume 1)
WINDOW = 4096        # piggyback window (volume 2, alpha 32)
PB_W = 12 * WINDOW   # piggyback shard width


def _seed(directory, seed=7):
    """Flat volume 1 and piggyback volume 2, RS(10,4), in ``directory``,
    each with an .ecx and a .vif; returns {vid: (14, w) shards}."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    flat = ref_codec.NumpyCodec(K, M).encode_to_all(
        rng.integers(0, 256, (K, W), dtype=np.uint8))
    pplan = ref_codec.piggyback_plan(K, M)
    data = rng.integers(0, 256, (K, PB_W), dtype=np.uint8)
    pb = np.concatenate([data, ref_codec.pb_merge(
        ref_codec.host_matmul(pplan.emat,
                              ref_codec.pb_split(data, pplan.alpha, WINDOW)),
        pplan.alpha, WINDOW)])
    for vid, shards in ((1, flat), (2, pb)):
        base = os.path.join(str(directory), str(vid))
        for i in range(TOTAL):
            shards[i].tofile(base + to_ext(i))
        with open(base + ".ecx", "wb") as f:
            f.write(rng.bytes(16 * 5))
        ref_layout.write_layout_sidecars(
            base, "piggyback" if vid == 2 else "flat", WINDOW,
            pplan.npairs, version=3, offset_width=4)
    return {1: flat, 2: pb}


class FakeHolder:
    """The JAX package's minimal holder (tests/test_streaming_gather.py):
    ``/admin/ec/shard_read`` from a directory of {vid}.ecNN files, with an
    injectable delay and failure, counting the reads it answers.
    ``strict`` refuses suffix ranges with 416, as some servers do."""

    def __init__(self, directory, strict=False):
        self.dir = directory
        self.delay = 0.0
        self.fail = False
        self.strict = strict
        self.calls = 0
        self._lock = threading.Lock()
        router = ref_http.Router()
        router.add("GET", "/admin/ec/shard_read", self._shard_read)
        self.server = ref_http.HttpServer(0, router).start()
        self.url = f"127.0.0.1:{self.server.port}"

    def _shard_read(self, req):
        with self._lock:
            self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        if self.fail:
            raise ref_http.HttpError(503, "injected failure")
        vid = int(req.query["volume"])
        sid = int(req.query["shard"])
        path = os.path.join(self.dir, f"{vid}{to_ext(sid)}")
        if not os.path.exists(path):
            raise ref_http.HttpError(404, f"shard {vid}.{sid} not here")
        total = os.path.getsize(path)
        rng = req.headers.get("Range", "")
        if self.strict and rng.startswith("bytes=-"):
            raise ref_http.HttpError(416, "suffix ranges not supported")
        rng = ref_http.parse_range(rng, total)
        with open(path, "rb") as f:
            if rng is None:
                off = int(req.query.get("offset", 0))
                n = int(req.query.get("size", 0))
                f.seek(off)
                return ref_http.Response(f.read(n),
                                         headers={"Accept-Ranges": "bytes"})
            off, n = rng
            f.seek(off)
            return ref_http.Response(
                f.read(n), status=206,
                headers={"Accept-Ranges": "bytes",
                         "Content-Range":
                             f"bytes {off}-{off + n - 1}/{total}"})

    def stop(self):
        self.server.stop()


@pytest.fixture
def fakes(tmp_path):
    shards = _seed(tmp_path)
    holders = [FakeHolder(str(tmp_path)) for _ in range(2)]
    yield holders, shards
    for h in holders:
        h.stop()


def _readers(holders, sid, **kw):
    """(JAX reader, port reader) of volume 1's shard ``sid``."""
    return (ref_gather.RemoteShardReader(1, sid, holders,
                                         ref_gather.GatherStats(), **kw),
            gather.RemoteShardReader(1, sid, holders, gather.GatherStats(),
                                     **kw))


def _same_stats(ref, port):
    a, b = ref.snapshot(), port.snapshot()
    assert set(b) == set(a)
    assert b == a
    return b


def test_round_robin_matches_jax(fakes):
    (a, b), shards = fakes
    want = shards[1][0].tobytes()
    chunk = 4096
    calls = []
    readers = _readers([a.url, b.url], 0, hedge_ms=0)
    for r in readers:
        a.calls = b.calls = 0
        got = b"".join(r.read(off, min(chunk, W - off), stripe_idx=i)
                       for i, off in enumerate(range(0, W, chunk)))
        assert got == want
        calls.append((a.calls, b.calls))
    n = -(-W // chunk)
    # consecutive stripes lead with alternating holders
    assert calls[1] == calls[0] == ((n + 1) // 2, n // 2)
    snap = _same_stats(readers[0].stats, readers[1].stats)
    assert snap["holder_fetches"] == {a.url: (n + 1) // 2, b.url: n // 2}
    assert snap["gather_fetches"] == n and snap["gather_retries"] == 0
    assert snap["gather_remote_bytes"] == snap["gather_bytes"] == W


def test_failover_retries_match_jax(fakes):
    (a, b), shards = fakes
    a.fail = True
    readers = _readers([a.url, b.url], 2, hedge_ms=0)
    for r in readers:
        for i in range(3):
            assert r.read(i * 4096, 4096, stripe_idx=i) == \
                shards[1][2][i * 4096:(i + 1) * 4096].tobytes()
    snap = _same_stats(readers[0].stats, readers[1].stats)
    # stripes 0 and 2 lead with the failing holder: one retry each
    assert snap["gather_retries"] == 2
    assert snap["holder_errors"] == {a.url: 2}
    assert snap["holder_fetches"] == {b.url: 3}
    assert snap["gather_remote_bytes"] == 3 * 4096


def test_hedge_on_straggler_matches_jax(fakes):
    (a, b), shards = fakes
    a.delay = 0.4  # the straggler leads stripe 0
    readers = _readers([a.url, b.url], 1, hedge_ms=50)
    for r in readers:
        t0 = time.perf_counter()
        assert r.read(0, 8192, stripe_idx=0) == shards[1][1][:8192].tobytes()
        # won by the hedge, not by waiting out the straggler
        assert time.perf_counter() - t0 < 0.35
    # the losers drain in the hedge pool and record their fetches
    deadline = time.monotonic() + 30
    while any(a.url not in r.stats.holder_fetches for r in readers) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    snap = _same_stats(readers[0].stats, readers[1].stats)
    assert (snap["hedges_fired"], snap["hedges_won"],
            snap["hedges_lost"]) == (1, 1, 1)
    assert snap["holder_fetches"] == {a.url: 1, b.url: 1}


@pytest.mark.parametrize("strict", [False, True])
def test_probe_shard_size_matches_jax(tmp_path, strict):
    """The suffix probe reads one byte's Content-Range; a holder that
    answers 416 is sized with 1-byte offset reads, as many in the port
    as in the JAX package."""
    _seed(tmp_path)
    h = FakeHolder(str(tmp_path), strict=strict)
    try:
        calls = []
        for probe in (ref_gather.probe_shard_size, gather.probe_shard_size):
            h.calls = 0
            assert probe(1, 5, [h.url]) == W
            assert probe(2, 5, [h.url]) == PB_W
            calls.append(h.calls)
        assert calls[0] == calls[1]
        assert calls[1] == 2 if not strict else calls[1] > 2 * 15
    finally:
        h.stop()


def test_shard_size_cache_probes_once(fakes):
    (a, _), _ = fakes
    caches = (ref_gather.ShardSizeCache(), gather.ShardSizeCache())
    for cache in caches:
        for _ in range(3):
            assert cache.get(1, 0, [a.url]) == W
        assert cache.get(1, 1, [a.url]) == W
    assert caches[1].probes == caches[0].probes == 2


def test_probe_errors_match_jax(fakes):
    (a, b), _ = fakes
    a.fail = True
    errs = []
    for probe in (ref_gather.probe_shard_size, gather.probe_shard_size):
        with pytest.raises(Exception) as ei:
            probe(1, 99, [a.url, b.url])
        errs.append((ei.value.status, str(ei.value)))
    assert errs[1] == errs[0] and errs[1][0] == 404


# -- the holder routes: the port's VolumeServer against the JAX one ----------

@pytest.fixture(scope="module")
def holders(tmp_path_factory):
    """(JAX VolumeServer, port VolumeServer, shards by vid), each over its
    own copy of the same files."""
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    root = tmp_path_factory.mktemp("holders")
    shards = _seed(root / "ref")
    shutil.copytree(root / "ref", root / "port")
    ref = RefVolumeServer(port=0, directories=[str(root / "ref")],
                          master_url="127.0.0.1:1", ec_backend="numpy",
                          fast_port=-1).start()
    port = VolumeServer(port=0, directories=[str(root / "port")]).start()
    yield ref, port, shards, root
    port.stop()
    ref.stop()


#: headers a route answers with, besides Date and Server
_HEADERS = ("content-type", "content-length", "accept-ranges",
            "content-range", "x-repair-planes", "x-repair-stride",
            "x-plane-alpha", "x-plane-window")

_SR = "/admin/ec/shard_read?volume=1&shard=3"
_RR = "/admin/ec/shard_repair_read?volume=1&shard=3"
_PR = "/admin/ec/shard_plane_read?volume=2&shard=4"
_PLANE = "&alpha=32&window=4096&bit=1&side=0"
CASES = [
    ("GET", _SR + "&offset=100&size=5000", {}),
    ("GET", _SR, {"Range": "bytes=10-99"}),
    ("GET", _SR, {"Range": "bytes=-1"}),
    ("GET", _SR, {"Range": "bytes=39990-"}),
    ("GET", _SR, {"Range": "bytes=-0"}),
    ("GET", _SR, {"Range": "bytes=99999-"}),
    ("GET", _SR, {"Range": "bytes=9-2"}),
    ("GET", "/admin/ec/shard_read?volume=1&shard=99&offset=0&size=4", {}),
    ("GET", "/admin/ec/shard_read?volume=7&shard=0&offset=0&size=4", {}),
    ("POST", _RR + "&offset=0&size=9000&masks=3,77,200", {}),
    ("POST", _RR + "&offset=40000&size=3&masks=255", {}),
    ("POST", _RR + "&offset=0&size=9000", {}),
    ("POST", _RR + "&offset=0&size=9000&masks=0,5", {}),
    ("POST", _RR + "&offset=0&size=9000&masks=256", {}),
    ("POST", _RR + "&offset=0&size=0&masks=5", {}),
    ("POST", _RR + "&offset=-1&size=8&masks=5", {}),
    ("POST", _RR + "&offset=40000&size=4&masks=5", {}),
    ("POST", "/admin/ec/shard_repair_read?volume=1&shard=99&offset=0"
             "&size=8&masks=5", {}),
    ("POST", _PR + "&offset=4096&size=8192" + _PLANE, {}),
    ("POST", _PR + "&offset=0&size=49152&alpha=32&window=4096&bit=4&side=1",
     {}),
    ("POST", _PR + "&offset=0&size=8192&alpha=3&window=4096&bit=0&side=0",
     {}),
    ("POST", _PR + "&offset=0&size=8192&alpha=32&window=4096&bit=5&side=0",
     {}),
    ("POST", _PR + "&offset=0&size=8192&alpha=32&window=4096&bit=0&side=2",
     {}),
    ("POST", _PR + "&offset=100&size=8192" + _PLANE, {}),
    ("POST", _PR + "&offset=45056&size=8192" + _PLANE, {}),
    ("POST", _PR + "&offset=0&size=8192", {}),
    ("GET", "/admin/file?name=1.ecx", {}),
    ("GET", "/admin/file?name=2.vif", {}),
    ("GET", "/admin/file?name=1.ecx&stat=1", {}),
    ("GET", "/admin/file?name=1.ec03&offset=10&size=100", {}),
    ("GET", "/admin/file?name=notes.txt", {}),
    ("GET", "/admin/file?name=9.ecx", {}),
]


def _request(url, method, target, headers):
    host, port = url.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, target, headers=headers)
        resp = conn.getresponse()
        body = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()
                if k.lower() in _HEADERS}
        return resp.status, hdrs, body
    finally:
        conn.close()


@pytest.mark.parametrize("method,target,headers", CASES,
                         ids=[f"{m} {t.split('/')[-1][:60]} {h}"
                              for m, t, h in CASES])
def test_holder_route_matches_jax(holders, method, target, headers):
    ref, port, _, _ = holders
    want = _request(ref.url, method, target, headers)
    got = _request(port.url, method, target, headers)
    assert got == want


def test_holder_route_bytes(holders):
    """The routes' bytes are the shard's range, its projection and its
    plane, as the host transforms give them."""
    ref, port, shards, _ = holders
    status, hdrs, body = _request(port.url, *CASES[0])
    assert status == 200 and body == shards[1][3][100:5100].tobytes()
    status, hdrs, body = _request(port.url, *CASES[1])
    assert status == 206 and hdrs["content-range"] == f"bytes 10-99/{W}"
    status, hdrs, body = _request(port.url, *CASES[9])
    planes = port_codec.project_slab(shards[1][3][:9000], [3, 77, 200])
    assert body == planes.tobytes() and hdrs["x-repair-planes"] == "3"
    status, hdrs, body = _request(port.url, *CASES[18])
    plane = port_codec.pb_plane_slice(shards[2][4][4096:12288], 32, WINDOW,
                                      1, 0)
    assert body == plane.tobytes() and len(body) == 4096
    status = json.loads(http_util.http_call("GET",
                                            f"http://{port.url}/status"))
    assert {"1", "2"} <= set(status["ec_shards"]) and all(
        bits == (1 << 14) - 1 for bits in status["ec_shards"].values())
    # no route: 404 from both (the JAX server's needle-read fallback
    # answers it, which the port leaves out)
    for h in (ref.url, port.url):
        assert _request(h, "GET", "/admin/ec/no_such_route", {})[0] == 404


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_readers_get_the_same_bytes_from_either_holder(holders, tmp_path,
                                                       pkg):
    """The JAX readers (``pkg="jax"``) and the port's, over the JAX holder
    and the port's: shard ranges, trace projections, plane slices, the
    size probe and the index sidecars."""
    ref, port, shards, root = holders
    g = ref_gather if pkg == "jax" else gather
    codec = ref_codec if pkg == "jax" else port_codec
    plan = codec.repair_plan(K, M, 6)
    rplan = codec.piggyback_repair_plan(K, M, 4)
    got = []
    for h in (ref.url, port.url):
        st = g.GatherStats()
        r = g.RemoteShardReader(1, 3, [h], st, hedge_ms=0)
        rr = g.RemoteRepairReader(1, 7, [h], plan.masks[7], st, hedge_ms=0)
        pr = g.RemotePlaneReader(2, 11, [h], rplan.alpha, WINDOW,
                                 rplan.plane_bit, rplan.plane_side, st,
                                 hedge_ms=0)
        base = str(tmp_path / f"{len(got)}" / "2")
        os.makedirs(os.path.dirname(base))
        fetched = g.fetch_index_files(base, [h])
        got.append((r.read(1000, 20_000, 1), rr.read(8192, 16_384, 2),
                    pr.read(8192, 16_384, 2),
                    g.probe_shard_size(1, 3, [h]),
                    g.probe_shard_size(2, 3, [h]), fetched,
                    [open(base + ext, "rb").read() for ext in fetched]))
    assert got[1] == got[0]
    seg, planes, plane, size, pb_size, fetched, files = got[1]
    assert seg == shards[1][3][1000:21_000].tobytes()
    assert planes == port_codec.project_slab(
        shards[1][7][8192:24_576], plan.masks[7]).tobytes()
    assert plane == port_codec.pb_plane_slice(
        shards[2][11][8192:24_576], rplan.alpha, WINDOW, rplan.plane_bit,
        rplan.plane_side).tobytes()
    assert (size, pb_size) == (W, PB_W)
    assert fetched[:2] == [".ecx", ".vif"]
    assert files[0] == open(root / "port" / "2.ecx", "rb").read()
