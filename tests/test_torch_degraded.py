"""The port's DegradedReadEngine (seaweedfs_tpu_torch/ec/degraded.py)
against the JAX package's, on the same seeded RS(10,4) shard files behind
a fake store, flat and piggyback: every read's bytes (the past-tail zero
pad included) and every counter both engines report must agree, and the
bytes must equal the lost shard's. The JAX side runs NumpyCodec, or
TpuCodec with a lowered small_dispatch_bytes for the device crossover;
the port runs NumpyCodec, or TorchCodec(device="cpu") with the same
crossover. Mirrors tests/test_degraded_read.py's engine tests, and adds
the piggyback layout (the JAX package reaches it only in a 3-server
drill). Also the repaired sync flat rebuild: its dispatch counters equal
the JAX package's rebuild_ec_files(pipelined=False)."""

import os
import shutil
import socket
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import degraded as ref_degraded
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ec.ec_volume import EcShardNotFound as RefEcShardNotFound
from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops.rs_tpu import TpuCodec
from seaweedfs_tpu_torch.ec import (DegradedReadEngine, EcShardLocationCache,
                                    EcShardNotFound, SlabCache, to_ext)
from seaweedfs_tpu_torch.ec import degraded, encoder
from seaweedfs_tpu_torch.ops import codec as port_codec
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

K, M = 10, 4
TOTAL = K + M
W = 131_077          # flat shard width: not slab-aligned, so the tail pads
WINDOW = 4096        # piggyback window (alpha 32: 128-byte sub-chunks)
PB_W = 20 * WINDOW   # piggyback shard width: window-aligned, as encoded
CROSS = 1024         # lowered small_dispatch_bytes of the crossover cases
#: counters and cache numbers both engines report (latencies aside)
KEYS = ("reads", "errors", "batches", "batched_requests",
        "last_batch_requests", "max_batch_requests", "batch_slabs",
        "survivor_rows", "survivor_fetches", "survivor_bytes",
        "host_dispatches", "device_dispatches", "readahead_slabs",
        "readahead_hits", "cache_hits", "cache_misses", "cache_evictions",
        "cache_entries", "cache_bytes", "cache_hit_ratio",
        "readahead_hit_ratio")


class _Shard:
    def __init__(self, path):
        self.path = path

    @property
    def size(self):
        return os.path.getsize(self.path)


class _Ev:
    def __init__(self, shards, base_name=None):
        self.shards = shards
        if base_name is not None:
            self.base_name = base_name


class _Store:
    def __init__(self, ev):
        self.ev = ev

    def find_ec_volume(self, vid):
        return self.ev


def _seed(tmp_path, layout="flat", seed=5):
    """RS(10,4) shard files of a seeded payload at tmp_path/1.ecNN, flat
    or piggyback (with its .vif); returns (shards (14, w), base)."""
    rng = np.random.default_rng(seed)
    base = str(tmp_path / "1")
    if layout == "flat":
        shards = ref_codec.NumpyCodec(K, M).encode_to_all(
            rng.integers(0, 256, (K, W), dtype=np.uint8))
    else:
        pplan = ref_codec.piggyback_plan(K, M)
        data = rng.integers(0, 256, (K, PB_W), dtype=np.uint8)
        parity = ref_codec.pb_merge(
            ref_codec.host_matmul(
                pplan.emat, ref_codec.pb_split(data, pplan.alpha, WINDOW)),
            pplan.alpha, WINDOW)
        shards = np.concatenate([data, parity])
        ref_layout.write_layout_sidecars(base, "piggyback", WINDOW,
                                         pplan.npairs)
    for i in range(TOTAL):
        shards[i].tofile(base + to_ext(i))
    return shards, base


def _codecs(kind):
    """(JAX codec, port codec) of one kind."""
    if kind == "numpy":
        return ref_codec.NumpyCodec(K, M), port_codec.NumpyCodec(K, M)
    return (TpuCodec(K, M, small_dispatch_bytes=CROSS),
            TorchCodec(K, M, device="cpu", small_dispatch_bytes=CROSS))


def _engines(tmp_path, kind="numpy", layout="flat", lost=3, keep=None,
             slab=4096, **kw):
    """(JAX engine, port engine, shards) over the same files."""
    shards, base = _seed(tmp_path, layout)
    sids = [i for i in range(TOTAL)
            if i != lost and (keep is None or i in keep)]
    ev = _Ev({i: _Shard(base + to_ext(i)) for i in sids},
             base if layout != "flat" else None)
    ref_c, port_c = _codecs(kind)
    ref = ref_degraded.DegradedReadEngine(
        store=_Store(ev), locations=lambda vid: {}, codec=lambda: ref_c,
        slab=slab, batch_ms=0.0, **kw)
    port = DegradedReadEngine(
        store=_Store(ev), locations=lambda vid: {}, codec=lambda: port_c,
        slab=slab, batch_ms=0.0, **kw)
    return ref, port, shards


def _expect(shards, lost, off, size):
    raw = shards[lost][off:off + size].tobytes()
    return raw + b"\x00" * (size - len(raw))


def _same(ref, port):
    a, b = ref.snapshot(), port.snapshot()
    assert {key: b[key] for key in KEYS} == {key: a[key] for key in KEYS}
    return b


def _read_both(ref, port, shards, lost, off, size):
    want = _expect(shards, lost, off, size)
    assert port.read(1, lost, off, size) == want, (off, size)
    assert ref.read(1, lost, off, size) == want, (off, size)


@pytest.mark.parametrize("kind", ["numpy", "crossover"])
@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_bit_identity_and_counters_match_jax(tmp_path, kind, layout):
    ref, port, shards = _engines(tmp_path, kind, layout)
    w = shards.shape[1]
    # cross-slab, slab-aligned, sub-slab, tail-overhanging, full-shard,
    # wholly past the tail
    for off, size in [(0, 100), (4096, 4096), (4000, 9000), (w - 50, 200),
                      (0, w), (w + 10, 64)]:
        _read_both(ref, port, shards, 3, off, size)
    snap = _same(ref, port)
    # exactly-k: every batch gathered k survivor rows
    assert snap["survivor_rows"] == K * snap["batches"]
    assert snap["errors"] == 0
    assert (snap["device_dispatches"] >= 1) == (kind == "crossover")
    assert set(snap["phases"]) >= {"plan", "gather", "dispatch"}


@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_device_crossover_decisions_match_jax(tmp_path, layout):
    """The flat batch decides on its concatenated width, the piggyback
    batch on its sub-chunk width (the run widened to whole windows, over
    alpha): the same reads take the same paths in both packages."""
    ref, port, shards = _engines(tmp_path, "crossover", layout)
    # narrow: the flat tail slab (5 bytes), or two piggyback slabs
    # widened to one window, 128 sub-chunk bytes; both below 1 KiB
    _read_both(ref, port, shards, 3, 131_073 if layout == "flat" else 0, 64)
    snap = _same(ref, port)
    assert snap["host_dispatches"] == 1 and snap["device_dispatches"] == 0
    _read_both(ref, port, shards, 3, 0, 80_000)
    snap = _same(ref, port)
    assert snap["device_dispatches"] == 1 and snap["errors"] == 0


def test_coalesces_concurrent_reads(tmp_path):
    _, port, shards = _engines(tmp_path)
    port.batch_s = 0.12
    n = 8
    barrier = threading.Barrier(n)
    results, errs = {}, []

    def reader(i):
        off, size = i * 13_000 + 7, 5_000 + i * 11
        try:
            barrier.wait(timeout=10)
            results[i] = port.read(1, 3, off, size) == \
                _expect(shards, 3, off, size)
        except Exception as e:  # noqa: BLE001 - assert below
            errs.append(e)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and all(results[i] for i in range(n))
    snap = port.snapshot()
    assert snap["reads"] == n and snap["batched_requests"] == n
    assert snap["max_batch_requests"] >= 2 and snap["batches"] < n
    assert snap["survivor_rows"] == K * snap["batches"]


@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_cache_hit_and_invalidate(tmp_path, layout):
    ref, port, shards = _engines(tmp_path, layout=layout)
    _read_both(ref, port, shards, 3, 8_000, 10_000)
    fetched = _same(ref, port)["survivor_bytes"]
    _read_both(ref, port, shards, 3, 8_000, 10_000)  # warm: LRU serves it
    snap = _same(ref, port)
    assert snap["survivor_bytes"] == fetched and snap["cache_hits"] > 0
    assert port.invalidate(1) == ref.invalidate(1) > 0
    assert port.snapshot()["cache_entries"] == 0
    _read_both(ref, port, shards, 3, 8_000, 10_000)
    assert _same(ref, port)["survivor_bytes"] > fetched


def test_readahead_prefetch_and_hits(tmp_path):
    ref, port, shards = _engines(tmp_path)
    ref.readahead = port.readahead = 2
    _read_both(ref, port, shards, 3, 0, 4096)
    snap = _same(ref, port)
    assert snap["readahead_slabs"] == 2 and snap["readahead_hits"] == 0
    _read_both(ref, port, shards, 3, 4096, 4096)
    snap = _same(ref, port)
    assert snap["readahead_hits"] == 1 and snap["readahead_hit_ratio"] == 0.5
    # a disabled cache never prefetches
    ref0, port0, shards0 = _engines(tmp_path, cache_bytes=0)
    ref0.readahead = port0.readahead = 2
    _read_both(ref0, port0, shards0, 3, 0, 4096)
    assert _same(ref0, port0)["readahead_slabs"] == 0


def test_insufficient_survivors(tmp_path):
    ref, port, _ = _engines(tmp_path, keep=list(range(10)))
    with pytest.raises(RefEcShardNotFound):
        ref.read(1, 3, 0, 128)
    with pytest.raises(EcShardNotFound):
        port.read(1, 3, 0, 128)
    assert _same(ref, port)["errors"] == 1


def _closed_port() -> str:
    """A localhost address nothing listens on: a holder that is down."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    url = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    return url


def test_remote_holders(tmp_path):
    """A shard only a remote holder has counts as present, so the plans
    agree; when its holder is down the gather fails with the JAX engine's
    EcShardNotFound text. This server's own address is never read, and a
    remote shard outside the plan's survivors is never read."""
    shards, base = _seed(tmp_path)
    local = {i: _Shard(base + to_ext(i)) for i in range(TOTAL)
             if i not in (3, 5, 13)}
    locs = {5: ["me:80", _closed_port()], 13: [_closed_port()]}
    errs = []
    for mod, cls in ((ref_degraded, ref_degraded.DegradedReadEngine),
                     (degraded, DegradedReadEngine)):
        eng = cls(store=_Store(_Ev(local)), locations=lambda vid: locs,
                  codec=lambda: port_codec.NumpyCodec(K, M),
                  self_url="me:80", slab=4096, batch_ms=0.0)
        # present: 11 local + 5 and 13 remote; src = 0-2, 4-10 takes 5
        with pytest.raises(mod.EcShardNotFound) as ei:
            eng.read(1, 3, 0, 128)
        errs.append(str(ei.value))
        assert eng.snapshot()["errors"] == 1
    assert errs[1] == errs[0]
    assert errs[1].startswith("survivor gather for 1.3 failed: GET "
                              f"http://{locs[5][1]}/admin/ec/shard_read"
                              "?volume=1&shard=5&offset=0&size=8192: ")
    # shard 5 back on disk: src is local, 13 (remote, down) is not read
    local[5] = _Shard(base + to_ext(5))
    assert eng.read(1, 3, 0, 5000) == _expect(shards, 3, 0, 5000)
    assert eng.snapshot()["remote_bytes"] == 0


@pytest.fixture
def one_torch_thread():
    """The plain K1 runs hundreds of small torch ops a batch; with the
    suite's workers sharing the cores, intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REMOTE_KEYS = KEYS + ("remote_bytes", "hedges_fired", "hedges_won",
                      "retries")


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("local", ["mixed", "none"])
@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_remote_survivors_match_jax(tmp_path, layout, local):
    """Both engines gather their survivors from two holders (a
    ``VolumeServer`` each over a copy of the shards), with two survivors
    local or none (then the shard is sized by a probe): the same bytes,
    remote bytes and host and device dispatches."""
    (tmp_path / "mine").mkdir()
    shards, base = _seed(tmp_path / "mine", layout)
    hdir = tmp_path / "holder"
    shutil.copytree(tmp_path / "mine", hdir)
    open(hdir / "1.ecx", "wb").close()
    lost = 3
    holders = [VolumeServer(port=0, directories=[str(hdir)]).start()
               for _ in range(2)]
    try:
        sids = (0, 2) if local == "mixed" else ()
        ev = _Ev({i: _Shard(base + to_ext(i)) for i in sids},
                 base if layout != "flat" else None)
        locs = {i: [h.url for h in holders] for i in range(TOTAL)
                if i != lost and i not in sids}
        ref_c, port_c = _codecs("crossover")
        engines = [cls(store=_Store(ev), locations=lambda vid: locs,
                       codec=lambda c=c: c, slab=4096, batch_ms=0.0)
                   for cls, c in ((ref_degraded.DegradedReadEngine, ref_c),
                                  (DegradedReadEngine, port_c))]
        w = shards.shape[1]
        # the tail slab alone is below the crossover, on the host
        for off, size in [(0, 100), (4000, 9000), (w - 3, 2), (w - 50, 200),
                          (8192, 40_000)]:
            want = _expect(shards, lost, off, size)
            for eng in engines:
                assert eng.read(1, lost, off, size) == want, (off, size)
        a, b = (eng.snapshot() for eng in engines)
        assert {k: b[k] for k in REMOTE_KEYS} == \
            {k: a[k] for k in REMOTE_KEYS}
        assert b["host_dispatches"] >= 1 and b["device_dispatches"] >= 1
        remote_rows = K - len(sids)
        assert 0 < b["remote_bytes"] < b["survivor_bytes"] or not sids
        assert b["remote_bytes"] * K == b["survivor_bytes"] * remote_rows
        assert engines[1].size_cache.probes == \
            engines[0].size_cache.probes == (0 if sids else 1)
    finally:
        for h in holders:
            h.stop()


def test_gather_failure_invalidates_locations(tmp_path):
    _, base = _seed(tmp_path)
    local = {i: _Shard(base + to_ext(i)) for i in range(TOTAL) if i != 3}
    fetched = []
    cache = EcShardLocationCache(lambda vid: fetched.append(vid) or {})
    eng = DegradedReadEngine(store=_Store(_Ev(local)),
                             locations=cache.lookup, loc_cache=cache,
                             codec=lambda: port_codec.NumpyCodec(K, M),
                             slab=4096, batch_ms=0.0)
    os.truncate(base + to_ext(1), 10)  # a survivor shorter than shard 0
    with pytest.raises(EcShardNotFound, match="survivor gather"):
        eng.read(1, 3, 4096, 100)
    cache.lookup(1)
    assert fetched == [1, 1]  # the failed gather dropped the cached map


def test_slab_cache_lru_matches_jax():
    caches = (ref_degraded.SlabCache(10_000), SlabCache(10_000))
    got = []
    for c in caches:
        c.put((1, 0, 0), b"a" * 4_000)
        c.put((1, 0, 1), b"b" * 4_000)
        c.put((1, 1, 0), b"c" * 4_000)   # over budget: (1,0,0) evicted
        c.put((1, 2, 0), b"x" * 20_000)  # larger than the budget
        got.append((c.get((1, 0, 0)), c.get((1, 0, 1)), c.evictions,
                    c.get((1, 2, 0)), c.invalidate(1, shard_ids=[1]),
                    c.get((1, 1, 0)), c.stats(), c.invalidate(1),
                    c.stats(), c.hits, c.misses))
    assert got[1] == got[0]
    assert got[1][1] == b"b" * 4_000 and got[1][2] == 1
    off = SlabCache(0)
    off.put((1, 0, 0), b"zz")
    assert off.get((1, 0, 0)) is None


def test_defaults_match_jax(monkeypatch):
    for env in ("SW_EC_DEGRADED_CACHE_BYTES", "SW_EC_DEGRADED_SLAB_BYTES",
                "SW_EC_DEGRADED_BATCH_MS", "SW_EC_DEGRADED_READ_TIMEOUT_S",
                "SW_EC_DEGRADED_READAHEAD_SLABS"):
        monkeypatch.delenv(env, raising=False)
    assert (degraded.CACHE_BYTES, degraded.SLAB_BYTES, degraded.BATCH_MS,
            degraded.READ_TIMEOUT_S, degraded.READAHEAD_SLABS) == (
        ref_degraded.degraded_cache_bytes(),
        ref_degraded.degraded_slab_bytes(),
        ref_degraded.degraded_batch_ms(),
        ref_degraded.degraded_read_timeout_s(),
        ref_degraded.degraded_readahead_slabs())
    eng = DegradedReadEngine(store=None, locations=lambda v: {},
                             codec=lambda: None)
    assert (eng.cache.max_bytes, eng.slab, eng.batch_s, eng.readahead) == (
        64 << 20, 128 << 10, 0.002, 1)


def test_dispatch_threshold():
    assert port_codec.dispatch_threshold(port_codec.NumpyCodec(K, M)) == 0
    assert port_codec.dispatch_threshold(
        TorchCodec(K, M, device="cpu")) == 256 << 10
    assert port_codec.dispatch_threshold(
        TorchCodec(K, M, device="cpu", small_dispatch_bytes=CROSS)) == CROSS


# -- the repaired sync flat rebuild ------------------------------------------

SMALL = dict(large_block=64 << 10, small_block=8 << 10)


@pytest.mark.parametrize("nbytes,slab,cross", [
    (100_003, 16 << 10, 256 << 10),  # every stripe below the crossover
    (700_007, 64 << 10, 64 << 10),   # a stripe at it, the tail below it
])
def test_sync_flat_rebuild_counters_match_jax(tmp_path, nbytes, slab, cross):
    rng = np.random.default_rng(nbytes)
    bases = []
    for name in ("ref", "port"):
        os.makedirs(tmp_path / name)
        bases.append(str(tmp_path / name / "1"))
    payload = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    for b in bases:
        with open(b + ".dat", "wb") as f:
            f.write(payload)
    ref_encoder.write_ec_files(bases[0], codec=ref_codec.NumpyCodec(K, M),
                               pipelined=False, **SMALL)
    encoder.write_ec_files(bases[1], codec=port_codec.NumpyCodec(K, M),
                           pipelined=False, **SMALL)
    want = [open(bases[0] + to_ext(i), "rb").read() for i in range(TOTAL)]
    lost = (1, 4, 12)
    stats = []
    for b, codec, rebuild in (
            (bases[0], TpuCodec(K, M, small_dispatch_bytes=cross),
             ref_encoder.rebuild_ec_files),
            (bases[1], TorchCodec(K, M, device="cpu",
                                  small_dispatch_bytes=cross),
             encoder.rebuild_ec_files)):
        for sid in lost:
            os.remove(b + to_ext(sid))
        st = {}
        assert sorted(rebuild(b, codec=codec, slab=slab, pipelined=False,
                              stats=st)) == list(lost)
        assert [open(b + to_ext(i), "rb").read()
                for i in range(TOTAL)] == want
        stats.append(st)
    ref_st, port_st = stats
    for key in ("dispatches", "host_fallbacks", "bitmat_uploads",
                "device_bytes", "survivor_bytes", "rebuilt_bytes"):
        assert port_st[key] == ref_st[key], key
    shard = len(want[0])
    widths = [min(slab, shard - off) for off in range(0, shard, slab)]
    host = sum(w < cross for w in widths)
    assert host >= 1
    assert port_st["host_fallbacks"] == host
    assert port_st["dispatches"] == len(widths) - host
