"""The port's ScrubEngine and locate_corrupt_shard
(seaweedfs_tpu_torch/ec/scrub.py) against the JAX package's, on the same
seeded RS(10,4) shard files behind a fake store, flat and piggyback: the
pass results, findings, .scrub sidecars (timestamps aside) and counters
must agree. Each engine scrubs its own copy of the files, since both
write the sidecar. The JAX side runs NumpyCodec, or TpuCodec with a
chosen small_dispatch_bytes; the port runs NumpyCodec, or
TorchCodec(device="cpu") with the same crossover. Mirrors
tests/test_scrub.py's engine tests, and adds the piggyback layout (the
JAX package reaches it only in a 3-server drill)."""

import json
import os
import shutil
import socket

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ec import scrub as ref_scrub
from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import telemetry as ref_telemetry
from seaweedfs_tpu.ops.rs_tpu import TpuCodec
from seaweedfs_tpu_torch.ec import ScrubEngine, locate_corrupt_shard, to_ext
from seaweedfs_tpu_torch.ec import scrub
from seaweedfs_tpu_torch.ops import codec as port_codec
from seaweedfs_tpu_torch.ops import telemetry
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

K, M = 10, 4
TOTAL = K + M
W = 40_000           # flat shard width
WINDOW = 4096        # piggyback window (alpha 32)
PB_W = 12 * WINDOW   # piggyback shard width
SLAB = 8192
#: per-pass numbers both engines report (timings aside)
RES_KEYS = ("volume", "collection", "slabs", "bytes", "clean",
            "corrupt_slabs", "corrupt_columns", "corrupt_shards", "skipped",
            "missing")
SNAP_KEYS = ("passes", "volumes_scrubbed", "slabs", "bytes_verified",
             "corrupt_slabs", "corrupt_columns", "findings",
             "report_failures", "skipped_missing", "skipped_not_owner",
             "errors", "host_dispatches", "device_dispatches", "rate_mbps",
             "idle_s", "slab_bytes")


class _Shard:
    def __init__(self, path):
        self.path = path

    @property
    def size(self):
        return os.path.getsize(self.path)


class _Ev:
    def __init__(self, shards, base_name, collection="s"):
        self.shards = shards
        self.base_name = base_name
        self.collection = collection


class _Loc:
    def __init__(self, ev, vid=1):
        self.ec_volumes = {vid: ev}


class _Store:
    def __init__(self, ev, vid=1):
        self.ev = ev
        self.vid = vid
        self.locations = [_Loc(ev, vid)]

    def find_ec_volume(self, vid):
        return self.ev if vid == self.vid else None


def _seed(tmp_path, layout="flat", seed=5):
    """Shard files (and, piggyback, the .vif) in tmp_path/ref and a copy
    in tmp_path/port; returns the two base names."""
    rng = np.random.default_rng(seed)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    base = str(ref_dir / "1")
    if layout == "flat":
        shards = ref_codec.NumpyCodec(K, M).encode_to_all(
            rng.integers(0, 256, (K, W), dtype=np.uint8))
    else:
        pplan = ref_codec.piggyback_plan(K, M)
        data = rng.integers(0, 256, (K, PB_W), dtype=np.uint8)
        shards = np.concatenate([data, ref_codec.pb_merge(
            ref_codec.host_matmul(
                pplan.emat, ref_codec.pb_split(data, pplan.alpha, WINDOW)),
            pplan.alpha, WINDOW)])
        ref_layout.write_layout_sidecars(base, "piggyback", WINDOW,
                                         pplan.npairs)
    for i in range(TOTAL):
        shards[i].tofile(base + to_ext(i))
    shutil.copytree(ref_dir, tmp_path / "port")
    return base, str(tmp_path / "port" / "1")


def _codecs(kind, cross=1024):
    if kind == "numpy":
        return ref_codec.NumpyCodec(K, M), port_codec.NumpyCodec(K, M)
    return (TpuCodec(K, M, small_dispatch_bytes=cross),
            TorchCodec(K, M, device="cpu", small_dispatch_bytes=cross))


def _engines(tmp_path, kind="numpy", layout="flat", local=None,
             locations=None, cross=1024):
    """(JAX engine, port engine, JAX base, port base, findings by side)."""
    bases = _seed(tmp_path, layout)
    sids = sorted(local) if local is not None else range(TOTAL)
    codecs = _codecs(kind, cross)
    findings = ([], [])
    engines = []
    for cls, base, codec, found in zip(
            (ref_scrub.ScrubEngine, ScrubEngine), bases, codecs, findings):
        ev = _Ev({i: _Shard(base + to_ext(i)) for i in sids}, base)
        engines.append(cls(
            store=_Store(ev), locations=locations or (lambda vid: {}),
            codec=lambda c=codec: c, self_url=lambda: "me:8080",
            on_finding=lambda f, found=found: found.append(f) or True,
            rate_mbps=0.0, idle_s=0, slab=SLAB))
    return (*engines, *bases, findings)


def _same_result(a, b):
    assert {k: b.get(k) for k in RES_KEYS} == {k: a.get(k) for k in RES_KEYS}


def _same_snapshot(ref, port):
    a, b = ref.snapshot(), port.snapshot()
    assert {k: b[k] for k in SNAP_KEYS} == {k: a[k] for k in SNAP_KEYS}
    strip = ("last_scrubbed",)
    assert {v: {k: x for k, x in s.items() if k not in strip}
            for v, s in b["volumes"].items()} == \
        {v: {k: x for k, x in s.items() if k not in strip}
         for v, s in a["volumes"].items()}
    return b


def _sidecar(base):
    with open(base + ".scrub", encoding="utf-8") as f:
        state = json.load(f)
    for rec in state["shards"].values():
        rec.pop("last_scrubbed")
    return state


def _flip(base, sid, off):
    with open(base + to_ext(sid), "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x01]))


# -- syndrome attribution ----------------------------------------------------

@pytest.mark.parametrize("sid", [0, 3, K, TOTAL - 1])
def test_locate_corrupt_shard_matches_jax(sid):
    for h in (ref_codec.NumpyCodec(K, M).syndrome_plan(),
              ref_codec.piggyback_plan(K, M).syndrome_rows()):
        for col in (sid, h.shape[1] - 1 - sid):
            syn = np.array([ref_gf256.MUL_TABLE[int(h[i][col])][0x5A]
                            for i in range(h.shape[0])], dtype=np.uint8)
            assert locate_corrupt_shard(h, syn) == \
                ref_scrub.locate_corrupt_shard(h, syn) == col
        zero = np.zeros(h.shape[0], np.uint8)
        assert locate_corrupt_shard(h, zero) == -1
        # two corrupt columns: ambiguous or unattributed, as in JAX
        syn = (h[:, 1].astype(np.uint8) ^ h[:, 2].astype(np.uint8))
        assert locate_corrupt_shard(h, syn) == \
            ref_scrub.locate_corrupt_shard(h, syn)


# -- engine ------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_clean_pass_and_sidecar_match_jax(tmp_path, layout):
    ref, port, rbase, pbase, _ = _engines(tmp_path, layout=layout)
    for _ in range(2):
        a, b = ref.scrub_volume(1, force=True), port.scrub_volume(1, force=True)
        _same_result(a, b)
        assert b["clean"] and b["corrupt_shards"] == []
    width = W if layout == "flat" else PB_W
    assert b["slabs"] == -(-width // SLAB)
    assert _sidecar(pbase) == _sidecar(rbase)
    assert _sidecar(pbase)["passes"] == 2
    snap = _same_snapshot(ref, port)
    assert snap["bytes_verified"] == 2 * width * TOTAL
    assert snap["host_dispatches"] == 2 * b["slabs"]  # numpy: host only
    assert set(b["phases"]) == {"gather", "dispatch"}


@pytest.mark.parametrize("layout,sid,off", [
    ("flat", 2, 12_345), ("flat", K + 1, 39_999),
    ("piggyback", 4, 20_000), ("piggyback", K + 2, 5),
])
def test_flipped_byte_found_and_attributed(tmp_path, layout, sid, off):
    ref, port, rbase, pbase, (rfound, pfound) = _engines(tmp_path,
                                                         layout=layout)
    for base in (rbase, pbase):
        _flip(base, sid, off)
    a, b = ref.scrub_volume(1, force=True), port.scrub_volume(1, force=True)
    _same_result(a, b)
    assert not b["clean"] and b["corrupt_shards"] == [sid]
    assert b["corrupt_slabs"] == [off // SLAB]
    # one column flat; on the piggyback layout the corrupt sub-chunk
    # shows in every parity-check row it feeds, still in one column
    assert b["corrupt_columns"] == 1
    for f in (rfound, pfound):
        f[0].pop("detected_at")
    assert pfound == rfound and pfound[0]["shards"] == [sid]
    assert _sidecar(pbase) == _sidecar(rbase)
    snap = _same_snapshot(ref, port)
    assert snap["findings"] == 1 and snap["report_failures"] == 0


@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_device_path_one_dispatch_per_slab(tmp_path, layout):
    """One decision per volume, on the slab (not the sub-chunk width):
    the piggyback slabs split to 256-byte rows still go to the device."""
    ref, port, *_ = _engines(tmp_path, "crossover", layout)
    before, ref_before = telemetry.STATS.snapshot(), \
        ref_telemetry.STATS.snapshot()
    b = port.scrub_volume(1, force=True)
    moved = telemetry.delta(before)
    a = ref.scrub_volume(1, force=True)
    _same_result(a, b)
    assert b["clean"] and b["path"] == "device"
    assert moved["dispatches"] == b["slabs"] == \
        ref_telemetry.delta(ref_before)["dispatches"]
    snap = _same_snapshot(ref, port)
    assert snap["device_dispatches"] == b["slabs"]
    assert snap["host_dispatches"] == 0


def test_below_crossover_stays_on_host(tmp_path):
    ref, port, *_ = _engines(tmp_path, "crossover", cross=1 << 30)
    _same_result(ref.scrub_volume(1, force=True),
                 port.scrub_volume(1, force=True))
    snap = _same_snapshot(ref, port)
    assert snap["host_dispatches"] == -(-W // SLAB)
    assert snap["device_dispatches"] == 0


def _closed_port() -> str:
    """A localhost address nothing listens on: a holder that is down."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    url = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    return url


def test_ownership_election_and_force(tmp_path):
    dead = _closed_port()
    ref, port, *_ = _engines(tmp_path, local=range(1, TOTAL),
                             locations=lambda vid: {0: [dead]})
    _same_result(ref.scrub_volume(1), port.scrub_volume(1))
    assert port.snapshot()["skipped_not_owner"] == 1
    _same_snapshot(ref, port)
    # forced with shard 0 on a holder that is down: the read fails as in
    # JAX, and a forced pass counts the volume as an error
    errs = []
    for eng in (ref, port):
        with pytest.raises(Exception) as ei:
            eng.scrub_volume(1, force=True)
        errs.append((ei.value.status, str(ei.value)))
    assert errs[1] == errs[0] and errs[1][0] == 503
    # (the JAX run_pass logs this through glog.warning, which its glog
    # lacks, so only the port's pass runs here)
    assert port.run_pass(force=True)["volumes"] == 0
    assert port.snapshot()["errors"] == 1
    # nobody holds shard 0: skipped as missing, as in JAX
    shutil.rmtree(tmp_path / "ref")
    shutil.rmtree(tmp_path / "port")
    ref, port, *_ = _engines(tmp_path, local=range(1, TOTAL))
    a, b = ref.scrub_volume(1, force=True), port.scrub_volume(1, force=True)
    _same_result(a, b)
    assert b["skipped"] == "missing_shards" and b["missing"] == [0]
    _same_snapshot(ref, port)


@pytest.fixture
def one_torch_thread():
    """The plain K1 runs hundreds of small torch ops a batch; with the
    suite's workers sharing the cores, intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("layout", ["flat", "piggyback"])
def test_remote_survivors_match_jax(tmp_path, layout):
    """Shards 0-4 local to each engine, 5-13 read from a holder (a
    ``VolumeServer`` over a third copy), crossover on so the slabs go to
    the device: a clean pass, then a byte flipped in a remote shard on
    the holder, found in its slab and attributed to its shard; results,
    findings, sidecars and counters (remote bytes included) agree."""
    holder = {}
    ref, port, rbase, pbase, (rfound, pfound) = _engines(
        tmp_path, "crossover", layout, local=range(5),
        locations=lambda vid: {i: ["me:8080", holder["url"]]
                               for i in range(5, TOTAL)})
    hdir = tmp_path / "holder"
    shutil.copytree(tmp_path / "ref", hdir)
    open(hdir / "1.ecx", "ab").close()
    vs = VolumeServer(port=0, directories=[str(hdir)], fast_port=-1).start()
    holder["url"] = vs.url
    try:
        width = W if layout == "flat" else PB_W
        a, b = ref.scrub_volume(1, force=True), port.scrub_volume(1,
                                                                  force=True)
        _same_result(a, b)
        assert b["clean"] and b["path"] == "device"
        sid, off = K + 1, width - 7
        _flip(str(hdir / "1"), sid, off)
        a, b = ref.scrub_volume(1, force=True), port.scrub_volume(1,
                                                                  force=True)
        _same_result(a, b)
        assert b["corrupt_shards"] == [sid]
        assert b["corrupt_slabs"] == [off // SLAB]
        for f in (rfound, pfound):
            f[0].pop("detected_at")
        assert pfound == rfound and pfound[0]["shards"] == [sid]
        assert _sidecar(pbase) == _sidecar(rbase)
        snap = _same_snapshot(ref, port)
        assert port.snapshot()["remote_bytes"] == \
            ref.snapshot()["remote_bytes"] == 2 * 9 * width
        assert snap["device_dispatches"] == 2 * b["slabs"]
    finally:
        vs.stop()


def test_run_pass_summary(tmp_path):
    ref, port, *_ = _engines(tmp_path)
    a, b = ref.run_pass(force=True), port.run_pass(force=True)
    assert (b["volumes"], b["findings"]) == (a["volumes"], a["findings"]) \
        == (1, 0)
    snap = _same_snapshot(ref, port)
    assert snap["passes"] == 1 and snap["last_pass_mbps"] > 0


def test_defaults_match_jax(monkeypatch):
    for env in ("SW_EC_SCRUB_RATE_MBPS", "SW_EC_SCRUB_IDLE_S",
                "SW_EC_SCRUB_SLAB_BYTES"):
        monkeypatch.delenv(env, raising=False)
    assert (scrub.RATE_MBPS, scrub.IDLE_S, scrub.SLAB_BYTES) == (
        ref_scrub.scrub_rate_mbps(), ref_scrub.scrub_idle_s(),
        ref_scrub.scrub_slab_bytes())
    assert scrub._LOCATE_SAMPLE == ref_scrub._LOCATE_SAMPLE == 64
    eng = ScrubEngine(store=None, locations=lambda v: {},
                      codec=lambda: None, self_url=lambda: "")
    assert (eng.rate_mbps, eng.idle_s, eng.slab) == (8.0, 300.0, 1 << 20)
    # idle_s <= 0 means start() must not spawn the loop thread
    eng = ScrubEngine(store=None, locations=lambda v: {},
                      codec=lambda: None, self_url=lambda: "", idle_s=0)
    eng.start()
    assert eng._thread is None
