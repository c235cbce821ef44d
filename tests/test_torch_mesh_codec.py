"""The port's MeshCodec (seaweedfs_tpu_torch/parallel/mesh_codec.py,
``ec_backend="mesh"``) against the JAX package's, on the CPU.

The JAX codec spans the eight virtual CPU devices of tests/conftest.py;
the port's a codec mesh of eight positions on ``cpu``, each running K1's
plain version. The same seeded numpy inputs go to both: encode and
reconstruct, the sharded dispatch against the single-position one at
widths 1, 4000, 8*512+1 and 3 MiB, the telemetry of one warm sharded
slab and of the crossover below MESH_SHARD_MIN_BYTES, drain_pieces,
write_ec_files and the pipelined rebuild_ec_files (flat and piggyback)
through a 512 KiB-chunk codec, and a volume server with
``ec_backend="mesh"`` generating and rebuilding a volume's shards.
Tolerance: none; bytes and counters are compared exactly (the
telemetry's per-device keys are device names in JAX and position labels
here, so their values are compared)."""

import hashlib
import http.client
import json
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ops import telemetry as ref_telemetry
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.parallel.mesh_codec import MeshCodec as RefMeshCodec
from seaweedfs_tpu_torch.ec import encoder, layout, to_ext
from seaweedfs_tpu_torch.ops import codec as ops_codec
from seaweedfs_tpu_torch.ops import device_stats, gf256, telemetry
from seaweedfs_tpu_torch.ops.codec import NumpyCodec, get_codec
from seaweedfs_tpu_torch.parallel import MeshCodec
from seaweedfs_tpu_torch.parallel.mesh import make_codec_mesh
from seaweedfs_tpu_torch.parallel.mesh_codec import MESH_SHARD_MIN_BYTES

CPU8 = ["cpu"] * 8
#: An encode's and a rebuild's counters, compared with JAX's.
COUNTERS = ("dispatches", "mesh_dispatches", "bitmat_uploads",
            "dispatch_width_devices")
COMPARED = ("dispatches", "mesh_dispatches", "bitmat_uploads",
            "device_bytes", "host_fallbacks", "dispatch_width_devices")


@pytest.fixture(autouse=True)
def jax_device_stats(monkeypatch):
    """The JAX programs compiled here at many shapes count their compiles
    and recompiles in a DeviceStats of their own: the process-wide one is
    read by the JAX package's own tests (its recompile sentinel must not
    have latched), which may run later in this process."""
    from seaweedfs_tpu.ops import device_stats as ref_device_stats
    monkeypatch.setattr(ref_device_stats, "DEVICE_STATS",
                        ref_device_stats.DeviceStats())


@pytest.fixture(autouse=True)
def torch_one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codec(k=10, m=4, **kw):
    return MeshCodec(k, m, mesh=make_codec_mesh(CPU8), **kw)


def _moved(mod, before):
    d = mod.delta(before)
    return ({key: d[key] for key in COMPARED},
            sorted(d["device_busy_frac"].values()),
            sorted(d["mesh_device_bytes"].values()))


def test_get_codec_mesh_backend():
    c = get_codec(10, 4, backend="mesh", mesh=make_codec_mesh(CPU8))
    assert isinstance(c, MeshCodec) and c.backend == "mesh"
    assert c.mesh.shape == {"data": 8, "shard": 1}
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_codec(10, 4, backend="mesh")


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (20, 4)])
def test_encode_and_reconstruct_match_jax(k, m):
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, (k, 4096 + 37), dtype=np.uint8)
    mine, ref = _codec(k, m), RefMeshCodec(k, m)
    parity = mine.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    assert np.array_equal(parity, NumpyCodec(k, m).encode(data))
    shards = list(mine.encode_to_all(data))
    ref_shards = list(shards)
    for sid in (0, 3, k, k + m - 1)[4 - m:]:
        shards[sid] = ref_shards[sid] = None
    got = mine.reconstruct(shards)
    want = ref.reconstruct(ref_shards)
    for sid in range(k + m):
        assert np.array_equal(got[sid], want[sid]), sid


@pytest.mark.parametrize("width", [1, 4000, 8 * 512 + 1, 3 << 20])
def test_sharded_equals_single_position(width):
    """The width split over eight positions and the whole width at one
    give the same bytes as the oracle, for widths that do not divide by
    the positions too."""
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, (10, width), dtype=np.uint8)
    coeffs = gf256.build_matrix(10, 14)[10:]
    sharded = _codec(mesh_shard_min_bytes=0)._matmul(coeffs, data)
    single = _codec(mesh_shard_min_bytes=1 << 60)._matmul(coeffs, data)
    assert np.array_equal(sharded, single)
    assert np.array_equal(sharded, ops_codec.host_matmul(coeffs, data))


def test_warm_sharded_slab_matches_jax_telemetry(monkeypatch):
    """A warm sharded slab is one dispatch, one mesh dispatch and no
    upload, over eight positions evenly, as in JAX; device_stats counts
    one mesh_codec._fn dispatch and one K1 call a position, no launch."""
    k, m, width = 10, 4, 8 * 512
    data = np.random.default_rng(7).integers(0, 256, (k, width),
                                             dtype=np.uint8)
    mine = _codec(k, m, mesh_shard_min_bytes=0)
    ref = RefMeshCodec(k, m, mesh_shard_min_bytes=0)
    mine.encode(data)
    ref.encode(data)
    stats = device_stats.DeviceStats()
    monkeypatch.setattr(device_stats, "DEVICE_STATS", stats)
    before, ref_before = telemetry.STATS.snapshot(), \
        ref_telemetry.STATS.snapshot()
    mine.encode(data)
    ref.encode(data)
    got, want = _moved(telemetry, before), _moved(ref_telemetry, ref_before)
    assert got == want
    assert got[0]["dispatches"] == got[0]["mesh_dispatches"] == 1
    assert got[0]["bitmat_uploads"] == 0
    assert got[0]["dispatch_width_devices"] == 8
    assert got[1] == [1.0] * 8
    snap = stats.snapshot()
    assert snap["dispatches"] == {device_stats.MESH_FN: 1,
                                  device_stats.K1: 8}
    assert snap["launches"] == {}


@pytest.mark.parametrize("width", [2048, 50_000, 70_000])
def test_crossover_matches_jax(width):
    """Below MESH_SHARD_MIN_BYTES of k x bucket a product runs at one
    position (width 1, no mesh dispatch), above it over all eight; the
    JAX codec crosses at the same bucket."""
    k, m = 10, 4
    data = np.random.default_rng(width).integers(0, 256, (k, width),
                                                 dtype=np.uint8)
    mine, ref = _codec(k, m), RefMeshCodec(k, m)
    mine.encode(data)
    ref.encode(data)
    before, ref_before = telemetry.STATS.snapshot(), \
        ref_telemetry.STATS.snapshot()
    out = mine.encode(data)
    ref.encode(data)
    got, want = _moved(telemetry, before), _moved(ref_telemetry, ref_before)
    assert got == want
    sharded = k * mine._width_bucket(width) >= MESH_SHARD_MIN_BYTES
    assert got[0]["mesh_dispatches"] == int(sharded)
    assert got[0]["dispatch_width_devices"] == (8 if sharded else 1)
    assert np.array_equal(out, NumpyCodec(k, m).encode(data))


def test_drain_pieces_tile_the_width():
    k, m, w = 10, 4, 4000
    codec = _codec(k, m, mesh_shard_min_bytes=0)
    data = np.random.default_rng(9).integers(0, 256, (k, w), dtype=np.uint8)
    coeffs = gf256.build_matrix(k, k + m)[k:]
    bucket = codec._width_bucket(w)
    fn, const, put = codec.device_fn(coeffs, bucket)
    padded = np.zeros((k, bucket), dtype=np.uint8)
    padded[:, :w] = data
    pieces = codec.drain_pieces(fn(const, put(padded)), w)
    assert len(pieces) == 8
    cursor = 0
    for lo, piece in pieces:
        assert lo == cursor
        cursor += piece.shape[1]
    assert cursor == w
    assert np.array_equal(np.concatenate([p for _, p in pieces], axis=1),
                          NumpyCodec(k, m).encode(data))


def _digests(base, total=14):
    out = []
    for i in range(total):
        with open(base + to_ext(i), "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


@pytest.mark.parametrize("layout_name", ["flat", "piggyback"])
def test_volume_encode_and_rebuild_match_jax(tmp_path, layout_name):
    """write_ec_files and rebuild_ec_files (a seeded 4 lost) through a
    512 KiB-chunk mesh codec, pipelined on the flat layout: shard
    sha256s equal to the JAX NumpyCodec's and, flat, to the JAX
    MeshCodec's with the same counters. The JAX MeshCodec's CPU program
    unrolls one popcount per output bit and input word, 1024 x 80 for
    the piggyback (128, 320) matrix, which takes minutes to trace: on
    that layout the JAX side is its NumpyCodec."""
    pb = layout_name == "piggyback"
    kw = dict(large_block=1 << 20, small_block=64 << 10, slab=256 << 10,
              layout=layout_name)
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
    bases = {}
    for name in ("numpy", "ref", "port"):
        os.makedirs(tmp_path / name)
        bases[name] = str(tmp_path / name / "1")
        with open(bases[name] + ".dat", "wb") as f:
            f.write(payload)

    def ref_codec():
        return RefNumpyCodec(10, 4) if pb else \
            RefMeshCodec(10, 4, chunk_bytes=512 << 10)

    def mine():
        return _codec(chunk_bytes=512 << 10)

    ref_encoder.write_ec_files(bases["numpy"], codec=RefNumpyCodec(10, 4),
                               pipelined=False, **kw)
    st, ref_before = {}, ref_telemetry.STATS.snapshot()
    ref_encoder.write_ec_files(bases["ref"], codec=ref_codec(), **kw)
    ref_st = ref_telemetry.delta(ref_before)
    encoder.write_ec_files(bases["port"], codec=mine(), stats=st, **kw)
    want = _digests(bases["numpy"])
    assert _digests(bases["ref"]) == want
    assert _digests(bases["port"]) == want
    assert st["backend"] == "mesh"
    assert st["mesh_dispatches"] > 0
    assert st["dispatch_width_devices"] == 8
    for key in () if pb else COUNTERS:
        assert st[key] == ref_st[key], key
    lost = (0, 5, 11, 13)
    for base in bases.values():
        for sid in lost:
            os.remove(base + to_ext(sid))
    info = layout.LayoutInfo(layout.LAYOUT_PIGGYBACK, 64 << 10, 5) \
        if pb else None
    ref_info = ref_layout.LayoutInfo("piggyback", 64 << 10, 5) \
        if pb else None
    ref_st, st = {}, {}
    assert ref_encoder.rebuild_ec_files(
        bases["ref"], codec=ref_codec(), slab=256 << 10, layout=ref_info,
        stats=ref_st) == list(lost)
    assert encoder.rebuild_ec_files(
        bases["port"], codec=mine(), slab=256 << 10, layout=info,
        stats=st) == list(lost)
    assert _digests(bases["ref"]) == want
    assert _digests(bases["port"]) == want
    assert st["mesh_dispatches"] > 0
    for key in () if pb else COUNTERS:
        assert st[key] == ref_st[key], key


def _fake_master():
    """Answers heartbeats and lookups with empty maps; a vid-map watch
    gets a 404 and parks."""
    from seaweedfs_tpu_torch.server.http_util import (HttpError, HttpServer,
                                                      Router)

    def fallback(req):
        if req.path == "/cluster/watch":
            raise HttpError(404, "no watch here")
        return {}
    router = Router()
    router.set_fallback(fallback)
    return HttpServer(0, router).start()


def _post(url, path):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _volume(directory, vid, nbytes, seed):
    """A plain volume: a superblock, ``nbytes`` of seeded needle bytes
    and an .idx of 64 KiB entries over them."""
    from seaweedfs_tpu_torch.storage import SuperBlock, entry_to_bytes
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(str(directory), str(vid))
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(SuperBlock().to_bytes())
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    with open(base + ".idx", "wb") as f:
        for i in range(nbytes // (64 << 10)):
            f.write(entry_to_bytes(i + 1, 8 + i * (64 << 10),
                                   (64 << 10) - 64, 4))
    return base


def test_volume_server_mesh_backend_matches_jax(tmp_path):
    """A port VolumeServer(ec_backend="mesh") over eight CPU positions
    and a JAX one over its eight devices generate a volume's shards,
    lose two, and rebuild them: every shard file and the .ecx equal."""
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    vid = 3
    _volume(tmp_path / "v", vid, 3 << 20, 17)
    shutil.copytree(tmp_path / "v", tmp_path / "ref")
    shutil.copytree(tmp_path / "v", tmp_path / "port")
    master = _fake_master()
    murl = f"127.0.0.1:{master.port}"
    ref = RefVolumeServer(port=0, directories=[str(tmp_path / "ref")],
                          master_url=murl, ec_backend="mesh",
                          fast_port=-1).start()
    port = VolumeServer(port=0, directories=[str(tmp_path / "port")],
                        master_url=murl, ec_backend="mesh",
                        mesh=make_codec_mesh(CPU8)).start()
    try:
        assert isinstance(port.store.codec, MeshCodec)
        all14 = ",".join(map(str, range(14)))
        for path in (f"/admin/volume/readonly?volume={vid}",
                     f"/admin/ec/generate?volume={vid}",
                     f"/admin/ec/mount?volume={vid}&shards={all14}",
                     f"/admin/ec/delete_shards?volume={vid}&shards=2,12"):
            for server in (ref, port):
                assert _post(server.url, path)[0] == 200, (server, path)
        results = [_post(server.url, f"/admin/ec/rebuild?volume={vid}")
                   for server in (ref, port)]
        assert [r[0] for r in results] == [200, 200]
        assert [r[1]["rebuilt"] for r in results] == [[2, 12], [2, 12]]
    finally:
        port.stop()
        ref.stop()
        master.stop()
    for ext in [to_ext(i) for i in range(14)] + [".ecx"]:
        with open(tmp_path / "ref" / f"{vid}{ext}", "rb") as a, \
                open(tmp_path / "port" / f"{vid}{ext}", "rb") as b:
            assert a.read() == b.read(), ext


def test_volume_server_cli_mesh_backend(tmp_path):
    """``python -m seaweedfs_tpu_torch.server.volume_server --ec.backend
    mesh --mesh.devices cpu,cpu`` generates a volume's shards through the
    mesh codec (its /admin/devices counts ``mesh_codec._fn`` dispatches),
    equal to NumpyCodec's."""
    import subprocess
    import sys
    vid = 5
    _volume(tmp_path / "cli", vid, 3 << 20, 23)
    _volume(tmp_path / "want", vid, 3 << 20, 23)
    encoder.write_ec_files(str(tmp_path / "want" / str(vid)),
                           codec=NumpyCodec(10, 4))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.server.volume_server",
         "--dir", str(tmp_path / "cli"), "--port", "0", "--device", "cpu",
         "--ec.backend", "mesh", "--mesh.devices", "cpu,cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening "), line + proc.stdout.read()
        url = line.split()[1]
        for path in (f"/admin/volume/readonly?volume={vid}",
                     f"/admin/ec/generate?volume={vid}"):
            assert _post(url, path)[0] == 200, path
        host, port = url.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("GET", "/admin/devices")
        stats = json.loads(conn.getresponse().read())["stats"]
        conn.close()
        assert stats["dispatches"].get("mesh_codec._fn", 0) > 0
        assert stats["launches"].get("rs_hopper.gf_matmul", 0) == 0
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    for ext in [to_ext(i) for i in range(14)]:
        with open(tmp_path / "want" / f"{vid}{ext}", "rb") as a, \
                open(tmp_path / "cli" / f"{vid}{ext}", "rb") as b:
            assert a.read() == b.read(), ext
