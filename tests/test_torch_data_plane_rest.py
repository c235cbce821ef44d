"""The rest of the port's data plane against the JAX package, on the CPU:
chunk manifests (``client/chunked``, the volume server's ``cm=``), the
``-index disk`` needle map (``storage/needle_map_disk``), ``/query``
(``query/json_query``) and image resizing (``images/resizing``).

* Manifests: each package's master and volume server (planes on) store
  a 50,000-byte file as three chunks through ``submit_chunked``; the
  file is read whole (through the plane, which redirects a manifest),
  by the client-side reader and by Range, each reply equal to the JAX
  server's; ``?cm=false`` gives the manifest; a DELETE at the plane is
  redirected, and Python deletes the chunks first (the flag read by
  ``read_needle_flags``). A ``cm=true`` POST writes the same .dat bytes
  as JAX's (the flags byte).
* ``-index disk``: the port's DiskNeedleMap, the JAX one and the memory
  map over one script of puts, overwrites and deletes (counters, every
  get, the live set), a reopen that replays records appended behind the
  checkpoint, and an .idx rewritten to the same length; a disk-index
  Volume of each package through writes, deletes and a vacuum, byte
  for byte, and a VolumeServer with ``-index disk`` whose plane wrote
  its needles, restarted cold.
* ``query_json_lines`` against JAX's for each of a list of queries
  (rows, or QueryError on both); ``/query`` replies equal on both
  servers, before and after the volume is encoded and a shard lost.
* ``resize_image`` and ``fix_orientation`` bytes equal JAX's (Pillow),
  and a GET with ``width``/``height``/``mode``.
Tolerances: none."""

import io
import json
import os
import time

import numpy as np
import pytest

from test_torch_native_plane import (TS, VID, _fid, _files, _post, _raw,
                                     pair)  # noqa: F401 - the fixture
from seaweedfs_tpu_torch.server.http_util import HttpError, http_call
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

RANGE_HEADERS = ("content-type", "content-range", "content-disposition",
                 "accept-ranges", "content-length")


# -- chunk manifests --------------------------------------------------------

def _package_cluster(kind, root):
    if kind == "ref":
        from seaweedfs_tpu.client import chunked, operation as op
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import \
            VolumeServer as Server
        master = MasterServer(port=0, pulse_seconds=1).start()
        vs = Server(port=0, directories=[str(root / kind)],
                    master_url=master.url, pulse_seconds=1,
                    max_volume_counts=[10], ec_backend="numpy").start()
    else:
        from seaweedfs_tpu_torch.client import chunked, operation as op
        from seaweedfs_tpu_torch.server.master import MasterServer
        master = MasterServer(port=0, pulse_seconds=1, seed=1,
                              repair_interval=0).start()
        vs = VolumeServer(port=0, directories=[str(root / kind)],
                          master_url=master.url, pulse_seconds=1,
                          max_volume_counts=[10], device="cpu").start()
    return chunked, op, master, vs


def test_chunked_file_matches_jax(tmp_path):
    data = np.random.default_rng(5).integers(
        0, 256, 50_000, dtype=np.uint8).tobytes()
    runs = {}
    for kind in ("ref", "port"):
        chunked, op, master, vs = _package_cluster(kind, tmp_path)
        try:
            assert vs.fast_plane is not None
            fid = chunked.submit_chunked(master.url, data, filename="big.bin",
                                         chunk_size=20_000,
                                         content_type="application/x-test")
            assert chunked.read_chunked_file(master.url, fid) == data
            whole = http_call("GET", f"http://{vs.fast_url}/{fid}")
            assert whole == data
            replies = []
            for rng in ("bytes=0-15", "bytes=19990-20010", "bytes=-100",
                        "bytes=45000-", "bytes=60000-60010"):
                st, h, body = _raw(vs.url, "GET", f"/{fid}", None,
                                   {"Range": rng})
                replies.append((st, {k: h.get(k) for k in RANGE_HEADERS},
                                body))
            st, h, body = _raw(vs.url, "GET", f"/{fid}")
            replies.append((st, {k: h.get(k) for k in RANGE_HEADERS}, body))
            manifest = json.loads(http_call(
                "GET", f"http://{vs.url}/{fid}?cm=false"))
            chunks = [c["fid"] for c in manifest["chunks"]]
            assert len(chunks) == 3
            for c in manifest["chunks"]:
                del c["fid"]
            # the plane leaves a manifest's delete to Python
            assert _raw(vs.fast_url, "DELETE", f"/{fid}")[0] == 307
            assert op.delete_file(master.url, fid)
            gone = []
            for f in [fid] + chunks:
                with pytest.raises(HttpError) as e:
                    http_call("GET", f"http://{vs.url}/{f}")
                gone.append(e.value.status)
            runs[kind] = (replies, manifest, gone)
        finally:
            vs.stop()
            master.stop()
    assert runs["port"] == runs["ref"]
    assert runs["port"][2] == [404] * 4
    assert runs["port"][0][1][0] == 206 and \
        runs["port"][0][1][2] == data[19990:20011]


def test_manifest_flag_written_like_jax(pair):
    ref, port = pair
    manifest = json.dumps({"name": "m", "mime": "", "size": 3, "chunks": [
        {"fid": _fid(1), "offset": 0, "size": 3}]}).encode()
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
        assert _post(vs.url, f"/{_fid(1)}?ts={TS}", "c", b"abc")[0] == 200
        assert _post(vs.url, f"/{_fid(2)}?cm=true&ts={TS}", "m",
                     manifest, "application/json")[0] == 200
    assert _files(port) == _files(ref)
    from seaweedfs_tpu_torch.storage.needle import (FLAG_IS_CHUNK_MANIFEST,
                                                    Needle)
    assert port.store.read_needle_flags(
        VID, Needle(id=2, cookie=0x1234ABCD)) & FLAG_IS_CHUNK_MANIFEST
    # the plane leaves a manifest to Python; ?cm=false gets its bytes
    assert _raw(port.fast_url, "GET", f"/{_fid(2)}")[0] == 307
    assert [http_call("GET", f"http://{vs.url}/{_fid(2)}?cm=false")
            for vs in pair] == [manifest, manifest]


# -- -index disk ------------------------------------------------------------

def _map_state(nm, keys):
    return ((nm.file_counter, nm.file_byte_counter, nm.deletion_counter,
             nm.deletion_byte_counter, nm.maximum_file_key, len(nm)),
            [(k, (v.offset, v.size) if (v := nm.get(k)) else None)
             for k in keys],
            sorted((k, v.offset, v.size) for k, v in nm.items()))


def test_disk_needle_map_matches_memory_and_jax(tmp_path):
    from seaweedfs_tpu.storage.needle_map_disk import \
        DiskNeedleMap as RefDisk
    from seaweedfs_tpu_torch.storage.needle_map import NeedleMap
    from seaweedfs_tpu_torch.storage.needle_map_disk import DiskNeedleMap
    from seaweedfs_tpu_torch.storage.types import entry_to_bytes
    rng = np.random.default_rng(9)
    script = []
    for _ in range(1500):
        key = int(rng.integers(1, 300))
        if rng.random() < 0.25:
            script.append(("del", key))
        else:
            script.append(("put", key, int(rng.integers(1, 1 << 20)) * 8,
                           int(rng.integers(1, 5000))))
    keys = list(range(0, 302)) + [(1 << 64) - 1]
    maps = {}
    for name, cls in (("port", DiskNeedleMap), ("ref", RefDisk),
                      ("memory", NeedleMap.load)):
        path = str(tmp_path / f"{name}.idx")
        open(path, "wb").close()
        nm = cls(path)
        for op in script:
            if op[0] == "put":
                nm.put(*op[1:])
            else:
                nm.delete(op[1])
        maps[name] = (path, nm, _map_state(nm, keys))
    assert maps["port"][2] == maps["ref"][2] == maps["memory"][2]
    with open(maps["port"][0], "rb") as a, open(maps["ref"][0], "rb") as b:
        assert a.read() == b.read()
    # records appended behind the checkpoint (as the plane's lease does)
    # are replayed at the next load; a rewritten .idx rebuilds
    states = {}
    for name in ("port", "ref"):
        path, nm, _ = maps[name]
        nm.close()
        with open(path, "ab") as f:
            f.write(entry_to_bytes(7, 64, 99, 4))
            f.write(entry_to_bytes(8, 0, 0xFFFFFFFF, 4))
        cls = DiskNeedleMap if name == "port" else RefDisk
        nm = cls(path)
        states[name] = [_map_state(nm, keys)]
        nm.close()
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size - 32)
            f.write(entry_to_bytes(11, 128, 5, 4) +
                    entry_to_bytes(12, 256, 6, 4))
        nm = cls(path)
        states[name].append(_map_state(nm, keys))
        assert nm.get(11).size == 5
        nm.close()
    memory = NeedleMap.load(maps["port"][0])
    assert states["port"] == states["ref"]
    assert states["port"][1] == _map_state(memory, keys)
    memory.close()
    # a needle id of 2^63 or more: the port checkpoints it, the JAX map
    # fails in sqlite (a fault of the JAX package, not copied)
    for name, cls in (("port", DiskNeedleMap), ("ref", RefDisk)):
        path = str(tmp_path / f"{name}-high.idx")
        nm = cls(path)
        nm.put((1 << 64) - 1, 8, 10)
        if name == "ref":
            with pytest.raises(OverflowError):
                nm.flush()
            continue
        nm.close()
        nm = cls(path)
        assert (nm.maximum_file_key, nm.get((1 << 64) - 1).size) == \
            ((1 << 64) - 1, 10)
        nm.close()


def test_disk_index_volume_matches_jax(tmp_path, monkeypatch):
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle
    from seaweedfs_tpu.storage.volume import Volume as RefVolume
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_001)
    rng = np.random.default_rng(3)
    blobs = [rng.integers(0, 256, int(rng.integers(1, 3000)),
                          dtype=np.uint8).tobytes() for _ in range(40)]
    out = {}
    for name, V, N, kind in (("ref", RefVolume, RefNeedle, "disk"),
                             ("port", Volume, Needle, "disk"),
                             ("memory", Volume, Needle, "memory")):
        d = str(tmp_path / name)
        v = V(d, "", 4, create=True, index_kind=kind)
        for i, b in enumerate(blobs):
            n = N(cookie=9, id=i + 1, data=b)
            n.set_last_modified(TS)
            v.write_needle(n)
        for i in range(0, 40, 3):
            v.delete_needle(N(cookie=9, id=i + 1))
        v.compact()
        late = N(cookie=9, id=100, data=b"late")
        late.set_last_modified(TS)
        v.write_needle(late)
        v.commit_compact()
        counts = (v.file_count(), v.deleted_count(), v.content_size(),
                  v.deleted_size(), v.max_file_key())
        v.close()
        v = V(d, "", 4, index_kind=kind)
        try:
            assert (v.file_count(), v.deleted_count(), v.content_size(),
                    v.deleted_size(), v.max_file_key()) == counts
            reads = []
            for i in list(range(40)) + [99]:
                try:
                    reads.append(v.read_needle(N(cookie=9, id=i + 1)).data)
                except Exception as e:  # noqa: BLE001 - NotFound, either
                    reads.append(type(e).__name__)
            with open(v.dat_path, "rb") as f:
                dat = f.read()
            with open(v.idx_path, "rb") as f:
                idx = f.read()
            out[name] = (counts, reads, dat, idx)
        finally:
            v.close()
    assert out["port"] == out["ref"] == out["memory"]
    assert os.path.exists(tmp_path / "port" / "4.ndb")


def test_disk_index_server_restart(tmp_path):
    """A ``-index disk`` server whose plane appended the needles (the
    records land behind the disk map's checkpoint) restarts cold and
    serves every one, with the lease's counters."""
    d = str(tmp_path / "srv")
    vs = VolumeServer(port=0, directories=[d], device="cpu",
                      index_kind="disk").start()
    want = {}
    try:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
        v = vs.store.find_volume(VID)
        assert v.index_kind == "disk" and v.fast_writer is not None
        for i in range(1, 25):
            data = f"disk-{i}".encode() * i
            assert _post(vs.fast_url, f"/{_fid(i)}", "d", data)[0] == 200
            want[i] = data
        for i in (3, 9):
            assert _raw(vs.fast_url, "DELETE", f"/{_fid(i)}")[0] == 200
            del want[i]
        counts = (v.file_count(), v.deleted_count(), v.content_size(),
                  v.max_file_key())
    finally:
        vs.stop()
    again = VolumeServer(port=0, directories=[d], device="cpu",
                         index_kind="disk").start()
    try:
        v = again.store.find_volume(VID)
        assert (v.file_count(), v.deleted_count(), v.content_size(),
                v.max_file_key()) == counts
        for i in range(1, 25):
            if i in want:
                assert http_call("GET", f"http://{again.fast_url}/"
                                        f"{_fid(i)}") == want[i]
            else:
                assert _raw(again.url, "GET", f"/{_fid(i)}")[0] == 404
    finally:
        again.stop()


# -- /query -------------------------------------------------------------------

DOCS = "\n".join(json.dumps(d) for d in (
    {"id": 1, "name": "ada", "v": 10, "tags": {"a": 1}},
    {"id": 2, "name": "bob", "v": 250.5, "ok": True},
    {"id": 3, "name": "cy's", "v": None},
    {"id": 4, "name": "dee", "v": 7, "tags": {"a": 3}},
)) + "\nnot json\n"

QUERIES = (
    "SELECT * FROM S3Object",
    "SELECT id, name FROM S3Object WHERE v > 9",
    "select id from t where v >= 7 and v < 100",
    "SELECT id FROM t WHERE name = 'bob' OR id = 4",
    "SELECT tags.a FROM t WHERE tags.a != 1",
    "SELECT id FROM t WHERE ok = true",
    "SELECT id FROM t WHERE v = null",
    "SELECT name FROM t WHERE name = \"cy's\"",
    "SELECT id FROM",
    "SELECT FROM t",
    "SELECT id FROM t WHERE",
    "SELECT id FROM t WHERE v ~ 3",
    "UPDATE t SET v = 1",
)


@pytest.mark.parametrize("sql", QUERIES)
def test_query_json_lines_matches_jax(sql):
    from seaweedfs_tpu.query import QueryError as RefError
    from seaweedfs_tpu.query import query_json_lines as ref_query
    from seaweedfs_tpu_torch.query import QueryError, query_json_lines

    def run(fn, err):
        try:
            return ("rows", fn(DOCS.encode(), sql),
                    fn(DOCS.encode(), sql, limit=1))
        except err as e:
            return ("error", str(e))

    assert run(query_json_lines, QueryError) == run(ref_query, RefError)
    array = json.dumps([{"id": 9, "v": 1}, {"id": 8, "v": 2}]).encode()
    assert query_json_lines(array, "SELECT id FROM t WHERE v > 1") == \
        ref_query(array, "SELECT id FROM t WHERE v > 1")


def test_query_route_matches_jax_through_a_lost_shard(pair):
    """JSON needles of about 700 KB each span shards 0 and 1; after the
    encode shard 0 is lost, and /query reads through it."""
    ref, port = pair
    rng = np.random.default_rng(11)
    fids = []
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
    for i in range(3):
        rows = [json.dumps({"id": i * 10000 + j,
                            "v": int(rng.integers(0, 1000)),
                            "pad": "x" * 60}) for j in range(8000)]
        body = ("\n".join(rows) + "\n").encode()
        fids.append(_fid(i + 1))
        for vs in pair:
            assert _post(vs.url, f"/{fids[-1]}?ts={TS}", f"q{i}.jsonl",
                         body, "application/json")[0] == 200
    requests = [{"fids": fids, "sql": "SELECT id, v FROM t WHERE v > 990"},
                {"fids": fids[1:], "sql": "SELECT * FROM t WHERE id = 10007",
                 "limit": 1},
                {"fids": [fids[0]], "sql": "SELECT id FROM t WHERE v < 3",
                 "limit": 5},
                {"fids": fids, "sql": "SELECT bad FROM"},
                {"fids": [], "sql": "SELECT * FROM t"},
                {"fids": ["nope"], "sql": "SELECT * FROM t"}]

    def ask():
        out = []
        for body in requests:
            got = [_raw(vs.url, "POST", "/query", json.dumps(body).encode(),
                        {"Content-Type": "application/json"})
                   for vs in pair]
            assert got[0][0] == got[1][0], body
            if got[1][0] == 200:
                assert got[0][2] == got[1][2]
                assert got[1][1]["content-type"] == "application/jsonl"
            out.append((got[1][0], got[1][2]))
        return out

    before = ask()
    assert before[0][0] == 200 and before[0][1].count(b"\n") > 5
    for vs in pair:
        for route in ("volume/readonly", "ec/generate"):
            http_call("POST", f"http://{vs.url}/admin/{route}?volume={VID}")
        http_call("POST", f"http://{vs.url}/admin/ec/mount?volume={VID}"
                          f"&shards={','.join(map(str, range(14)))}")
        http_call("POST", f"http://{vs.url}/admin/delete_volume"
                          f"?volume={VID}")
        http_call("POST", f"http://{vs.url}/admin/ec/delete_shards"
                          f"?volume={VID}&shards=0")
    reads = port.degraded.snapshot()["reads"]
    assert ask() == before
    assert port.degraded.snapshot()["reads"] > reads


# -- image resizing -----------------------------------------------------------

def _images():
    from PIL import Image
    g = np.arange(64 * 48 * 3, dtype=np.uint32).reshape(48, 64, 3)
    rgb = Image.fromarray(((g * 7) % 251).astype(np.uint8), "RGB")
    out = {}
    for mime, fmt, img in (("image/png", "PNG", rgb),
                           ("image/png", "PNG", rgb.convert("RGBA")),
                           ("image/jpeg", "JPEG", rgb),
                           ("image/gif", "GIF", rgb.convert("P"))):
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        out[f"{fmt}-{img.mode}"] = (mime, buf.getvalue())
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    rgb.save(buf, format="JPEG", exif=exif)
    out["JPEG-rotated"] = ("image/jpeg", buf.getvalue())
    return out


@pytest.mark.parametrize("box", [(32, 0, ""), (0, 24, ""), (20, 20, ""),
                                 (20, 20, "fill"), (0, 0, "")])
def test_resize_image_matches_jax(box):
    from seaweedfs_tpu.images import fix_orientation as ref_fix
    from seaweedfs_tpu.images import resize_image as ref_resize
    from seaweedfs_tpu_torch.images import fix_orientation, resize_image
    for name, (mime, data) in _images().items():
        assert resize_image(data, mime, *box) == ref_resize(data, mime, *box)
        assert fix_orientation(data, mime) == ref_fix(data, mime)
    mime, data = _images()["JPEG-rotated"]
    assert fix_orientation(data, mime) != data
    assert resize_image(b"not an image", "image/png", 10, 10) == \
        (b"not an image", "image/png")


def test_resize_on_get_matches_jax(pair):
    ref, port = pair
    images = _images()
    for vs in pair:
        http_call("POST", f"http://{vs.url}/admin/assign_volume"
                          f"?volume={VID}")
        for i, (name, (mime, data)) in enumerate(images.items()):
            assert _post(vs.url, f"/{_fid(i + 1)}?ts={TS}", name, data,
                         mime)[0] == 200
    for i in range(len(images)):
        for q in ("?width=16", "?height=10&width=30&mode=fill",
                  "?width=20&height=20", ""):
            got = [_raw(vs.url, "GET", f"/{_fid(i + 1)}{q}")
                   for vs in pair]
            assert got[0][0] == got[1][0] == 200
            assert got[0][2] == got[1][2]
            assert got[0][1]["content-type"] == got[1][1]["content-type"]
        # a Range read gets the stored bytes, never a resized image
        got = [_raw(vs.url, "GET", f"/{_fid(i + 1)}?width=16", None,
                    {"Range": "bytes=0-9"}) for vs in pair]
        assert got[0][2] == got[1][2] == list(images.values())[i][1][:10]
