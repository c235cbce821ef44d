"""The port's ``compact`` and ``sortedfile`` needle maps
(storage/compact_map) against the JAX package's, and the port's
``Volume`` on them.

- ``tests/test_compact_map.py``'s ``random_workload`` and
  ``assert_maps_equal`` through both packages' maps of each kind, from a
  cold load of the same .idx: entries, lookups, the counters, and for
  ``sortedfile`` the ``.sdx`` bytes and the ``.sdx.meta`` watermark after
  the load, after a delete-only session and after writes.
- A reload over an unchanged .idx maps the ``.sdx`` without a replay.
- The factory's rules: a 5-byte-offset volume gets the dict map unless
  ``disk`` is asked for; an unknown kind raises.
- ``tests/test_concurrency.py``'s threaded flow (``:78``) and
  ``test_vacuum_makeup.py::test_crash_recovery_drops_stale_sdx``
  (``:151``) on the port's ``Volume`` with ``index_kind="sortedfile"``,
  and the three sidecar cleanups: a compaction's commit, its redo after
  a crash between the renames, and ``destroy``, each with a stale
  ``.sdx`` whose watermark matches the compacted .idx.
- Records another writer appended to the .idx (the native plane, under
  its write lease) drop the watermark, so a reload replays them: a
  sortedfile volume server takes a POST on its plane, gives the lease
  back and is restarted, and the needle is still read and survives a
  vacuum.

Tolerances: none.
"""

import json
import os
import random
import shutil
import threading

import numpy as np
import pytest

from seaweedfs_tpu.storage import compact_map as ref_cm
from seaweedfs_tpu.storage.needle_map import NeedleMap as RefNeedleMap
from seaweedfs_tpu_torch.storage import compact_map as cm
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map import NeedleMap
from seaweedfs_tpu_torch.storage.volume import NotFound, Volume
from test_compact_map import assert_maps_equal, random_workload

KINDS = ("compact", "sortedfile")


def _pair(tmp_path, kind, seed, n_ops=3000):
    """The same .idx (a seeded workload on the JAX dict map), loaded by
    each package's map of ``kind``."""
    src = str(tmp_path / "src.idx")
    nm = RefNeedleMap(src)
    random_workload(nm, random.Random(seed), n_ops=n_ops)
    nm.close()
    out = []
    for name, mod in (("ref", ref_cm), ("port", cm)):
        os.makedirs(tmp_path / name)
        path = str(tmp_path / name / "1.idx")
        shutil.copy(src, path)
        out.append(mod.load_needle_map(path, kind))
    return out


def _sidecars(nm):
    base = os.path.splitext(nm.idx_path)[0]
    out = []
    for ext in (".sdx", ".sdx.meta"):
        path = base + ext
        out.append(open(path, "rb").read() if os.path.exists(path)
                   else None)
    return out


def _lookups_equal(a, b, key_space=500):
    for nid in range(1, key_space + 100):
        va, vb = a.get(nid), b.get(nid)
        assert (va is None) == (vb is None), nid
        if va is not None:
            assert (va.offset, va.size) == (vb.offset, vb.size), nid
        assert (nid in a) == (nid in b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [5, 9])
def test_maps_match_jax(tmp_path, kind, seed):
    ref, port = _pair(tmp_path, kind, seed)
    assert type(port).__name__ == type(ref).__name__
    assert port.kind == ref.kind == kind
    assert_maps_equal(ref, port)
    assert list((k, v.offset, v.size) for k, v in port.items()) == \
        list((k, v.offset, v.size) for k, v in ref.items())
    _lookups_equal(ref, port)
    assert _sidecars(port) == _sidecars(ref)
    # a delete-only session (in place on the .sdx), then writes
    for nm in (ref, port):
        rng = random.Random(seed + 1)
        for _ in range(200):
            nm.delete(rng.randrange(1, 500))
    assert _sidecars(port) == _sidecars(ref)
    for nm in (ref, port):
        random_workload(nm, random.Random(seed + 2), n_ops=1500)
    assert_maps_equal(ref, port)
    _lookups_equal(ref, port)
    assert port.content_size == ref.content_size
    assert port.deleted_size == ref.deleted_size
    for nm in (ref, port):
        nm.close()
    assert _sidecars(port) == _sidecars(ref)
    with open(port.idx_path, "rb") as a, open(ref.idx_path, "rb") as b:
        assert a.read() == b.read()
    # cold reloads agree too
    again = [mod.load_needle_map(nm.idx_path, kind)
             for mod, nm in ((ref_cm, ref), (cm, port))]
    assert_maps_equal(*again)
    assert _sidecars(again[1]) == _sidecars(again[0])
    for nm in again:
        nm.close()


def test_compact_merge_matches_jax(tmp_path):
    maps = [mod.CompactNeedleMap.load(str(tmp_path / f"{name}.idx"))
            for name, mod in (("ref", ref_cm), ("port", cm))]
    for nm in maps:
        nm.MERGE_THRESHOLD = 64
        random_workload(nm, random.Random(3), n_ops=2000, key_space=300)
    assert len(maps[1]._overflow) < 64
    assert_maps_equal(*maps)
    assert np.array_equal(maps[0]._base, maps[1]._base)
    assert maps[1].index_nbytes == maps[0].index_nbytes
    for nm in maps:
        nm.close()


def test_sorted_file_fast_reload_skips_replay(tmp_path, monkeypatch):
    path = str(tmp_path / "f.idx")
    nm = NeedleMap(path)
    for i in range(1, 500):
        nm.put(i, i * 8, 75)
    nm.close()
    sf = cm.SortedFileNeedleMap.load(path)
    sf.delete(42)
    counters = (sf.file_counter, sf.deletion_counter,
                sf.deletion_byte_counter)
    sf.close()

    def boom(_):
        raise AssertionError("full .idx replay on a fresh .sdx")
    monkeypatch.setattr(cm, "_replay_idx_vectorized", boom)
    again = cm.load_needle_map(path, "sortedfile")
    assert again.get(42) is None and again.get(41).size == 75
    assert (again.file_counter, again.deletion_counter,
            again.deletion_byte_counter) == counters
    again.put(600, 4800, 10)  # a write takes the watermark away
    again.close()
    assert not os.path.exists(str(tmp_path / "f.sdx.meta"))
    monkeypatch.undo()
    third = cm.load_needle_map(path, "sortedfile")
    assert third.get(600).size == 10 and third.get(42) is None
    third.close()


def test_factory_rules(tmp_path):
    from seaweedfs_tpu_torch.storage.needle_map_disk import DiskNeedleMap
    assert cm.NEEDLE_MAP_KINDS == ("memory", "compact", "sortedfile", "disk")
    assert set(cm.NEEDLE_MAP_KINDS) == ref_cm.NEEDLE_MAP_KINDS
    path = str(tmp_path / "w.idx")
    for kind in ("memory", "compact", "sortedfile"):
        nm = cm.load_needle_map(path, kind, offset_width=5)
        assert type(nm) is NeedleMap and nm.offset_width == 5
        nm.close()
    nm = cm.load_needle_map(path, "disk", offset_width=5)
    assert type(nm) is DiskNeedleMap
    nm.close()
    with pytest.raises(ValueError, match="unknown needle map kind"):
        cm.load_needle_map(path, "leveldb")


@pytest.mark.parametrize("kind", KINDS)
def test_threaded_volume(tmp_path, kind):
    """tests/test_concurrency.py's flow on the port's Volume."""
    v = Volume(str(tmp_path), "", 2, create=True, index_kind=kind)
    errors = []

    def worker(t):
        try:
            rng = np.random.default_rng(t)
            for i in range(80):
                nid = t * 500 + i
                v.write_needle(Needle(
                    id=nid, cookie=1,
                    data=rng.integers(0, 256, 500
                                      ).astype(np.uint8).tobytes()))
                if i % 3 == 0:
                    v.read_needle(Needle(id=nid, cookie=1))
                if i % 5 == 0:
                    v.delete_needle(Needle(id=nid, cookie=1))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors, errors[:3]
    assert len(v.nm) == 6 * 80 - 6 * len(range(0, 80, 5))
    assert v.nm.kind == kind
    v.close()


def _sortedfile_volume(tmp_path):
    """Needles 1-5 with 2 deleted, closed and opened again on the
    sortedfile map (so its .sdx and .sdx.meta exist)."""
    v = Volume(str(tmp_path), "", 1, create=True, index_kind="sortedfile")
    for i in range(1, 6):
        v.write_needle(Needle(id=i, cookie=9, data=b"d%d" % i * 100))
    v.delete_needle(Needle(id=2, cookie=9))
    v.close()
    v = Volume(str(tmp_path), "", 1, index_kind="sortedfile")
    assert os.path.exists(v.file_name() + ".sdx")
    return v


def _forge_watermark(prefix, idx_size):
    """The stale .sdx's meta claims to cover an .idx of ``idx_size``: the
    coincidence that would serve pre-compaction offsets."""
    with open(prefix + ".sdx.meta") as f:
        meta = json.load(f)
    meta["idx_size"] = idx_size
    with open(prefix + ".sdx.meta", "w") as f:
        json.dump(meta, f)


def _check_survivors(v):
    for i in (1, 3, 4, 5):
        assert v.read_needle(Needle(id=i, cookie=9)).data == b"d%d" % i * 100
    with pytest.raises(NotFound):
        v.read_needle(Needle(id=2, cookie=9))


def test_crash_recovery_drops_stale_sdx(tmp_path):
    """test_vacuum_makeup.py's flow, with the stale .sdx's watermark
    forged to the compacted .idx's size."""
    v = _sortedfile_volume(tmp_path)
    v.compact()
    prefix = v.file_name()
    cpd, cpx = prefix + ".cpd", prefix + ".cpx"
    v._makeup_diff(cpd, cpx)
    v.dat.close()
    v.nm.close()
    with open(prefix + ".commit", "w") as f:
        f.write("compact-commit")
    os.replace(cpd, v.dat_path)  # the crash, between the renames
    _forge_watermark(prefix, os.path.getsize(cpx))
    v2 = Volume(str(tmp_path), "", 1, index_kind="sortedfile")
    assert not os.path.exists(prefix + ".commit")
    _check_survivors(v2)
    v2.close()


def test_commit_drops_stale_sdx(tmp_path):
    v = _sortedfile_volume(tmp_path)
    v.compact()
    prefix = v.file_name()
    close = v.nm.close

    def close_then_forge():
        close()
        _forge_watermark(prefix, os.path.getsize(prefix + ".cpx"))
    v.nm.close = close_then_forge
    v.commit_compact()
    _check_survivors(v)
    v.close()
    v2 = Volume(str(tmp_path), "", 1, index_kind="sortedfile")
    _check_survivors(v2)
    v2.close()


def test_destroy_removes_sidecars(tmp_path):
    v = _sortedfile_volume(tmp_path)
    prefix = v.file_name()
    v.destroy()
    for ext in (".dat", ".idx", ".sdx", ".sdx.meta"):
        assert not os.path.exists(prefix + ext), ext


def test_sorted_file_drops_meta_over_foreign_appends(tmp_path):
    """Records another writer appended to the .idx (the native plane,
    while it holds the write lease) are not in the .sdx: closing the map
    drops the watermark instead of stamping the grown size on it, so the
    next load replays them."""
    path = str(tmp_path / "g.idx")
    nm = NeedleMap(path)
    for i in range(1, 50):
        nm.put(i, i * 8, 75)
    nm.close()
    sf = cm.SortedFileNeedleMap.load(path)
    sf.put(60, 60 * 8, 11)
    sf.close()
    sf = cm.SortedFileNeedleMap.load(path)
    other = NeedleMap.load(path)
    other.put(70, 70 * 8, 33)
    other.delete(3)
    other.close()
    sf.delete(5)
    sf.close()
    assert not os.path.exists(str(tmp_path / "g.sdx.meta"))
    again = cm.SortedFileNeedleMap.load(path)
    assert again.get(70).size == 33 and again.get(60).size == 11
    assert again.get(3) is None and again.get(5) is None
    assert again.get(4).size == 75
    again.close()
    assert os.path.exists(str(tmp_path / "g.sdx.meta"))


def test_plane_write_survives_lease_return_and_restart(tmp_path):
    """A sortedfile volume takes a POST on the native plane (appended
    under the plane's write lease), gives the lease back and is
    restarted: the needle is still read, and vacuum keeps it."""
    from seaweedfs_tpu_torch.server.http_util import http_call
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.types import format_file_id
    from test_torch_native_plane import _post
    d = str(tmp_path / "vs")
    vs = VolumeServer(port=0, directories=[d], device="cpu",
                      index_kind="sortedfile").start()
    try:
        if vs.fast_plane is None:
            pytest.fail("the native plane did not start")
        http_call("POST", f"http://{vs.url}/admin/assign_volume?volume=4")
        assert vs.store.find_volume(4).fast_writer is not None
        fids = [format_file_id(4, k, 0x5EED) for k in (1, 2)]
        assert _post(vs.url, f"/{fids[0]}", "py", b"before")[0] == 200
        assert _post(vs.fast_url, f"/{fids[1]}", "plane", b"planed")[0] \
            == 200
        vs._fast_sync(4)   # the lease comes back: the map is replayed
        assert http_call("GET", f"http://{vs.url}/{fids[1]}") == b"planed"
    finally:
        vs.stop()
    again = VolumeServer(port=0, directories=[d], device="cpu",
                         index_kind="sortedfile").start()
    try:
        for fid, data in zip(fids, (b"before", b"planed")):
            assert http_call("GET", f"http://{again.url}/{fid}") == data
        for phase in ("compact", "commit"):
            http_call("POST", f"http://{again.url}/admin/vacuum/{phase}"
                              f"?volume=4")
        assert http_call("GET", f"http://{again.url}/{fids[1]}") == b"planed"
    finally:
        again.stop()
