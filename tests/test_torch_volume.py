"""The port's plain-volume half (storage/volume.py, and the volume half of
storage/store.py's ``DiskLocation`` and ``Store``) against the JAX
package's, each opened over its own copy of the same directory (CPU,
small volumes): a ``Volume``'s superblock, version, offset width, file
name and readonly flag; the torn-tail repair of ``check_integrity`` (the
.dat and .idx it leaves, byte for byte); the boot scan's volumes and
quarantine; ``load_volume``; ``find_free_location`` with EC shards
counting a tenth; and ``mark_volume_readonly``'s previous states.
Tolerances: none; every comparison is exact."""

import json
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import disk_location as ref_disk_location
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.ec import to_ext
from seaweedfs_tpu_torch.storage import SuperBlock, entry_to_bytes
from seaweedfs_tpu_torch.storage import store, volume
from seaweedfs_tpu_torch.storage.super_block import FLAG_5_BYTE_OFFSETS


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _volume(directory, vid, collection="", needles=6, flags=0, seed=0,
            torn=0, idx_past_end=0):
    """A volume's .dat (superblock + needles of 4 KiB) and .idx; ``torn``
    trailing bytes that do not end on 8, ``idx_past_end`` .idx entries
    that point past the .dat's end."""
    os.makedirs(directory, exist_ok=True)
    name = f"{collection}_{vid}" if collection else str(vid)
    base = os.path.join(str(directory), name)
    rng = np.random.default_rng(seed)
    width = 5 if flags & FLAG_5_BYTE_OFFSETS else 4
    with open(base + ".dat", "wb") as f:
        f.write(SuperBlock(flags=flags).to_bytes())
        f.write(rng.integers(0, 256, needles * 4096 + torn,
                             dtype=np.uint8).tobytes())
    with open(base + ".idx", "wb") as f:
        for i in range(needles + idx_past_end):
            f.write(entry_to_bytes(int(rng.integers(1, 1 << 40)),
                                   8 + i * 4096, 4096 - 64, width))
    return base


def _twin(tmp_path):
    shutil.copytree(tmp_path / "v", tmp_path / "ref")
    shutil.copytree(tmp_path / "v", tmp_path / "port")
    return str(tmp_path / "ref"), str(tmp_path / "port")


@pytest.mark.parametrize("flags,torn,past", [
    (0, 0, 0), (0, 5, 0), (0, 0, 2), (FLAG_5_BYTE_OFFSETS, 3, 1)],
    ids=["clean", "torn dat", "idx past end", "5-byte offsets"])
def test_volume_matches_jax(tmp_path, flags, torn, past):
    _volume(tmp_path / "v", 3, collection="pics", flags=flags, torn=torn,
            idx_past_end=past)
    ref_dir, port_dir = _twin(tmp_path)
    ref = ref_volume.Volume(ref_dir, "pics", 3)
    got = volume.Volume(port_dir, "pics", 3)
    try:
        for attr in ("version", "offset_width", "readonly", "collection",
                     "id"):
            assert getattr(got, attr) == getattr(ref, attr), attr
        assert got.super_block.to_bytes() == ref.super_block.to_bytes()
        assert os.path.basename(got.file_name()) == \
            os.path.basename(ref.file_name()) == "pics_3"
        for ext in (".dat", ".idx"):
            assert _read(os.path.join(port_dir, "pics_3" + ext)) == \
                _read(os.path.join(ref_dir, "pics_3" + ext)), ext
        dat_size = os.path.getsize(os.path.join(port_dir, "pics_3.dat"))
        assert (dat_size - 8) % 8 == 0
    finally:
        ref.close()
        got.close()


def test_volume_errors_match_jax(tmp_path):
    os.makedirs(tmp_path / "v")
    with open(tmp_path / "v" / "4.dat", "wb") as f:
        f.write(b"\x03\x00\x00")          # shorter than a superblock
    open(tmp_path / "v" / "4.idx", "wb").close()
    ref_dir, port_dir = _twin(tmp_path)
    errs = []
    for mod, d in ((ref_volume, ref_dir), (volume, port_dir)):
        with pytest.raises(Exception) as ei:
            mod.Volume(d, "", 4)
        errs.append(type(ei.value).__name__)
        with pytest.raises(FileNotFoundError):
            mod.Volume(d, "", 5)
    assert errs[0] == errs[1] == "InvalidSuperBlock"
    assert issubclass(volume.NotFound, volume.VolumeError)
    assert store.VolumeError is volume.VolumeError
    assert store.volume_file_prefix(port_dir, "c", 7) == \
        ref_volume.volume_file_prefix(port_dir, "c", 7) == \
        os.path.join(port_dir, "c_7")


def test_tier_parked_volume_is_readonly(tmp_path):
    base = _volume(tmp_path / "v", 2)
    with open(base + ".vif", "w") as f:
        json.dump({"version": 3, "remote": {"backend": "s3", "key": "k",
                                            "file_size": 1}}, f)
    _volume(tmp_path / "v", 6)
    with open(str(tmp_path / "v" / "6.vif"), "w") as f:
        json.dump({"version": 3}, f)
    ref_dir, port_dir = _twin(tmp_path)
    for vid in (2, 6):
        ref = ref_volume.Volume(ref_dir, "", vid)
        got = volume.Volume(port_dir, "", vid)
        assert got.readonly == ref.readonly == (vid == 2)
        ref.close()
        got.close()


def test_boot_scan_matches_jax(tmp_path):
    _volume(tmp_path / "v", 1)
    _volume(tmp_path / "v", 2, collection="c")
    _volume(tmp_path / "v", 12, collection="a_b", needles=2)
    base = _volume(tmp_path / "v", 9)
    os.remove(base + ".dat")                     # orphaned .idx
    with open(tmp_path / "v" / "8.dat", "wb") as f:
        f.write(b"\x07" * 8)                     # bad version: quarantined
    open(tmp_path / "v" / "8.idx", "wb").close()
    open(tmp_path / "v" / "notes.idx", "wb").close()
    ref_dir, port_dir = _twin(tmp_path)
    ref = ref_disk_location.DiskLocation(ref_dir)
    got = store.DiskLocation(port_dir)
    try:
        ref.load_existing_volumes()
        got.load_existing_volumes()
        assert sorted(got.volumes) == sorted(ref.volumes) == [1, 2, 12]
        for vid, v in got.volumes.items():
            assert v.collection == ref.volumes[vid].collection
            assert v.file_name() == os.path.join(
                port_dir, os.path.basename(ref.volumes[vid].file_name()))
        assert got.get_volume(3) is ref.get_volume(3) is None
        assert got.max_volume_count == ref.max_volume_count == 7
        # load_volume: an id not yet mounted, an orphan and an absent one
        for loc in (ref, got):
            loc.volumes.pop(2).close()
        for vid in (2, 9, 44):
            r, g = ref.load_volume(vid), got.load_volume(vid)
            assert (g is None) == (r is None), vid
            if g is not None:
                assert g.collection == r.collection == "c"
                assert got.load_volume(vid) is g
    finally:
        ref.close()
        got.close()


def test_find_free_location_and_readonly_match_jax(tmp_path):
    """Three directories: volumes and EC shards (a tenth of a slot each)
    fill them so that the choice moves as slots fill."""
    from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
    for d, vids in (("a", (1, 2, 3)), ("b", (4,)), ("c", (5, 6))):
        for vid in vids:
            _volume(tmp_path / "v" / d, vid, needles=1)
    # 14 EC shards of volume 20 in b (1.4 slots), 4 of volume 21 in c
    for d, vid, n in (("b", 20, 14), ("c", 21, 4)):
        base = os.path.join(str(tmp_path / "v" / d), str(vid))
        for sid in range(n):
            with open(base + to_ext(sid), "wb") as f:
                f.write(b"\0" * 64)
        with open(base + ".ecx", "wb") as f:
            f.write(b"\0" * 16)
    ref_root, port_root = _twin(tmp_path)
    dirs = ("a", "b", "c")
    counts = [4, 6, 5]
    ref = ref_store.Store([os.path.join(ref_root, d) for d in dirs],
                          max_volume_counts=counts,
                          codec=RefNumpyCodec(10, 4))
    got = store.Store([os.path.join(port_root, d) for d in dirs],
                      max_volume_counts=counts, device="cpu")
    try:
        seen = []
        for _ in range(3):
            r, g = ref.find_free_location(), got.find_free_location()
            seen.append((None if g is None else os.path.basename(g.directory),
                         None if r is None else os.path.basename(r.directory)))
            if g is None:
                break
            # fill one more slot where the choice fell
            for loc in (r, g):
                loc.volumes[100 + len(seen)] = loc.volumes[
                    next(iter(loc.volumes))]
        assert all(a == b for a, b in seen), seen
        assert [a for a, _ in seen] == ["b", "b", "c"]
        for st in (ref, got):
            for loc in st.locations:
                for key in [k for k in loc.volumes if k > 100]:
                    loc.volumes.pop(key)
        answers = []
        for st in (ref, got):
            answers.append([st.mark_volume_readonly(4),
                            st.mark_volume_readonly(4),
                            st.mark_volume_readonly(4, False),
                            st.mark_volume_readonly(77),
                            st.find_volume(4).readonly,
                            st.find_volume(77)])
        assert answers[1] == answers[0] == [False, True, True, None, False,
                                            None]
    finally:
        for st in (ref, got):
            for loc in st.locations:
                loc.close()


# -- the write and read half: one sequence of operations on both Volumes ---

class _Clock:
    """time.time / time.time_ns for both packages, moved by the test."""

    def __init__(self, t: float):
        self.t = t

    def time(self) -> float:
        return self.t

    def time_ns(self) -> int:
        return int(self.t * 1e9)


def _counters(v):
    return {"file_count": v.file_count(), "deleted_count": v.deleted_count(),
            "max_file_key": v.max_file_key(),
            "content_size": v.content_size(),
            "deleted_size": v.deleted_size(), "size": v.size(),
            "garbage": v.garbage_level(), "expired_0": v.expired(0),
            "expired_30g": v.expired(30 << 30),
            "revision": v.super_block.compaction_revision}


def _read_all(mods, v, ids):
    """{id: (fields) or the exception's class name} for every id."""
    needle_mod = mods[1]
    out = {}
    for nid, cookie in ids.items():
        try:
            n = v.read_needle(needle_mod.Needle(id=nid, cookie=cookie))
            out[nid] = (n.data, n.flags, n.name, n.mime, n.last_modified,
                        n.pairs, n.checksum, n.append_at_ns,
                        n.ttl.to_bytes(),
                        v.read_needle_flags(needle_mod.Needle(id=nid,
                                                              cookie=cookie)))
        except Exception as e:  # noqa: BLE001 - compared by class name
            out[nid] = type(e).__name__
    return out


def _sequence(mods, d, clock, method, width):
    """Writes, overwrites, deletes, TTL expiry, a compaction with writes
    between it and its commit, a reload, and a commit cut short between
    its renames then replayed at the next load; returns what each step
    observed."""
    vol_mod, needle_mod, types_mod = mods
    obs = []
    rng = np.random.default_rng(11)
    v = vol_mod.Volume(d, "c", 9, create=True, offset_width=width,
                       replica_placement=types_mod.ReplicaPlacement.parse(
                           "010"),
                       ttl=types_mod.TTL.parse("1h"))
    ids = {}

    def write(nid, size, cookie=None, **meta):
        cookie = ids.setdefault(nid, 0x1000 + nid) if cookie is None \
            else cookie
        n = needle_mod.Needle(id=nid, cookie=cookie, data=rng.bytes(size))
        if "name" in meta:
            n.set_name(meta["name"])
        if "mime" in meta:
            n.set_mime(meta["mime"])
        if "pairs" in meta:
            n.set_pairs(meta["pairs"])
        if "ttl" in meta:
            n.set_ttl(types_mod.TTL.parse(meta["ttl"]))
            n.set_last_modified(int(clock.t))
        try:
            obs.append(("write", nid, v.write_needle(n)))
        except Exception as e:  # noqa: BLE001 - compared by message
            obs.append(("write", nid, type(e).__name__, str(e)))

    def delete(nid, cookie=None):
        n = needle_mod.Needle(id=nid, cookie=ids.get(nid, 1)
                              if cookie is None else cookie)
        try:
            obs.append(("delete", nid, v.delete_needle(n)))
        except Exception as e:  # noqa: BLE001 - compared by message
            obs.append(("delete", nid, type(e).__name__, str(e)))

    for nid in range(1, 9):
        write(nid, int(rng.integers(50, 3000)), name=b"f%d.bin" % nid,
              mime=b"text/plain", pairs=b'{"Seaweed-n": "%d"}' % nid)
    write(2, 777)                        # overwrite, same cookie
    write(5, 10, cookie=0xBAD)           # overwrite, wrong cookie
    write(6, 0)                          # empty: the tombstone format
    write(20, 400, ttl="2m")             # its own TTL
    delete(3)
    delete(4, cookie=0xBAD)
    delete(99)
    obs.append(("read", _read_all(mods, v, ids)))
    obs.append(("counters", _counters(v)))
    clock.t += 30 * 60
    write(9, 1500)
    write(10, 900, name=b"late")
    obs.append(("read", _read_all(mods, v, ids)))  # 20 has expired
    clock.t += 31 * 60                   # 1-8 are past the volume's 1h
    obs.append(("read", _read_all(mods, v, ids)))
    obs.append(("scan", [(n.id, n.size, off) for n, off in v.scan()]))
    obs.append(("counters", _counters(v)))
    obs.append(("compact", getattr(v, method)()))
    write(11, 640)                       # between compact and commit
    delete(9)
    write(10, 300)
    v.commit_compact()
    obs.append(("committed", _counters(v)))
    obs.append(("read", _read_all(mods, v, ids)))
    v.close()
    v = vol_mod.Volume(d, "c", 9)        # reload
    obs.append(("reloaded", _counters(v), _read_all(mods, v, ids)))
    # a commit cut short after its first rename, replayed at the load
    write(12, 2048)
    delete(11)
    v.compact()
    write(13, 100)
    prefix = v.file_name()
    v._makeup_diff(prefix + ".cpd", prefix + ".cpx")
    with open(prefix + ".commit", "w") as f:
        f.write("compact-commit")
    os.replace(prefix + ".cpd", prefix + ".dat")
    v.dat.close()
    v.nm.close()
    v = vol_mod.Volume(d, "c", 9)
    obs.append(("replayed", _counters(v), _read_all(mods, v, ids),
                sorted(os.listdir(d))))
    v.cleanup_compact()
    v.close()
    return obs


@pytest.mark.parametrize("method", ("compact", "compact_scan"))
@pytest.mark.parametrize("width", (4, 5))
def test_write_read_vacuum_match_jax(tmp_path, monkeypatch, method, width):
    from seaweedfs_tpu.storage import needle as ref_needle
    from seaweedfs_tpu.storage import types as ref_types
    from seaweedfs_tpu_torch.storage import needle, types
    import time
    clock = _Clock(1_700_000_000.0)
    monkeypatch.setattr(time, "time", clock.time)
    monkeypatch.setattr(time, "time_ns", clock.time_ns)
    got = _sequence((volume, needle, types), str(tmp_path / "port"), clock,
                    method, width)
    clock.t = 1_700_000_000.0
    want = _sequence((ref_volume, ref_needle, ref_types),
                     str(tmp_path / "ref"), clock, method, width)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    for ext in (".dat", ".idx"):
        assert _read(tmp_path / "port" / ("c_9" + ext)) == \
            _read(tmp_path / "ref" / ("c_9" + ext)), ext
    # what the sequence must have shown
    kinds = [o[0] for o in got]
    assert kinds.count("read") == 4 and "replayed" in kinds
    assert any(o[:2] == ("write", 5) and o[2] == "VolumeError" for o in got)
    first_read = got[kinds.index("read")][1]
    assert first_read[3] == "NotFound" and isinstance(first_read[2], tuple)
    late = [o for o in got if o[0] == "read"][2][1]
    assert late[1] == "NotFound" and late[20] == "NotFound"
    assert isinstance(late[9], tuple)


def test_volume_lifecycle_in_store_matches_jax(tmp_path):
    """Store.add_volume, write/read/delete through the store,
    delete_volume, and DiskLocation.unload_volume."""
    from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
    from seaweedfs_tpu.storage import needle as ref_needle
    from seaweedfs_tpu_torch.storage import needle
    ref = ref_store.Store([str(tmp_path / "ref")], max_volume_counts=[2],
                          codec=RefNumpyCodec(10, 4))
    got = store.Store([str(tmp_path / "port")], max_volume_counts=[2],
                      device="cpu")
    try:
        answers = []
        for st, nmod in ((ref, ref_needle), (got, needle)):
            a = []
            v = st.add_volume(4, "col", "001", "3d")
            a.append((v.super_block.to_bytes(), st.add_volume(4) is v))
            st.add_volume(5)
            try:
                st.add_volume(6)
            except Exception as e:  # noqa: BLE001 - compared by message
                a.append((type(e).__name__, str(e)))
            a.append(st.write_needle(4, nmod.Needle(id=7, cookie=3,
                                                    data=b"x" * 99)))
            a.append(st.read_needle(4, nmod.Needle(id=7, cookie=3)).data)
            a.append(st.read_needle_flags(4, nmod.Needle(id=7, cookie=3)))
            a.append(st.delete_needle(4, nmod.Needle(id=7, cookie=3)))
            for call in (st.write_needle, st.read_needle, st.delete_needle):
                try:
                    call(8, nmod.Needle(id=1, cookie=1, data=b"y"))
                except Exception as e:  # noqa: BLE001 - compared by message
                    a.append((type(e).__name__, str(e)))
            a.append((st.delete_volume(5), st.delete_volume(5)))
            a.append(st.locations[0].unload_volume(4))
            a.append(st.find_volume(4))
            a.append(sorted(os.listdir(st.locations[0].directory)))
            answers.append(a)
        assert answers[1] == answers[0]
        assert answers[1][-1] == ["col_4.dat", "col_4.idx"]
    finally:
        ref.close()
        got.close()
