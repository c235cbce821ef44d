"""The port's EcVolume, locate_data and EcShardLocationCache
(seaweedfs_tpu_torch/ec/{ec_volume,locate,shard_cache}.py) against the
JAX package's. A seeded .dat of a few MiB with needles across the 1 MiB
block boundaries is encoded at the production block sizes (EcVolume
locates with them); with one data shard lost, every live needle must
locate to the same intervals and read back, through each package's
DegradedReadEngine, as the .dat's bytes in both packages. Tombstoning
through delete_needle and the .ecj replay must leave identical .ecx and
.ecj files."""

import dataclasses
import itertools
import os
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import degraded as ref_degraded
from seaweedfs_tpu.ec import ec_volume as ref_ec_volume
from seaweedfs_tpu.ec import locate as ref_locate
from seaweedfs_tpu.ec import shard_cache as ref_shard_cache
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.storage.needle import get_actual_size
from seaweedfs_tpu_torch.ec import (DegradedReadEngine, EcShardLocationCache,
                                    EcShardNotFound, EcVolume, locate_data,
                                    to_ext, write_ec_files,
                                    write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ec import ec_volume
from seaweedfs_tpu_torch.ops.codec import NumpyCodec
from seaweedfs_tpu_torch.storage import SuperBlock, entry_to_bytes

K, M = 10, 4
TOTAL = K + M
DAT = (3 << 20) + 123_457   # four 1 MiB blocks, the last one partial
LOST = 1                    # the data shard that holds the .dat's 2nd MiB


def _iv(intervals):
    return [dataclasses.astuple(iv) for iv in intervals]


class _Store:
    def __init__(self, ev):
        self.ev = ev

    def find_ec_volume(self, vid):
        return self.ev


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """A seeded volume encoded into tmp/vol/1.ec00-.ec13 + .ecx, with
    needles every ~96 KiB and one across each block boundary, and
    tombstones. Returns (dir, {nid: (offset, size)} live, .dat)."""
    d = tmp_path_factory.mktemp("vol")
    base = str(d / "1")
    rng = np.random.default_rng(13)
    dat = SuperBlock().to_bytes() + rng.bytes(DAT - 8)
    with open(base + ".dat", "wb") as f:
        f.write(dat)
    live = {}
    with open(base + ".idx", "wb") as f:
        off = 8
        for i in itertools.count():
            size = int(rng.integers(1, 180_000))
            if off + get_actual_size(size, 3) > DAT:
                break
            nid = int(rng.integers(1, 1 << 40))
            f.write(entry_to_bytes(nid, off, size))
            live[nid] = (off, size)
            if i % 9 == 4:  # delete an earlier needle
                victim = next(iter(live))
                f.write(entry_to_bytes(victim, 0, 0xFFFFFFFF))
                live.pop(victim)
            off += (int(rng.integers(60_000, 130_000)) + 7) // 8 * 8
        for block in (1, 2, 3):  # one needle straddling each boundary
            nid = int(rng.integers(1, 1 << 40))
            live[nid] = ((block << 20) - 1000, 5000)
            f.write(entry_to_bytes(nid, *live[nid]))
    write_sorted_file_from_idx(base)
    write_ec_files(base, codec=NumpyCodec(K, M))
    assert os.path.getsize(base + to_ext(0)) == 1 << 20
    return d, live, dat


def _mount(cls, d, lost=(LOST,)):
    ev = cls(str(d), "", 1)
    for sid in range(TOTAL):
        if sid not in lost:
            ev.add_shard(sid)
    return ev


def _copy(volume, dst):
    d, _, _ = volume
    shutil.copytree(d, dst)
    return dst


def test_version_and_offset_width_from_superblock_and_vif(volume, tmp_path):
    d = _copy(volume, tmp_path / "v")
    port, ref = _mount(EcVolume, d), _mount(ref_ec_volume.EcVolume, d)
    assert (port.version, port.offset_width) == \
        (ref.version, ref.offset_width) == (3, 4)
    port.write_vif(version=3)
    with open(str(d / "1.vif")) as f:
        assert f.read() == '{"version": 3, "offset_width": 4}'
    assert ec_volume.ec_offset_width(str(d / "1")) == \
        ref_ec_volume.ec_offset_width(str(d / "1")) == 4
    for ev in (port, ref):
        ev.close()
    with pytest.raises(EcShardNotFound):
        EcVolume(str(tmp_path), "", 9)


def test_needles_locate_and_read_through_a_lost_shard(volume):
    d, live, dat = volume
    port, ref = _mount(EcVolume, d), _mount(ref_ec_volume.EcVolume, d)
    port_eng = DegradedReadEngine(store=_Store(port), locations=lambda v: {},
                                  codec=lambda: NumpyCodec(K, M),
                                  batch_ms=0.0)
    ref_eng = ref_degraded.DegradedReadEngine(
        store=_Store(ref), locations=lambda v: {},
        codec=lambda: RefNumpyCodec(K, M), batch_ms=0.0)
    assert port._dat_size_hint() == ref._dat_size_hint() == 10 << 20
    crossing = lost = 0
    for nid, (off, size) in sorted(live.items()):
        got = port.locate_needle(nid)
        assert got[:2] == (off, size)
        assert _iv(got[2]) == _iv(ref.locate_needle(nid)[2])
        crossing += len(got[2]) > 1
        touched = {iv.to_shard_id_and_offset(1 << 30, 1 << 20)[0]
                   for iv in got[2]}
        lost += LOST in touched
        want = dat[off:off + get_actual_size(size, 3)]
        assert port.read_needle_blob(nid, reconstruct_fetch=port_eng.read) \
            == ref.read_needle_blob(nid, reconstruct_fetch=ref_eng.read) \
            == want, nid
    assert crossing >= 3 and lost >= 5
    a, b = ref_eng.snapshot(), port_eng.snapshot()
    for key in ("reads", "batches", "survivor_bytes", "cache_hits",
                "host_dispatches", "device_dispatches", "readahead_hits"):
        assert b[key] == a[key], key
    assert b["reads"] >= lost
    # without a reconstruct fetch the lost shard is unavailable
    nid = next(n for n, (off, _) in live.items() if off > (1 << 20) + 8
               and off + 8 < 2 << 20)
    with pytest.raises(EcShardNotFound):
        port.read_needle_blob(nid)
    # a needle the index never had
    with pytest.raises(KeyError):
        port.locate_needle(1 << 50)
    for ev in (port, ref):
        ev.close()


def test_delete_needle_and_ecj_replay_match_jax(volume, tmp_path):
    _, live, _ = volume
    dirs = [_copy(volume, tmp_path / name) for name in ("ref", "port")]
    evs = [_mount(ref_ec_volume.EcVolume, dirs[0]),
           _mount(EcVolume, dirs[1])]
    victims = sorted(live)[1::5]
    for ev in evs:
        for nid in victims:
            assert ev.delete_needle(nid)
            with pytest.raises(KeyError):
                ev.locate_needle(nid)
        assert not ev.delete_needle(1 << 50)
        ev.close()

    def files(d):
        return [open(str(d / f"1{ext}"), "rb").read()
                for ext in (".ecx", ".ecj")]

    assert files(dirs[1]) == files(dirs[0])
    assert len(files(dirs[1])[1]) == 8 * len(victims)
    # replay the journal onto a fresh .ecx copy in each package
    for d, replay in zip(dirs, (ref_ec_volume.rebuild_ecx_file,
                                ec_volume.rebuild_ecx_file)):
        shutil.copy(str(volume[0] / "1.ecx"), str(d / "1.ecx"))
        replay(str(d / "1"))
        assert not os.path.exists(str(d / "1.ecj"))
    assert open(str(dirs[1] / "1.ecx"), "rb").read() == \
        open(str(dirs[0] / "1.ecx"), "rb").read()


@pytest.mark.parametrize("dat_size", [
    1, 4095, 4096 * 10, 4096 * 10 + 1, 3 * 4096 * 10 - 7,
    3 * 4096 * 10 + 512 * 10, 3 * 4096 * 10 + 512 * 10 + 1,
])
def test_locate_data_matches_jax(dat_size):
    large, small = 4096, 512
    rng = np.random.default_rng(dat_size)
    cases = [(0, 1), (0, dat_size), (dat_size - 1, 1)] + [
        (int(rng.integers(0, dat_size)), int(rng.integers(1, 20_000)))
        for _ in range(60)]
    for off, size in cases:
        got = locate_data(large, small, dat_size, off, size)
        assert _iv(got) == _iv(ref_locate.locate_data(large, small, dat_size,
                                                       off, size))
        assert [iv.to_shard_id_and_offset(large, small) for iv in got] == [
            iv.to_shard_id_and_offset(large, small)
            for iv in ref_locate.locate_data(large, small, dat_size, off,
                                             size)]
        assert sum(iv.size for iv in got) == size


def test_shard_location_cache_matches_jax(monkeypatch):
    fetches = {"port": 0, "ref": 0}
    maps = {1: {i: ["h:1"] for i in range(5)},
            2: {i: ["h:1"] for i in range(TOTAL)},
            3: {i: ["h:1", "h:2"] for i in range(11)}}

    def fetch(side):
        def f(vid):
            fetches[side] += 1
            return {s: list(u) for s, u in maps[vid].items()}
        return f

    now = [0.0]
    caches = {"ref": ref_shard_cache.EcShardLocationCache(fetch("ref")),
              "port": EcShardLocationCache(fetch("port"))}
    # both modules read the one time module's clock
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    seen = {}
    for side, c in caches.items():
        now[0] = 0.0
        out = []
        for vid in (1, 2, 3):
            c.lookup(vid)
        for t in (10.0, 12.0, 400.0, 421.0, 2200.0, 2221.0):
            now[0] = t
            out.append([fetches[side]] + [c.lookup(v) == maps[v]
                                          for v in (1, 2, 3)])
            out[-1].append(fetches[side])
        c.forget(3, 7, "h:1")
        out.append(c.lookup(3)[7])
        c.invalidate(3)
        out.append((c.lookup(3) == maps[3], fetches[side]))
        seen[side] = out
    assert seen["port"] == seen["ref"]
    assert seen["port"][-2] == ["h:2"]
