"""The port's EC encoder (seaweedfs_tpu_torch/ec/encoder.py) against the
JAX package's: the same seeded .dat + .idx through both, sync and
pipelined, with small blocks so the large-row and small-row branches
both run. .ec00-.ec13 and .ecx must be byte-identical, and so must the
shards rebuilt after losses."""

import os

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.ops.rs_tpu import TpuCodec
from seaweedfs_tpu.storage.needle_map import entry_to_bytes
from seaweedfs_tpu.storage.super_block import SuperBlock
from seaweedfs_tpu.util import file_sha256
from seaweedfs_tpu_torch.ec import (rebuild_ec_files, to_ext,
                                    write_ec_files,
                                    write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec

BLOCKS = dict(large_block=64 << 10, small_block=8 << 10)
SLAB = 32 << 10


def _seed_volume(path, nbytes, seed, offset_width=4):
    """A .dat (real superblock + seeded payload) and a matching .idx with
    overwrites and tombstones, written at ``path`` (no extension)."""
    rng = np.random.default_rng(seed)
    sb = SuperBlock(flags=1 if offset_width == 5 else 0)
    with open(path + ".dat", "wb") as f:
        f.write(sb.to_bytes())
        f.write(rng.integers(0, 256, nbytes - 8, dtype=np.uint8).tobytes())
    with open(path + ".idx", "wb") as f:
        for i in range(400):
            nid = int(rng.integers(1, 300))
            size = int(rng.integers(1, 4096))
            if i % 17 == 5:
                offset, size = 0, 0xFFFFFFFF  # tombstone
            else:
                offset = 8 * int(rng.integers(1, (nbytes - 8) // 8))
            f.write(entry_to_bytes(nid, offset, size, offset_width))


def _digests(base, ids, exts=None):
    out = {}
    for name in [to_ext(i) for i in ids] + list(exts or ()):
        with open(base + name, "rb") as f:
            out[name] = file_sha256(f)
    return out


def _copy_volume(src, dst):
    for ext in (".dat", ".idx"):
        with open(src + ext, "rb") as a, open(dst + ext, "wb") as b:
            b.write(a.read())


@pytest.mark.parametrize("offset_width", [4, 5])
def test_sorted_index_matches(tmp_path, offset_width):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    _seed_volume(ref, 50_000, seed=offset_width, offset_width=offset_width)
    _copy_volume(ref, port)
    ref_encoder.write_sorted_file_from_idx(ref)
    write_sorted_file_from_idx(port)
    with open(ref + ".ecx", "rb") as a, open(port + ".ecx", "rb") as b:
        want = a.read()
        assert b.read() == want
    assert len(want) % (12 + offset_width) == 0 and want


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (20, 4)])
def test_encode_and_rebuild_match_jax(tmp_path, k, m, pipelined):
    # 1.5 large rows' worth: one large row, then the small-row tail
    nbytes = int(1.5 * k * BLOCKS["large_block"]) + 4321
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    _seed_volume(ref, nbytes, seed=k + m)
    _copy_volume(ref, port)
    jax_codec = TpuCodec(k, m) if pipelined else RefNumpyCodec(k, m)
    ref_encoder.write_ec_files(ref, codec=jax_codec, slab=SLAB,
                               pipelined=pipelined, **BLOCKS)
    ref_encoder.write_sorted_file_from_idx(ref)
    codec = TorchCodec(k, m, device="cpu")
    stats = {}
    write_ec_files(port, codec=codec, slab=SLAB, pipelined=pipelined,
                   stats=stats, **BLOCKS)
    write_sorted_file_from_idx(port)
    want = _digests(ref, range(k + m), [".ecx"])
    assert _digests(port, range(k + m), [".ecx"]) == want
    assert stats["dispatches"] > 0 and stats["backend"] == "cuda"
    _assert_phases_tile_wall(stats)

    for lost in ((0, 5, k + 2), tuple(range(min(m, 4)))):
        for sid in lost:
            os.remove(port + to_ext(sid))
        stats = {}
        rebuilt = rebuild_ec_files(port, codec=codec, slab=SLAB,
                                   pipelined=pipelined, stats=stats)
        assert sorted(rebuilt) == sorted(lost)
        assert _digests(port, range(k + m), [".ecx"]) == want
        _assert_phases_tile_wall(stats)


def _assert_phases_tile_wall(stats):
    """Encode and rebuild report the same five phases, summing to the
    operation's wall time."""
    phases = stats["phases"]
    assert set(phases) == {"gather", "plan", "dispatch", "drain", "write"}
    assert all(s >= 0 for s in phases.values())
    assert sum(phases.values()) == pytest.approx(stats["stream_s"],
                                                 abs=1e-5)


def test_one_dispatch_per_slab_one_upload_per_rebuild(tmp_path):
    k, m, lost = 10, 4, (0, 5, 12)
    base = str(tmp_path / "1")
    _seed_volume(base, 300_000, seed=11)
    codec = TorchCodec(k, m, device="cpu")
    stats = {}
    write_ec_files(base, codec=codec, slab=SLAB, stats=stats, **BLOCKS)
    shard_size = os.path.getsize(base + to_ext(1))
    # the .dat fits no large row: small rows of 8 KiB, coalesced 4 to a
    # 32 KiB dispatch
    assert stats["dispatches"] == -(-shard_size // SLAB)
    assert stats["bitmat_uploads"] == 1
    for sid in lost:
        os.remove(base + to_ext(sid))
    slab = 16 << 10
    n_slabs = -(-shard_size // slab)
    stats = {}
    rebuild_ec_files(base, codec=codec, slab=slab, stats=stats)
    # ONE fused dispatch regenerates all three shards of a slab, and the
    # decode constant uploads exactly once for the whole stream
    assert stats["dispatches"] == n_slabs
    assert stats["bitmat_uploads"] == 1
    assert stats["host_fallbacks"] == 0
    assert stats["survivor_bytes"] == shard_size * k
    assert stats["rebuilt_bytes"] == shard_size * len(lost)
    assert stats["backend"] == "cuda"
    # same presence pattern on the same codec: the constant is resident
    for sid in lost:
        os.remove(base + to_ext(sid))
    stats2 = {}
    rebuild_ec_files(base, codec=codec, slab=slab, stats=stats2)
    assert stats2["bitmat_uploads"] == 0
    assert stats2["dispatches"] == n_slabs


def test_rebuild_refuses_too_few_and_no_op(tmp_path):
    k, m = 6, 3
    base = str(tmp_path / "1")
    _seed_volume(base, 40_000, seed=2)
    codec = TorchCodec(k, m, device="cpu")
    write_ec_files(base, codec=codec, slab=SLAB, **BLOCKS)
    assert rebuild_ec_files(base, codec=codec) == []
    for sid in range(m + 1):
        os.remove(base + to_ext(sid))
    with pytest.raises(ValueError, match="cannot rebuild"):
        rebuild_ec_files(base, codec=codec)
