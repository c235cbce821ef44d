"""The port's ec.decode half (ec/decoder.py: find_dat_file_size,
write_dat_file, write_idx_file_from_ec_index, the .ecx/.ecj iterators)
and the needle sizes it reads (storage/needle.py) against the JAX
package's, byte for byte: flat and piggyback-tagged .ecx, with and
without an .ecj, 4- and 5-byte offsets."""

import os

import numpy as np
import pytest

from seaweedfs_tpu.ec import decoder as ref_decoder
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import types as ref_types
from seaweedfs_tpu_torch.ec import decoder, to_ext
from seaweedfs_tpu_torch.storage import needle, types
from seaweedfs_tpu_torch.storage.super_block import SuperBlock

LB, SB = 64 << 10, 8 << 10
NBYTES = 300_007


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _volume(dirpath, flags=0, ecj=True, tag=False, seed=5):
    """A volume with needles every ~4 KiB (overwrites and tombstones in
    the .idx), EC-encoded by the JAX package, then its .dat and .idx
    removed as ec.decode finds them. Returns (base, original .dat)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(str(dirpath), "1")
    sb = SuperBlock(flags=flags)
    dat = sb.to_bytes() + rng.integers(0, 256, NBYTES - 8,
                                       dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f:
        f.write(dat)
    width = sb.offset_width
    live = []
    with open(base + ".idx", "wb") as f:
        for i, off in enumerate(range(8, NBYTES - 5000, 4096)):
            nid = int(rng.integers(1, 1 << 40))
            size = int(rng.integers(100, 4000))
            f.write(types.entry_to_bytes(nid, off, size, width))
            live.append(nid)
            if i % 5 == 2:
                f.write(types.entry_to_bytes(live.pop(0), 0,
                                             types.TOMBSTONE_FILE_SIZE,
                                             width))
    ref_encoder.write_sorted_file_from_idx(base)
    ref_encoder.write_ec_files(base, codec=RefNumpyCodec(10, 4),
                               large_block=LB, small_block=SB,
                               slab=32 << 10, pipelined=False)
    if ecj:
        with open(base + ".ecj", "wb") as f:
            for nid in live[3:6]:
                f.write(nid.to_bytes(8, "big"))
    if tag:
        ref_layout.write_ecx_tag(base, "piggyback",
                                 types.entry_size(width))
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    return base, dat


CASES = [dict(), dict(ecj=False), dict(tag=True), dict(flags=1),
         dict(flags=1, tag=True)]


@pytest.mark.parametrize(
    "case", CASES,
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "flat")
def test_decode_matches_jax(tmp_path, case):
    base, dat = _volume(tmp_path, **case)
    width = 5 if case.get("flags") else 4
    assert decoder.read_ec_volume_superblock(base).offset_width == width
    assert list(decoder.iterate_ecx_file(base, width)) == \
        list(ref_decoder.iterate_ecx_file(base, width))
    assert list(decoder.iterate_ecj_file(base)) == \
        list(ref_decoder.iterate_ecj_file(base))

    size = decoder.find_dat_file_size(base)
    assert size == ref_decoder.find_dat_file_size(base)
    assert 0 < size <= NBYTES

    decoder.write_dat_file(base, size, large_block=LB, small_block=SB)
    got = _read(base + ".dat")
    ref_decoder.write_dat_file(base, size, large_block=LB, small_block=SB)
    assert got == _read(base + ".dat") == dat[:size]

    decoder.write_idx_file_from_ec_index(base)
    got = _read(base + ".idx")
    ref_decoder.write_idx_file_from_ec_index(base)
    assert got == _read(base + ".idx")
    rec = types.entry_size(width)
    ecx = _read(base + ".ecx")
    aligned = len(ecx) // rec * rec
    assert len(ecx) == aligned + (1 if case.get("tag") else 0)
    assert got[:aligned] == ecx[:aligned]
    tombstones = got[aligned:]
    assert len(tombstones) == (3 * rec if case.get("ecj", True) else 0)
    for i in range(0, len(tombstones), rec):
        assert types.bytes_to_entry(tombstones[i:i + rec])[2] == \
            types.TOMBSTONE_FILE_SIZE


def test_dat_larger_than_one_large_row(tmp_path):
    """A .dat past one large row takes the large-block branch."""
    base, _ = _volume(tmp_path)
    size = 10 * LB + 1234
    decoder.write_dat_file(base, size, large_block=LB // 8,
                           small_block=SB // 8)
    got = _read(base + ".dat")
    ref_decoder.write_dat_file(base, size, large_block=LB // 8,
                               small_block=SB // 8)
    assert got == _read(base + ".dat") and len(got) == size


@pytest.mark.parametrize("version", [2, 3])
def test_needle_sizes_match_jax(version):
    for size in (0, 1, 7, 8, 100, 4091, (1 << 20) - 64):
        assert needle.padding_length(size, version) == \
            ref_needle.padding_length(size, version)
        assert needle.needle_body_length(size, version) == \
            ref_needle.needle_body_length(size, version)
        got = needle.get_actual_size(size, version)
        assert got == ref_needle.get_actual_size(size, version)
        assert got % types.NEEDLE_PADDING_SIZE == 0
    for b in (bytes(8), b"\x01" * 8 + b"tail", (1 << 63).to_bytes(8, "big")):
        assert types.bytes_to_needle_id(b) == ref_types.bytes_to_needle_id(b)
    assert types.NEEDLE_HEADER_SIZE == ref_types.NEEDLE_HEADER_SIZE == 16
