"""The port's needle record, file ids, TTL, replica placement and CRC32-C
(storage/needle.py, types.py, crc.py) against the JAX package's, on the
same seeded inputs (CPU, needles of at most a few KiB, since the JAX side
may checksum with its pure-Python loop).

* ``Needle.to_bytes`` for versions 1, 2 and 3 over every combination of
  the seven flags, at data sizes that include the ones whose record is
  already 8-aligned (padding 8, never 0); ``from_bytes`` of those bytes,
  field by field, and ``CorruptNeedle`` on a flipped data byte or a size
  that disagrees with the index.
* ``parse_file_id`` (batch deltas, bad ids), ``format_file_id``,
  ``TTL.parse`` and ``ReplicaPlacement.parse``.
* The compiled CRC32-C (its SSE4.2 path where the CPU has it and its
  slicing-by-8 path), the plain version and the JAX ``crc32c``, chained
  and whole, with the masked value.

Tolerances: none; every comparison is exact."""

import itertools

import numpy as np
import pytest

from seaweedfs_tpu.storage import crc as ref_crc
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import types as ref_types
from seaweedfs_tpu_torch.storage import crc, needle, types

FLAG_SETTERS = ("name", "mime", "last_modified", "ttl", "pairs", "gzip",
                "chunk_manifest")
#: data sizes; 4 and 12 make a v1/v2 record 8-aligned before padding
SIZES = (1, 4, 12, 100, 1003, 4096)
FIELDS = ("cookie", "id", "size", "data", "flags", "name", "mime",
          "last_modified", "pairs", "checksum", "append_at_ns")


def _pair(mod, rng, size, flags, types_mod):
    """A needle of ``mod`` with ``flags`` set through its setters."""
    rs = np.random.default_rng(rng)
    n = mod.Needle(cookie=int(rs.integers(0, 1 << 32)),
                   id=int(rs.integers(1, 1 << 63)),
                   data=rs.bytes(size),
                   append_at_ns=int(rs.integers(0, 1 << 62)))
    for flag in flags:
        if flag == "name":
            n.set_name(b"photo-" + rs.bytes(300).hex().encode())
        elif flag == "mime":
            n.set_mime(b"image/jpeg")
        elif flag == "last_modified":
            n.set_last_modified(int(rs.integers(1, 1 << 40)))
        elif flag == "ttl":
            n.set_ttl(types_mod.TTL.parse("3d"))
        elif flag == "pairs":
            n.set_pairs(b'{"Seaweed-k": "' + rs.bytes(20).hex().encode()
                        + b'"}')
        elif flag == "gzip":
            n.set_gzipped()
        else:
            n.set_is_chunk_manifest()
    return n


@pytest.mark.parametrize("version", (1, 2, 3))
@pytest.mark.parametrize("size", SIZES)
def test_needle_bytes_match_jax(version, size):
    seed = version * 1000 + size
    for r in range(len(FLAG_SETTERS) + 1):
        for combo in itertools.combinations(FLAG_SETTERS, r):
            ref = _pair(ref_needle, seed, size, combo, ref_types)
            got = _pair(needle, seed, size, combo, types)
            blob = got.to_bytes(version)
            assert blob == ref.to_bytes(version), combo
            assert got.size == ref.size and got.etag == ref.etag
            assert len(blob) % 8 == 0
            assert len(blob) == needle.get_actual_size(got.size, version) \
                == ref_needle.get_actual_size(ref.size, version)
            assert needle.padding_length(got.size, version) in range(1, 9)
            back = needle.Needle.from_bytes(blob, version,
                                            expected_size=got.size)
            want = ref_needle.Needle.from_bytes(blob, version,
                                                expected_size=got.size)
            for f in FIELDS:
                assert getattr(back, f) == getattr(want, f), (combo, f)
            assert back.ttl.to_bytes() == want.ttl.to_bytes()
            for probe in ("has_name", "has_mime", "has_last_modified",
                          "has_ttl", "has_pairs", "is_gzipped",
                          "is_chunk_manifest"):
                assert getattr(back, probe)() == getattr(want, probe)()
            assert back.fid_suffix() == want.fid_suffix()
            seed += 1


@pytest.mark.parametrize("version", (1, 2, 3))
def test_corrupt_needle_matches_jax(version):
    got = _pair(needle, 7, 2000, ("name", "mime", "pairs"), types)
    blob = bytearray(got.to_bytes(version))
    flipped = bytearray(blob)
    flipped[16 + 4 + 1000] ^= 0x40              # a data byte
    for mod in (needle, ref_needle):
        with pytest.raises(mod.CorruptNeedle, match="CRC"):
            mod.Needle.from_bytes(bytes(flipped), version)
        with pytest.raises(mod.CorruptNeedle, match="index size"):
            mod.Needle.from_bytes(bytes(blob), version,
                                  expected_size=got.size + 8)
        # the metadata read skips the checksum
        n = mod.Needle.from_bytes(bytes(flipped), version, verify_crc=False)
        assert n.id == got.id
    with pytest.raises(ValueError):
        needle.Needle(data=b"x").to_bytes(4)
    # an empty needle is the v2/v3 tombstone: header, CRC, padding
    for version in (2, 3):
        empty = needle.Needle(cookie=9, id=5).to_bytes(version)
        assert empty == ref_needle.Needle(cookie=9, id=5).to_bytes(version)
        assert needle.Needle.parse_header(empty).size == 0


FIDS = ("3,01637037d6", "1,0000000100000001", "7,ffffffffffffffff12345678",
        "42,1a2b3c4d5e", "3,01637037d6_1", "3,01637037d6_17",
        "9/aabbccdd01", "3,01637037d6_x", "3,0123", "noseparator",
        "3,1234567890123456789012345", "x,01637037d6",
        "3,ffffffffffffffffaabbccdd_999999999999999999",
        "3,01637037d6_1234567890123456789")


@pytest.mark.parametrize("fid", FIDS)
def test_file_ids_match_jax(fid):
    try:
        want = ref_types.parse_file_id(fid)
    except ValueError:
        with pytest.raises(ValueError):
            types.parse_file_id(fid)
        return
    got = types.parse_file_id(fid)
    assert got == want
    assert types.format_file_id(*got) == ref_types.format_file_id(*want)
    assert types.parse_file_id(types.format_file_id(*got)) == got


def test_format_needle_id_cookie_matches_jax():
    rng = np.random.default_rng(3)
    cases = [(0, 0), (1, 0), (0, 1), ((1 << 64) - 1, (1 << 32) - 1)]
    cases += [(int(rng.integers(0, 1 << 63)), int(rng.integers(0, 1 << 32)))
              for _ in range(50)]
    for key, cookie in cases:
        assert types.format_needle_id_cookie(key, cookie) == \
            ref_types.format_needle_id_cookie(key, cookie)
    for off in (0, 8, 1 << 20, (1 << 35) - 8):
        for width in (4, 5):
            try:
                want = ref_types.offset_to_bytes(off, width)
            except ValueError:
                with pytest.raises(ValueError):
                    types.offset_to_bytes(off, width)
                continue
            assert types.offset_to_bytes(off, width) == want
            assert types.bytes_to_offset(want) == off
    with pytest.raises(ValueError):
        types.offset_to_bytes(12)
    assert types.max_volume_size(5) == ref_types.max_volume_size(5)
    assert types.max_volume_size(4) == ref_types.max_volume_size(4)


TTLS = ("", "3m", "4h", "5d", "6w", "7M", "8y", "15", "0m", "255d", " 2h ",
        "3q", "d")


@pytest.mark.parametrize("s", TTLS)
def test_ttl_parse_matches_jax(s):
    try:
        want = ref_types.TTL.parse(s)
    except ValueError:
        with pytest.raises(ValueError):
            types.TTL.parse(s)
        return
    got = types.TTL.parse(s)
    assert (got.count, got.unit) == (want.count, want.unit)
    assert got.to_uint32() == want.to_uint32()
    assert got.minutes == want.minutes
    assert str(got) == str(want)
    assert got.to_bytes() == want.to_bytes()
    assert types.TTL.from_bytes(got.to_bytes()) == got


@pytest.mark.parametrize("s", ("000", "001", "010", "100", "123", "", None,
                               " 200 ", "12", "abc", "1234"))
def test_replica_placement_parse_matches_jax(s):
    try:
        want = ref_types.ReplicaPlacement.parse(s)
    except ValueError:
        with pytest.raises(ValueError):
            types.ReplicaPlacement.parse(s)
        return
    got = types.ReplicaPlacement.parse(s)
    assert str(got) == str(want)
    assert got.to_byte() == want.to_byte()
    assert got.copy_count == want.copy_count
    assert types.ReplicaPlacement.from_byte(got.to_byte()) == got


@pytest.mark.parametrize("size", (0, 1, 7, 8, 9, 63, 4097, 100_003))
def test_crc_matches_jax(size):
    data = np.random.default_rng(size).bytes(size)
    want = ref_crc.crc32c(data)
    assert crc.crc32c(data) == crc.crc32c_sliced(data) == \
        crc.crc32c_plain(data) == want
    # chained: the CRC of a prefix continues over the rest
    cut = size // 3
    assert crc.crc32c(data[cut:], crc.crc32c(data[:cut])) == want
    assert crc.crc32c_sliced(data[cut:], crc.crc32c_plain(data[:cut])) \
        == want
    assert crc.masked_value(want) == ref_crc.masked_value(want)
    assert crc.needle_checksum(data) == ref_crc.needle_checksum(data)
    assert crc.crc32c(bytearray(data)) == crc.crc32c(memoryview(data)) \
        == want


def test_crc_check_value_and_library():
    # the CRC-32C check value of "123456789"
    assert crc.crc32c(b"123456789") == crc.crc32c_plain(b"123456789") \
        == 0xE3069283
    assert isinstance(crc.hardware_path(), bool)
    assert crc.LIBRARY.exists()


def test_crc_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not build raises; nothing falls back to the
    plain version."""
    bad = tmp_path / "crc32c.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(crc, "SOURCE", bad)
    monkeypatch.setattr(crc, "LIBRARY", tmp_path / "build" / "libcrc32c.so")
    monkeypatch.setattr(crc, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        crc.crc32c(b"abc")
    with pytest.raises(RuntimeError, match="build failed"):
        needle.Needle(data=b"abc").to_bytes()
