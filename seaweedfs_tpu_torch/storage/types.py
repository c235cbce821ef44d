"""On-disk widths of the volume index, file ids, and the superblock's
small fields (TTL, replica placement).

Wire/disk compatible with the reference (SeaweedFS v1.71):
  * big-endian integers
  * index entry: NeedleId(8) + Offset(4) + Size(4) = 16 bytes
  * needle header: Cookie(4) + NeedleId(8) + Size(4) = 16 bytes
  * offsets stored divided by 8 (needle padding unit) -> 32GB max volume
    with 4-byte offsets; a volume flag widens them to 5 bytes (17-byte
    entries, 8TB volumes)
  * tombstone size = 0xFFFFFFFF
  * TTL: count byte + unit byte; replica placement: one byte, decimal
    digits DC/rack/server
  * file id string: "<vid>,<key+cookie hex, leading zero bytes stripped>"
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
OFFSET_SIZE_5 = 5
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE   # 16
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
TOMBSTONE_FILE_SIZE = 0xFFFFFFFF
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB (4B offsets * 8)
MAX_POSSIBLE_VOLUME_SIZE_5 = (1 << 40) * 8              # 8TB (5B offsets)

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


def entry_size(offset_width: int = OFFSET_SIZE) -> int:
    """.idx record width for a volume's offset width (16 or 17)."""
    return NEEDLE_ID_SIZE + offset_width + SIZE_SIZE


def max_volume_size(offset_width: int = OFFSET_SIZE) -> int:
    return MAX_POSSIBLE_VOLUME_SIZE_5 if offset_width == OFFSET_SIZE_5 \
        else MAX_POSSIBLE_VOLUME_SIZE


def bytes_to_needle_id(b: bytes) -> int:
    return struct.unpack(">Q", b[:8])[0]


def needle_id_to_bytes(nid: int) -> bytes:
    return struct.pack(">Q", nid)


def offset_to_bytes(offset: int, offset_width: int = OFFSET_SIZE) -> bytes:
    """offset is the real byte offset; stored /8 in 4 or 5 big-endian
    bytes."""
    if offset % NEEDLE_PADDING_SIZE:
        raise ValueError(f"offset {offset} not {NEEDLE_PADDING_SIZE}B aligned")
    stored = offset // NEEDLE_PADDING_SIZE
    if stored >> (8 * offset_width):
        raise ValueError(
            f"offset {offset} exceeds {offset_width}-byte addressing")
    return stored.to_bytes(offset_width, "big")


def bytes_to_offset(b: bytes) -> int:
    """Width inferred from the slice length (4 or 5 bytes)."""
    return int.from_bytes(b, "big") * NEEDLE_PADDING_SIZE


def entry_to_bytes(nid: int, offset: int, size: int,
                   offset_width: int = OFFSET_SIZE) -> bytes:
    return struct.pack(">Q", nid) + offset_to_bytes(offset, offset_width) \
        + struct.pack(">I", size)


def bytes_to_entry(b: bytes):
    """(needle_id, offset, size); the record width implies the offset
    width (16 -> 4B, 17 -> 5B)."""
    return (struct.unpack(">Q", b[0:8])[0], bytes_to_offset(b[8:-4]),
            struct.unpack(">I", b[-4:])[0])


# -- file ids ------------------------------------------------------------------

def format_needle_id_cookie(key: int, cookie: int) -> str:
    stripped = struct.pack(">QI", key, cookie).lstrip(b"\x00")
    return (stripped or b"\x00").hex()


def parse_key_hash(key_hash: str) -> tuple:
    """'<key_hex><cookie_hex>' -> (key, cookie); the last 8 hex chars are
    the cookie."""
    if len(key_hash) <= 8 or len(key_hash) > 24:
        raise ValueError(f"invalid key-cookie string {key_hash!r}")
    raw = bytes.fromhex(key_hash.zfill(len(key_hash) + len(key_hash) % 2))
    return int.from_bytes(raw[:-4], "big"), int.from_bytes(raw[-4:], "big")


def parse_file_id(fid: str) -> tuple:
    """'3,01637037d6' -> (volume_id, key, cookie). A '_<n>' suffix is the
    batch-assign convention: key + n with the same cookie."""
    sep = "," if "," in fid else "/"
    if sep not in fid:
        raise ValueError(f"invalid fid {fid!r}")
    vid_s, key_hash = fid.split(sep, 1)
    key_hash = key_hash.strip()
    delta = 0
    if "_" in key_hash:
        key_hash, delta_s = key_hash.split("_", 1)
        # capped at 18 digits: a longer delta could push the key past
        # 2^64 and fail in serialization instead of here
        if not delta_s.isdigit() or len(delta_s) > 18:
            raise ValueError(f"invalid fid delta in {fid!r}")
        delta = int(delta_s)
    key, cookie = parse_key_hash(key_hash)
    key += delta
    if key >> 64:
        raise ValueError(f"fid key overflows 64 bits in {fid!r}")
    return int(vid_s), key, cookie


def format_file_id(vid: int, key: int, cookie: int) -> str:
    return f"{vid},{format_needle_id_cookie(key, cookie)}"


# -- TTL -----------------------------------------------------------------------

TTL_EMPTY = 0
TTL_MINUTE = 1
TTL_HOUR = 2
TTL_DAY = 3
TTL_WEEK = 4
TTL_MONTH = 5
TTL_YEAR = 6

_UNIT_CHARS = {TTL_MINUTE: "m", TTL_HOUR: "h", TTL_DAY: "d",
               TTL_WEEK: "w", TTL_MONTH: "M", TTL_YEAR: "y"}
_CHAR_UNITS = {v: k for k, v in _UNIT_CHARS.items()}
_UNIT_MINUTES = {TTL_EMPTY: 0, TTL_MINUTE: 1, TTL_HOUR: 60, TTL_DAY: 24 * 60,
                 TTL_WEEK: 7 * 24 * 60, TTL_MONTH: 31 * 24 * 60,
                 TTL_YEAR: 365 * 24 * 60}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = TTL_EMPTY

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """'3d', '15m', '2M', a bare count of minutes, or empty."""
        s = (s or "").strip()
        if not s:
            return cls()
        unit_ch = s[-1]
        if unit_ch.isdigit():
            return cls(int(s), TTL_MINUTE)
        unit = _CHAR_UNITS.get(unit_ch)
        if unit is None:
            raise ValueError(f"invalid TTL unit {unit_ch!r}")
        return cls(int(s[:-1] or 0), unit)

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if len(b) < 2 or (b[0] == 0 and b[1] == 0):
            return cls()
        return cls(b[0], b[1])

    @classmethod
    def from_uint32(cls, v: int) -> "TTL":
        return cls.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_uint32(self) -> int:
        if self.count == 0:
            return 0
        return (self.count << 8) | self.unit

    @property
    def minutes(self) -> int:
        return self.count * _UNIT_MINUTES.get(self.unit, 0)

    def __str__(self) -> str:
        if self.count == 0 or self.unit == TTL_EMPTY:
            return ""
        return f"{self.count}{_UNIT_CHARS[self.unit]}"


# -- replica placement ---------------------------------------------------------

@dataclass(frozen=True)
class ReplicaPlacement:
    """"xyz": x other data centers, y other racks, z same rack."""
    diff_data_center: int = 0
    diff_rack: int = 0
    same_rack: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        s = (s or "000").strip() or "000"
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"invalid replica placement {s!r}")
        return cls(int(s[0]), int(s[1]), int(s[2]))

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(b // 100, (b // 10) % 10, b % 10)

    def to_byte(self) -> int:
        return self.diff_data_center * 100 + self.diff_rack * 10 \
            + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.diff_data_center + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_data_center}{self.diff_rack}{self.same_rack}"
