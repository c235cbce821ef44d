"""On-disk widths of the volume index, and the superblock's small fields.

Wire/disk compatible with the reference (SeaweedFS v1.71):
  * big-endian integers
  * index entry: NeedleId(8) + Offset(4) + Size(4) = 16 bytes
  * needle header: Cookie(4) + NeedleId(8) + Size(4) = 16 bytes
  * offsets stored divided by 8 (needle padding unit); a volume flag
    widens them to 5 bytes (17-byte entries)
  * tombstone size = 0xFFFFFFFF
  * TTL: count byte + unit byte; replica placement: one byte
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

VERSION3 = 3
CURRENT_VERSION = VERSION3


def entry_size(offset_width: int = OFFSET_SIZE) -> int:
    """.idx record width for a volume's offset width (16 or 17)."""
    return NEEDLE_ID_SIZE + offset_width + SIZE_SIZE


def bytes_to_needle_id(b: bytes) -> int:
    return struct.unpack(">Q", b[:8])[0]


def needle_id_to_bytes(nid: int) -> bytes:
    return struct.pack(">Q", nid)


def entry_to_bytes(nid: int, offset: int, size: int,
                   offset_width: int = OFFSET_SIZE) -> bytes:
    """offset is the real byte offset; stored /8 in 4 or 5 big-endian
    bytes."""
    if offset % NEEDLE_PADDING_SIZE:
        raise ValueError(f"offset {offset} not {NEEDLE_PADDING_SIZE}B aligned")
    stored = offset // NEEDLE_PADDING_SIZE
    if stored >> (8 * offset_width):
        raise ValueError(
            f"offset {offset} exceeds {offset_width}-byte addressing")
    return struct.pack(">Q", nid) + stored.to_bytes(offset_width, "big") \
        + struct.pack(">I", size)


def bytes_to_entry(b: bytes):
    """(needle_id, offset, size); the record width implies the offset
    width (16 -> 4B, 17 -> 5B)."""
    return (struct.unpack(">Q", b[0:8])[0],
            int.from_bytes(b[8:-4], "big") * NEEDLE_PADDING_SIZE,
            struct.unpack(">I", b[-4:])[0])


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = 0

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if len(b) < 2 or (b[0] == 0 and b[1] == 0):
            return cls()
        return cls(b[0], b[1])

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])


@dataclass(frozen=True)
class ReplicaPlacement:
    """"xyz": x other data centers, y other racks, z same rack."""
    diff_data_center: int = 0
    diff_rack: int = 0
    same_rack: int = 0

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(b // 100, (b // 10) % 10, b % 10)

    def to_byte(self) -> int:
        return self.diff_data_center * 100 + self.diff_rack * 10 \
            + self.same_rack
