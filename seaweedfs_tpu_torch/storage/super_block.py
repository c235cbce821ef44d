"""Volume superblock — first 8 bytes of every .dat file.

Byte 0 version, byte 1 replica placement, bytes 2-3 TTL, bytes 4-5
compaction revision, byte 6 volume flags (bit 0 marks 5-byte offsets).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .types import (CURRENT_VERSION, OFFSET_SIZE, OFFSET_SIZE_5,
                    ReplicaPlacement, TTL)

SUPER_BLOCK_SIZE = 8

FLAG_5_BYTE_OFFSETS = 0x01


class InvalidSuperBlock(Exception):
    pass


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(
        default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compaction_revision: int = 0
    flags: int = 0

    @property
    def offset_width(self) -> int:
        return OFFSET_SIZE_5 if self.flags & FLAG_5_BYTE_OFFSETS \
            else OFFSET_SIZE

    def to_bytes(self) -> bytes:
        return bytes([self.version & 0xFF,
                      self.replica_placement.to_byte()]) \
            + self.ttl.to_bytes() \
            + struct.pack(">H", self.compaction_revision) \
            + bytes([self.flags & 0xFF, 0])

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise InvalidSuperBlock("short superblock")
        version = b[0]
        if version == 0 or version > CURRENT_VERSION:
            raise InvalidSuperBlock(f"unsupported volume version {version}")
        return cls(
            version=version,
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=TTL.from_bytes(b[2:4]),
            compaction_revision=struct.unpack(">H", b[4:6])[0],
            flags=b[6],
        )
