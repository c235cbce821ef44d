"""Needle — one stored blob and its metadata (the Haystack record).

Disk layout, byte-compatible with the reference
(weed/storage/needle/needle_read_write.go):

  header (16B): Cookie(4) NeedleId(8) Size(4), big-endian
  v1 body:      Data[Size] CRC(4) padding
  v2 body:      DataSize(4) Data Flags(1) [NameSize(1) Name] [MimeSize(1)
                Mime] [LastModified(5)] [TTL(2)] [PairsSize(2) Pairs]
                CRC(4) padding      (the body is present only when
                                     DataSize > 0; Size covers the body
                                     without CRC and padding)
  v3 body:      v2 body + AppendAtNs(8) between CRC and padding

  padding: to the next multiple of 8 of (16 + Size + 4 [+ 8]); the
  reference's PaddingLength never returns 0, so a needle that is already
  aligned still gets 8 bytes of padding (needle_read_write.go:287-293).

  CRC is Castagnoli over Data only, stored masked (crc.py).

``get_actual_size`` is what ec.decode sizes a .dat from, and what a
volume's index walk adds to an offset.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from . import crc as crc_mod
from .types import (CURRENT_VERSION, NEEDLE_CHECKSUM_SIZE, NEEDLE_HEADER_SIZE,
                    NEEDLE_PADDING_SIZE, TIMESTAMP_SIZE, TTL, VERSION1,
                    VERSION2, VERSION3, format_needle_id_cookie)

FLAG_GZIP = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED_DATE = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2


def padding_length(needle_size: int, version: int) -> int:
    base = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
    if version == VERSION3:
        base += TIMESTAMP_SIZE
    return NEEDLE_PADDING_SIZE - (base % NEEDLE_PADDING_SIZE)


def needle_body_length(needle_size: int, version: int) -> int:
    extra = TIMESTAMP_SIZE if version == VERSION3 else 0
    return (needle_size + NEEDLE_CHECKSUM_SIZE + extra
            + padding_length(needle_size, version))


def get_actual_size(size: int, version: int) -> int:
    """Bytes a needle of ``size`` (its header's Size) takes in the .dat."""
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)


class CorruptNeedle(Exception):
    pass


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0            # the Size field of the header and the index
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    last_modified: int = 0   # unix seconds (5 bytes on disk)
    ttl: TTL = field(default_factory=TTL)
    pairs: bytes = b""       # the Seaweed-* pairs, serialized
    checksum: int = 0
    append_at_ns: int = 0

    # -- flags -------------------------------------------------------------
    def _flag(self, bit: int) -> bool:
        return bool(self.flags & bit)

    def has_name(self): return self._flag(FLAG_HAS_NAME)
    def has_mime(self): return self._flag(FLAG_HAS_MIME)
    def has_last_modified(self): return self._flag(FLAG_HAS_LAST_MODIFIED_DATE)
    def has_ttl(self): return self._flag(FLAG_HAS_TTL)
    def has_pairs(self): return self._flag(FLAG_HAS_PAIRS)
    def is_gzipped(self): return self._flag(FLAG_GZIP)
    def is_chunk_manifest(self): return self._flag(FLAG_IS_CHUNK_MANIFEST)

    def set_name(self, name: bytes):
        self.name = name[:255]
        self.flags |= FLAG_HAS_NAME

    def set_mime(self, mime: bytes):
        self.mime = mime[:255]
        self.flags |= FLAG_HAS_MIME

    def set_last_modified(self, ts: int = 0):
        self.last_modified = ts or int(time.time())
        self.flags |= FLAG_HAS_LAST_MODIFIED_DATE

    def set_ttl(self, ttl: TTL):
        if ttl.to_uint32():
            self.ttl = ttl
            self.flags |= FLAG_HAS_TTL

    def set_pairs(self, pairs: bytes):
        self.pairs = pairs
        self.flags |= FLAG_HAS_PAIRS

    def set_gzipped(self):
        self.flags |= FLAG_GZIP

    def set_is_chunk_manifest(self):
        """The payload is a chunk-manifest JSON (reference
        needle_read_write.go:22 FlagIsChunkManifest)."""
        self.flags |= FLAG_IS_CHUNK_MANIFEST

    @property
    def etag(self) -> str:
        return struct.pack(">I", self.checksum).hex()

    def fid_suffix(self) -> str:
        return format_needle_id_cookie(self.id, self.cookie)

    # -- serialization -----------------------------------------------------
    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        self.checksum = crc_mod.needle_checksum(self.data)
        if version == VERSION1:
            self.size = len(self.data)
            return b"".join((
                struct.pack(">IQI", self.cookie, self.id, self.size),
                self.data, struct.pack(">I", self.checksum),
                b"\x00" * padding_length(self.size, version)))
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")
        meta = bytearray()
        if len(self.data) > 0:
            meta.append(self.flags & 0xFF)
            if self.has_name():
                meta.append(len(self.name[:255]))
                meta += self.name[:255]
            if self.has_mime():
                meta.append(len(self.mime[:255]))
                meta += self.mime[:255]
            if self.has_last_modified():
                meta += struct.pack(">Q", self.last_modified)[
                    8 - LAST_MODIFIED_BYTES_LENGTH:]
            if self.has_ttl():
                meta += self.ttl.to_bytes()
            if self.has_pairs():
                meta += struct.pack(">H", len(self.pairs))
                meta += self.pairs
            self.size = 4 + len(self.data) + len(meta)
            head = struct.pack(">IQII", self.cookie, self.id, self.size,
                               len(self.data))
        else:
            self.size = 0
            head = struct.pack(">IQI", self.cookie, self.id, 0)
        tail = struct.pack(">I", self.checksum)
        if version == VERSION3:
            tail += struct.pack(">Q", self.append_at_ns)
        # one join: the payload is copied once, not once per append
        return b"".join((head, self.data, bytes(meta), tail,
                         b"\x00" * padding_length(self.size, version)))

    @classmethod
    def parse_header(cls, blob: bytes) -> "Needle":
        cookie, nid, size = struct.unpack(">IQI", blob[:NEEDLE_HEADER_SIZE])
        return cls(cookie=cookie, id=nid, size=size)

    @classmethod
    def from_bytes(cls, blob: bytes, version: int = CURRENT_VERSION,
                   expected_size: int = None,
                   verify_crc: bool = True) -> "Needle":
        """A needle from its whole record (header to padding).
        ``verify_crc=False`` skips the payload checksum, for callers that
        need only the metadata (a vacuum's TTL check)."""
        n = cls.parse_header(blob)
        if expected_size is not None and n.size != expected_size:
            raise CorruptNeedle(
                f"needle {n.id}: size {n.size} != index size {expected_size}")
        size = n.size
        if version == VERSION1:
            n.data = blob[NEEDLE_HEADER_SIZE:NEEDLE_HEADER_SIZE + size]
        elif version in (VERSION2, VERSION3):
            n._parse_body_v2(blob[NEEDLE_HEADER_SIZE:NEEDLE_HEADER_SIZE + size])
        else:
            raise ValueError(f"unsupported needle version {version}")
        if size > 0:
            stored = struct.unpack(
                ">I", blob[NEEDLE_HEADER_SIZE + size:
                           NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE])[0]
            if verify_crc and stored != crc_mod.needle_checksum(n.data):
                raise CorruptNeedle(f"needle {n.id}: CRC mismatch")
            n.checksum = stored
        if version == VERSION3:
            ts_off = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = struct.unpack(
                ">Q", blob[ts_off:ts_off + TIMESTAMP_SIZE])[0]
        return n

    def _parse_body_v2(self, b: bytes):
        idx, ln = 0, len(b)
        if idx < ln:
            if idx + 4 > ln:
                raise CorruptNeedle("truncated data-size field")
            data_size = struct.unpack(">I", b[idx:idx + 4])[0]
            idx += 4
            if data_size + idx >= ln:  # the flags byte follows the data
                raise CorruptNeedle("data size out of range")
            self.data = b[idx:idx + data_size]
            idx += data_size
            self.flags = b[idx]
            idx += 1
        if idx < ln and self.has_name():
            nsize = b[idx]
            idx += 1
            self.name = b[idx:idx + nsize]
            idx += nsize
        if idx < ln and self.has_mime():
            msize = b[idx]
            idx += 1
            self.mime = b[idx:idx + msize]
            idx += msize
        if idx < ln and self.has_last_modified():
            self.last_modified = int.from_bytes(
                b[idx:idx + LAST_MODIFIED_BYTES_LENGTH], "big")
            idx += LAST_MODIFIED_BYTES_LENGTH
        if idx < ln and self.has_ttl():
            self.ttl = TTL.from_bytes(b[idx:idx + TTL_BYTES_LENGTH])
            idx += TTL_BYTES_LENGTH
        if idx < ln and self.has_pairs():
            psize = struct.unpack(">H", b[idx:idx + 2])[0]
            idx += 2
            self.pairs = b[idx:idx + psize]
            idx += psize
