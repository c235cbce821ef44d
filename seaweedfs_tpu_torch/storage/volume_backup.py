"""Incremental volume sync: follow a volume's appends since a timestamp.

The JAX package's ``storage/volume_backup.py`` (reference
weed/storage/volume_backup.go + weed/server/volume_grpc_tail.go):
the .idx is an append log, so for v3 volumes the needles' append-at
timestamps are monotone in index order. Binary-search the .idx for the
last *live* record at-or-before a given timestamp and ship raw .dat bytes
from just after it; tombstone records (whose idx entries carry offset 0
and so cannot be located directly) lie physically after that point and
ship with the stream — replaying an already-applied record is idempotent,
so over-shipping across a tombstone run is safe while under-shipping
would silently lose deletes. The receiver appends the bytes and replays
the appended region into its needle map; a tombstone record (size 0)
replays as a delete, mirroring the tombstones delete_needle appends.
"""

from __future__ import annotations

import os
import struct

from .needle import Needle, get_actual_size, padding_length
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .types import (NEEDLE_PADDING_SIZE, TOMBSTONE_FILE_SIZE, VERSION3,
                    bytes_to_entry, entry_size, entry_to_bytes)
from .volume import Volume, VolumeError

# server-side default page cap for /admin/volume/tail: an uncapped tail
# of a 30GB volume must not transit RAM in one Response body
DEFAULT_TAIL_PAGE_BYTES = 64 << 20


def walk_records(pread, version: int, start: int, end: int):
    """Yield (header_needle, offset, actual_size) for each raw record in
    [start, end). `pread(offset, size) -> bytes` is the only I/O needed,
    so the same walk serves a live Volume, a bare .dat file, and an
    in-memory blob — the record framing lives in exactly one place.
    Stops at a short tail."""
    offset = start
    while offset + 16 <= end:
        header = pread(offset, 16)
        if len(header) < 16:
            return
        n = Needle.parse_header(header)
        size = 0 if n.size == TOMBSTONE_FILE_SIZE else n.size
        actual = get_actual_size(size, version)
        if offset + actual > end:
            return
        yield n, offset, actual
        offset += actual


def _read_append_at_ns(volume: Volume, dat_offset: int) -> int:
    """append_at_ns of the needle record starting at dat_offset."""
    header = _pread(volume, dat_offset, 16)
    n = Needle.parse_header(header)
    size = 0 if n.size == TOMBSTONE_FILE_SIZE else n.size
    actual = get_actual_size(size, volume.version)
    # v3 record = header + data... + checksum + append_at_ns(8) + padding
    ts_off = dat_offset + actual - padding_length(size, volume.version) - 8
    blob = _pread(volume, ts_off, 8)
    return struct.unpack(">Q", blob)[0]


def _pread(volume: Volume, offset: int, size: int) -> bytes:
    with volume.lock:
        volume.dat.seek(offset)
        return volume.dat.read(size)


def _record_end(volume: Volume, offset: int, idx_size: int) -> int:
    """End offset of the .dat record that an idx entry points at."""
    size = 0 if idx_size == TOMBSTONE_FILE_SIZE else idx_size
    return offset + get_actual_size(size, volume.version)


class _IdxReader:
    """One open .idx handle for a whole search (probes are record-sized
    preads; 16B for 4-byte-offset volumes, 17B for 5-byte)."""

    def __init__(self, volume: Volume):
        self.rec = entry_size(volume.offset_width)
        self.f = open(volume.idx_path, "rb")
        self.total = os.path.getsize(volume.idx_path) // self.rec

    def entry(self, slot: int):
        self.f.seek(slot * self.rec)
        return bytes_to_entry(self.f.read(self.rec))

    def close(self):
        self.f.close()


def _probe_live_ns(volume: Volume, idx: _IdxReader, slot: int):
    """append_at_ns for idx slot, skipping tombstone entries (offset 0,
    whose .dat position is unknowable) forward to the next live record.
    Returns (ns, slot) or None when only tombstones remain."""
    while slot < idx.total:
        nid, offset, size = idx.entry(slot)
        if offset != 0:
            return _read_append_at_ns(volume, offset), slot
        slot += 1
    return None


def last_append_at_ns(volume: Volume) -> int:
    """Timestamp of the newest record, tombstones included (0 for an
    empty volume). Tombstone idx entries hide their .dat offset, so the
    run of records past the last live one — which is exactly the
    trailing tombstones — is walked forward in the .dat."""
    if volume.version != VERSION3:
        raise VolumeError("append timestamps need a v3 volume")
    idx = _IdxReader(volume)
    try:
        scan_from = SUPER_BLOCK_SIZE
        last_ns = 0
        for slot in range(idx.total - 1, -1, -1):
            nid, offset, size = idx.entry(slot)
            if offset != 0:
                last_ns = _read_append_at_ns(volume, offset)
                scan_from = _record_end(volume, offset, size)
                break
    finally:
        idx.close()
    pread = lambda off, size: _pread(volume, off, size)  # noqa: E731
    for n, offset, actual in walk_records(pread, volume.version,
                                          scan_from, volume.size()):
        last_ns = max(last_ns, _read_append_at_ns(volume, offset))
    return last_ns


def binary_search_append_at_ns(volume: Volume, since_ns: int) -> int:
    """Smallest .dat offset from which every record must be shipped to a
    follower synced through since_ns. This is the end of the last live
    record with append_at_ns <= since_ns — NOT the offset of the first
    newer live record, which would skip tombstone records appended in
    between (deletes would be silently lost).

    Reference volume_backup.go BinarySearchForAppendAtNs over the idx.
    """
    if volume.version != VERSION3:
        raise VolumeError("incremental sync needs a v3 volume")
    idx = _IdxReader(volume)
    try:
        # lo = first slot at/after which every live record is > since_ns
        lo, hi = 0, idx.total
        while lo < hi:
            mid = (lo + hi) // 2
            probe = _probe_live_ns(volume, idx, mid)
            if probe is None or probe[0] > since_ns:
                hi = mid
            else:
                lo = probe[1] + 1
        for slot in range(lo - 1, -1, -1):
            nid, offset, size = idx.entry(slot)
            if offset != 0:
                return _record_end(volume, offset, size)
        return SUPER_BLOCK_SIZE
    finally:
        idx.close()


def read_incremental(volume: Volume, since_ns: int,
                     max_bytes: int = 0) -> bytes:
    """Raw .dat bytes for every record appended after since_ns. A
    max_bytes cap ends on a record boundary so a paginating client can
    always apply what it received and resume from its new tail."""
    start = binary_search_append_at_ns(volume, since_ns)
    end = volume.size()
    if max_bytes and end - start > max_bytes:
        pread = lambda off, size: _pread(volume, off, size)  # noqa: E731
        cap = start
        for n, offset, actual in walk_records(pread, volume.version,
                                              start, end):
            if offset + actual - start > max_bytes:
                if cap == start:
                    # the first pending record alone exceeds the cap:
                    # ship it anyway, or pagination would return an
                    # empty page forever and the follower would silently
                    # stop advancing
                    cap = offset + actual
                break
            cap = offset + actual
        end = cap
    return _pread(volume, start, end - start)


def append_raw_records(volume: Volume, blob: bytes,
                       since_ns: int = None) -> tuple:
    """Receiver side: append raw record bytes and replay them into the
    needle map. Returns (records_applied, cursor_ns) where cursor_ns is
    the newest append-at time seen (the resume point for a paginating
    follower — last_append_at_ns(volume) alone cannot serve as cursor
    because tombstone idx entries hide their timestamps). Records are
    re-parsed (not blindly trusted): a short/garbled tail raises before
    anything is written. Records at/before since_ns (the sender
    over-ships across tombstone runs) are skipped."""
    if volume.readonly:
        raise VolumeError(f"volume {volume.id} is read only")
    if volume.version != VERSION3:
        raise VolumeError("incremental sync needs a v3 volume")
    local_last = last_append_at_ns(volume) if since_ns is None \
        else since_ns
    # parse first so a corrupt stream can't leave a torn tail
    records = []
    pos = 0
    pread = lambda off, size: blob[off:off + size]  # noqa: E731
    for n, offset, actual in walk_records(pread, volume.version,
                                          0, len(blob)):
        records.append(
            (Needle.from_bytes(blob[offset:offset + actual],
                               volume.version), offset, actual))
        pos = offset + actual
    if pos != len(blob):
        raise VolumeError(
            "truncated or garbled incremental record stream")
    cursor = max([local_last] + [n.append_at_ns for n, _, _ in records])
    fresh = [(n, rel, actual) for n, rel, actual in records
             if n.append_at_ns > local_last]
    if not fresh:
        return 0, cursor
    base_rel = fresh[0][1]
    blob = blob[base_rel:]
    with volume.lock:
        volume.dat.seek(0, os.SEEK_END)
        base = volume.dat.tell()
        if base % NEEDLE_PADDING_SIZE:
            base += NEEDLE_PADDING_SIZE - base % NEEDLE_PADDING_SIZE
            volume.dat.truncate(base)
        volume.dat.seek(base)
        volume.dat.write(blob)
        volume.dat.flush()
        for n, rel, actual in fresh:
            if n.size > 0:
                volume.nm.put(n.id, base + rel - base_rel, n.size)
            else:
                volume.nm.delete(n.id)
    return len(fresh), cursor


def rebuild_index(dat_path: str, idx_path: str) -> int:
    """Rebuild .idx from a .dat scan (reference weed/command/fix.go).
    Returns the number of records walked."""
    with open(dat_path, "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        version = sb.version
        f.seek(0, os.SEEK_END)
        end = f.tell()

        def pread(off, size):
            f.seek(off)
            return f.read(size)

        width = sb.offset_width
        count = 0
        tmp = idx_path + ".tmp"
        with open(tmp, "wb") as idx:
            for n, offset, actual in walk_records(pread, version,
                                                  SUPER_BLOCK_SIZE, end):
                if n.size > 0:
                    idx.write(entry_to_bytes(n.id, offset, n.size, width))
                else:
                    idx.write(entry_to_bytes(n.id, 0, TOMBSTONE_FILE_SIZE,
                                             width))
                count += 1
    os.replace(tmp, idx_path)
    return count
