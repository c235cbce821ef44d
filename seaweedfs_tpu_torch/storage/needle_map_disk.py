"""The disk-backed needle map of ``-index disk`` (on stdlib sqlite3).

The JAX package's ``storage/needle_map_disk.py`` (reference
needle_map_leveldb.go:15-120, on sqlite in place of LevelDB). A volume
whose index outgrows RAM keeps it on disk, as a log and a checkpoint:

* the .idx stays the durable append-only log, byte for byte what every
  other map kind writes;
* ``<base>.ndb`` is a sqlite checkpoint of the live set and the
  counters, valid up to a recorded .idx watermark, whose last 4 KiB are
  fingerprinted (crc32) so a rewritten .idx of the same length is told
  from an appended one;
* a load replays only the .idx past the watermark; a shorter .idx (a
  vacuum), changed bytes under it or another offset width rebuild the
  checkpoint from the whole .idx.

Memory is sqlite's page cache and one replay batch, whatever the
needle count. Records that another writer (the native plane's write
lease) appended behind this map stay past the watermark until a replay
takes them in: the watermark never runs ahead of what was applied.
Two differences from the JAX map, both faults there: ``sync``
fdatasyncs the .idx log as the memory map's does (the JAX map has none,
so a Python append under ``-index disk`` skipped the .idx fdatasync of
SW_PLANE_FSYNC_MODE), and the largest needle id is checkpointed in
sqlite's signed range (the JAX map fails every checkpoint once a needle
id of 2^63 or more was written).
"""

from __future__ import annotations

import os
import sqlite3
import zlib
from typing import Iterator, Optional, Tuple

from .needle_map import NeedleValue
from .types import (OFFSET_SIZE, TOMBSTONE_FILE_SIZE, bytes_to_needle_id,
                    bytes_to_offset, entry_to_bytes)

_BATCH = 65536          # replay records per batch (bounds replay RAM)
_COMMIT_EVERY = 512     # mutations per durable checkpoint
_IN_CHUNK = 900         # keys per IN (...) probe (sqlite's variable cap)

_COUNTER_KEYS = ("file_counter", "file_byte_counter", "deletion_counter",
                 "deletion_byte_counter", "maximum_file_key")


def _s64(nid: int) -> int:
    """uint64 needle id -> sqlite's signed INTEGER."""
    return nid - (1 << 64) if nid >= (1 << 63) else nid


def _u64(nid: int) -> int:
    return nid + (1 << 64) if nid < 0 else nid


class _SnapshotCursor:
    """An iterator over a pinned WAL snapshot (``items_snapshot``) that
    closes its private connection when exhausted, on ``close`` or when
    collected, whichever comes first."""

    def __init__(self, db, cur, first):
        self._db, self._cur, self._row = db, cur, first

    def __iter__(self):
        return self

    def __next__(self):
        row = self._row
        if row is None:
            self.close()
            raise StopIteration
        self._row = self._cur.fetchone()
        return _u64(row[0]), NeedleValue(row[1], row[2])

    def close(self):
        db, self._db = self._db, None
        self._row = None
        if db is not None:
            db.close()

    def __del__(self):
        self.close()


class DiskNeedleMap:
    """A sqlite-checkpointed needle map with ``NeedleMap``'s interface
    and counters."""

    kind = "disk"

    def __init__(self, idx_path: str, offset_width: int = OFFSET_SIZE):
        self.idx_path = idx_path
        self.offset_width = offset_width
        self.db_path = os.path.splitext(idx_path)[0] + ".ndb"
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.maximum_file_key = 0
        self._dirty = 0
        self._idx_file = None
        # handler threads share the map under the volume lock
        self._db = sqlite3.connect(self.db_path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute("CREATE TABLE IF NOT EXISTS needles("
                         "nid INTEGER PRIMARY KEY, off INTEGER, "
                         "size INTEGER)")
        self._db.execute("CREATE TABLE IF NOT EXISTS meta("
                         "key TEXT PRIMARY KEY, value INTEGER)")
        self._catch_up()
        self._idx_file = open(idx_path, "ab")

    @classmethod
    def load(cls, idx_path: str,
             offset_width: int = OFFSET_SIZE) -> "DiskNeedleMap":
        return cls(idx_path, offset_width)

    # -- load: the checkpoint and the .idx past it -------------------------
    def _meta_get(self, key: str, default: int = 0) -> int:
        row = self._db.execute("SELECT value FROM meta WHERE key=?",
                               (key,)).fetchone()
        return default if row is None else int(row[0])

    def _tail_crc(self, end: int, span: int) -> int:
        """crc32 of the .idx bytes [end - span, end)."""
        if span <= 0:
            return 0
        with open(self.idx_path, "rb") as f:
            f.seek(end - span)
            return zlib.crc32(f.read(span))

    def _catch_up(self):
        idx_size = os.path.getsize(self.idx_path) \
            if os.path.exists(self.idx_path) else 0
        entry = 12 + self.offset_width
        if idx_size % entry:
            # a torn last record is cut off: the append handle writes at
            # the physical end, and a half record would misframe every
            # record after it
            idx_size -= idx_size % entry
            with open(self.idx_path, "r+b") as f:
                f.truncate(idx_size)
        watermark = self._meta_get("idx_size", -1)
        stale = watermark < 0 or watermark > idx_size or \
            self._meta_get("offset_width", 0) != self.offset_width
        if not stale and watermark > 0:
            span = self._meta_get("tail_span", 0)
            if span > watermark or self._meta_get("tail_crc", -1) != \
                    self._tail_crc(watermark, span):
                stale = True    # as long or longer, other bytes
        if stale:
            self._db.execute("DELETE FROM needles")
            self._db.execute("DELETE FROM meta")
            watermark = 0
        else:
            for k in _COUNTER_KEYS:
                setattr(self, k, self._meta_get(k))
            self.maximum_file_key = _u64(self.maximum_file_key)
        if watermark < idx_size:
            self._replay_range(watermark, idx_size)
        # the .idx byte position the db is complete through
        self._applied = idx_size
        self._checkpoint(idx_size)

    def _replay_range(self, start: int, end: int):
        entry = 12 + self.offset_width
        with open(self.idx_path, "rb") as f:
            f.seek(start)
            remaining = end - start
            while remaining > 0:
                chunk = f.read(min(remaining, _BATCH * entry))
                if not chunk:
                    break
                remaining -= len(chunk)
                self._apply_batch(chunk)

    def _apply_batch(self, chunk: bytes):
        """``NeedleMap._apply``'s counters over a batch of records, one
        db probe per distinct key."""
        entry = 12 + self.offset_width
        recs = []
        for i in range(0, len(chunk) - entry + 1, entry):
            b = chunk[i:i + entry]
            recs.append((bytes_to_needle_id(b[0:8]),
                         bytes_to_offset(b[8:8 + self.offset_width]),
                         int.from_bytes(b[-4:], "big")))
        keys = list({_s64(nid) for nid, _, _ in recs})
        prior = {}
        for j in range(0, len(keys), _IN_CHUNK):
            part = keys[j:j + _IN_CHUNK]
            q = ",".join("?" * len(part))
            for nid_s, off, size in self._db.execute(
                    f"SELECT nid, off, size FROM needles WHERE nid IN ({q})",
                    part):
                prior[_u64(nid_s)] = (off, size)
        pending = {}                    # nid -> (off, size), or None: dead
        for nid, off, size in recs:
            self.maximum_file_key = max(self.maximum_file_key, nid)
            old = pending[nid] if nid in pending else prior.get(nid)
            if size != TOMBSTONE_FILE_SIZE and off != 0:
                pending[nid] = (off, size)
                self.file_counter += 1
                self.file_byte_counter += size
            else:
                pending[nid] = None
            if old is not None:
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
        self._db.executemany(
            "INSERT INTO needles(nid, off, size) VALUES(?,?,?) "
            "ON CONFLICT(nid) DO UPDATE SET off=excluded.off, "
            "size=excluded.size",
            [(_s64(nid), v[0], v[1]) for nid, v in pending.items()
             if v is not None])
        self._db.executemany(
            "DELETE FROM needles WHERE nid=?",
            [(_s64(nid),) for nid, v in pending.items() if v is None])

    def _checkpoint(self, idx_size: Optional[int] = None):
        if idx_size is None:
            self._idx_file.flush()
            idx_size = self._applied
        state = {k: getattr(self, k) for k in _COUNTER_KEYS}
        state["maximum_file_key"] = _s64(self.maximum_file_key)
        span = min(4096, idx_size)
        state.update(idx_size=idx_size, offset_width=self.offset_width,
                     tail_span=span,
                     tail_crc=self._tail_crc(idx_size, span))
        self._db.executemany(
            "INSERT INTO meta(key, value) VALUES(?,?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            list(state.items()))
        self._db.commit()
        self._dirty = 0

    # -- mutations: the .idx log and the db --------------------------------
    def _maybe_checkpoint(self):
        self._dirty += 1
        if self._dirty >= _COMMIT_EVERY:
            self._checkpoint()

    def _append_entry(self, raw: bytes) -> bool:
        """Append one .idx record. True: the caller applies it. False:
        another writer's records lay between what was applied and this
        one, and the whole gap, this record included, was replayed."""
        self._idx_file.write(raw)
        self._idx_file.flush()
        pos = self._idx_file.tell()
        if pos - len(raw) == self._applied:
            self._applied = pos
            return True
        self._replay_range(self._applied, pos)
        self._applied = pos
        return False

    def _upsert(self, nid: int, offset: int, size: int):
        self._db.execute(
            "INSERT INTO needles(nid, off, size) VALUES(?,?,?) "
            "ON CONFLICT(nid) DO UPDATE SET off=excluded.off, "
            "size=excluded.size", (_s64(nid), offset, size))

    def put(self, nid: int, offset: int, size: int):
        if self._append_entry(entry_to_bytes(nid, offset, size,
                                             self.offset_width)):
            old = self.get(nid)
            self.maximum_file_key = max(self.maximum_file_key, nid)
            if size != TOMBSTONE_FILE_SIZE and offset != 0:
                self._upsert(nid, offset, size)
                self.file_counter += 1
                self.file_byte_counter += size
            else:
                self._db.execute("DELETE FROM needles WHERE nid=?",
                                 (_s64(nid),))
            if old is not None:
                self.deletion_counter += 1
                self.deletion_byte_counter += old.size
        self._maybe_checkpoint()

    def delete(self, nid: int):
        if self._append_entry(entry_to_bytes(nid, 0, TOMBSTONE_FILE_SIZE,
                                             self.offset_width)):
            old = self.get(nid)
            if old is not None:
                self.deletion_counter += 1
                self.deletion_byte_counter += old.size
                self._db.execute("DELETE FROM needles WHERE nid=?",
                                 (_s64(nid),))
        self._maybe_checkpoint()

    # -- lookups -----------------------------------------------------------
    def get(self, nid: int) -> Optional[NeedleValue]:
        row = self._db.execute("SELECT off, size FROM needles WHERE nid=?",
                               (_s64(nid),)).fetchone()
        return None if row is None else NeedleValue(row[0], row[1])

    def __contains__(self, nid: int) -> bool:
        return self.get(nid) is not None

    def __len__(self) -> int:
        return self._db.execute("SELECT COUNT(*) FROM needles").fetchone()[0]

    def flush(self):
        """Commit what is pending and move the checkpoint up: before a
        read from another connection (the vacuum's snapshot)."""
        self._checkpoint()

    def items_snapshot(self, by_offset: bool = False
                       ) -> Iterator[Tuple[int, NeedleValue]]:
        """The live set streamed from a private connection (WAL snapshot
        isolation), pinned before this returns: a caller holding the
        volume lock gets the set of now, and a later write is the
        vacuum's makeup diff. ``by_offset`` sorts by .dat offset (a
        whole-table sort). Call ``flush`` first (snapshot_live_items
        does)."""
        db = sqlite3.connect(self.db_path, check_same_thread=False)
        cur = db.execute("SELECT nid, off, size FROM needles"
                         + (" ORDER BY off" if by_offset else ""))
        return _SnapshotCursor(db, cur, cur.fetchone())

    def items(self) -> Iterator[Tuple[int, NeedleValue]]:
        """Every live entry in id order, on the mutating connection: not
        stable under concurrent writes (``items_snapshot`` is)."""
        for nid_s, off, size in self._db.cursor().execute(
                "SELECT nid, off, size FROM needles ORDER BY nid"):
            yield _u64(nid_s), NeedleValue(off, size)

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    @property
    def deleted_size(self) -> int:
        return self.deletion_byte_counter

    def sync(self):
        """fdatasync the .idx log (SW_PLANE_FSYNC_MODE on the Python
        append path)."""
        if self._idx_file is not None:
            self._idx_file.flush()
            os.fdatasync(self._idx_file.fileno())

    def close(self):
        if self._idx_file is not None:
            self._checkpoint()
            self._idx_file.close()
            self._idx_file = None
        if self._db is not None:
            self._db.close()
            self._db = None
