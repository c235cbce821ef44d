"""Needle maps — in-memory needle id -> (offset, size) indexes.

* ``NeedleMap`` — a volume's live index: a dict, plus the reference's
  write-through discipline (every put and delete appends an entry to the
  .idx log, reference needle_map.go:51 baseNeedleMapper), and the
  counters the vacuum and the volume report read.
* ``MemDb`` — the sorted needle db that turns a volume's .idx append log
  into the EC index (.ecx), reference needle_map/memdb.go.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

from .types import (OFFSET_SIZE, TOMBSTONE_FILE_SIZE, bytes_to_entry,
                    entry_size, entry_to_bytes)


class NeedleValue:
    __slots__ = ("offset", "size")

    def __init__(self, offset: int, size: int):
        self.offset = offset
        self.size = size


class NeedleMap:
    """Write-through needle map: an in-memory dict and the append-only
    .idx log. ``file_counter`` / ``file_byte_counter`` count every put,
    ``deletion_counter`` / ``deletion_byte_counter`` every live entry a
    put or a delete replaced, as the reference's counters do."""

    def __init__(self, idx_path: Optional[str] = None,
                 offset_width: int = OFFSET_SIZE):
        self._m: dict = {}
        self.idx_path = idx_path
        self.offset_width = offset_width
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.maximum_file_key = 0
        self._idx_file = None if idx_path is None else open(idx_path, "ab")

    @classmethod
    def load(cls, idx_path: str,
             offset_width: int = OFFSET_SIZE) -> "NeedleMap":
        """Replay an .idx log (if any), then append to it."""
        nm = cls(None, offset_width)
        nm.idx_path = idx_path
        if os.path.exists(idx_path):
            for nid, offset, size in walk_index_file(idx_path,
                                                     offset_width):
                nm._apply(nid, offset, size)
        nm._idx_file = open(idx_path, "ab")
        return nm

    def _apply(self, nid: int, offset: int, size: int):
        self.maximum_file_key = max(self.maximum_file_key, nid)
        if size != TOMBSTONE_FILE_SIZE and offset != 0:
            old = self._m.get(nid)
            self._m[nid] = NeedleValue(offset, size)
            self.file_counter += 1
            self.file_byte_counter += size
        else:
            old = self._m.pop(nid, None)
        if old is not None:
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size

    def _log(self, nid: int, offset: int, size: int):
        if self._idx_file is not None:
            self._idx_file.write(
                entry_to_bytes(nid, offset, size, self.offset_width))
            self._idx_file.flush()

    def put(self, nid: int, offset: int, size: int):
        self._apply(nid, offset, size)
        self._log(nid, offset, size)

    def delete(self, nid: int):
        """Tombstone: an entry with offset 0 and the tombstone size."""
        old = self._m.pop(nid, None)
        if old is not None:
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._log(nid, 0, TOMBSTONE_FILE_SIZE)

    def get(self, nid: int) -> Optional[NeedleValue]:
        return self._m.get(nid)

    def __contains__(self, nid: int) -> bool:
        return nid in self._m

    def __len__(self) -> int:
        return len(self._m)

    def items(self) -> Iterator[Tuple[int, NeedleValue]]:
        return iter(self._m.items())

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    @property
    def deleted_size(self) -> int:
        return self.deletion_byte_counter

    def close(self):
        if self._idx_file is not None:
            self._idx_file.close()
            self._idx_file = None


class MemDb:
    """needle id -> (offset, size), visited in ascending id order."""

    def __init__(self, offset_width: int = OFFSET_SIZE):
        self._m: dict = {}
        self.offset_width = offset_width

    def set(self, nid: int, offset: int, size: int):
        self._m[nid] = (offset, size)

    def delete(self, nid: int):
        self._m.pop(nid, None)

    def ascending_visit(self) -> Iterator[Tuple[int, int, int]]:
        for nid in sorted(self._m):
            offset, size = self._m[nid]
            yield nid, offset, size

    @classmethod
    def load_from_idx(cls, idx_path: str,
                      offset_width: int = OFFSET_SIZE) -> "MemDb":
        """Replay a .idx log: later entries win, tombstones (and zero
        offsets) delete."""
        db = cls(offset_width)
        for nid, offset, size in walk_index_file(idx_path, offset_width):
            if size != TOMBSTONE_FILE_SIZE and offset != 0:
                db.set(nid, offset, size)
            else:
                db.delete(nid)
        return db

    def save_to_idx(self, path: str):
        with open(path, "wb") as f:
            for nid, offset, size in self.ascending_visit():
                f.write(entry_to_bytes(nid, offset, size, self.offset_width))


def walk_index_file(idx_path: str, offset_width: int = OFFSET_SIZE):
    """Stream (needle_id, offset, size) from a .idx file — 16B records
    with 4-byte offsets, 17B with 5-byte."""
    rec = entry_size(offset_width)
    with open(idx_path, "rb") as f:
        while True:
            chunk = f.read(rec * 1024)
            if not chunk:
                break
            for i in range(0, len(chunk) - rec + 1, rec):
                yield bytes_to_entry(chunk[i:i + rec])
