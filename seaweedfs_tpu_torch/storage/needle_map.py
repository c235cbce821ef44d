"""MemDb — the sorted needle db that turns a volume's .idx append log
into the EC index (.ecx), reference needle_map/memdb.go."""

from __future__ import annotations

from typing import Iterator, Tuple

from .types import (OFFSET_SIZE, TOMBSTONE_FILE_SIZE, bytes_to_entry,
                    entry_size, entry_to_bytes)


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
