"""The in-memory filer store (the JAX package's
``filer/memory_store.py``): encoded entries by path, and a sorted list
of child names per directory for listings."""

from __future__ import annotations

import bisect
import posixpath
from typing import Dict, List, Optional

from ..util.locks import make_rlock
from .entry import Entry
from .filerstore import FilerStore, register_store


@register_store
class MemoryStore(FilerStore):
    name = "memory"

    def initialize(self, **options):
        self._lock = make_rlock("torch.memory_store._lock")
        self._entries: Dict[str, bytes] = {}
        self._children: Dict[str, List[str]] = {}

    def _index_add(self, entry: Entry):
        names = self._children.setdefault(entry.dir_name, [])
        i = bisect.bisect_left(names, entry.name)
        if i >= len(names) or names[i] != entry.name:
            names.insert(i, entry.name)

    def _index_remove(self, full_path: str):
        names = self._children.get(posixpath.dirname(full_path) or "/")
        n = posixpath.basename(full_path)
        if names:
            i = bisect.bisect_left(names, n)
            if i < len(names) and names[i] == n:
                names.pop(i)

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._entries[entry.full_path] = entry.encode()
            self._index_add(entry)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        with self._lock:
            data = self._entries.get(full_path)
        return None if data is None else Entry.decode(full_path, data)

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            self._entries.pop(full_path, None)
            self._index_remove(full_path)

    def delete_folder_children(self, full_path: str) -> None:
        prefix = full_path.rstrip("/") + "/"
        with self._lock:
            for p in [p for p in self._entries if p.startswith(prefix)]:
                self._entries.pop(p, None)
                self._index_remove(p)

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        base = dir_path.rstrip("/")
        with self._lock:
            names = self._children.get(dir_path, [])
            i = 0
            if start_file_name:
                i = bisect.bisect_left(names, start_file_name)
                if i < len(names) and names[i] == start_file_name and \
                        not inclusive:
                    i += 1
            out: List[Entry] = []
            for name in names[i:]:
                if len(out) >= limit:
                    break
                full = f"{base}/{name}"
                data = self._entries.get(full)
                if data is not None:
                    out.append(Entry.decode(full, data))
            return out
