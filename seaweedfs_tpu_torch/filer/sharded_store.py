"""The sharded filer store (the JAX package's
``filer/sharded_store.py``): N SQLite databases ``filer_NN.db`` in one
directory, a directory's entries in shard ``md5(dir)[0] % N``, so a
listing stays one range scan; a recursive delete goes to every shard.
The shard count is kept in a ``SHARDS`` file on first open and read
back after. The files, the marker and the hashing are the JAX
package's: a store directory one package wrote opens in the other."""

from __future__ import annotations

import hashlib
import os
import posixpath
from typing import List, Optional

from .entry import Entry
from .filerstore import FilerStore, register_store
from .sqlite_store import SqliteStore

DEFAULT_SHARDS = 8


@register_store
class ShardedStore(FilerStore):
    name = "sharded"

    def initialize(self, path: str = "", shards: int = DEFAULT_SHARDS,
                   **options):
        """``path`` is the directory of the shard databases (empty or
        ':memory:': in-memory shards)."""
        self._n = int(shards)
        on_disk = bool(path) and path != ":memory:"
        if on_disk:
            os.makedirs(path, exist_ok=True)
            marker = os.path.join(path, "SHARDS")
            if os.path.exists(marker):
                with open(marker) as f:
                    self._n = int(f.read().strip())
            else:
                existing = [p for p in os.listdir(path)
                            if p.startswith("filer_") and p.endswith(".db")]
                if existing and len(existing) != self._n:
                    self._n = len(existing)
                with open(marker, "w") as f:
                    f.write(str(self._n))
        self._shards: List[SqliteStore] = []
        for i in range(self._n):
            s = SqliteStore()
            s.initialize(path=os.path.join(path, f"filer_{i:02d}.db")
                         if on_disk else ":memory:")
            self._shards.append(s)

    def _shard_for_dir(self, dir_path: str) -> SqliteStore:
        digest = hashlib.md5(
            (dir_path.rstrip("/") or "/").encode()).digest()
        return self._shards[digest[0] % self._n]

    def _shard(self, full_path: str) -> SqliteStore:
        return self._shard_for_dir(posixpath.dirname(full_path) or "/")

    def insert_entry(self, entry: Entry) -> None:
        self._shard(entry.full_path).insert_entry(entry)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        return self._shard(full_path).find_entry(full_path)

    def delete_entry(self, full_path: str) -> None:
        self._shard(full_path).delete_entry(full_path)

    def delete_folder_children(self, full_path: str) -> None:
        # descendants' directories hash to any shard
        for s in self._shards:
            s.delete_folder_children(full_path)

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool, limit: int) -> List[Entry]:
        return self._shard_for_dir(dir_path).list_directory_entries(
            dir_path, start_file_name, inclusive, limit)

    def close(self):
        for s in self._shards:
            s.close()
