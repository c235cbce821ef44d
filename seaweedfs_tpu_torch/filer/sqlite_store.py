"""The SQLite filer store (the JAX package's ``filer/sqlite_store.py``):
one table ``filemeta (directory, name, meta)`` keyed by (directory,
name), the encoded entry as the blob, listings as ordered range scans.
The schema is the JAX package's: a database one package wrote opens in
the other."""

from __future__ import annotations

import posixpath
import sqlite3
from typing import List, Optional

from ..util.locks import make_rlock
from .entry import Entry
from .filerstore import FilerStore, register_store


@register_store
class SqliteStore(FilerStore):
    name = "sqlite"

    def initialize(self, path: str = ":memory:", **options):
        self._lock = make_rlock("torch.sqlite_store._lock")
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS filemeta ("
            " directory TEXT NOT NULL,"
            " name TEXT NOT NULL,"
            " meta BLOB,"
            " PRIMARY KEY (directory, name))")
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_dir ON filemeta (directory)")
        self._db.commit()

    @staticmethod
    def _split(full_path: str):
        return (posixpath.dirname(full_path) or "/",
                posixpath.basename(full_path))

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO filemeta (directory, name, meta) "
                "VALUES (?, ?, ?)", (d, n, entry.encode()))
            self._db.commit()

    def find_entry(self, full_path: str) -> Optional[Entry]:
        d, n = self._split(full_path)
        with self._lock:
            row = self._db.execute(
                "SELECT meta FROM filemeta WHERE directory=? AND name=?",
                (d, n)).fetchone()
        return None if row is None else Entry.decode(full_path, row[0])

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        with self._lock:
            self._db.execute(
                "DELETE FROM filemeta WHERE directory=? AND name=?", (d, n))
            self._db.commit()

    def delete_folder_children(self, full_path: str) -> None:
        prefix = full_path.rstrip("/") + "/"
        # LIKE wildcards in the path are escaped: "/a_b" must not take
        # the children of "/axb" along
        escaped = prefix.replace("\\", "\\\\").replace("%", "\\%") \
                        .replace("_", "\\_")
        with self._lock:
            self._db.execute(
                "DELETE FROM filemeta WHERE directory=? "
                "OR directory LIKE ? ESCAPE '\\'",
                (full_path.rstrip("/") or "/", escaped + "%"))
            self._db.commit()

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        op = ">=" if inclusive else ">"
        with self._lock:
            if start_file_name:
                rows = self._db.execute(
                    f"SELECT name, meta FROM filemeta WHERE directory=? "
                    f"AND name {op} ? ORDER BY name LIMIT ?",
                    (dir_path, start_file_name, limit)).fetchall()
            else:
                rows = self._db.execute(
                    "SELECT name, meta FROM filemeta WHERE directory=? "
                    "ORDER BY name LIMIT ?", (dir_path, limit)).fetchall()
        base = dir_path.rstrip("/")
        return [Entry.decode(f"{base}/{name}", meta) for name, meta in rows]

    def close(self):
        with self._lock:
            self._db.close()
