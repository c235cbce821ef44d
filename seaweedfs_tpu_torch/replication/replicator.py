"""Replicator — route filer events to a sink: the JAX package's
``replication/replicator.py`` (reference weed/replication/replicator.go):
which of oldEntry and newEntry is present decides create, update or
delete; only events under the source's prefix replicate, keyed by the
path below it."""

from __future__ import annotations

from .sink import ReplicationSink
from .source import FilerSource


class Replicator:
    def __init__(self, source: FilerSource, sink: ReplicationSink):
        self.source = source
        self.sink = sink

    def replicate(self, event: dict) -> str:
        """Apply one EventNotification. Returns what was done
        ('create' / 'update' / 'delete' / 'skip')."""
        old = event.get("oldEntry")
        new = event.get("newEntry")
        old_path = old.get("FullPath") if old else None
        new_path = new.get("FullPath") if new else None

        if new is not None and not self.source.matches(new_path):
            new = None
        if old is not None and not self.source.matches(old_path):
            old = None

        if old is None and new is None:
            return "skip"
        if old is None:
            self._with_data(new, lambda data: self.sink.create_entry(
                self.source.relative(new_path), new, data))
            return "create"
        if new is None:
            self.sink.delete_entry(self.source.relative(old_path),
                                   old.get("IsDirectory", False))
            return "delete"
        if old_path == new_path:
            self._with_data(new, lambda data: self.sink.update_entry(
                self.source.relative(new_path), old, new, data))
            return "update"
        # rename: delete at the old key, create at the new
        self.sink.delete_entry(self.source.relative(old_path),
                               old.get("IsDirectory", False))
        self._with_data(new, lambda data: self.sink.create_entry(
            self.source.relative(new_path), new, data))
        return "update"

    def _with_data(self, entry: dict, fn):
        """Run fn with the entry's content as a spooled (fileobj, size)
        — RAM-bounded however large the entry — closing the spool after."""
        if entry.get("IsDirectory"):
            return fn(b"")
        fileobj, size = self.source.open_entry_data(entry)
        try:
            return fn((fileobj, size))
        finally:
            fileobj.close()
