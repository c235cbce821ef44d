"""The needle-map factory and the live-set snapshot compaction walks.

The JAX package's ``storage/compact_map.py`` for the ``memory`` and
``disk`` kinds (the volume server's ``-index memory|disk``):
``load_needle_map`` and ``snapshot_live_items``. The ``compact`` (sorted
arrays) and ``sortedfile`` (mmap'd .sdx) kinds are not ported.
"""

from __future__ import annotations

from .needle_map import NeedleMap
from .types import OFFSET_SIZE

NEEDLE_MAP_KINDS = ("memory", "disk")


class SnapshotItems:
    """A live-set snapshot to iterate once: the disk map's cursor over
    a private connection, or a list. ``close`` (or leaving a ``with``)
    releases the cursor's connection when the walk ends early, so its
    WAL snapshot does not block the checkpoints until it is collected."""

    def __init__(self, items):
        self._items = items

    def __iter__(self):
        return iter(self._items)

    def close(self):
        close = getattr(self._items, "close", None)
        self._items = ()
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def snapshot_live_items(nm, by_offset: bool = False) -> SnapshotItems:
    """A consistent copy of the live set (the caller holds the volume
    lock): the disk map flushes, then streams from a pinned snapshot of
    its own connection; the memory map copies. In .dat offset order when
    ``by_offset``."""
    snap = getattr(nm, "items_snapshot", None)
    if snap is not None:
        nm.flush()
        return SnapshotItems(snap(by_offset=by_offset))
    items = list(nm.items())
    if by_offset:
        items.sort(key=lambda kv: kv[1].offset)
    return SnapshotItems(items)


def load_needle_map(idx_path: str, kind: str = "memory",
                    offset_width: int = OFFSET_SIZE):
    """The needle map of ``kind``: ``memory`` replays the .idx into a
    dict, ``disk`` opens (or rebuilds) its sqlite checkpoint and replays
    only the .idx past it."""
    if kind == "disk":
        from .needle_map_disk import DiskNeedleMap
        return DiskNeedleMap.load(idx_path, offset_width)
    if kind == "memory":
        return NeedleMap.load(idx_path, offset_width)
    raise ValueError(f"unknown needle map kind {kind!r} "
                     f"(want one of {list(NEEDLE_MAP_KINDS)})")
