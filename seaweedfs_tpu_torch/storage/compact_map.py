"""The needle maps of a volume's ``-index`` kind, the factory, and the
live-set snapshot the compaction walks.

The JAX package's ``storage/compact_map.py`` (reference
weed/storage/needle_map/): ``load_needle_map(idx_path, kind)`` for the
four kinds of ``NEEDLE_MAP_KINDS``:

* ``memory``: ``needle_map.NeedleMap``, a dict;
* ``compact``: ``CompactNeedleMap``, three sorted numpy columns (needle
  id, stored offset, size: 16 B a needle) and a dict overflow for recent
  writes, merged down once it grows; lookups are binary searches, and a
  load replays the whole .idx in one vectorized pass;
* ``sortedfile``: ``SortedFileNeedleMap``, the same columns written to a
  ``.sdx`` sidecar and mmap'd, so a read-only or EC-bound volume's index
  lives in the page cache; a ``.sdx.meta`` watermark (the .idx size it
  covers, and the counters) lets a reload skip the replay; deletes
  tombstone the mapped record in place, new writes go to the overflow;
* ``disk``: ``needle_map_disk.DiskNeedleMap``, a sqlite checkpoint.

Each keeps the .idx write-through and the counters of ``NeedleMap``
(events tallied, not live entries), so a ``Volume`` takes any of them. A
volume of 5-byte offsets (17-byte .idx records) gets the dict map unless
``disk`` is asked for: the numpy paths read 16-byte records.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .needle_map import NeedleMap, NeedleValue
from .types import (NEEDLE_ENTRY_SIZE, NEEDLE_PADDING_SIZE, OFFSET_SIZE,
                    TOMBSTONE_FILE_SIZE, entry_to_bytes)

# .idx record layout; "off" is in STORED units (real byte offset / 8,
# reference types/needle_types.go) — converted at the get/put boundary
IDX_DTYPE = np.dtype([("nid", ">u8"), ("off", ">u4"), ("size", ">u4")])
_DELETED = NeedleValue(0, TOMBSTONE_FILE_SIZE)  # overflow tombstone marker


def _replay_idx_vectorized(idx_path: str):
    """One-pass vectorized .idx replay: returns (live_records sorted by
    nid, counters dict). Last event per needle wins; counters match the
    dict map's event-tally semantics exactly:
      deletion_counter = puts - live,  deletion_bytes = put_bytes - live_bytes
    (every non-final put is superseded exactly once; deletes of dead
    needles tally nothing — same as NeedleMap._apply)."""
    counters = {"file_counter": 0, "file_byte_counter": 0,
                "deletion_counter": 0, "deletion_byte_counter": 0,
                "maximum_file_key": 0}
    if not os.path.exists(idx_path) or os.path.getsize(idx_path) == 0:
        return np.empty(0, dtype=IDX_DTYPE), counters
    raw = np.fromfile(idx_path, dtype=np.uint8)
    n = len(raw) // NEEDLE_ENTRY_SIZE
    arr = raw[:n * NEEDLE_ENTRY_SIZE].view(IDX_DTYPE)
    puts = (arr["size"] != TOMBSTONE_FILE_SIZE) & (arr["off"] != 0)
    counters["maximum_file_key"] = int(arr["nid"].max()) if n else 0
    counters["file_counter"] = int(puts.sum())
    counters["file_byte_counter"] = int(arr["size"][puts].sum())
    # last event per nid: first occurrence in the reversed stream
    _, idx_rev = np.unique(arr["nid"][::-1], return_index=True)
    last_idx = n - 1 - idx_rev  # ascending nid order (np.unique sorts)
    live = arr[last_idx][puts[last_idx]]
    counters["deletion_counter"] = \
        counters["file_counter"] - len(live)
    counters["deletion_byte_counter"] = \
        counters["file_byte_counter"] - int(live["size"].sum())
    return live, counters


class _SortedBase:
    """Shared: sorted record array + dict overflow + .idx write-through."""

    MERGE_THRESHOLD = 8192

    def __init__(self, idx_path: Optional[str] = None):
        self._base = np.empty(0, dtype=IDX_DTYPE)
        self._overflow: dict = {}
        self.idx_path = idx_path
        self._idx_file = open(idx_path, "ab") if idx_path else None
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.maximum_file_key = 0

    # -- lookup ------------------------------------------------------------
    def _base_find(self, nid: int) -> int:
        """Index of nid in the sorted base, or -1."""
        base = self._base
        if len(base) == 0:
            return -1
        i = int(np.searchsorted(base["nid"], nid))
        if i < len(base) and int(base["nid"][i]) == nid:
            return i
        return -1

    def get(self, nid: int) -> Optional[NeedleValue]:
        ov = self._overflow.get(nid)
        if ov is not None:
            return None if ov is _DELETED else ov
        i = self._base_find(nid)
        if i < 0:
            return None
        size = int(self._base["size"][i])
        off = int(self._base["off"][i])
        # off == 0 marks an in-place sorted-file tombstone (size kept for
        # deleted-byte accounting); no live needle sits at stored offset 0
        if size == TOMBSTONE_FILE_SIZE or off == 0:
            return None
        return NeedleValue(off * NEEDLE_PADDING_SIZE, size)

    def _live_mask(self) -> np.ndarray:
        return (self._base["size"] != TOMBSTONE_FILE_SIZE) & \
            (self._base["off"] != 0)

    def __contains__(self, nid: int) -> bool:
        return self.get(nid) is not None

    def __len__(self) -> int:
        # live = unshadowed live base entries + live overflow entries
        base_live = int(self._live_mask().sum()) if len(self._base) else 0
        shadowed = sum(1 for nid in self._overflow if self._base_live(nid))
        live_ov = sum(1 for ov in self._overflow.values()
                      if ov is not _DELETED)
        return base_live - shadowed + live_ov

    def _base_live(self, nid: int) -> bool:
        i = self._base_find(nid)
        return i >= 0 and \
            int(self._base["size"][i]) != TOMBSTONE_FILE_SIZE and \
            int(self._base["off"][i]) != 0

    def items(self) -> Iterator[Tuple[int, NeedleValue]]:
        for rec in self._base:
            nid = int(rec["nid"])
            if nid in self._overflow:
                continue
            size = int(rec["size"])
            off = int(rec["off"])
            if size != TOMBSTONE_FILE_SIZE and off != 0:
                yield nid, NeedleValue(off * NEEDLE_PADDING_SIZE, size)
        for nid, ov in self._overflow.items():
            if ov is not _DELETED:
                yield nid, ov

    # -- mutations ---------------------------------------------------------
    def put(self, nid: int, offset: int, size: int):
        old = self.get(nid)
        self.maximum_file_key = max(self.maximum_file_key, nid)
        self.file_counter += 1
        self.file_byte_counter += size
        if old is not None:
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._overflow[nid] = NeedleValue(offset, size)
        self._maybe_merge()
        if self._idx_file is not None:
            self._idx_file.write(entry_to_bytes(nid, offset, size))
            self._idx_file.flush()

    def delete(self, nid: int):
        old = self.get(nid)
        if old is not None:
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
            self._tombstone(nid)
        if self._idx_file is not None:
            self._idx_file.write(entry_to_bytes(nid, 0, TOMBSTONE_FILE_SIZE))
            self._idx_file.flush()

    def _tombstone(self, nid: int):
        self._overflow[nid] = _DELETED
        self._maybe_merge()

    def _maybe_merge(self):
        pass  # CompactNeedleMap folds the overflow down; mmap variant keeps it

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    @property
    def deleted_size(self) -> int:
        return self.deletion_byte_counter

    def sync(self):
        """fdatasync the .idx append log (SW_PLANE_FSYNC_MODE, as
        NeedleMap.sync)."""
        if self._idx_file is not None:
            os.fdatasync(self._idx_file.fileno())

    def close(self):
        if self._idx_file is not None:
            self._idx_file.close()
            self._idx_file = None


class CompactNeedleMap(_SortedBase):
    """Sorted-column map, ~16B/needle steady state."""

    kind = "compact"

    @classmethod
    def load(cls, idx_path: str) -> "CompactNeedleMap":
        nm = cls.__new__(cls)
        _SortedBase.__init__(nm, None)
        live, counters = _replay_idx_vectorized(idx_path)
        nm._base = live
        nm.__dict__.update(counters)
        nm.idx_path = idx_path
        nm._idx_file = open(idx_path, "ab")
        return nm

    def _maybe_merge(self):
        if len(self._overflow) < self.MERGE_THRESHOLD:
            return
        keep = np.ones(len(self._base), dtype=bool)
        if len(self._base):
            keep &= self._live_mask()
            ov_keys = np.fromiter(self._overflow.keys(), dtype=np.uint64,
                                  count=len(self._overflow))
            keep &= ~np.isin(self._base["nid"].astype(np.uint64), ov_keys)
        extra = [(nid, ov.offset // NEEDLE_PADDING_SIZE, ov.size)
                 for nid, ov in self._overflow.items() if ov is not _DELETED]
        merged = np.empty(int(keep.sum()) + len(extra), dtype=IDX_DTYPE)
        merged[:int(keep.sum())] = self._base[keep]
        for j, (nid, off, size) in enumerate(extra):
            merged[int(keep.sum()) + j] = (nid, off, size)
        merged.sort(order="nid")
        self._base = merged
        self._overflow = {}

    @property
    def index_nbytes(self) -> int:
        """Steady-state footprint of the index arrays (diagnostics)."""
        return self._base.nbytes


class SortedFileNeedleMap(_SortedBase):
    """Binary search over an mmap'd .sdx sidecar; RAM = page cache.

    Freshness protocol: a ``.sdx.meta`` sidecar records the .idx byte
    size the .sdx covers plus the counters. On load, if the .idx hasn't
    grown past that watermark the .sdx is mmap'd as-is — no replay, no
    rewrite (the large-readonly-volume fast path). Otherwise one
    vectorized .idx replay regenerates it. Deletes tombstone the mapped
    record in place by zeroing its offset (size stays for deleted-byte
    accounting) and advance the watermark, so a delete-only session
    still reloads without a replay. New writes live in the dict
    overflow and invalidate the meta — the map is meant for
    rarely-written (readonly/EC-bound) volumes. The watermark is the
    .idx bytes this map has applied (the size at load plus its own
    appends): records another writer appended (the native plane, under
    its write lease) are not in the .sdx, so a file grown past that
    drops the meta and the next load replays.
    """

    kind = "sortedfile"

    @classmethod
    def load(cls, idx_path: str) -> "SortedFileNeedleMap":
        nm = cls.__new__(cls)
        _SortedBase.__init__(nm, None)
        sdx_path = os.path.splitext(idx_path)[0] + ".sdx"
        meta_path = sdx_path + ".meta"
        nm.idx_path = idx_path
        nm.sdx_path = sdx_path
        nm.meta_path = meta_path
        idx_size = os.path.getsize(idx_path) \
            if os.path.exists(idx_path) else 0
        meta = None
        if os.path.exists(meta_path) and os.path.exists(sdx_path):
            try:
                with open(meta_path) as f:
                    candidate = json.load(f)
                if candidate.get("idx_size") == idx_size:
                    meta = candidate
            except (ValueError, OSError):
                meta = None
        if meta is not None:  # fast path: mmap the existing sidecar
            for k in ("file_counter", "file_byte_counter",
                      "deletion_counter", "deletion_byte_counter",
                      "maximum_file_key"):
                setattr(nm, k, int(meta.get(k, 0)))
        else:
            live, counters = _replay_idx_vectorized(idx_path)
            nm.__dict__.update(counters)
            live.tofile(sdx_path)
        if os.path.getsize(sdx_path) if os.path.exists(sdx_path) else 0:
            nm._base = np.memmap(sdx_path, dtype=IDX_DTYPE, mode="r+")
        else:
            nm._base = np.empty(0, dtype=IDX_DTYPE)
        nm._idx_file = open(idx_path, "ab")
        nm._idx_applied = idx_size
        nm._save_meta()
        return nm

    def put(self, nid: int, offset: int, size: int):
        super().put(nid, offset, size)
        self._idx_applied += NEEDLE_ENTRY_SIZE

    def _save_meta(self):
        """Valid only while every mutation since is reflected in the
        .sdx itself (i.e. the overflow is empty) and the .idx holds no
        record this map did not apply."""
        self._idx_file.flush()
        if self._overflow or \
                os.path.getsize(self.idx_path) != self._idx_applied:
            if os.path.exists(self.meta_path):
                os.remove(self.meta_path)
            return
        if isinstance(self._base, np.memmap):
            # the watermark asserts the .sdx covers the .idx — in-place
            # tombstones must be durable BEFORE the meta says so, or a
            # crash resurrects the needle on the no-replay fast path
            self._base.flush()
        state = {"idx_size": self._idx_applied,
                 "file_counter": self.file_counter,
                 "file_byte_counter": self.file_byte_counter,
                 "deletion_counter": self.deletion_counter,
                 "deletion_byte_counter": self.deletion_byte_counter,
                 "maximum_file_key": self.maximum_file_key}
        with open(self.meta_path, "w") as f:
            json.dump(state, f)

    def _tombstone(self, nid: int):
        i = self._base_find(nid)
        if i >= 0 and isinstance(self._base, np.memmap):
            self._base["off"][i] = 0  # in-place on disk; size kept
            self._overflow.pop(nid, None)
        else:
            self._overflow[nid] = _DELETED

    def delete(self, nid: int):
        super().delete(nid)
        self._idx_applied += NEEDLE_ENTRY_SIZE
        self._save_meta()  # advance the watermark past the tombstone

    def close(self):
        if isinstance(self._base, np.memmap):
            self._base.flush()
        if self._idx_file is not None:
            self._save_meta()
        super().close()


NEEDLE_MAP_KINDS = ("memory", "compact", "sortedfile", "disk")


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
    dict, ``compact`` into sorted columns, ``sortedfile`` maps its .sdx
    (replaying the .idx only when the watermark is behind), ``disk``
    opens (or rebuilds) its sqlite checkpoint and replays only the .idx
    past it. A 5-byte-offset volume gets the dict map unless ``disk`` is
    asked for."""
    if kind == "disk":
        from .needle_map_disk import DiskNeedleMap
        return DiskNeedleMap.load(idx_path, offset_width)
    if offset_width != OFFSET_SIZE or kind == "memory":
        return NeedleMap.load(idx_path, offset_width)
    if kind == "compact":
        return CompactNeedleMap.load(idx_path)
    if kind == "sortedfile":
        return SortedFileNeedleMap.load(idx_path)
    raise ValueError(f"unknown needle map kind {kind!r} "
                     f"(want one of {list(NEEDLE_MAP_KINDS)})")
