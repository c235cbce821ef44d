"""Volume — one append-only .dat file + .idx index (Haystack store), in
the half an EC encode needs: load an existing volume and freeze it.

The JAX package's ``storage/volume.py`` in these parts: ``VolumeError``,
``NotFound``, ``volume_file_prefix``, and a ``Volume`` opened over an
existing ``.dat``/``.idx`` with its superblock, the torn-tail repair of
``check_integrity`` (which opens the ``.dat`` read-write and may
truncate it and the ``.idx``), ``version``, ``offset_width``,
``file_name()``, the ``readonly`` flag and ``close``. A ``.vif`` whose
``remote`` key parks the volume on a tier keeps it readonly, as in the
JAX package.

Left out, for a later slice: needle writes, reads and deletes, the needle
map, compaction (and the replay of an interrupted compaction commit),
tiering (a volume whose ``.dat`` lives only on a remote backend),
``create=True`` and TTL expiry.
"""

from __future__ import annotations

import json
import os

from .needle import get_actual_size
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .types import (NEEDLE_PADDING_SIZE, TOMBSTONE_FILE_SIZE,
                    bytes_to_entry, entry_size)


class VolumeError(Exception):
    pass


class NotFound(VolumeError):
    pass


def volume_file_prefix(dirname: str, collection: str, vid: int) -> str:
    name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(dirname, name)


def _parked_on_tier(vif_path: str) -> bool:
    """A keep-local tier upload leaves the .dat beside a .vif that names
    its remote copy: the volume serves locally but stays frozen."""
    try:
        with open(vif_path) as f:
            info = json.load(f)
    except (OSError, ValueError):
        return False
    return isinstance(info, dict) and "remote" in info


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int):
        self.dir = dirname
        self.collection = collection or ""
        self.id = vid
        self.readonly = False
        prefix = volume_file_prefix(dirname, self.collection, vid)
        self.dat_path = prefix + ".dat"
        self.idx_path = prefix + ".idx"
        with open(self.dat_path, "rb") as f:
            self.super_block = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        self.dat = open(self.dat_path, "r+b")
        try:
            self.check_integrity()
        except BaseException:
            self.dat.close()
            raise
        if _parked_on_tier(prefix + ".vif"):
            self.readonly = True

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def offset_width(self) -> int:
        """4 (32GB max, reference-compatible) or 5 (8TB volumes);
        carried by the superblock flag byte."""
        return self.super_block.offset_width

    def file_name(self) -> str:
        return volume_file_prefix(self.dir, self.collection, self.id)

    def check_integrity(self):
        """Truncate a torn tail: the .dat must end on an 8-byte boundary
        and cover every .idx entry; trailing garbage after a crash is
        dropped."""
        self.dat.seek(0, os.SEEK_END)
        size = self.dat.tell()
        if size < SUPER_BLOCK_SIZE:
            raise VolumeError(f"volume {self.id}: missing superblock")
        aligned = SUPER_BLOCK_SIZE + (
            (size - SUPER_BLOCK_SIZE) // NEEDLE_PADDING_SIZE
        ) * NEEDLE_PADDING_SIZE
        if aligned != size:
            self.dat.truncate(aligned)
        # drop trailing .idx entries that point past the .dat's end (a
        # crash lost .dat pages but kept .idx pages), and a partial one
        if os.path.exists(self.idx_path):
            rec = entry_size(self.super_block.offset_width)
            idx_size = os.path.getsize(self.idx_path)
            idx_size -= idx_size % rec
            dat_end = self.dat.seek(0, os.SEEK_END)
            version = self.super_block.version
            with open(self.idx_path, "r+b") as f:
                while idx_size >= rec:
                    f.seek(idx_size - rec)
                    _, offset, size = bytes_to_entry(f.read(rec))
                    if size == TOMBSTONE_FILE_SIZE or offset == 0 or \
                            offset + get_actual_size(size, version) \
                            <= dat_end:
                        break
                    idx_size -= rec
                f.truncate(idx_size)

    def close(self):
        self.dat.close()
