"""EcVolume / EcVolumeShard — runtime EC shard access on a volume server.

Reference ec_volume.go / ec_shard.go / ec_volume_delete.go:
  * EcVolume opens .ecx (sorted index), .ecj (delete journal), .vif
    (volume info; JSON here, protobuf in the reference)
  * needle lookup is a binary search directly on the .ecx file
  * delete = tombstone the .ecx record in place + append the id to .ecj;
    rebuild_ecx_file replays the journal and removes it
  * reads resolve (offset,size) -> intervals (locate.py) -> local shard
    ReadAt, else the caller's remote fetch, else reconstruction (a
    DegradedReadEngine's ``read``)

A copy of the JAX package's ec/ec_volume.py; the volume server's shard
location bookkeeping stays with the server.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..storage.needle import get_actual_size
from ..storage.types import (NEEDLE_ENTRY_SIZE, TOMBSTONE_FILE_SIZE,
                             bytes_to_entry, entry_size, needle_id_to_bytes)
from .constants import (DATA_SHARDS, LARGE_BLOCK_SIZE,
                        SMALL_BLOCK_SIZE, TOTAL_SHARDS, to_ext)
from .locate import Interval, locate_data


class EcShardNotFound(Exception):
    pass


def search_needle_from_sorted_index(f, file_size: int, needle_id: int,
                                    on_found: Optional[Callable] = None,
                                    offset_width: int = 4
                                    ) -> Tuple[int, int]:
    """Binary search a sorted fixed-record index stream (16B records for
    4-byte offsets, 17B for 5-byte) for needle_id. Returns
    (offset, size); on_found(file, record_pos, record_size) runs before
    return (the delete path passes the tombstoning writer). Raises
    KeyError."""
    rec_size = entry_size(offset_width)
    lo, hi = 0, file_size // rec_size - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        f.seek(mid * rec_size)
        rec_id, offset, size = bytes_to_entry(f.read(rec_size))
        if rec_id == needle_id:
            if on_found is not None:
                on_found(f, mid * rec_size, rec_size)
            return offset, size
        if rec_id < needle_id:
            lo = mid + 1
        else:
            hi = mid - 1
    raise KeyError(needle_id)


def mark_needle_deleted(f, record_pos: int,
                        record_size: int = NEEDLE_ENTRY_SIZE):
    """Overwrite the Size field of the record at record_pos with the
    tombstone value (reference MarkNeedleDeleted)."""
    f.seek(record_pos + record_size - 4)  # size is the trailing 4 bytes
    f.write(struct.pack(">I", TOMBSTONE_FILE_SIZE))
    f.flush()


def ec_offset_width(base_name: str, default: int = 4) -> int:
    """The volume's index offset width, preferring the .vif sidecar
    over the .ec00 superblock. The streaming rebuilder often has NO
    local .ec00 (it pulls survivor ranges, not whole shards), so the
    .vif — which fetch_index_files copies over — must win."""
    vif = base_name + ".vif"
    if os.path.exists(vif):
        try:
            with open(vif) as f:
                width = json.load(f).get("offset_width")
            if width:
                return int(width)
        except (ValueError, OSError):
            pass
    try:
        from .decoder import read_ec_volume_superblock
        return read_ec_volume_superblock(base_name).offset_width
    except Exception:  # noqa: BLE001 - no .ec00 either
        return default


def rebuild_ecx_file(base_name: str, offset_width: int = 4):
    """Replay .ecj tombstones into .ecx, then remove the journal."""
    ecj = base_name + ".ecj"
    if not os.path.exists(ecj):
        return
    ecx_size = os.path.getsize(base_name + ".ecx")
    with open(base_name + ".ecx", "r+b") as ecx_f, open(ecj, "rb") as ecj_f:
        while True:
            rec = ecj_f.read(8)
            if len(rec) < 8:
                break
            nid = int.from_bytes(rec, "big")
            try:
                search_needle_from_sorted_index(
                    ecx_f, ecx_size, nid, mark_needle_deleted,
                    offset_width)
            except KeyError:
                pass
    os.remove(ecj)


class EcVolumeShard:
    """One .ecNN file, read-only random access."""

    def __init__(self, base_name: str, vid: int, shard_id: int,
                 collection: str = ""):
        self.base_name = base_name
        self.vid = vid
        self.shard_id = shard_id
        self.collection = collection
        self.path = base_name + to_ext(shard_id)
        self.f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def read_at(self, offset: int, length: int) -> bytes:
        # one positioned read: a holder serves concurrent ranges of one
        # shard from its handler threads, and a shared seek would race
        return os.pread(self.f.fileno(), length, offset)

    def close(self):
        self.f.close()

    def destroy(self):
        self.close()
        os.remove(self.path)


class EcVolume:
    """Mounted EC volume: local shards + the sorted index + journal.
    ``shard_size`` sizes the volume's needle layout when no shard file is
    local (every survivor on a holder): the size its holders report."""

    def __init__(self, dirname: str, collection: str, vid: int,
                 shard_size: Optional[int] = None):
        self.dir = dirname
        self.shard_size = shard_size
        self.collection = collection or ""
        self.vid = vid
        name = f"{self.collection}_{vid}" if self.collection else str(vid)
        self.base_name = os.path.join(dirname, name)
        if not os.path.exists(self.base_name + ".ecx"):
            raise EcShardNotFound(f"missing {self.base_name}.ecx")
        self.ecx_file = open(self.base_name + ".ecx", "r+b")
        self.ecx_size = os.path.getsize(self.base_name + ".ecx")
        # one seekable handle shared by lookups and in-place tombstoning —
        # every seek+read/write pair must hold this lock
        self.ecx_lock = threading.Lock()
        self.ecj_file = open(self.base_name + ".ecj", "a+b")
        self.ecj_lock = threading.Lock()
        self.shards: Dict[int, EcVolumeShard] = {}
        self.version = None
        self.offset_width = None
        vif = self.base_name + ".vif"
        if os.path.exists(vif):
            try:
                with open(vif) as f:
                    info = json.load(f)
                self.version = info.get("version")
                self.offset_width = info.get("offset_width")
            except (ValueError, OSError):
                pass
        if self.version is None or self.offset_width is None:
            # no .vif: the real version+flags sit in the volume superblock,
            # which rides verbatim at the start of .ec00 (data shards hold
            # the original bytes)
            try:
                from .decoder import read_ec_volume_superblock
                sb = read_ec_volume_superblock(self.base_name)
                self.version = self.version or sb.version
                self.offset_width = self.offset_width or sb.offset_width
            except Exception:
                # last resort: defaults. Loud, not silent — a wrong
                # offset width misparses every .ecx record on this
                # holder (5B volumes), and the operator needs to know
                # to restore the .vif (ec.rebuild from a holder that
                # has it, or recreate it by hand)
                defaulted = [f for f, val in
                             (("version", self.version),
                              ("offset_width", self.offset_width))
                             if val is None]
                self.version = self.version or 3
                self.offset_width = self.offset_width or 4
                logging.getLogger(__name__).warning(
                    "ec volume %s: no usable .vif and no local data "
                    "shard; DEFAULTED %s (now version=%s "
                    "offset_width=%s) — wrong for 5-byte-offset "
                    "volumes; restore %s.vif",
                    self.base_name, ",".join(defaulted), self.version,
                    self.offset_width, self.base_name)

    # -- shard management --------------------------------------------------
    def add_shard(self, shard_id: int) -> bool:
        if shard_id in self.shards:
            return False
        self.shards[shard_id] = EcVolumeShard(
            self.base_name, self.vid, shard_id, self.collection)
        return True

    def delete_shard(self, shard_id: int) -> Optional[EcVolumeShard]:
        return self.shards.pop(shard_id, None)

    def shard_ids(self) -> List[int]:
        return sorted(self.shards)

    # -- needle lookup -----------------------------------------------------
    def locate_needle(self, needle_id: int) -> Tuple[int, int, List[Interval]]:
        """-> (dat offset, size, intervals). KeyError if absent or deleted."""
        with self.ecx_lock:
            offset, size = search_needle_from_sorted_index(
                self.ecx_file, self.ecx_size, needle_id,
                offset_width=self.offset_width)
        if size == TOMBSTONE_FILE_SIZE:
            raise KeyError(needle_id)
        dat_size = self._dat_size_hint()
        intervals = locate_data(LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, dat_size,
                                offset, get_actual_size(size, self.version))
        return offset, size, intervals

    def _dat_size_hint(self) -> int:
        """Derive a row-accurate .dat size from a shard file size.

        shard = n_large*large + n_small*small with n_small >= 1 whenever the
        volume is non-empty (the encoder's strict `>` loop turns an exact
        final large row into small rows), so a shard size that's an exact
        multiple of the large block still means the last large-block's worth
        is small rows — the reference's +10*small fudge misreads exactly
        this case (see locate.py module docstring)."""
        shard_size = None
        for s in self.shards.values():
            shard_size = s.size
            break
        if shard_size is None:
            for i in range(TOTAL_SHARDS):
                p = self.base_name + to_ext(i)
                if os.path.exists(p):
                    shard_size = os.path.getsize(p)
                    break
        if shard_size is None:
            shard_size = self.shard_size
        if shard_size is None:
            raise EcShardNotFound(f"no local shards for volume {self.vid}")
        n_large = shard_size // LARGE_BLOCK_SIZE
        if n_large > 0 and shard_size % LARGE_BLOCK_SIZE == 0:
            n_large -= 1
        return n_large * LARGE_BLOCK_SIZE * DATA_SHARDS + \
            (shard_size - n_large * LARGE_BLOCK_SIZE) * DATA_SHARDS

    # -- reads -------------------------------------------------------------
    def read_interval(self, interval: Interval,
                      remote_fetch: Optional[Callable] = None,
                      reconstruct_fetch: Optional[Callable] = None) -> bytes:
        """Read one interval: local shard, else remote_fetch(shard_id,
        offset, size), else reconstruction via reconstruct_fetch."""
        shard_id, off = interval.to_shard_id_and_offset(
            LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)
        shard = self.shards.get(shard_id)
        if shard is not None:
            return shard.read_at(off, interval.size)
        if remote_fetch is not None:
            data = remote_fetch(self.vid, shard_id, off, interval.size)
            if data is not None:
                return data
        if reconstruct_fetch is not None:
            return reconstruct_fetch(self.vid, shard_id, off, interval.size)
        raise EcShardNotFound(
            f"shard {shard_id} of volume {self.vid} unavailable")

    def read_needle_blob(self, needle_id: int, remote_fetch=None,
                         reconstruct_fetch=None) -> bytes:
        _, size, intervals = self.locate_needle(needle_id)
        parts = [self.read_interval(iv, remote_fetch, reconstruct_fetch)
                 for iv in intervals]
        return b"".join(parts)

    # -- delete ------------------------------------------------------------
    def delete_needle(self, needle_id: int) -> bool:
        """Tombstone in .ecx + journal to .ecj. False if not found."""
        try:
            with self.ecx_lock:
                search_needle_from_sorted_index(
                    self.ecx_file, self.ecx_size, needle_id,
                    mark_needle_deleted, self.offset_width)
        except KeyError:
            return False
        with self.ecj_lock:
            if not os.path.exists(self.base_name + ".ecj"):
                # a rebuild folded the journal into the .ecx and removed
                # it: journal into a new one, not the unlinked file
                self.ecj_file.close()
                self.ecj_file = open(self.base_name + ".ecj", "a+b")
            self.ecj_file.seek(0, os.SEEK_END)
            self.ecj_file.write(needle_id_to_bytes(needle_id))
            self.ecj_file.flush()
        return True

    def write_vif(self, version: int = None):
        # merge-write: the .vif also carries the EC layout keys
        # (ec_layout/ec_window/ec_pairs, ec/layout.py) which a version
        # bump must not erase
        info = {}
        try:
            with open(self.base_name + ".vif") as f:
                info = json.load(f) or {}
        except (OSError, ValueError):
            pass
        info["version"] = version or self.version
        info["offset_width"] = self.offset_width or 4
        with open(self.base_name + ".vif", "w") as f:
            json.dump(info, f)

    def close(self):
        self.ecx_file.close()
        self.ecj_file.close()
        for s in self.shards.values():
            s.close()

    def destroy(self):
        self.close()
        for ext in (".ecx", ".ecj", ".vif", ".scrub"):
            p = self.base_name + ext
            if os.path.exists(p):
                os.remove(p)
        for i in range(TOTAL_SHARDS):
            p = self.base_name + to_ext(i)
            if os.path.exists(p):
                os.remove(p)
