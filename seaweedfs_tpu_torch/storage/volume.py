"""Volume — one append-only .dat file and its .idx index (Haystack store).

The JAX package's ``storage/volume.py`` over the same disk formats
(reference weed/storage/volume.go, volume_read_write.go,
volume_loading.go, volume_checking.go, volume_vacuum.go):

* create (``create=True``: a superblock with the replica placement, TTL
  and offset width) or load: the superblock, the torn-tail repair of
  ``check_integrity``, the needle map replayed from the .idx;
* writes append at 8-byte-aligned offsets with a write-through .idx
  entry; an overwrite or a delete must present the stored cookie; a
  delete appends an empty tombstone needle and a tombstone .idx entry;
* reads check the cookie, the CRC and the needle's TTL;
* the counters (``file_count``, ``deleted_count``, ``content_size``,
  ``deleted_size``, ``garbage_level``, ``expired``...);
* the vacuum: ``compact`` (copies the live needles the map lists, the
  reference's Compact2) and ``compact_scan`` (walks the .dat, the
  reference's Compact) into .cpd/.cpx, ``commit_compact`` (replays the
  writes made since the copy began, then swaps the files under a
  ``.commit`` marker that a crash leaves for ``_finish_interrupted_commit``
  to complete at the next load) and ``cleanup_compact``;
* ``configure_replication`` (the superblock's placement byte);
* ``destroy``;
* a tiered volume (``storage/volume_tier``): when the .dat is gone and
  the ``.vif`` has a ``remote`` key, the .dat is a ``backend.RemoteFile``
  (the object's size checked against the .vif's ``file_size``) and every
  read a range request; a local .dat beside such a ``.vif`` (a
  keep-local upload) is served locally. Either way the volume is
  readonly, so the remote copy cannot diverge.

Left out: the native plane's write lease (``fast_writer``), the fsync
knob, and every needle-map kind but ``memory``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..util.throttler import WriteThrottler
from .backend import BackendError, RemoteFile, get_backend
from .compact_map import load_needle_map, snapshot_live_items
from .needle import CorruptNeedle, Needle, get_actual_size
from .super_block import (FLAG_5_BYTE_OFFSETS, SUPER_BLOCK_SIZE, SuperBlock)
from .types import (NEEDLE_HEADER_SIZE, NEEDLE_PADDING_SIZE,
                    TOMBSTONE_FILE_SIZE, TTL, ReplicaPlacement,
                    bytes_to_entry, entry_size, entry_to_bytes,
                    max_volume_size)


class VolumeError(Exception):
    pass


class NotFound(VolumeError):
    pass


def volume_file_prefix(dirname: str, collection: str, vid: int) -> str:
    name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(dirname, name)


def _remote_info(vif_path: str) -> Optional[dict]:
    """The ``remote`` record of a tiered volume's .vif, or None."""
    from .volume_tier import load_volume_info
    info = load_volume_info(vif_path)
    if isinstance(info, dict) and "remote" in info:
        return info["remote"]
    return None


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 replica_placement: Optional[ReplicaPlacement] = None,
                 ttl: Optional[TTL] = None, create: bool = False,
                 version: int = None, offset_width: int = 4):
        self.dir = dirname
        self.collection = collection or ""
        self.id = vid
        self.readonly = False
        self.lock = threading.RLock()
        self.last_modified = 0
        self._compacting = False
        self._compact_idx_watermark = None
        prefix = volume_file_prefix(dirname, self.collection, vid)
        self.dat_path = prefix + ".dat"
        self.idx_path = prefix + ".idx"
        self._finish_interrupted_commit(prefix)
        # the .dat of a tiered volume lives on its backend, but only
        # when the local one is gone: a keep-local upload leaves both,
        # and the local copy is served (below, frozen)
        if not os.path.exists(self.dat_path):
            remote = _remote_info(prefix + ".vif")
            if remote is not None:
                self._open_remote(remote)
                return
        if create and not os.path.exists(self.dat_path):
            os.makedirs(dirname, exist_ok=True)
            sb = SuperBlock(
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or TTL(),
                flags=FLAG_5_BYTE_OFFSETS if offset_width == 5 else 0)
            if version:
                sb.version = version
            with open(self.dat_path, "wb") as f:
                f.write(sb.to_bytes())
            self.super_block = sb
            open(self.idx_path, "ab").close()
        else:
            with open(self.dat_path, "rb") as f:
                self.super_block = SuperBlock.from_bytes(
                    f.read(SUPER_BLOCK_SIZE))
        self.dat = open(self.dat_path, "r+b")
        try:
            self.check_integrity()
            self.nm = load_needle_map(self.idx_path, self.offset_width)
        except BaseException:
            self.dat.close()
            raise
        self.last_modified = int(os.path.getmtime(self.dat_path))
        if not create and _remote_info(prefix + ".vif") is not None:
            self.readonly = True

    def _open_remote(self, remote: dict):
        """Serve the .dat from its tier. A .vif naming an object that is
        unreachable, or whose size is not the recorded ``file_size``
        (truncated or replaced), refuses the load: it would serve short
        reads forever."""
        backend = get_backend(remote["backend"])
        expect = int(remote["file_size"])
        try:
            actual = backend.size(remote["key"])
        except NotImplementedError:
            actual = expect
        except BackendError as e:
            raise VolumeError(
                f"volume {self.id}: remote .dat {remote['key']} "
                f"unreachable: {e}") from None
        if actual != expect:
            raise VolumeError(
                f"volume {self.id}: remote .dat {remote['key']} is "
                f"{actual} bytes but .vif records {expect}; refusing "
                f"to serve a mismatched remote volume")
        self.dat = RemoteFile(backend, remote["key"], expect)
        self.super_block = SuperBlock.from_bytes(
            self.dat.read(SUPER_BLOCK_SIZE))
        self.readonly = True
        self.nm = load_needle_map(self.idx_path, self.offset_width)
        self.last_modified = remote.get("modified_at", 0)

    # -- properties --------------------------------------------------------
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

    def content_size(self) -> int:
        return self.nm.content_size

    def deleted_size(self) -> int:
        return self.nm.deleted_size

    def file_count(self) -> int:
        return self.nm.file_counter

    def deleted_count(self) -> int:
        return self.nm.deletion_counter

    def max_file_key(self) -> int:
        return self.nm.maximum_file_key

    def size(self) -> int:
        with self.lock:
            return self.dat.seek(0, os.SEEK_END)

    def configure_replication(self, rp: ReplicaPlacement) -> None:
        """Rewrite the replica placement in the superblock (byte 1 of the
        .dat, reference VolumeConfigure); the master sees it in the next
        heartbeat. A readonly volume is refused, as every write is."""
        with self.lock:
            if self.readonly:
                raise VolumeError(
                    f"volume {self.id} is read only; cannot reconfigure "
                    f"replication")
            self.super_block.replica_placement = rp
            self.dat.seek(1)
            self.dat.write(bytes([rp.to_byte()]))
            self.dat.flush()

    def garbage_level(self) -> float:
        sz = self.size()
        if sz <= SUPER_BLOCK_SIZE:
            return 0.0
        return self.deleted_size() / sz

    def expired(self, volume_size_limit: int) -> bool:
        """A 0 size limit never expires, nor does an empty volume
        (reference volume.go expired())."""
        if volume_size_limit == 0 or self.content_size() == 0:
            return False
        ttl = self.super_block.ttl
        if ttl.minutes == 0:
            return False
        return time.time() - self.last_modified > ttl.minutes * 60

    # -- integrity (reference volume_checking.go:14) ----------------------
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

    # -- write -------------------------------------------------------------
    def _stored_cookie(self, offset: int) -> int:
        self.dat.seek(offset)
        return Needle.parse_header(self.dat.read(NEEDLE_HEADER_SIZE)).cookie

    def write_needle(self, n: Needle) -> int:
        with self.lock:
            if self.readonly:
                raise VolumeError(f"volume {self.id} is read only")
            self._reject_empty(n)
            # an overwrite must present the stored cookie (cookies stop
            # id guessing; reference volume_read_write.go)
            existing = self.nm.get(n.id)
            if existing is not None and existing.offset != 0 and \
                    existing.size != TOMBSTONE_FILE_SIZE and \
                    self._stored_cookie(existing.offset) != n.cookie:
                raise VolumeError(
                    f"needle {n.id}: mismatching cookie on overwrite")
            # a needle without a TTL takes the volume's, so its expiry
            # fires per needle
            vol_ttl = self.super_block.ttl
            if not n.has_ttl() and vol_ttl.to_uint32():
                n.set_ttl(vol_ttl)
                if not n.has_last_modified():
                    n.set_last_modified()
            if not n.append_at_ns:
                n.append_at_ns = time.time_ns()
            offset = self.dat.seek(0, os.SEEK_END)
            if offset % NEEDLE_PADDING_SIZE:
                offset += NEEDLE_PADDING_SIZE - offset % NEEDLE_PADDING_SIZE
                self.dat.truncate(offset)
            blob = n.to_bytes(self.version)
            # the offset width's ceiling (32GB / 8TB), checked before the
            # append so a write past it never lands unindexed
            if offset + len(blob) > max_volume_size(self.offset_width):
                raise VolumeError(
                    f"volume {self.id}: write at {offset} exceeds the "
                    f"{self.offset_width}-byte-offset ceiling")
            try:
                self.dat.seek(offset)
                self.dat.write(blob)
                self.dat.flush()
            except OSError:
                self.dat.truncate(offset)
                raise
            if n.size > 0 or self.version == 1:
                self.nm.put(n.id, offset, n.size)
            self.last_modified = int(time.time())
            return n.size

    def _reject_empty(self, n: Needle):
        """An empty record is the tombstone format on disk (v2/v3): it
        would never read back, so the write is refused."""
        if len(n.data) == 0 and self.version != 1:
            raise VolumeError(
                f"needle {n.id}: empty data — zero-size records are "
                "tombstones; store empty objects at the filer layer "
                "(an entry with no chunks)")

    def delete_needle(self, n: Needle) -> int:
        """Append a tombstone; returns the freed size (0 if absent)."""
        with self.lock:
            if self.readonly:
                raise VolumeError(f"volume {self.id} is read only")
            nv = self.nm.get(n.id)
            if nv is None or nv.size == TOMBSTONE_FILE_SIZE:
                return 0
            if self._stored_cookie(nv.offset) != n.cookie:
                raise VolumeError(
                    f"needle {n.id}: mismatching cookie on delete")
            freed = nv.size
            tomb = Needle(cookie=n.cookie, id=n.id, data=b"",
                          append_at_ns=time.time_ns())
            self.nm.delete(n.id)
            self.dat.seek(0, os.SEEK_END)
            self.dat.write(tomb.to_bytes(self.version))
            self.dat.flush()
            self.last_modified = int(time.time())
            return freed

    # -- read --------------------------------------------------------------
    def read_needle(self, n: Needle) -> Needle:
        """Read by id (``n`` carries the id and cookie); checks the
        cookie, the CRC and the needle's TTL."""
        with self.lock:
            nv = self.nm.get(n.id)
            if nv is None or nv.offset == 0 or \
                    nv.size == TOMBSTONE_FILE_SIZE:
                raise NotFound(f"needle {n.id} not found in volume {self.id}")
            blob = self._read_blob(nv.offset, nv.size)
        got = Needle.from_bytes(blob, self.version, expected_size=nv.size)
        if got.cookie != n.cookie:
            raise NotFound(
                f"cookie mismatch for needle {n.id} in volume {self.id}")
        if got.has_ttl() and got.ttl.minutes and got.has_last_modified():
            if time.time() - got.last_modified > got.ttl.minutes * 60:
                raise NotFound(f"needle {n.id} expired")
        return got

    def read_needle_flags(self, n: Needle) -> int:
        """The flags byte of a stored needle from two small reads, no
        payload; 0 for v1 needles. NotFound if absent."""
        with self.lock:
            nv = self.nm.get(n.id)
            if nv is None or nv.offset == 0 or \
                    nv.size == TOMBSTONE_FILE_SIZE:
                raise NotFound(
                    f"needle {n.id} not found in volume {self.id}")
            if self.version == 1 or nv.size == 0:
                return 0
            self.dat.seek(nv.offset + NEEDLE_HEADER_SIZE)
            raw = self.dat.read(4)
            if len(raw) < 4:
                return 0
            self.dat.seek(nv.offset + NEEDLE_HEADER_SIZE + 4
                          + int.from_bytes(raw, "big"))
            b = self.dat.read(1)
            return b[0] if b else 0

    def _read_blob(self, offset: int, size: int) -> bytes:
        want = get_actual_size(size, self.version)
        self.dat.seek(offset)
        blob = self.dat.read(want)
        if len(blob) < want:
            raise CorruptNeedle(f"volume {self.id}: short read at {offset} "
                                f"({len(blob)} < {want})")
        return blob

    def scan(self):
        """(needle, offset) for every record of the .dat, in order."""
        with self.lock:
            end = self.size()
            offset = SUPER_BLOCK_SIZE
            while offset + NEEDLE_HEADER_SIZE <= end:
                self.dat.seek(offset)
                n = Needle.parse_header(self.dat.read(NEEDLE_HEADER_SIZE))
                actual = get_actual_size(n.size, self.version)
                self.dat.seek(offset)
                blob = self.dat.read(actual)
                if len(blob) < actual:
                    break
                yield Needle.from_bytes(blob, self.version), offset
                offset += actual

    # -- vacuum (reference volume_vacuum.go) -------------------------------
    def _ttl_clock(self):
        """(ttl_seconds, now) for one vacuum pass."""
        return self.super_block.ttl.minutes * 60, time.time()

    def _blob_expired(self, blob: bytes, ttl_seconds: int,
                      now: float) -> bool:
        """Volume-TTL expiry of one raw record (reference
        volume_vacuum.go:333-335, :426-428), without the payload CRC. A
        record that does not parse is kept, as is one without the TTL
        flag (written before the volume had its TTL)."""
        if not ttl_seconds or self.version == 1:
            return False
        try:
            n = Needle.from_bytes(blob, self.version, verify_crc=False)
        except Exception:  # noqa: BLE001 - a corrupt record is kept
            return False
        return n.has_ttl() and bool(n.last_modified) and \
            now >= n.last_modified + ttl_seconds

    def _begin_compaction(self):
        """Claim the one-compaction guard, bump the superblock's
        revision and take the makeup watermark (caller holds the lock).
        Returns (new superblock, .cpd, .cpx, deleted size)."""
        if self._compacting:
            raise VolumeError(
                f"volume {self.id}: compaction already in progress")
        self._compacting = True
        prefix = self.file_name()
        new_sb = SuperBlock(
            version=self.version,
            replica_placement=self.super_block.replica_placement,
            ttl=self.super_block.ttl,
            compaction_revision=(
                self.super_block.compaction_revision + 1) & 0xFFFF,
            flags=self.super_block.flags)
        self._compact_idx_watermark = os.path.getsize(self.idx_path)
        return (new_sb, prefix + ".cpd", prefix + ".cpx",
                self.nm.deleted_size)

    def _copy_live(self, walk, new_sb, cpd, cpx, bytes_per_second):
        """Write the superblock and every (nid, size, blob) of ``walk``
        that has not expired into .cpd/.cpx; releases the guard."""
        throttler = WriteThrottler(bytes_per_second)
        ttl_seconds, now = self._ttl_clock()
        width = self.offset_width
        try:
            with open(cpd, "wb") as dat_out, open(cpx, "wb") as idx_out:
                dat_out.write(new_sb.to_bytes())
                for nid, size, blob in walk:
                    if self._blob_expired(blob, ttl_seconds, now):
                        continue
                    idx_out.write(entry_to_bytes(nid, dat_out.tell(), size,
                                                 width))
                    dat_out.write(blob)
                    throttler.maybe_slowdown(len(blob))
        finally:
            self._compacting = False

    def compact(self, bytes_per_second: int = 0) -> int:
        """Copy the live needles the map lists to .cpd/.cpx (the
        reference's Compact2); returns the reclaimed-byte estimate. The
        lock is held for the snapshot and for each blob read only: what
        lands after the snapshot is replayed by commit_compact's makeup
        diff. ``bytes_per_second`` > 0 throttles the copy."""
        with self.lock:
            new_sb, cpd, cpx, deleted_size = self._begin_compaction()
            live = snapshot_live_items(self.nm, by_offset=True)

        def walk():
            for nid, nv in live:
                if nv.size == TOMBSTONE_FILE_SIZE or nv.offset == 0:
                    continue
                with self.lock:
                    blob = self._read_blob(nv.offset, nv.size)
                yield nid, nv.size, blob

        self._copy_live(walk(), new_sb, cpd, cpx, bytes_per_second)
        return deleted_size

    def compact_scan(self, bytes_per_second: int = 0) -> int:
        """Scan-based compaction (the reference's Compact,
        volume_vacuum.go:37, :310-352): walk the .dat in order and keep a
        record only where the map shows it live at exactly that offset.
        Same outputs and commit as ``compact``."""
        with self.lock:
            new_sb, cpd, cpx, deleted_size = self._begin_compaction()
            end = self.size()
            live = iter(snapshot_live_items(self.nm, by_offset=True))

        def walk():
            live_nid, live_nv = next(live, (None, None))
            with open(self.dat_path, "rb") as src:
                offset = SUPER_BLOCK_SIZE
                while offset + NEEDLE_HEADER_SIZE <= end:
                    src.seek(offset)
                    n = Needle.parse_header(src.read(NEEDLE_HEADER_SIZE))
                    is_tomb = n.size == TOMBSTONE_FILE_SIZE
                    actual = get_actual_size(0 if is_tomb else n.size,
                                             self.version)
                    if offset + actual > end:
                        break
                    while live_nv is not None and live_nv.offset < offset:
                        live_nid, live_nv = next(live, (None, None))
                    if not is_tomb and n.size > 0 and live_nv is not None \
                            and live_nv.offset == offset and \
                            live_nid == n.id and 0 < live_nv.size \
                            != TOMBSTONE_FILE_SIZE:
                        src.seek(offset)
                        yield n.id, n.size, src.read(actual)
                    offset += actual

        self._copy_live(walk(), new_sb, cpd, cpx, bytes_per_second)
        return deleted_size

    def _finish_interrupted_commit(self, prefix: str):
        """Redo a compaction commit cut short between its renames: the
        ``.commit`` marker exists only while they are pending, so what is
        left of .cpd/.cpx is newer than its .dat/.idx and the renames are
        safe to replay."""
        marker = prefix + ".commit"
        if not os.path.exists(marker):
            return
        for src, dst in ((prefix + ".cpd", self.dat_path),
                         (prefix + ".cpx", self.idx_path)):
            if os.path.exists(src):
                os.replace(src, dst)
        os.remove(marker)

    def commit_compact(self):
        with self.lock:
            prefix = self.file_name()
            cpd, cpx = prefix + ".cpd", prefix + ".cpx"
            if not (os.path.exists(cpd) and os.path.exists(cpx)):
                raise VolumeError("no compaction files to commit")
            self._makeup_diff(cpd, cpx)
            self.dat.close()
            self.nm.close()
            # the marker makes the two renames redo-able: a crash between
            # them would otherwise leave the new .dat with the old .idx
            marker = prefix + ".commit"
            with open(marker, "w") as f:
                f.write("compact-commit")
                f.flush()
                os.fsync(f.fileno())
            # the marker's directory entry is durable before the renames
            dfd = os.open(os.path.dirname(marker) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            os.replace(cpd, self.dat_path)
            os.replace(cpx, self.idx_path)
            os.remove(marker)
            with open(self.dat_path, "rb") as f:
                self.super_block = SuperBlock.from_bytes(
                    f.read(SUPER_BLOCK_SIZE))
            self.dat = open(self.dat_path, "r+b")
            self.nm = load_needle_map(self.idx_path, self.offset_width)

    def _makeup_diff(self, cpd: str, cpx: str):
        """Replay the .idx entries appended since the compaction's
        snapshot onto the compacted files (reference makeupDiff,
        volume_vacuum.go:181)."""
        watermark = self._compact_idx_watermark
        if watermark is None:
            return
        idx_size = os.path.getsize(self.idx_path)
        if idx_size <= watermark:
            return
        width = self.offset_width
        rec = entry_size(width)
        with open(self.idx_path, "rb") as f:
            f.seek(watermark)
            delta = f.read(idx_size - watermark)
        new_off = os.path.getsize(cpd)
        with open(cpd, "ab") as dat_out, open(cpx, "ab") as idx_out:
            for i in range(0, len(delta) - rec + 1, rec):
                nid, offset, size = bytes_to_entry(delta[i:i + rec])
                if size == TOMBSTONE_FILE_SIZE or offset == 0:
                    idx_out.write(
                        entry_to_bytes(nid, 0, TOMBSTONE_FILE_SIZE, width))
                    continue
                blob = self._read_blob(offset, size)
                dat_out.write(blob)
                idx_out.write(entry_to_bytes(nid, new_off, size, width))
                new_off += len(blob)
        self._compact_idx_watermark = None

    def cleanup_compact(self):
        for ext in (".cpd", ".cpx"):
            p = self.file_name() + ext
            if os.path.exists(p):
                os.remove(p)

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        with self.lock:
            self.nm.close()
            self.dat.close()

    def destroy(self):
        self.close()
        exts = [".dat", ".idx", ".cpd", ".cpx"]
        # the .vif is shared with the EC volume: keep it while an .ecx
        # (and so shards) remain, whose parity-only holders need it
        if not os.path.exists(self.file_name() + ".ecx"):
            exts.append(".vif")
        for ext in exts:
            p = self.file_name() + ext
            if os.path.exists(p):
                os.remove(p)
