"""Offline volume tools: backup, export, fix, compact, see_idx, see_dat.

The JAX package's ``command/volume_tools.py`` (reference
weed/command/{backup,export,fix,compact}.go and the unmaintained
see_idx/see_dat dumps): ``backup`` keeps an incremental local copy of a
live volume (a full pull on the first run or after the source was
compacted, the raw record tail after that); ``export`` lists the live
needles and can write them to a tar; ``fix`` rebuilds the .idx from a
scan of the .dat; ``compact`` vacuums a local volume in place;
``see_idx`` and ``see_dat`` print an index's entries and a .dat's
records. Outputs and files are the JAX package's.

    python3 -m seaweedfs_tpu_torch.command.volume_tools backup
        -volumeId N [-server MASTER] [-dir D] [-collection C]
    python3 -m seaweedfs_tpu_torch.command.volume_tools export
        -volumeId N [-dir D] [-collection C] [-o out.tar]
    python3 -m seaweedfs_tpu_torch.command.volume_tools fix
        -volumeId N [-dir D] [-collection C]
    python3 -m seaweedfs_tpu_torch.command.volume_tools compact
        -volumeId N [-dir D] [-collection C] [-method 0|1]
    python3 -m seaweedfs_tpu_torch.command.volume_tools see_idx FILE
        [-offsetWidth 4|5] [-limit N]
    python3 -m seaweedfs_tpu_torch.command.volume_tools see_dat FILE
        [-limit N]

The flags are those of the JAX ``cli.py`` subcommands (its ``see`` is
split here by the kind of file); the CLI's ``backup``, ``export``,
``fix``, ``compact`` and ``see`` print what these print.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tarfile
from typing import Optional

from ..client import operation as op
from ..server.http_util import get_json, http_call, pull_file
from ..storage import volume_backup
from ..storage.compact_map import snapshot_live_items
from ..storage.needle import Needle
from ..storage.needle_map import walk_index_file
from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from ..storage.types import TOMBSTONE_FILE_SIZE
from ..storage.volume import Volume, VolumeError, volume_file_prefix

TAIL_PAGE_BYTES = volume_backup.DEFAULT_TAIL_PAGE_BYTES


def backup_volume(master_url: str, vid: int, dirname: str,
                  collection: str = "") -> dict:
    """Pull, or bring up to date, a local copy of volume ``vid`` from
    the first server the master lists; {volume, mode, applied, size}."""
    locations = op.lookup(master_url, vid)
    if not locations:
        raise VolumeError(f"volume {vid} has no locations")
    src = locations[0]
    status = get_json(f"http://{src}/admin/volume/sync_status?volume={vid}")
    prefix = volume_file_prefix(dirname, collection, vid)
    dat_path, idx_path = prefix + ".dat", prefix + ".idx"
    os.makedirs(dirname, exist_ok=True)

    mode = "full"
    if os.path.exists(dat_path) and os.path.exists(idx_path):
        local = Volume(dirname, collection, vid)
        try:
            if local.super_block.compaction_revision == \
                    status["compact_revision"] and \
                    local.size() <= status["tail_offset"]:
                mode = "incremental"
                applied = 0
                since = volume_backup.last_append_at_ns(local)
                while True:            # record-aligned pages until dry
                    blob = http_call(
                        "GET",
                        f"http://{src}/admin/volume/tail?volume={vid}"
                        f"&since_ns={since}"
                        f"&max_bytes={TAIL_PAGE_BYTES}")
                    got, new_since = volume_backup.append_raw_records(
                        local, blob, since)
                    applied += got
                    # done when the cursor stops: a record-aligned page
                    # is almost never exactly TAIL_PAGE_BYTES long
                    if not blob or new_since == since:
                        break
                    since = new_since
                return {"volume": vid, "mode": mode, "applied": applied,
                        "size": local.size()}
        finally:
            local.close()

    # the source was compacted (or there is no copy yet): resync in full
    pull_file(src, os.path.basename(dat_path), dat_path)
    volume_backup.rebuild_index(dat_path, idx_path)
    local = Volume(dirname, collection, vid)
    try:
        return {"volume": vid, "mode": mode,
                "applied": local.file_count(), "size": local.size()}
    finally:
        local.close()


def export_volume(dirname: str, vid: int, collection: str = "",
                  tar_path: Optional[str] = None) -> list:
    """The live needles as [(fid, name, size)], in .dat order; with
    ``tar_path``, also a tar whose members carry the needles' names (the
    fid where a needle has none)."""
    v = Volume(dirname, collection, vid)
    listed = []
    tar = tarfile.open(tar_path, "w") if tar_path else None
    try:
        for nid, nv in snapshot_live_items(v.nm, by_offset=True):
            if nv.size == TOMBSTONE_FILE_SIZE or nv.offset == 0:
                continue
            blob = v._read_blob(nv.offset, nv.size)
            n = Needle.from_bytes(blob, v.version, expected_size=nv.size)
            fid = f"{vid},{n.fid_suffix()}"
            name = n.name.decode("utf-8", "replace") if n.has_name() \
                else fid.replace(",", "_")
            listed.append((fid, name, len(n.data)))
            if tar is not None:
                info = tarfile.TarInfo(name=name)
                info.size = len(n.data)
                if n.has_last_modified():
                    info.mtime = n.last_modified
                tar.addfile(info, io.BytesIO(n.data))
    finally:
        if tar is not None:
            tar.close()
        v.close()
    return listed


def fix_volume(dirname: str, vid: int, collection: str = "") -> int:
    """Rebuild the .idx from the .dat; the records walked."""
    prefix = volume_file_prefix(dirname, collection, vid)
    return volume_backup.rebuild_index(prefix + ".dat", prefix + ".idx")


def compact_volume(dirname: str, vid: int, collection: str = "",
                   method: int = 1) -> dict:
    """Vacuum a local volume in place: method 0 walks the .dat
    (``Volume.compact_scan``, reference Compact), method 1 copies by the
    index (``Volume.compact``, reference Compact2, the live vacuum's)."""
    v = Volume(dirname, collection, vid)
    try:
        before = v.size()
        if method == 0:
            v.compact_scan()
        else:
            v.compact()
        v.commit_compact()
        return {"volume": vid, "before": before, "after": v.size(),
                "method": method}
    finally:
        v.close()


def see_idx(idx_path: str, offset_width: int = 4, out=None,
            limit: int = 0) -> int:
    """Print each .idx entry as ``key offset size``; the entries
    printed."""
    out = out or sys.stdout
    count = 0
    for nid, offset, size in walk_index_file(idx_path, offset_width):
        print(f"key {nid} offset {offset} size {size}"
              + (" (tombstone)" if size == TOMBSTONE_FILE_SIZE else ""),
              file=out)
        count += 1
        if limit and count >= limit:
            break
    return count


def see_dat(dat_path: str, out=None, limit: int = 0) -> int:
    """Print the superblock and each record of a .dat (offset, id,
    cookie, size, name, mime; a size-0 record is a delete's tombstone),
    and a torn record at the tail; the records printed."""
    out = out or sys.stdout
    count = 0
    with open(dat_path, "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        print(f"superblock: version {sb.version} replication "
              f"{sb.replica_placement} ttl {sb.ttl} "
              f"compact_revision {sb.compaction_revision}", file=out)
        end = f.seek(0, 2)

        def pread(offset, size):
            f.seek(offset)
            return f.read(size)

        tail = SUPER_BLOCK_SIZE  # where the walk stopped
        for n, pos, total in volume_backup.walk_records(
                pread, sb.version, SUPER_BLOCK_SIZE, end):
            tail = pos + total
            try:
                full = Needle.from_bytes(pread(pos, total), sb.version,
                                         expected_size=n.size)
                name = full.name.decode("utf-8", "replace") \
                    if full.has_name() else ""
                mime = full.mime.decode("utf-8", "replace") \
                    if full.has_mime() else ""
            except Exception:  # noqa: BLE001 - a torn or corrupt record
                name = mime = ""
            print(f"offset {pos} id {n.id} cookie {n.cookie:08x} "
                  f"size {n.size}"
                  + (f" name {name!r}" if name else "")
                  + (f" mime {mime}" if mime else "")
                  + (" DELETED" if n.size == 0 else ""), file=out)
            count += 1
            if limit and count >= limit:
                break
        else:
            # a whole header with a short body at the tail: a torn append
            if end - tail >= 16:
                t = Needle.parse_header(pread(tail, 16))
                print(f"offset {tail} id {t.id} cookie "
                      f"{t.cookie:08x} size {t.size} TORN "
                      f"({end - tail} bytes of record present)",
                      file=out)
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m seaweedfs_tpu_torch.command.volume_tools",
        description="Offline tools over a volume's .dat and .idx.")
    sub = ap.add_subparsers(dest="command", required=True)

    def volume_flags(p):
        p.add_argument("-dir", default=".")
        p.add_argument("-volumeId", type=int, required=True)
        p.add_argument("-collection", default="")

    bk = sub.add_parser("backup",
                        help="incremental local copy of a live volume")
    bk.add_argument("-server", default="127.0.0.1:9333",
                    help="master url")
    volume_flags(bk)
    ex = sub.add_parser("export", help="export volume needles to tar")
    volume_flags(ex)
    ex.add_argument("-o", default="", help="tar output path")
    fx = sub.add_parser("fix", help="rebuild .idx from .dat")
    volume_flags(fx)
    cp = sub.add_parser("compact", help="force-vacuum a local volume")
    volume_flags(cp)
    cp.add_argument("-method", type=int, default=1, choices=[0, 1],
                    help="0 = scan the .dat (reference Compact), "
                         "1 = copy by the index (reference Compact2)")
    si = sub.add_parser("see_idx", help="dump a .idx's entries")
    si.add_argument("file", help="path to a .idx (or .ecx) file")
    si.add_argument("-offsetWidth", type=int, default=4, choices=[4, 5],
                    help="idx entry offset width")
    si.add_argument("-limit", type=int, default=0,
                    help="stop after N records (0 = all)")
    sd = sub.add_parser("see_dat", help="dump a .dat's records")
    sd.add_argument("file", help="path to a .dat file")
    sd.add_argument("-limit", type=int, default=0,
                    help="stop after N records (0 = all)")
    args = ap.parse_args(argv)
    from . import cli
    if args.command in ("see_idx", "see_dat"):
        # ``see`` tells the two apart by the file's name
        if args.command == "see_idx":
            n = see_idx(args.file, offset_width=args.offsetWidth,
                        limit=args.limit)
            print(f"{n} index records")
        else:
            n = see_dat(args.file, limit=args.limit)
            print(f"{n} needles")
    else:
        getattr(cli, "cmd_" + args.command)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
