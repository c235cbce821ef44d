"""The filer's entry model. The JAX package's ``filer/entry.py``: an
``Entry`` is a full path, an ``Attr`` and an ordered list of
``FileChunk``s, stored as JSON (``Entry.encode``: the bytes the stores
hold, equal between the packages); ``entry_to_wire`` /
``entry_from_wire`` are the metadata API's shape, shared by the filer
server and ``FilerClient``."""

from __future__ import annotations

import json
import posixpath
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FileChunk:
    """One stored chunk of a file: its fid on a volume server, where it
    lies in the file, and, for a sealed or gzipped blob, its key and
    flag (``size`` is the plaintext's)."""

    fid: str
    offset: int
    size: int
    mtime: int = 0      # ns; a newer chunk overlays an older one
    etag: str = ""
    cipher_key: bytes = b""
    is_compressed: bool = False

    def to_dict(self) -> dict:
        d = {"fid": self.fid, "offset": self.offset, "size": self.size,
             "mtime": self.mtime}
        if self.etag:
            d["etag"] = self.etag
        if self.cipher_key:
            d["cipherKey"] = self.cipher_key.hex()
        if self.is_compressed:
            d["isCompressed"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(fid=d["fid"], offset=d["offset"], size=d["size"],
                   mtime=d.get("mtime", 0), etag=d.get("etag", ""),
                   cipher_key=bytes.fromhex(d.get("cipherKey", "")),
                   is_compressed=d.get("isCompressed", False))


@dataclass
class Attr:
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    replication: str = ""
    collection: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    md5: str = ""
    symlink_target: str = ""

    @property
    def is_directory(self) -> bool:
        return (self.mode & 0o170000) == 0o040000

    def set_directory(self):
        # setuid, setgid and sticky bits are kept
        self.mode = (self.mode & 0o7777) | 0o040000


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: List[FileChunk] = field(default_factory=list)
    extended: Dict[str, bytes] = field(default_factory=dict)

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    @property
    def name(self) -> str:
        return posixpath.basename(self.full_path)

    @property
    def dir_name(self) -> str:
        return posixpath.dirname(self.full_path) or "/"

    def size(self) -> int:
        from .filechunks import total_size
        return total_size(self.chunks)

    def timestamp(self) -> float:
        return self.attr.crtime if self.is_directory else self.attr.mtime

    def encode(self) -> bytes:
        a = self.attr
        d = {
            "path": self.full_path,
            "attr": {
                "mtime": a.mtime, "crtime": a.crtime, "mode": a.mode,
                "uid": a.uid, "gid": a.gid, "mime": a.mime,
                "replication": a.replication, "collection": a.collection,
                "ttlSec": a.ttl_sec, "userName": a.user_name, "md5": a.md5,
                "symlinkTarget": a.symlink_target,
            },
            "chunks": [c.to_dict() for c in self.chunks],
        }
        if self.extended:
            d["extended"] = {k: v.hex() for k, v in self.extended.items()}
        return json.dumps(d).encode()

    @classmethod
    def decode(cls, full_path: str, data: bytes) -> "Entry":
        d = json.loads(data)
        a = d.get("attr", {})
        attr = Attr(mtime=a.get("mtime", 0.0), crtime=a.get("crtime", 0.0),
                    mode=a.get("mode", 0o660), uid=a.get("uid", 0),
                    gid=a.get("gid", 0), mime=a.get("mime", ""),
                    replication=a.get("replication", ""),
                    collection=a.get("collection", ""),
                    ttl_sec=a.get("ttlSec", 0),
                    user_name=a.get("userName", ""),
                    md5=a.get("md5", ""),
                    symlink_target=a.get("symlinkTarget", ""))
        chunks = [FileChunk.from_dict(c) for c in d.get("chunks", [])]
        extended = {k: bytes.fromhex(v)
                    for k, v in d.get("extended", {}).items()}
        return cls(full_path=full_path, attr=attr, chunks=chunks,
                   extended=extended)


def entry_to_wire(e: Entry) -> dict:
    return {
        "FullPath": e.full_path,
        "Mtime": e.attr.mtime,
        "Crtime": e.attr.crtime,
        "Mode": e.attr.mode,
        "Uid": e.attr.uid,
        "Gid": e.attr.gid,
        "Mime": e.attr.mime,
        "Replication": e.attr.replication,
        "Collection": e.attr.collection,
        "TtlSec": e.attr.ttl_sec,
        "IsDirectory": e.is_directory,
        "Md5": e.attr.md5,
        "UserName": e.attr.user_name,
        "SymlinkTarget": e.attr.symlink_target,
        "chunks": [c.to_dict() for c in e.chunks],
        "extended": {k: v.hex() for k, v in (e.extended or {}).items()},
    }


def entry_from_wire(d: dict) -> Entry:
    attr = Attr(mtime=d.get("Mtime", 0.0), crtime=d.get("Crtime", 0.0),
                mode=d.get("Mode", 0o660), uid=d.get("Uid", 0),
                gid=d.get("Gid", 0), mime=d.get("Mime", ""),
                replication=d.get("Replication", ""),
                collection=d.get("Collection", ""),
                ttl_sec=d.get("TtlSec", 0), md5=d.get("Md5", ""),
                user_name=d.get("UserName", ""),
                symlink_target=d.get("SymlinkTarget", ""))
    if d.get("IsDirectory"):
        attr.set_directory()
    chunks = [FileChunk.from_dict(c) for c in d.get("chunks", [])]
    extended = {k: bytes.fromhex(v)
                for k, v in d.get("extended", {}).items()}
    # lookups normpath their paths: an un-normalized one would be
    # unreachable
    return Entry(full_path=posixpath.normpath(d["FullPath"]),
                 attr=attr, chunks=chunks, extended=extended)


def new_dir_entry(path: str, now: Optional[float] = None) -> Entry:
    now = time.time() if now is None else now
    attr = Attr(mtime=now, crtime=now, mode=0o777)
    attr.set_directory()
    return Entry(full_path=path, attr=attr)
