"""Large files as chunk needles and a chunk manifest.

The JAX package's ``client/chunked.py`` (reference
weed/operation/submit.go:114-230 and chunked_file.go): ``submit_chunked``
splits a file into chunk needles, each on a fid of its own (possibly on
many volumes), and stores a manifest needle, flagged
``FLAG_IS_CHUNK_MANIFEST`` by the volume server's ``?cm=true``, whose
fid is the file's. A GET of the manifest's fid is answered with the file
(or the Range of it asked for) by the volume server; ``?cm=false`` gets
the manifest itself; a DELETE of it deletes the chunks first.

The manifest, the flagged needle's payload:

    {"name": ..., "mime": ..., "size": N,
     "chunks": [{"fid": ..., "offset": N, "size": N}, ...]}
"""

from __future__ import annotations

import json
from typing import List, Optional

from ..server.http_util import HttpError, http_call, post_multipart
from ..storage.types import parse_file_id
from . import operation as op


class ChunkInfo:
    __slots__ = ("fid", "offset", "size")

    def __init__(self, fid: str, offset: int, size: int):
        self.fid = fid
        self.offset = offset
        self.size = size


class ChunkManifest:
    def __init__(self, name: str = "", mime: str = "", size: int = 0,
                 chunks: Optional[List[ChunkInfo]] = None):
        self.name = name
        self.mime = mime
        self.size = size
        self.chunks = chunks or []

    def to_json(self) -> bytes:
        return json.dumps({
            "name": self.name, "mime": self.mime, "size": self.size,
            "chunks": [{"fid": c.fid, "offset": c.offset, "size": c.size}
                       for c in self.chunks]}).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "ChunkManifest":
        d = json.loads(blob.decode())
        return cls(d.get("name", ""), d.get("mime", ""),
                   int(d.get("size", 0)),
                   [ChunkInfo(c["fid"], int(c["offset"]), int(c["size"]))
                    for c in d.get("chunks", [])])


def submit_chunked(master_url: str, data: bytes, filename: str = "",
                   collection: str = "", replication: str = "",
                   ttl: str = "", chunk_size: int = 32 << 20,
                   content_type: str = "") -> str:
    """Store ``data`` as chunks of ``chunk_size`` and a manifest; returns
    the manifest's fid. The chunks stored before a failure are deleted
    before it propagates."""
    manifest = ChunkManifest(name=filename, mime=content_type,
                             size=len(data))
    uploaded: List[str] = []
    try:
        for off in range(0, len(data), chunk_size) or [0]:
            piece = data[off:off + chunk_size]
            a = op.assign(master_url, collection=collection,
                          replication=replication, ttl=ttl)
            op.upload(a["url"], a["fid"], piece,
                      filename=f"{filename}_chunk_{off}",
                      content_type="application/octet-stream",
                      ttl=ttl, jwt=a.get("auth", ""))
            uploaded.append(a["fid"])
            manifest.chunks.append(ChunkInfo(a["fid"], off, len(piece)))
        main = op.assign(master_url, collection=collection,
                         replication=replication, ttl=ttl)
        target = f"http://{main['url']}/{main['fid']}?cm=true"
        if ttl:
            target += f"&ttl={ttl}"
        headers = {"Authorization": f"Bearer {main['auth']}"} \
            if main.get("auth") else None
        post_multipart(target, filename or "manifest", manifest.to_json(),
                       "application/json", headers=headers)
        return main["fid"]
    except BaseException:
        for fid in uploaded:
            try:
                op.delete_file(master_url, fid)
            except (HttpError, OSError):
                pass    # best effort: the upload's failure is the news
        raise


def read_chunked_file(master_url: str, fid: str,
                      cache: Optional[op.VidCache] = None) -> bytes:
    """The file a manifest fid lists, put together on the client (the
    volume server does it too on a plain GET)."""
    manifest = ChunkManifest.from_json(_raw_read(master_url, fid, cache))
    out = bytearray(manifest.size)
    for c in manifest.chunks:
        piece = op.read_file(master_url, c.fid, cache=cache)
        out[c.offset:c.offset + len(piece)] = piece
    return bytes(out)


def _raw_read(master_url: str, fid: str, cache=None) -> bytes:
    """The manifest needle itself (``?cm=false``)."""
    vid, _, _ = parse_file_id(fid)
    urls = cache.lookup(vid) if cache else op.lookup(master_url, vid)
    last: Optional[Exception] = None
    for u in urls:
        try:
            return http_call("GET", f"http://{u}/{fid}?cm=false")
        except HttpError as e:
            last = e
    raise last or HttpError(404, f"no locations for {fid}")
