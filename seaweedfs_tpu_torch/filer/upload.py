"""The chunked upload of the filer and the S3 gateway. The JAX
package's ``filer/upload.py``: the data is cut into ``chunk_size``
pieces; each is gzipped first where that pays (``compress=True`` and a
compressible name or type), sealed under a fresh key with
``cipher=True``, then assigned a fid and uploaded. A chunk's ``size``
is always the plaintext's.

An upload goes to the holder's native plane (``fastUrl`` of the assign)
when it has one; a failure of the plane alone retries the holder's
Python URL. A volume that refuses the write between the assign and the
upload (frozen by maintenance, unrouted, a dead replica) is assigned
around, after a back-off scaled by ``config.retry_backoff_s``."""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional, Tuple

from ..client import operation
from ..server.http_util import HttpError, http_call
from ..util import config
from ..util.cipher import encrypt
from ..util.compression import gzip_data, is_compressible
from .entry import FileChunk


def split_and_upload(master_url: str, data: bytes, filename: str,
                     chunk_size: int, collection: str = "",
                     replication: str = "", ttl: str = "",
                     content_type: str = "application/octet-stream",
                     cipher: bool = False, compress: bool = False,
                     uploaded: Optional[List[FileChunk]] = None,
                     ) -> Tuple[List[FileChunk], str]:
    """(chunks, md5 hex) of ``data``. Empty data uploads nothing (a
    zero-size needle is a tombstone): the entry holds no chunk. Each
    chunk is appended to ``uploaded``, when given, as soon as it landed,
    so a caller that catches a failure can reclaim them."""
    now_ns = time.time_ns()
    chunks: List[FileChunk] = [] if uploaded is None else uploaded
    md5 = hashlib.md5()
    if not data:
        return [], md5.hexdigest()
    want_gzip = compress and is_compressible(filename, content_type)
    for i in range(0, len(data), chunk_size):
        piece = data[i:i + chunk_size]
        md5.update(piece)
        blob, is_gzipped, key = piece, False, b""
        if want_gzip and len(piece) > 128:
            gz = gzip_data(piece)
            if len(gz) < len(piece):
                blob, is_gzipped = gz, True
        if cipher:
            blob, key = encrypt(blob)
        a, up = _assign_and_upload(master_url, blob, filename,
                                   content_type, collection,
                                   replication, ttl)
        chunks.append(FileChunk(fid=a["fid"], offset=i, size=len(piece),
                                mtime=now_ns + i, etag=up.get("eTag", ""),
                                cipher_key=key, is_compressed=is_gzipped))
    return chunks, md5.hexdigest()


def _upload(a: dict, blob: bytes, filename: str, content_type: str,
            ttl: str) -> dict:
    """To the plane when the assign names one, else (or when the plane
    alone fails) to the holder's Python URL."""
    try:
        return operation.upload(a.get("fastUrl") or a["url"], a["fid"],
                                blob, filename=filename,
                                content_type=content_type, ttl=ttl,
                                jwt=a.get("auth", ""))
    except HttpError:
        if not a.get("fastUrl"):
            raise
    return operation.upload(a["url"], a["fid"], blob, filename=filename,
                            content_type=content_type, ttl=ttl,
                            jwt=a.get("auth", ""))


def _assign_and_upload(master_url: str, blob: bytes, filename: str,
                       content_type: str, collection: str,
                       replication: str, ttl: str, attempts: int = 6):
    failed_vids: set = set()
    failed_urls: set = set()
    for attempt in range(attempts):
        if attempt:
            # about a heartbeat-expiry window in all: the master stops
            # routing to a frozen volume within a pulse
            time.sleep(config.retry_backoff_s(
                min(0.3 * (2 ** (attempt - 1)), 1.5)))
        a = None
        try:
            a = _fresh_assign(master_url, collection, replication, ttl,
                              failed_vids, failed_urls)
            return a, _upload(a, blob, filename, content_type, ttl)
        except HttpError as e:
            if a is None:
                # the assign failed: a leader change (503) or every
                # volume briefly frozen (406) retries
                if e.status not in (503, 406) or attempt + 1 == attempts:
                    raise
                continue
            # the upload failed: a node gone (503) or a volume that
            # cannot take the write now (500 naming why) retries
            retriable = e.status == 503 or (
                e.status == 500 and ("read only" in str(e)
                                     or "not found" in str(e)
                                     or "replication failed" in str(e)))
            if not retriable or attempt + 1 == attempts:
                raise
            if e.status == 503:
                failed_urls.add(a["url"])
            failed_vids.add(a["fid"].split(",")[0])
            if "replication failed" in str(e) or e.status == 503:
                # the needle may have landed: best-effort delete, so the
                # retry's fresh fid strands nothing
                try:
                    headers = {"Authorization": f"Bearer {a['auth']}"} \
                        if a.get("auth") else None
                    http_call("DELETE", f"http://{a['url']}/{a['fid']}",
                              headers=headers, timeout=3)
                except HttpError:
                    pass


def _fresh_assign(master_url: str, collection: str, replication: str,
                  ttl: str, failed_vids: set, failed_urls: set,
                  rolls: int = 6) -> dict:
    """An assign past the volumes and nodes that just refused; after
    ``rolls`` tries the last one is taken anyway."""
    a = None
    for _ in range(rolls):
        a = operation.assign(master_url, collection=collection,
                             replication=replication, ttl=ttl)
        if a["fid"].split(",")[0] not in failed_vids and \
                a["url"] not in failed_urls:
            break
    return a
