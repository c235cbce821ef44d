"""Reads of chunked files from the volume servers. The JAX package's
``filer/stream.py``: a read range is planned as chunk views and each is
fetched from a holder of its volume (``default_fetcher``: the read
routes of the master's pushed location map, each holder's native plane
before its Python URL). When every route fails at the transport or the
server, the failed routes are dropped from the map and the refreshed
set is tried once more; a 4xx is final. A sealed or gzipped chunk is
fetched whole, opened, then sliced."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..client.operation import VidCache
from ..server.http_util import HttpError, http_call
from ..storage.types import parse_file_id
from ..util import config
from ..util.cipher import decrypt
from ..util.compression import gunzip_data
from .entry import FileChunk
from .filechunks import total_size, view_from_chunks


def default_fetcher(master_url: str):
    cache = VidCache(master_url, watch=True)

    def fetch(fid: str, offset: int, size: int) -> bytes:
        vid, _, _ = parse_file_id(fid)
        headers = {}
        if size >= 0:
            headers["Range"] = f"bytes={offset}-{offset + size - 1}"
        last: Optional[HttpError] = None
        for round_ in range(2):
            failed = []
            for url in cache.lookup_read(vid):
                try:
                    return http_call("GET", f"http://{url}/{fid}",
                                     headers=headers)
                except HttpError as e:
                    last = e
                    failed.append(url)
            cache.invalidate(vid, failed_urls=failed)
            if last is not None and last.status < 500:
                break
            if round_ == 0:
                time.sleep(config.retry_backoff_s(0.5))
        raise last or HttpError(404, f"no locations for {fid}")

    return fetch


def _view_bytes(v, fetch) -> bytes:
    if v.cipher_key or v.is_compressed:
        blob = fetch(v.fid, 0, -1)
        if v.cipher_key:
            blob = decrypt(blob, v.cipher_key)
        if v.is_compressed:
            blob = gunzip_data(blob)
        return blob[v.offset:v.offset + v.size]
    return fetch(v.fid, v.offset, v.size)


def read_chunked(chunks: List[FileChunk], offset: int, size: int,
                 fetch: Callable[[str, int, int], bytes]) -> bytes:
    """[offset, offset+size) of the file (``size`` < 0: to its end);
    gaps between chunks read as zeros."""
    views = view_from_chunks(chunks, offset, size)
    if size < 0:
        size = max(total_size(chunks) - offset, 0)
    out = bytearray(size)
    for v in views:
        data = _view_bytes(v, fetch)
        start = v.logical_offset - offset
        out[start:start + len(data)] = data
    return bytes(out)


def stream_chunked(chunks: List[FileChunk], fetch, out) -> int:
    """The whole file into the file object ``out``, one view at a time
    (gaps as zeros); returns the bytes written."""
    size = total_size(chunks)
    pos = 0
    for v in view_from_chunks(chunks, 0, size):
        if v.logical_offset > pos:
            _write_zeros(out, v.logical_offset - pos)
            pos = v.logical_offset
        data = _view_bytes(v, fetch)
        out.write(data)
        pos += len(data)
    if pos < size:
        _write_zeros(out, size - pos)
        pos = size
    return pos


def _write_zeros(out, n: int, block: int = 1 << 20):
    zeros = b"\x00" * min(n, block)
    while n > 0:
        out.write(zeros[:min(n, block)])
        n -= block
