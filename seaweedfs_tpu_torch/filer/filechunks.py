"""Overlapping writes of a chunked file. The JAX package's
``filer/filechunks.py``: chunks overlay each other in mtime order (the
newer wins) into non-overlapping ``VisibleInterval``s, from which a read
range is planned as ``ChunkView``s; ``compact_file_chunks`` splits the
chunks still visible from those wholly shadowed, ``minus_chunks`` is a
list difference, ``etag`` the one chunk's etag or the md5 of all."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import List, Set, Tuple

from .entry import FileChunk


def total_size(chunks: List[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def etag(chunks: List[FileChunk]) -> str:
    if len(chunks) == 1:
        return chunks[0].etag
    h = hashlib.md5()
    for c in chunks:
        h.update(c.etag.encode())
    return h.hexdigest()


@dataclass(frozen=True)
class VisibleInterval:
    """[start, stop) of the file served by one chunk; ``chunk_offset``
    is where ``start`` lies inside the chunk's data."""

    start: int
    stop: int
    fid: str
    mtime: int
    chunk_offset: int = 0
    is_full_chunk: bool = True
    cipher_key: bytes = b""
    is_compressed: bool = False


def non_overlapping_visible_intervals(
        chunks: List[FileChunk]) -> List[VisibleInterval]:
    visibles: List[VisibleInterval] = []
    for c in sorted(chunks, key=lambda c: (c.mtime, c.fid)):
        new = VisibleInterval(start=c.offset, stop=c.offset + c.size,
                              fid=c.fid, mtime=c.mtime,
                              cipher_key=c.cipher_key,
                              is_compressed=c.is_compressed)
        out: List[VisibleInterval] = []
        for v in visibles:
            if v.stop <= new.start or v.start >= new.stop:
                out.append(v)
                continue
            if v.start < new.start:   # its head survives
                out.append(replace(v, stop=new.start, is_full_chunk=False))
            if v.stop > new.stop:     # its tail survives, shifted
                out.append(replace(
                    v, start=new.stop,
                    chunk_offset=v.chunk_offset + (new.stop - v.start),
                    is_full_chunk=False))
        out.append(new)
        visibles = sorted(out, key=lambda v: v.start)
    return visibles


@dataclass(frozen=True)
class ChunkView:
    """One fetch of a read range: ``size`` bytes at ``offset`` of the
    chunk's data, landing at ``logical_offset`` of the file."""

    fid: str
    offset: int
    size: int
    logical_offset: int
    is_full_chunk: bool = False
    cipher_key: bytes = b""
    is_compressed: bool = False


def view_from_visible_intervals(visibles: List[VisibleInterval],
                                offset: int, size: int) -> List[ChunkView]:
    if size < 0:  # to the end of the file
        size = max((v.stop for v in visibles), default=0) - offset
    stop = offset + size
    views: List[ChunkView] = []
    for v in visibles:
        if v.start >= stop or v.stop <= offset:
            continue
        lo = max(offset, v.start)
        hi = min(stop, v.stop)
        views.append(ChunkView(
            fid=v.fid, offset=v.chunk_offset + (lo - v.start),
            size=hi - lo, logical_offset=lo,
            is_full_chunk=v.is_full_chunk and lo == v.start
            and hi == v.stop,
            cipher_key=v.cipher_key, is_compressed=v.is_compressed))
    return views


def view_from_chunks(chunks: List[FileChunk], offset: int,
                     size: int) -> List[ChunkView]:
    return view_from_visible_intervals(
        non_overlapping_visible_intervals(chunks), offset, size)


def compact_file_chunks(
        chunks: List[FileChunk]) -> Tuple[List[FileChunk], List[FileChunk]]:
    """(still visible, wholly shadowed)."""
    visible: Set[str] = {
        v.fid for v in non_overlapping_visible_intervals(chunks)}
    return ([c for c in chunks if c.fid in visible],
            [c for c in chunks if c.fid not in visible])


def minus_chunks(before: List[FileChunk],
                 after: List[FileChunk]) -> List[FileChunk]:
    """The chunks of ``before`` that ``after`` does not hold."""
    keep = {(c.fid, c.offset, c.size) for c in after}
    return [c for c in before if (c.fid, c.offset, c.size) not in keep]
