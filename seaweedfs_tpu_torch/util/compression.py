"""Gzip of chunk data, and whether a file is worth gzipping. The JAX
package's ``util/compression.py``: ``is_compressible`` decides by the
name's extension (media and archives never, text-ish formats yes), then
by the mime type; ``gzip_data`` writes mtime 0, so equal input gives
equal bytes."""

from __future__ import annotations

import gzip
import io

_COMPRESSIBLE_EXT = {
    ".txt", ".text", ".htm", ".html", ".css", ".js", ".json", ".xml",
    ".csv", ".tsv", ".md", ".yaml", ".yml", ".toml", ".ini", ".conf",
    ".log", ".svg", ".sql", ".go", ".py", ".c", ".cc", ".cpp", ".h",
    ".java", ".rs", ".ts", ".sh", ".bat", ".pdf",
}
_INCOMPRESSIBLE_EXT = {
    ".zip", ".gz", ".tgz", ".bz2", ".xz", ".zst", ".7z", ".rar",
    ".jpg", ".jpeg", ".png", ".gif", ".webp", ".heic",
    ".mp3", ".mp4", ".mkv", ".avi", ".mov", ".ogg", ".flac",
    ".woff", ".woff2",
}
_COMPRESSIBLE_MIME_PREFIXES = ("text/",)
_COMPRESSIBLE_MIMES = {
    "application/json", "application/xml", "application/javascript",
    "application/x-javascript", "application/xhtml+xml",
    "image/svg+xml",
}


def is_compressible(filename: str = "", mime: str = "") -> bool:
    name = filename.lower()
    if any(name.endswith(ext) for ext in _INCOMPRESSIBLE_EXT):
        return False
    if any(name.endswith(ext) for ext in _COMPRESSIBLE_EXT):
        return True
    mime = mime.split(";")[0].strip().lower()
    if mime.startswith(_COMPRESSIBLE_MIME_PREFIXES):
        return True
    return mime in _COMPRESSIBLE_MIMES


def gzip_data(data: bytes, level: int = 3) -> bytes:
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=level,
                       mtime=0) as f:
        f.write(data)
    return buf.getvalue()


def gunzip_data(data: bytes) -> bytes:
    return gzip.decompress(data)
