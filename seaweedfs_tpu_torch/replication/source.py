"""FilerSource — an entry's bytes from the source cluster: the JAX
package's ``replication/source.py`` (reference
weed/replication/source/filer_source.go). Events carry metadata only; the
chunks are read through the master's lookup from the volume servers, and
an entry larger than ``SPOOL_MAX_BYTES`` spools to disk."""

from __future__ import annotations

import tempfile

from ..filer.entry import FileChunk
from ..filer.stream import default_fetcher, stream_chunked

# entries at most this big replicate via RAM; larger ones spool to disk
SPOOL_MAX_BYTES = 32 << 20


class FilerSource:
    def __init__(self, filer_url: str, master_url: str,
                 path_prefix: str = "/"):
        self.filer_url = filer_url
        self.master_url = master_url
        self.path_prefix = path_prefix if path_prefix.endswith("/") \
            else path_prefix + "/"
        self._fetch = default_fetcher(master_url)

    def matches(self, path: str) -> bool:
        return path.startswith(self.path_prefix) or \
            path == self.path_prefix.rstrip("/")

    def relative(self, path: str) -> str:
        """Path with the watched prefix stripped (keyed into the sink)."""
        root = self.path_prefix.rstrip("/")
        if path == root:
            return ""
        return path[len(self.path_prefix):] if \
            path.startswith(self.path_prefix) else path.lstrip("/")

    def open_entry_data(self, entry: dict):
        """(fileobj, size) for an entry's content — spooled to disk past
        SPOOL_MAX_BYTES so replicating a volume-sized file cannot OOM
        the replicator. Caller closes the file."""
        chunks = [FileChunk.from_dict(c) for c in entry.get("chunks", [])]
        spool = tempfile.SpooledTemporaryFile(max_size=SPOOL_MAX_BYTES)
        size = stream_chunked(chunks, self._fetch, spool) if chunks else 0
        spool.seek(0)
        return spool, size
