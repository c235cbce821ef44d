"""The ``Filer`` surface over a remote filer's metadata API
(``/filer/meta/*``), so a gateway runs in a process of its own: the JAX
package's ``filer/filer_client.py``. A 404 is ``NotFoundError``, a 409
``FilerError``."""

from __future__ import annotations

import posixpath
import time
import urllib.parse
from typing import List

from ..server.http_util import HttpError, get_json, post_json
from .entry import (Attr, Entry, FileChunk, entry_from_wire, entry_to_wire,
                    new_dir_entry)
from .filer import FilerError, NotFoundError


def _q(s: str) -> str:
    return urllib.parse.quote(s, safe="")


class FilerClient:
    def __init__(self, filer_url: str, buckets_folder: str = "/buckets"):
        self.url = filer_url.rstrip("/")
        if not self.url.startswith("http"):
            self.url = "http://" + self.url
        self.buckets_folder = buckets_folder

    def find_entry(self, full_path: str) -> Entry:
        try:
            out = get_json(f"{self.url}/filer/meta/lookup?path="
                           f"{_q(full_path)}")
        except HttpError as e:
            if e.status == 404:
                raise NotFoundError(full_path) from None
            raise
        return entry_from_wire(out["entry"])

    def exists(self, full_path: str) -> bool:
        try:
            self.find_entry(full_path)
            return True
        except NotFoundError:
            return False

    def list_entries(self, dir_path: str, start_file: str = "",
                     inclusive: bool = False,
                     limit: int = 1000) -> List[Entry]:
        out = get_json(
            f"{self.url}/filer/meta/list?path={_q(dir_path)}"
            f"&lastFileName={_q(start_file)}"
            f"&inclusive={'true' if inclusive else 'false'}&limit={limit}")
        return [entry_from_wire(d) for d in out["entries"]]

    def create_entry(self, entry: Entry) -> Entry:
        self._post("create", {"entry": entry_to_wire(entry)})
        return entry

    def update_entry(self, entry: Entry) -> Entry:
        self._post("update", {"entry": entry_to_wire(entry)})
        return entry

    def delete_entry(self, full_path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False):
        self._post("delete", {"path": full_path, "recursive": recursive,
                              "ignoreRecursiveError":
                              ignore_recursive_error})

    def rename_entry(self, old_path: str, new_path: str):
        self._post("rename", {"old": old_path, "new": new_path})

    def mkdir(self, full_path: str):
        """A directory, parents included; one that exists is fine, a
        file in its way raises ``FilerError``."""
        self._post("create",
                   {"entry": entry_to_wire(new_dir_entry(full_path))})

    def ensure_parents(self, full_path: str):
        parent = posixpath.dirname(full_path)
        if parent and parent != "/":
            self.mkdir(parent)

    def queue_chunk_deletion(self, chunks: List[FileChunk]):
        self._post("delete_chunks",
                   {"chunks": [c.to_dict() for c in chunks]})

    def create_bucket(self, name: str, collection: str = "",
                      replication: str = "") -> Entry:
        now = time.time()
        attr = Attr(mtime=now, crtime=now, collection=collection or name,
                    replication=replication)
        attr.set_directory()
        return self.create_entry(Entry(
            full_path=f"{self.buckets_folder}/{name}", attr=attr))

    def list_buckets(self) -> List[Entry]:
        try:
            return [e for e in self.list_entries(self.buckets_folder,
                                                 limit=10000)
                    if e.is_directory]
        except (NotFoundError, HttpError):
            return []

    def delete_bucket(self, name: str):
        self.delete_entry(f"{self.buckets_folder}/{name}", recursive=True,
                          ignore_recursive_error=True)

    def _post(self, op: str, body: dict):
        try:
            post_json(f"{self.url}/filer/meta/{op}", body)
        except HttpError as e:
            if e.status == 404:
                raise NotFoundError(str(e)) from None
            if e.status == 409:
                raise FilerError(str(e)) from None
            raise
