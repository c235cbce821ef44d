"""The filer: a directory tree over a ``FilerStore``. The JAX package's
``filer/filer.py``: ``create_entry`` makes missing parent directories
and queues the chunks an overwrite drops; ``delete_entry`` recurses
into directories (``recursive``) and queues their chunks; a rename moves
a whole subtree; buckets are directories under ``/buckets`` whose
collection is their name; an LRU cache holds directory entries; every
change calls the ``on_update`` hooks with (old, new, delete_chunks);
fids to delete on the volume servers wait in the deletion queue, which
the filer server drains."""

from __future__ import annotations

import posixpath
import time
from collections import OrderedDict
from typing import Callable, List, Optional

from ..util.locks import make_rlock
from .entry import Attr, Entry, FileChunk, new_dir_entry
from .filechunks import minus_chunks
from .filerstore import FilerStore


class FilerError(Exception):
    pass


class NotFoundError(FilerError):
    pass


class Filer:
    def __init__(self, store: FilerStore, dir_cache_size: int = 1024,
                 buckets_folder: str = "/buckets"):
        self.store = store
        self.buckets_folder = buckets_folder
        self._dir_cache: "OrderedDict[str, Entry]" = OrderedDict()
        self._dir_cache_size = dir_cache_size
        self._lock = make_rlock("torch.filer._lock")
        self.notify_fns: List[Callable] = []
        self._deletion_queue: List[str] = []

    # -- notifications ------------------------------------------------------

    def on_update(self, fn: Callable):
        self.notify_fns.append(fn)

    def _notify(self, old: Optional[Entry], new: Optional[Entry],
                delete_chunks: bool = False):
        for fn in self.notify_fns:
            fn(old, new, delete_chunks)

    # -- directory cache ----------------------------------------------------

    def _cached_dir(self, path: str) -> Optional[Entry]:
        with self._lock:
            e = self._dir_cache.get(path)
            if e is not None:
                self._dir_cache.move_to_end(path)
            return e

    def _cache_dir(self, entry: Entry):
        with self._lock:
            self._dir_cache[entry.full_path] = entry
            self._dir_cache.move_to_end(entry.full_path)
            while len(self._dir_cache) > self._dir_cache_size:
                self._dir_cache.popitem(last=False)

    def _uncache_dir(self, path: str):
        with self._lock:
            self._dir_cache.pop(path, None)

    # -- entries --------------------------------------------------------------

    def ensure_parents(self, full_path: str):
        parent = posixpath.dirname(full_path) or "/"
        if parent == "/" or self._cached_dir(parent) is not None:
            return
        existing = self.store.find_entry(parent)
        if existing is not None:
            if not existing.is_directory:
                raise FilerError(f"{parent} is a file, not a directory")
            self._cache_dir(existing)
            return
        self.ensure_parents(parent)
        d = new_dir_entry(parent)
        self.store.insert_entry(d)
        self._cache_dir(d)
        self._notify(None, d)

    def create_entry(self, entry: Entry) -> Entry:
        if entry.full_path != "/" and entry.full_path.endswith("/"):
            entry.full_path = entry.full_path.rstrip("/")
        self.ensure_parents(entry.full_path)
        old = self.store.find_entry(entry.full_path)
        if old is not None and old.is_directory and not entry.is_directory:
            raise FilerError(f"{entry.full_path} is a directory")
        self.store.insert_entry(entry)
        if entry.is_directory:
            self._cache_dir(entry)
        replaced_file = old is not None and not old.is_directory
        self._notify(old, entry, delete_chunks=replaced_file)
        if replaced_file:
            self.queue_chunk_deletion(minus_chunks(old.chunks,
                                                   entry.chunks))
        return entry

    def update_entry(self, entry: Entry) -> Entry:
        old = self.store.find_entry(entry.full_path)
        self.store.update_entry(entry)
        self._notify(old, entry)
        return entry

    def find_entry(self, full_path: str) -> Entry:
        if full_path == "/":
            root = new_dir_entry("/")
            root.attr.mode = 0o40777
            return root
        e = self.store.find_entry(full_path.rstrip("/"))
        if e is None:
            raise NotFoundError(full_path)
        return e

    def exists(self, full_path: str) -> bool:
        try:
            self.find_entry(full_path)
            return True
        except NotFoundError:
            return False

    def list_entries(self, dir_path: str, start_file: str = "",
                     inclusive: bool = False,
                     limit: int = 1024) -> List[Entry]:
        return self.store.list_directory_entries(
            dir_path, start_file, inclusive, limit)

    def delete_entry(self, full_path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False,
                     delete_chunks: bool = True) -> None:
        """``delete_chunks=False`` drops the metadata only (the chunks
        are shared, or reclaimed elsewhere)."""
        entry = self.find_entry(full_path)
        if entry.is_directory:
            self._delete_dir(entry, recursive, ignore_recursive_error,
                             delete_chunks)
        elif delete_chunks:
            self.queue_chunk_deletion(entry.chunks)
        self.store.delete_entry(entry.full_path)
        self._uncache_dir(entry.full_path)
        self._notify(entry, None, delete_chunks=delete_chunks)

    def _delete_dir(self, entry: Entry, recursive: bool,
                    ignore_error: bool, delete_chunks: bool = True):
        children = self.list_entries(entry.full_path, limit=1 << 30)
        if children and not recursive:
            raise FilerError(f"{entry.full_path}: folder not empty")
        for child in children:
            try:
                if child.is_directory:
                    self._delete_dir(child, recursive, ignore_error,
                                     delete_chunks)
                elif delete_chunks:
                    self.queue_chunk_deletion(child.chunks)
                self.store.delete_entry(child.full_path)
                self._uncache_dir(child.full_path)
                self._notify(child, None, delete_chunks=delete_chunks)
            except FilerError:
                if not ignore_error:
                    raise

    def rename_entry(self, old_path: str, new_path: str) -> Entry:
        old_path = old_path.rstrip("/") or "/"
        new_path = new_path.rstrip("/") or "/"
        if new_path == old_path:
            return self.find_entry(old_path)
        if new_path.startswith(old_path + "/"):
            raise FilerError(
                f"cannot move {old_path} into its own subtree {new_path}")
        entry = self.find_entry(old_path)
        self.ensure_parents(new_path)
        dest = self.store.find_entry(new_path)
        if dest is not None:
            if dest.is_directory:
                raise FilerError(f"{new_path} is an existing directory")
            self.queue_chunk_deletion(dest.chunks)
        if entry.is_directory:
            self._rename_tree(entry, old_path, new_path)
        else:
            moved = Entry(full_path=new_path, attr=entry.attr,
                          chunks=entry.chunks, extended=entry.extended)
            self.store.insert_entry(moved)
            self.store.delete_entry(old_path)
            self._notify(entry, moved)
        return self.find_entry(new_path)

    def _rename_tree(self, entry: Entry, old_root: str, new_root: str):
        # the children are listed before the moved copy is inserted, so a
        # listing never walks into the destination
        children = self.list_entries(entry.full_path, limit=1 << 30) \
            if entry.is_directory else []
        moved = Entry(full_path=new_root + entry.full_path[len(old_root):],
                      attr=entry.attr, chunks=entry.chunks,
                      extended=entry.extended)
        self.store.insert_entry(moved)
        for child in children:
            self._rename_tree(child, old_root, new_root)
        self.store.delete_entry(entry.full_path)
        self._uncache_dir(entry.full_path)
        self._notify(entry, moved)

    # -- the chunk deletion queue -----------------------------------------

    def queue_chunk_deletion(self, chunks: List[FileChunk]):
        with self._lock:
            self._deletion_queue.extend(c.fid for c in chunks)

    def drain_deletion_queue(self) -> List[str]:
        with self._lock:
            fids, self._deletion_queue = self._deletion_queue, []
            return fids

    # -- buckets --------------------------------------------------------------

    def create_bucket(self, name: str, collection: str = "",
                      replication: str = "") -> Entry:
        now = time.time()
        attr = Attr(mtime=now, crtime=now, mode=0o777,
                    collection=collection or name, replication=replication)
        attr.set_directory()
        return self.create_entry(Entry(
            full_path=f"{self.buckets_folder}/{name}", attr=attr))

    def list_buckets(self) -> List[Entry]:
        try:
            return [e for e in self.list_entries(self.buckets_folder,
                                                 limit=1 << 20)
                    if e.is_directory]
        except NotFoundError:
            return []

    def delete_bucket(self, name: str):
        self.delete_entry(f"{self.buckets_folder}/{name}", recursive=True,
                          ignore_recursive_error=True)
