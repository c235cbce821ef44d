"""The filer's HTTP server. The JAX package's
``server/filer_server.py``:

- data routes: ``GET``/``HEAD /<path>`` streams the file's chunk views
  (a ``Range`` gives a 206) or lists a directory as JSON; a multipart
  or raw ``POST``/``PUT`` auto-chunks the body (``chunk_size``) through
  the master's assigns onto the volume servers and creates the entry
  (``POST /dir/`` with a file stores ``/dir/<name>``; ``?op=mkdir``
  makes a directory; ``?mode=`` sets the mode); ``?mv.to=`` renames;
  ``DELETE`` removes (``?recursive=true``, ``?skipChunkDeletion=true``);
- the metadata API ``/filer/meta/{lookup,list,create,update,delete,
  rename,delete_chunks}`` that ``FilerClient`` speaks, so a gateway
  can run in another process;
- ``/filer/events``, the long poll of the metadata event log (with a
  server-side ``prefix`` filter and a scanned-up-to ``cursor``),
  ``/filer/status``, ``/stats/integrity`` (the master's repair queue),
  ``/metrics`` (``FILER_GATHER``), ``/admin/traces(/export)`` and
  ``POST /admin/profile``;
- the deletion loop, which every ``SW_FILER_TICK_S`` deletes the fids
  the filer queued (an overwrite's, a delete's) on the volume servers,
  and an optional ``notify_publisher`` (an object with ``.send(key,
  event)``) fed off the write path through a bounded queue.

``flush_deletions`` returns only once every fid queued when it was
called has had its delete tried, those that a concurrent drain of the
loop took included: the drain and its deletes run under one lock. (The
JAX server's flush returns at once when the loop has just emptied the
queue and is still deleting.)

A directory's ``GET`` answers a browser (``Accept: text/html`` without
``?pretty=y``) with an HTML page of links (``server/status_ui``, every
name escaped, a next-page link when the page is full), and any other
client with the JSON listing."""

from __future__ import annotations

import json
import logging
import posixpath
import queue
import threading
import time
from typing import Optional

from ..client import operation
from ..filer.entry import (Attr, Entry, FileChunk, entry_from_wire,
                           entry_to_wire, new_dir_entry)
from ..filer.filer import Filer, FilerError, NotFoundError
from ..filer.filerstore import make_store
from ..filer.log_buffer import LogBuffer, event_notification
from ..filer.stream import default_fetcher, read_chunked
from ..filer.upload import split_and_upload
from ..security.jwt import GenJwt
from ..stats.metrics import (FILER_GATHER, FILER_REQUEST_COUNTER,
                             FILER_REQUEST_HISTOGRAM)
from ..storage.types import TTL
from ..util import config, tracing
from ..util.locks import make_lock
from .http_util import (HttpError, HttpServer, Request, Response, Router,
                        http_call, parse_range, profile_handler,
                        traces_export_handler, traces_handler)

log = logging.getLogger(__name__)

CHUNK_SIZE_DEFAULT = 32 << 20  # the reference's -maxMB=32


class FilerServer:
    def __init__(self, port: int = 8888, host: str = "127.0.0.1",
                 master_url: str = "127.0.0.1:9333",
                 store: str = "memory", store_options: Optional[dict] = None,
                 collection: str = "", replication: str = "",
                 chunk_size: int = CHUNK_SIZE_DEFAULT,
                 notify_publisher=None, jwt_signing_key: str = "",
                 cipher: bool = False, compress: bool = False):
        router = Router()
        router.add("GET", "/filer/events", self.events_handler)
        router.add("GET", "/filer/status", self.status_handler)
        router.add("GET", "/filer/meta/lookup", self.meta_lookup)
        router.add("GET", "/filer/meta/list", self.meta_list)
        router.add("POST", "/filer/meta/create", self.meta_create)
        router.add("POST", "/filer/meta/update", self.meta_update)
        router.add("POST", "/filer/meta/delete", self.meta_delete)
        router.add("POST", "/filer/meta/rename", self.meta_rename)
        router.add("POST", "/filer/meta/delete_chunks",
                   self.meta_delete_chunks)
        router.add("GET", "/metrics", self.metrics_handler)
        router.add("GET", "/stats/integrity", self.stats_integrity)
        router.add("GET", "/admin/traces", traces_handler)
        router.add("GET", "/admin/traces/export", traces_export_handler)
        router.add("POST", "/admin/profile", profile_handler)
        router.set_fallback(self.data_handler)

        def observe(label, seconds, ok):
            FILER_REQUEST_COUNTER.inc(label if ok else label + " error")
            FILER_REQUEST_HISTOGRAM.observe(
                seconds, label, trace_id=tracing.current_trace_id())
        router.observe = observe
        self.server = HttpServer(port, router, host)
        self.port = self.server.port
        self.host = host
        router.node = f"{host}:{self.port}"
        self.master_url = master_url
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        self.cipher = cipher
        self.compress = compress
        self.jwt_signing_key = jwt_signing_key
        self.filer = Filer(make_store(store, **(store_options or {})))
        self.log_buffer = LogBuffer()
        self.notify_publisher = notify_publisher
        self.filer.on_update(self._on_meta_update)
        self.vid_cache = operation.VidCache(master_url, watch=True)
        self._fetch = None
        self._stop = threading.Event()
        # held from a drain of the deletion queue through its deletes
        self._deleting = make_lock("torch.filer_server._deleting")
        self._deleter = threading.Thread(target=self._deletion_loop,
                                         daemon=True, name="filer-deleter")
        self._notify_queue: queue.Queue = queue.Queue(maxsize=1024)
        self._notifier = threading.Thread(
            target=self._notify_loop, daemon=True,
            name="filer-notifier") if notify_publisher is not None else None

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self.server.start()
        self._deleter.start()
        if self._notifier is not None:
            self._notifier.start()
        return self

    def stop(self):
        self._stop.set()
        if self._notifier is not None:
            self._put_sentinel()
        self.log_buffer.close()
        self.server.stop()
        self.filer.store.close()

    def _put_sentinel(self):
        try:
            self._notify_queue.put_nowait(None)
        except queue.Full:
            try:  # shutdown outranks a pending event
                self._notify_queue.get_nowait()
            except queue.Empty:
                pass
            try:
                self._notify_queue.put_nowait(None)
            except queue.Full:
                pass  # the daemon notifier dies with the process

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def _on_meta_update(self, old, new, delete_chunks):
        event = event_notification(old, new, delete_chunks)
        self.log_buffer.append(event)
        if self.notify_publisher is None:
            return
        # the change has committed: a slow or failing broker must not
        # fail the client, and a dead one must not grow a backlog, so
        # the oldest pending event makes room
        key = (new or old).full_path
        try:
            self._notify_queue.put_nowait((key, event))
            return
        except queue.Full:
            pass
        try:
            dropped = self._notify_queue.get_nowait()
        except queue.Empty:
            dropped = None
        if dropped is None and self._stop.is_set():
            self._notify_queue.put_nowait(None)  # the sentinel stays
            return
        if dropped is not None:
            log.warning("notification buffer full; dropped event for %s",
                        dropped[0])
        try:
            self._notify_queue.put_nowait((key, event))
        except queue.Full:
            log.warning("notification buffer full; dropped event for %s",
                        key)

    def _notify_loop(self):
        while True:
            item = self._notify_queue.get()
            if item is None:
                return
            key, event = item
            try:
                self.notify_publisher.send(key, event)
            except Exception as e:  # noqa: BLE001 - the loop must live
                log.warning("notification for %s failed: %s", key, e)

    def _deletion_loop(self):
        while not self._stop.wait(
                max(0.01, config.env_float("SW_FILER_TICK_S"))):
            self.flush_deletions()

    def flush_deletions(self):
        """Delete every queued fid on the volume servers; returns once a
        drain that was running when it was called has finished too."""
        with self._deleting:
            for fid in self.filer.drain_deletion_queue():
                jwt = GenJwt(self.jwt_signing_key, fid) \
                    if self.jwt_signing_key else ""
                try:
                    operation.delete_file(self.master_url, fid,
                                          self.vid_cache, jwt=jwt)
                except HttpError:
                    pass

    # -- handlers -----------------------------------------------------------

    def metrics_handler(self, req: Request):
        return Response(FILER_GATHER.render().encode(),
                        content_type="text/plain; version=0.0.4")

    def status_handler(self, req: Request):
        return {"version": "seaweedfs-tpu", "master": self.master_url}

    def stats_integrity(self, req: Request):
        """The master's repair queue, for filer clients."""
        out = http_call("GET", f"http://{self.master_url}/cluster/repairs",
                        timeout=10)
        return json.loads(out or b"{}")

    def events_handler(self, req: Request):
        since = float(req.query.get("since", 0) or 0)
        timeout = min(float(req.query.get("timeout", 10) or 10), 55.0)
        prefix = req.query.get("prefix", "")
        base = prefix.rstrip("/")

        def touches(e: dict) -> bool:
            # either side under the prefix, on a component boundary (a
            # rename out of the tree reaches its watcher as a delete)
            for side in ("newEntry", "oldEntry"):
                ent = e.get(side)
                if ent:
                    path = str(ent.get("path", ""))
                    if path == base or path.startswith(base + "/"):
                        return True
            return False

        # the cursor is the scanned high-water mark: a batch the filter
        # empties still moves the client on, and the wait goes on here
        deadline = time.monotonic() + timeout
        while True:
            remaining = max(0.0, deadline - time.monotonic())
            events = self.log_buffer.wait_since(since, timeout=remaining)
            cursor = max((t for t, _ in events), default=since)
            if prefix and events:
                events = [(t, e) for t, e in events if touches(e)]
                if not events and deadline - time.monotonic() > 0:
                    since = cursor
                    continue
            return {"cursor": cursor,
                    "events": [{"ts": t, "event": e} for t, e in events]}

    def data_handler(self, req: Request):
        # the trailing slash means "into this directory" for a write
        is_dir_path = req.path.endswith("/") and req.path != "/"
        path = posixpath.normpath(req.path)
        if req.method in ("GET", "HEAD"):
            return self.read_handler(req, path)
        if req.method in ("POST", "PUT"):
            if "mv.to" in req.query:
                return self.move_handler(req, path)
            return self.write_handler(req, path, is_dir_path)
        if req.method == "DELETE":
            return self.delete_handler(req, path)
        raise HttpError(405, req.method)

    def read_handler(self, req: Request, path: str):
        try:
            entry = self.filer.find_entry(path)
        except NotFoundError:
            raise HttpError(404, f"{path} not found") from None
        if entry.is_directory:
            return self.list_handler(req, path)
        size = entry.size()
        offset, length, status = 0, size, 200
        headers = {"Accept-Ranges": "bytes"}
        parsed = parse_range(req.headers.get("Range", ""), size)
        if parsed is not None:
            offset, length = parsed
            headers["Content-Range"] = \
                f"bytes {offset}-{offset + length - 1}/{size}"
            status = 206
        head = req.method == "HEAD"
        body = b"" if head else read_chunked(entry.chunks, offset, length,
                                             self._chunk_fetcher())
        if entry.attr.md5:
            headers["Etag"] = f'"{entry.attr.md5}"'
        headers["Last-Modified"] = time.strftime(
            "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(entry.attr.mtime))
        return Response(body, status,
                        entry.attr.mime or "application/octet-stream",
                        headers, content_length=length if head else None)

    def _chunk_fetcher(self):
        if self._fetch is None:
            self._fetch = default_fetcher(self.master_url)
        return self._fetch

    def list_handler(self, req: Request, path: str):
        limit = int(req.query.get("limit", 1000))
        last = req.query.get("lastFileName", "")
        entries = self.filer.list_entries(path, last, False, limit)
        if "text/html" in req.headers.get("Accept", "") and \
                req.query.get("pretty") != "y":
            return self._list_page(path, entries, limit)
        return {
            "path": path,
            "entries": [self._entry_json(e) for e in entries],
            "lastFileName": entries[-1].name if entries else "",
            "shouldDisplayLoadMore": len(entries) == limit,
        }

    @staticmethod
    def _list_page(path: str, entries, limit: int) -> Response:
        """The file-browser page of a listing (reference filer_ui/)."""
        import html
        import urllib.parse
        from .status_ui import Raw, render_page
        rows = []
        base = path.rstrip("/")
        for e in entries:
            href = urllib.parse.quote(f"{base}/{e.name}")
            kind = "dir" if e.is_directory else (e.attr.mime or "file")
            rows.append((Raw(f'<a href="{href}">{html.escape(e.name)}</a>'),
                         kind, e.size() if not e.is_directory else "-"))
        footer = ""
        if entries and len(entries) == limit:  # a full page: more follow
            nxt = urllib.parse.quote(entries[-1].name)
            footer = (f'<p><a href="?lastFileName={nxt}&'
                      f'limit={limit}">next page &raquo;</a></p>')
        page = render_page(f"Filer {path}",
                           [(path, ["name", "type", "size"], rows)],
                           footer_html=footer)
        return Response(page, content_type="text/html; charset=utf-8")

    @staticmethod
    def _entry_json(e: Entry) -> dict:
        d = entry_to_wire(e)
        d["FileSize"] = e.size()
        return d

    def write_handler(self, req: Request, path: str,
                      is_dir_path: bool = False):
        filename, ctype, data = req.upload_payload()
        if is_dir_path and filename:
            path = posixpath.join(path, filename)
        elif is_dir_path or req.query.get("op") == "mkdir":
            self.filer.create_entry(new_dir_entry(path))
            return {"name": posixpath.basename(path)}
        collection = req.query.get("collection", self.collection)
        replication = req.query.get("replication", self.replication)
        ttl = req.query.get("ttl", "")
        chunks, md5_hex = split_and_upload(
            self.master_url, data, posixpath.basename(path),
            self.chunk_size, collection=collection,
            replication=replication, ttl=ttl,
            content_type=ctype or "application/octet-stream",
            cipher=self.cipher, compress=self.compress)
        now = time.time()
        # ?mode= in octal, 0660 by default; negative or malformed: 0660
        try:
            mode = int(req.query.get("mode", "") or "660", 8)
            mode = mode & 0o7777 if mode >= 0 else 0o660
        except ValueError:
            mode = 0o660
        attr = Attr(mtime=now, crtime=now, mime=ctype, mode=mode,
                    collection=collection, replication=replication,
                    ttl_sec=TTL.parse(ttl).minutes * 60 if ttl else 0,
                    md5=md5_hex)
        try:
            self.filer.create_entry(Entry(full_path=path, attr=attr,
                                          chunks=chunks))
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        return {"name": posixpath.basename(path), "size": len(data),
                "fid": chunks[0].fid if chunks else ""}

    def move_handler(self, req: Request, path: str):
        dest = req.query["mv.to"]
        try:
            self.filer.rename_entry(path, dest)
        except NotFoundError:
            raise HttpError(404, f"{path} not found") from None
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        return {"from": path, "to": dest}

    def delete_handler(self, req: Request, path: str):
        try:
            self.filer.delete_entry(
                path, recursive=req.query.get("recursive", "") == "true",
                ignore_recursive_error=req.query.get(
                    "ignoreRecursiveError", "") == "true",
                delete_chunks=req.query.get("skipChunkDeletion",
                                            "") != "true")
        except NotFoundError:
            raise HttpError(404, f"{path} not found") from None
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        return Response(b"", 204)

    # -- the metadata API -----------------------------------------------------

    def meta_lookup(self, req: Request):
        path = posixpath.normpath(req.query.get("path", "/"))
        try:
            return {"entry": self._entry_json(self.filer.find_entry(path))}
        except NotFoundError:
            raise HttpError(404, f"{path} not found") from None

    def meta_list(self, req: Request):
        path = posixpath.normpath(req.query.get("path", "/"))
        entries = self.filer.list_entries(
            path, req.query.get("lastFileName", ""),
            req.query.get("inclusive", "") == "true",
            int(req.query.get("limit", 1000)))
        return {"entries": [self._entry_json(e) for e in entries]}

    def meta_create(self, req: Request):
        entry = entry_from_wire(req.json()["entry"])
        try:
            self.filer.create_entry(entry)
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        return {"name": entry.name}

    def meta_update(self, req: Request):
        entry = entry_from_wire(req.json()["entry"])
        try:
            self.filer.update_entry(entry)
        except NotFoundError:
            raise HttpError(404, f"{entry.full_path} not found") from None
        return {"name": entry.name}

    def meta_delete(self, req: Request):
        body = req.json()
        try:
            self.filer.delete_entry(
                posixpath.normpath(body["path"]),
                recursive=body.get("recursive", False),
                ignore_recursive_error=body.get("ignoreRecursiveError",
                                                False))
        except NotFoundError:
            raise HttpError(404, f"{body['path']} not found") from None
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        return {}

    def meta_rename(self, req: Request):
        body = req.json()
        try:
            self.filer.rename_entry(posixpath.normpath(body["old"]),
                                    posixpath.normpath(body["new"]))
        except NotFoundError:
            raise HttpError(404, f"{body['old']} not found") from None
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        return {}

    def meta_delete_chunks(self, req: Request):
        self.filer.queue_chunk_deletion(
            [FileChunk.from_dict(c) for c in req.json().get("chunks", [])])
        return {}
