"""WebDAV gateway over the filer: the JAX package's
``server/webdav_server.py`` (reference weed/server/webdav_server.go).
OPTIONS, PROPFIND at depth 0 and 1, GET and HEAD with ranges, PUT in
chunks, MKCOL, DELETE, MOVE, COPY, and class-2 LOCK and UNLOCK:
exclusive write locks of infinite depth with timeouts and refresh, and a
423 for a mutation without the lock's token in ``If:``. It runs over an
in-process ``Filer`` or a remote ``FilerClient``."""

from __future__ import annotations

import posixpath
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Optional

from ..filer.entry import Attr, Entry, new_dir_entry
from ..filer.filer import FilerError, NotFoundError
from ..filer.stream import read_chunked
from ..filer.upload import split_and_upload
from ..util.locks import make_lock
from .http_util import (HttpError, HttpServer, Request, Response, Router)

DAV_NS = "DAV:"


def _rfc1123(ts: float) -> str:
    # formatdate, not strftime: day/month names must be English
    # regardless of LC_TIME — DAV clients parse Last-Modified
    import email.utils
    return email.utils.formatdate(ts, usegmt=True)


def _iso8601(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


class _Lock:
    __slots__ = ("token", "owner", "expires")

    def __init__(self, token: str, owner: str, expires: float):
        self.token = token
        self.owner = owner
        self.expires = expires


class LockManager:
    """In-memory exclusive write locks, depth-infinity (the shape
    golang.org/x/net/webdav's memLS implements and office clients use).
    A lock on a path covers the path and everything under it."""

    def __init__(self):
        self._locks: dict = {}       # path -> _Lock
        self._mu = make_lock("torch.webdav_server._mu")

    def _evict_expired(self, now: float):
        dead = [p for p, lk in self._locks.items() if lk.expires <= now]
        for p in dead:
            del self._locks[p]

    def _covering(self, path: str):
        """(lock_path, lock) whose scope covers `path`, else None."""
        probe = path
        while True:
            lk = self._locks.get(probe)
            if lk is not None:
                return probe, lk
            if probe in ("/", ""):
                return None
            probe = posixpath.dirname(probe) or "/"

    def acquire(self, path: str, timeout_s: float, owner: str) -> str:
        now = time.time()
        with self._mu:
            self._evict_expired(now)
            hit = self._covering(path)
            if hit is not None:
                raise HttpError(423, f"locked by {hit[1].owner or 'peer'}")
            # a descendant lock also conflicts with an infinite-depth
            # request on the ancestor
            prefix = path.rstrip("/") + "/"
            if any(p.startswith(prefix) for p in self._locks):
                raise HttpError(423, "descendant is locked")
            token = f"opaquelocktoken:{uuid.uuid4()}"
            self._locks[path] = _Lock(token, owner, now + timeout_s)
            return token

    def refresh(self, path: str, if_header: str, timeout_s: float) -> str:
        now = time.time()
        with self._mu:
            self._evict_expired(now)
            hit = self._covering(path)
            if hit is None:
                raise HttpError(412, "no lock to refresh")
            if hit[1].token not in (if_header or ""):
                raise HttpError(412, "lock token mismatch")
            hit[1].expires = now + timeout_s
            return hit[1].token

    def release(self, path: str, token: str) -> bool:
        with self._mu:
            self._evict_expired(time.time())
            hit = self._covering(path)
            if hit is None or hit[1].token != token:
                return False
            del self._locks[hit[0]]
            return True

    def require(self, path: str, if_header: str,
                descendants: bool = False):
        """Raise 423 unless the lock covering `path` has its token in
        the If header (RFC4918 tagged-list parsing is simplified to a
        substring check, like many servers). With ``descendants=True``
        — for operations that destroy the subtree (DELETE, MOVE,
        overwriting COPY) — locks held below `path` must be presented
        too; a PROPPATCH/MKCOL on the parent doesn't touch them."""
        with self._mu:
            self._evict_expired(time.time())
            hit = self._covering(path)
            if hit is not None and hit[1].token not in (if_header or ""):
                raise HttpError(423, "resource is locked")
            if descendants:
                prefix = path.rstrip("/") + "/"
                for p, lk in self._locks.items():
                    if p.startswith(prefix) and \
                            lk.token not in (if_header or ""):
                        raise HttpError(423, f"{p} is locked")

    def forget(self, path: str):
        """Drop any lock at `path` or below — the resource was deleted
        or moved away (RFC4918 9.6)."""
        prefix = path.rstrip("/") + "/"
        with self._mu:
            for p in [p for p in self._locks
                      if p == path or p.startswith(prefix)]:
                del self._locks[p]


class WebDavServer:
    def __init__(self, filer, master_url: str,
                 port: int = 7333, host: str = "127.0.0.1",
                 chunk_size: int = 8 << 20,
                 collection: str = "", replication: str = "",
                 fetcher=None):
        self.filer = filer
        self.master_url = master_url
        self.chunk_size = chunk_size
        self.locks = LockManager()
        self.collection = collection
        self.replication = replication
        self._fetch = fetcher
        router = Router()
        router.set_fallback(self.dispatch)
        self.server = HttpServer(port, router, host)
        self.port = self.server.port
        self.host = host

    def start(self):
        self.server.start()
        return self

    def stop(self):
        self.server.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- dispatch -----------------------------------------------------------

    def dispatch(self, req: Request):
        path = urllib.parse.unquote(req.path)
        if path != "/":
            path = posixpath.normpath(path)
        method = req.method
        if method == "OPTIONS":
            return Response(b"", 200, "text/plain", {
                "DAV": "1, 2",
                "MS-Author-Via": "DAV",
                "Allow": ("OPTIONS, GET, HEAD, PUT, DELETE, PROPFIND, "
                          "PROPPATCH, MKCOL, MOVE, COPY, LOCK, UNLOCK")})
        if method == "PROPFIND":
            return self.propfind(req, path)
        if method in ("GET", "HEAD"):
            return self.get(req, path)
        # class-2 enforcement: a mutating method on a locked resource
        # must present the lock token (If header) or draw 423; subtree-
        # destroying operations must also present descendant locks
        if_header = req.headers.get("If", "")
        if method in ("PUT", "MKCOL", "PROPPATCH"):
            self.locks.require(path, if_header)
        if method == "DELETE":
            self.locks.require(path, if_header, descendants=True)
        if method in ("MOVE", "COPY"):
            if method == "MOVE":
                self.locks.require(path, if_header, descendants=True)
            dest = self._dest_path(req)
            if dest:
                # an overwriting MOVE/COPY replaces the dest subtree
                self.locks.require(dest, if_header, descendants=True)
        if method == "PUT":
            return self.put(req, path)
        if method == "MKCOL":
            return self.mkcol(req, path)
        if method == "DELETE":
            return self.delete(req, path)
        if method in ("MOVE", "COPY"):
            return self.move_copy(req, path, copy=(method == "COPY"))
        if method == "PROPPATCH":
            return self._multistatus([self._prop_response(
                path, None, ok_props_only=True)])
        if method == "LOCK":
            return self.lock(req, path)
        if method == "UNLOCK":
            return self.unlock(req, path)
        raise HttpError(405, method)

    # -- handlers -----------------------------------------------------------

    def propfind(self, req: Request, path: str):
        depth = req.headers.get("Depth", "1")
        try:
            entry = self.filer.find_entry(path)
        except NotFoundError:
            raise HttpError(404, path) from None
        responses = [self._prop_response(path, entry)]
        if depth != "0" and entry.is_directory:
            for child in self.filer.list_entries(path, limit=10000):
                responses.append(
                    self._prop_response(child.full_path, child))
        return self._multistatus(responses)

    def get(self, req: Request, path: str):
        try:
            entry = self.filer.find_entry(path)
        except NotFoundError:
            raise HttpError(404, path) from None
        if entry.is_directory:
            names = [e.name + ("/" if e.is_directory else "")
                     for e in self.filer.list_entries(path, limit=10000)]
            body = ("\n".join(names) + "\n").encode()
            return Response(body, 200, "text/plain")
        size = entry.size()
        offset, length, status = 0, size, 200
        headers = {"Accept-Ranges": "bytes",
                   "Last-Modified": _rfc1123(entry.attr.mtime)}
        from .http_util import parse_range
        parsed = parse_range(req.headers.get("Range", ""), size)
        if parsed is not None:
            offset, length = parsed
            headers["Content-Range"] = \
                f"bytes {offset}-{offset + length - 1}/{size}"
            status = 206
        head = req.method == "HEAD"
        body = b"" if head else read_chunked(
            entry.chunks, offset, length, self._chunk_fetcher())
        return Response(body, status,
                        entry.attr.mime or "application/octet-stream",
                        headers, content_length=length if head else None)

    def put(self, req: Request, path: str):
        data = req.body
        existed = self.filer.exists(path)
        chunks, md5_hex = split_and_upload(
            self.master_url, data, posixpath.basename(path),
            self.chunk_size, collection=self.collection,
            replication=self.replication,
            content_type=req.headers.get("Content-Type",
                                         "application/octet-stream"))
        now = time.time()
        attr = Attr(mtime=now, crtime=now,
                    mime=req.headers.get("Content-Type", ""),
                    collection=self.collection,
                    replication=self.replication, md5=md5_hex)
        self.filer.create_entry(Entry(full_path=path, attr=attr,
                                      chunks=chunks))
        return Response(b"", 201 if not existed else 204)

    def mkcol(self, req: Request, path: str):
        if self.filer.exists(path):
            raise HttpError(405, f"{path} exists")
        self.filer.create_entry(new_dir_entry(path))
        return Response(b"", 201)

    def delete(self, req: Request, path: str):
        try:
            self.filer.delete_entry(path, recursive=True,
                                    ignore_recursive_error=True)
        except NotFoundError:
            raise HttpError(404, path) from None
        # RFC4918 9.6: DELETE removes locks on the deleted resource —
        # otherwise the path stays 423 for the rest of the lock timeout
        self.locks.forget(path)
        return Response(b"", 204)

    def move_copy(self, req: Request, path: str, copy: bool):
        dest = self._dest_path(req)
        if not dest:
            raise HttpError(400, "missing Destination header")
        overwrite = req.headers.get("Overwrite", "T").upper() != "F"
        try:
            self.filer.find_entry(path)  # 404 before touching the dest
        except NotFoundError:
            raise HttpError(404, path) from None
        if dest == path or dest.startswith(path + "/"):
            raise HttpError(409, "destination inside source")
        dest_existed = self.filer.exists(dest)
        if dest_existed and not overwrite:
            raise HttpError(412, f"{dest} exists")
        try:
            if copy:
                self._copy_tree(path, dest)
            else:
                if dest_existed:
                    self.filer.delete_entry(dest, recursive=True,
                                            ignore_recursive_error=True)
                self.filer.rename_entry(path, dest)
        except NotFoundError:
            raise HttpError(404, path) from None
        except FilerError as e:
            raise HttpError(409, str(e)) from None
        if not copy:
            # the source no longer exists: its lock goes with it
            self.locks.forget(path)
        return Response(b"", 204 if dest_existed else 201)

    @staticmethod
    def _dest_path(req: Request) -> str:
        dest_header = req.headers.get("Destination", "")
        if not dest_header:
            return ""
        return posixpath.normpath(urllib.parse.unquote(
            urllib.parse.urlparse(dest_header).path))

    @staticmethod
    def _parse_timeout(header: str) -> float:
        """'Second-N', 'Infinite', or comma list — first parsable wins
        (RFC4918 10.7); capped like golang webdav's maxTimeout."""
        for part in (header or "").split(","):
            part = part.strip()
            if part.lower().startswith("second-"):
                try:
                    return min(float(part[7:]), 7 * 24 * 3600.0)
                except ValueError:
                    continue
            if part.lower() == "infinite":
                return 7 * 24 * 3600.0
        return 3600.0

    def lock(self, req: Request, path: str):
        timeout = self._parse_timeout(req.headers.get("Timeout", ""))
        owner = ""
        body = req.body
        if body:
            try:
                owner_el = ET.fromstring(body).find(
                    "{%s}owner" % DAV_NS)
                if owner_el is not None:
                    owner = "".join(owner_el.itertext()).strip()
            except ET.ParseError:
                raise HttpError(400, "malformed lock body") from None
            token = self.locks.acquire(path, timeout, owner)
        else:
            # bodyless LOCK = refresh of the token in the If header
            token = self.locks.refresh(
                path, req.headers.get("If", ""), timeout)
        ns = "{%s}" % DAV_NS
        root = ET.Element(ns + "prop")
        disc = ET.SubElement(root, ns + "lockdiscovery")
        active = ET.SubElement(disc, ns + "activelock")
        ET.SubElement(ET.SubElement(active, ns + "locktype"),
                      ns + "write")
        ET.SubElement(ET.SubElement(active, ns + "lockscope"),
                      ns + "exclusive")
        ET.SubElement(active, ns + "depth").text = "infinity"
        ET.SubElement(active, ns + "timeout").text = \
            f"Second-{int(timeout)}"
        if owner:
            ET.SubElement(active, ns + "owner").text = owner
        ET.SubElement(ET.SubElement(active, ns + "locktoken"),
                      ns + "href").text = token
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(root)
        return Response(body, 200, "application/xml",
                        {"Lock-Token": f"<{token}>"})

    def unlock(self, req: Request, path: str):
        header = req.headers.get("Lock-Token", "").strip()
        token = header.strip("<>")
        if not token:
            raise HttpError(400, "missing Lock-Token header")
        if not self.locks.release(path, token):
            raise HttpError(409, "no such lock")
        return Response(b"", 204)

    # -- helpers ------------------------------------------------------------

    def _copy_tree(self, src: str, dest: str):
        """COPY re-uploads file bytes (chunks are owned by exactly one
        entry — sharing them would double-free on delete; the reference
        webdav does a read/write copy too)."""
        entry = self.filer.find_entry(src)
        if entry.is_directory:
            if not self.filer.exists(dest):
                self.filer.create_entry(new_dir_entry(dest))
            for child in self.filer.list_entries(src, limit=10000):
                self._copy_tree(child.full_path,
                                posixpath.join(dest, child.name))
            return
        data = read_chunked(entry.chunks, 0, entry.size(),
                            self._chunk_fetcher())
        chunks, md5_hex = split_and_upload(
            self.master_url, data, posixpath.basename(dest),
            self.chunk_size, collection=self.collection,
            replication=self.replication,
            content_type=entry.attr.mime or "application/octet-stream")
        now = time.time()
        attr = Attr(mtime=now, crtime=now, mime=entry.attr.mime,
                    collection=self.collection,
                    replication=self.replication, md5=md5_hex)
        if self.filer.exists(dest):
            self.filer.delete_entry(dest)
        self.filer.create_entry(Entry(full_path=dest, attr=attr,
                                      chunks=chunks))

    def _chunk_fetcher(self):
        if self._fetch is None:
            from ..filer.stream import default_fetcher
            self._fetch = default_fetcher(self.master_url)
        return self._fetch

    def _prop_response(self, path: str, entry: Optional[Entry],
                       ok_props_only: bool = False) -> ET.Element:
        ns = "{%s}" % DAV_NS
        resp = ET.Element(ns + "response")
        href = urllib.parse.quote(path)
        if entry is not None and entry.is_directory and path != "/":
            href += "/"
        ET.SubElement(resp, ns + "href").text = href
        propstat = ET.SubElement(resp, ns + "propstat")
        prop = ET.SubElement(propstat, ns + "prop")
        if entry is not None:
            ET.SubElement(prop, ns + "displayname").text = \
                entry.name or "/"
            rt = ET.SubElement(prop, ns + "resourcetype")
            if entry.is_directory:
                ET.SubElement(rt, ns + "collection")
            else:
                ET.SubElement(prop, ns + "getcontentlength").text = \
                    str(entry.size())
                ET.SubElement(prop, ns + "getcontenttype").text = \
                    entry.attr.mime or "application/octet-stream"
                if entry.attr.md5:
                    ET.SubElement(prop, ns + "getetag").text = \
                        f'"{entry.attr.md5}"'
            ET.SubElement(prop, ns + "getlastmodified").text = \
                _rfc1123(entry.attr.mtime)
            ET.SubElement(prop, ns + "creationdate").text = \
                _iso8601(entry.attr.crtime)
        ET.SubElement(propstat, ns + "status").text = \
            "HTTP/1.1 200 OK"
        return resp

    def _multistatus(self, responses) -> Response:
        ns = "{%s}" % DAV_NS
        ET.register_namespace("D", DAV_NS)
        root = ET.Element(ns + "multistatus")
        for r in responses:
            root.append(r)
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(root)
        return Response(body, 207, 'application/xml; charset="utf-8"')
