"""The S3 REST gateway. The JAX package's ``s3/s3_server.py``: path-style
requests over a ``Filer`` in the same process or a ``FilerClient`` of a
remote one. Objects live at ``<buckets folder>/<bucket>/<key>`` and are
written to collection ``<bucket>`` in chunks of ``chunk_size`` (8 MiB);
ETags are the MD5 of the object, or for a multipart upload the MD5 of
the parts' MD5s with ``-<parts>``.

Routes: list buckets; create, head, delete (only when empty) a bucket,
its location, ListObjects v1 and v2 (prefix, delimiter, marker or
continuation token, max-keys), DeleteObjects; put (aws-chunked bodies
decoded and their chunk signatures checked), get and head (Range),
copy (``x-amz-copy-source``, which needs Read on the source bucket) and
delete an object; multipart initiate, part, complete, abort, list
uploads and list parts. Parts are staged under the bucket's hidden
``.uploads/<id>/`` and composed without a copy: complete re-bases each
part's chunk list at the part's offset. Every request is authenticated
(``auth.authenticate``) unless the ``Iam`` is empty, and a path is
normalized before its bucket is taken, so ``..`` cannot leave a bucket.
"""

from __future__ import annotations

import hashlib
import posixpath
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from ..filer.entry import Attr, Entry, FileChunk, new_dir_entry
from ..filer.filer import Filer, FilerError, NotFoundError
from ..filer.stream import default_fetcher, read_chunked
from ..filer.upload import split_and_upload
from ..server.http_util import (HttpError, HttpServer, Request, Response,
                                Router, parse_range)
from .auth import (ACTION_ADMIN, ACTION_LIST, ACTION_READ, ACTION_WRITE,
                   STREAMING_PAYLOAD, Iam, S3AuthError, authenticate,
                   decode_aws_chunked)

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
UPLOADS_PREFIX = ".uploads"


def _xml(root: ET.Element) -> Response:
    body = b'<?xml version="1.0" encoding="UTF-8"?>' + \
        ET.tostring(root)
    return Response(body, 200, "application/xml")


def _err(status: int, code: str, message: str = "",
         resource: str = "") -> Response:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = message or code
    ET.SubElement(root, "Resource").text = resource
    return Response(
        b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root),
        status, "application/xml")


class S3ApiServer:
    def __init__(self, filer: Filer, master_url: str,
                 port: int = 8333, host: str = "127.0.0.1",
                 iam: Optional[Iam] = None,
                 chunk_size: int = 8 << 20,
                 fetcher=None):
        self.filer = filer
        self.master_url = master_url
        self.iam = iam or Iam()
        self.chunk_size = chunk_size
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
        return f"{self.host}:{self.port}"

    # -- plumbing -----------------------------------------------------------

    def _bucket_path(self, bucket: str) -> str:
        return f"{self.filer.buckets_folder}/{bucket}"

    def _object_path(self, bucket: str, key: str) -> str:
        return f"{self._bucket_path(bucket)}/{key}".rstrip("/")

    def _chunk_fetcher(self):
        if self._fetch is None:
            self._fetch = default_fetcher(self.master_url)
        return self._fetch

    def dispatch(self, req: Request):
        parsed = urllib.parse.urlparse(req.handler.path)
        query_pairs = urllib.parse.parse_qsl(parsed.query,
                                             keep_blank_values=True)
        path = urllib.parse.unquote(parsed.path)
        # normalize before extracting bucket/key: auth is bucket-scoped,
        # so '..' segments must not let a key escape into another bucket
        # (the filer normpaths server-side; match it here)
        if path != "/":
            trail = "/" if path.endswith("/") else ""
            path = posixpath.normpath(path)
            if path == "/":
                trail = ""
            path += trail
        body = req.body
        try:
            ident = authenticate(self.iam, req.method, parsed.path,
                                 query_pairs, dict(req.headers), body)
        except S3AuthError as e:
            return _err(e.status, e.code, str(e), path)
        # aws-chunked streaming payload (aws cli default for puts)
        sha_hdr = req.headers.get("x-amz-content-sha256", "")
        if sha_hdr.startswith(STREAMING_PAYLOAD) and body:
            try:
                seed, scope, amz_date, secret = "", "", "", ""
                if ident is not None:
                    auth_hdr = req.headers.get("Authorization", "")
                    seed = auth_hdr.rpartition("Signature=")[2].strip()
                    cred = auth_hdr.partition("Credential=")[2]
                    parts = cred.split("/")
                    scope = "/".join(parts[1:5]).split(",")[0]
                    amz_date = req.headers.get("x-amz-date", "")
                    secret = ident.secret_key
                body = decode_aws_chunked(
                    body, secret_key=secret, seed_signature=seed,
                    scope=scope, amz_date=amz_date,
                    verify=ident is not None)
            except S3AuthError as e:
                return _err(e.status, e.code, str(e), path)

        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        q = dict(query_pairs)
        try:
            return self._route(req, ident, bucket, key, q, body, path)
        except S3AuthError as e:
            return _err(e.status, e.code, str(e), path)
        except NotFoundError:
            code = "NoSuchKey" if key else "NoSuchBucket"
            return _err(404, code, path, path)
        except FilerError as e:
            return _err(409, "OperationAborted", str(e), path)

    def _check(self, ident, action: str, bucket: str):
        if ident is None:  # anonymous mode (iam disabled)
            return
        if not ident.can(action, bucket):
            raise S3AuthError(403, "AccessDenied",
                              f"{action} denied on {bucket}")

    def _route(self, req, ident, bucket, key, q, body, path):
        m = req.method
        if not bucket:
            if m == "GET":
                return self.list_buckets(ident)
            raise S3AuthError(405, "MethodNotAllowed")
        if not key:
            if m == "PUT":
                self._check(ident, ACTION_ADMIN, bucket)
                return self.put_bucket(bucket)
            if m == "DELETE":
                self._check(ident, ACTION_ADMIN, bucket)
                return self.delete_bucket(bucket)
            if m == "HEAD":
                self._check(ident, ACTION_READ, bucket)
                self.filer.find_entry(self._bucket_path(bucket))
                return Response(b"", 200)
            if m == "GET":
                if "location" in q:
                    # GetBucketLocation: clients (SDK region probes)
                    # expect an empty LocationConstraint for us-east-1
                    self._check(ident, ACTION_READ, bucket)
                    self.filer.find_entry(self._bucket_path(bucket))
                    root = ET.Element("LocationConstraint")
                    return _xml(root)
                if "uploads" in q:
                    self._check(ident, ACTION_LIST, bucket)
                    return self.list_multipart_uploads(bucket)
                self._check(ident, ACTION_LIST, bucket)
                return self.list_objects(bucket, q)
            if m == "POST" and "delete" in q:
                self._check(ident, ACTION_WRITE, bucket)
                return self.delete_multiple(bucket, body)
            raise S3AuthError(405, "MethodNotAllowed")
        # object-level
        if m == "GET" and "uploadId" in q:
            self._check(ident, ACTION_READ, bucket)
            return self.list_parts(bucket, key, q["uploadId"])
        if m in ("GET", "HEAD"):
            self._check(ident, ACTION_READ, bucket)
            return self.get_object(req, bucket, key, head=(m == "HEAD"))
        if m == "PUT":
            self._check(ident, ACTION_WRITE, bucket)
            if "partNumber" in q and "uploadId" in q:
                return self.upload_part(bucket, key, q, body)
            src = req.headers.get("x-amz-copy-source", "")
            if src:
                # normalize before extracting the source bucket so '..'
                # segments can't smuggle a read from another bucket
                src = posixpath.normpath(
                    "/" + urllib.parse.unquote(src).lstrip("/"))
                src_bucket = src.lstrip("/").partition("/")[0]
                self._check(ident, ACTION_READ, src_bucket)
                return self.copy_object(bucket, key, src)
            return self.put_object(req, bucket, key, body)
        if m == "POST":
            if "uploads" in q:
                self._check(ident, ACTION_WRITE, bucket)
                return self.initiate_multipart(bucket, key)
            if "uploadId" in q:
                self._check(ident, ACTION_WRITE, bucket)
                return self.complete_multipart(bucket, key, q["uploadId"],
                                               body)
            raise S3AuthError(405, "MethodNotAllowed")
        if m == "DELETE":
            self._check(ident, ACTION_WRITE, bucket)
            if "uploadId" in q:
                return self.abort_multipart(bucket, key, q["uploadId"])
            return self.delete_object(bucket, key)
        raise S3AuthError(405, "MethodNotAllowed")

    # -- buckets ------------------------------------------------------------

    def list_buckets(self, ident):
        root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = \
            ident.name if ident else "anonymous"
        buckets = ET.SubElement(root, "Buckets")
        for b in self.filer.list_buckets():
            if ident is not None and not ident.can(ACTION_LIST, b.name):
                continue
            el = ET.SubElement(buckets, "Bucket")
            ET.SubElement(el, "Name").text = b.name
            ET.SubElement(el, "CreationDate").text = _iso(b.attr.crtime)
        return _xml(root)

    def put_bucket(self, bucket: str):
        if self.filer.exists(self._bucket_path(bucket)):
            return _err(409, "BucketAlreadyExists", bucket)
        self.filer.create_bucket(bucket)
        return Response(b"", 200, headers={"Location": f"/{bucket}"})

    def delete_bucket(self, bucket: str):
        self.filer.find_entry(self._bucket_path(bucket))
        # S3 requires the bucket to be empty (hidden upload staging
        # doesn't count)
        for e in self.filer.list_entries(self._bucket_path(bucket),
                                         limit=16):
            if not e.name.startswith("."):
                return _err(409, "BucketNotEmpty", bucket)
        self.filer.delete_bucket(bucket)
        return Response(b"", 204)

    # -- objects ------------------------------------------------------------

    def put_object(self, req: Request, bucket: str, key: str, body: bytes):
        self.filer.find_entry(self._bucket_path(bucket))
        if key.endswith("/"):  # folder marker
            self.filer.create_entry(
                new_dir_entry(self._object_path(bucket, key)))
            return Response(b"", 200, headers={"ETag": '"folder"'})
        ctype = req.headers.get("Content-Type",
                                "application/octet-stream")
        chunks, md5_hex = split_and_upload(
            self.master_url, body, posixpath.basename(key),
            self.chunk_size, collection=bucket, content_type=ctype)
        now = time.time()
        entry = Entry(full_path=self._object_path(bucket, key),
                      attr=Attr(mtime=now, crtime=now, mime=ctype,
                                collection=bucket, md5=md5_hex),
                      chunks=chunks)
        self.filer.create_entry(entry)
        return Response(b"", 200, headers={"ETag": f'"{md5_hex}"'})

    def get_object(self, req: Request, bucket: str, key: str,
                   head: bool = False):
        entry = self.filer.find_entry(self._object_path(bucket, key))
        if entry.is_directory:
            if key.endswith("/"):
                return Response(b"", 200, "application/octet-stream")
            raise NotFoundError(key)
        size = entry.size()
        offset, length, status = 0, size, 200
        headers = {"ETag": f'"{entry.attr.md5}"',
                   "Last-Modified": _http_date(entry.attr.mtime),
                   "Accept-Ranges": "bytes"}
        rng = req.headers.get("Range", "")
        try:
            parsed = parse_range(rng, size)
        except HttpError:
            return _err(416, "InvalidRange", rng)
        if parsed is not None:
            offset, length = parsed
            headers["Content-Range"] = \
                f"bytes {offset}-{offset+length-1}/{size}"
            status = 206
        body = b"" if head else read_chunked(
            entry.chunks, offset, length, self._chunk_fetcher())
        return Response(body, status,
                        entry.attr.mime or "application/octet-stream",
                        headers,
                        content_length=length if head else None)

    def delete_object(self, bucket: str, key: str):
        try:
            self.filer.delete_entry(self._object_path(bucket, key),
                                    recursive=True,
                                    ignore_recursive_error=True)
        except NotFoundError:
            pass  # S3 delete is idempotent
        return Response(b"", 204)

    def copy_object(self, bucket: str, key: str, src: str):
        # src arrives unquoted + normalized from dispatch
        src_bucket, _, src_key = src.lstrip("/").partition("/")
        entry = self.filer.find_entry(self._object_path(src_bucket,
                                                        src_key))
        data = read_chunked(entry.chunks, 0, entry.size(),
                            self._chunk_fetcher())
        chunks, md5_hex = split_and_upload(
            self.master_url, data, posixpath.basename(key),
            self.chunk_size, collection=bucket,
            content_type=entry.attr.mime or "application/octet-stream")
        now = time.time()
        self.filer.create_entry(Entry(
            full_path=self._object_path(bucket, key),
            attr=Attr(mtime=now, crtime=now, mime=entry.attr.mime,
                      collection=bucket, md5=md5_hex), chunks=chunks))
        root = ET.Element("CopyObjectResult", xmlns=XMLNS)
        ET.SubElement(root, "ETag").text = f'"{md5_hex}"'
        ET.SubElement(root, "LastModified").text = _iso(now)
        return _xml(root)

    def delete_multiple(self, bucket: str, body: bytes):
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            return _err(400, "MalformedXML")
        root = ET.Element("DeleteResult", xmlns=XMLNS)
        for obj in tree.iter():
            if not obj.tag.endswith("Object"):
                continue
            key_el = next((c for c in obj if c.tag.endswith("Key")), None)
            if key_el is None or not key_el.text:
                continue
            self.delete_object(bucket, key_el.text)
            el = ET.SubElement(root, "Deleted")
            ET.SubElement(el, "Key").text = key_el.text
        return _xml(root)

    # -- listing (reference s3api_objects_list_handlers.go) -----------------

    def _walk_keys(self, dir_path: str, rel_prefix: str, prefix: str,
                   marker: str, collected: List[Tuple[str, Entry]],
                   limit: int):
        """DFS in sorted order, collecting keys > marker that match
        prefix; subtrees that cannot contain a match are pruned so a
        prefixed listing touches only the matching directories."""
        for e in self.filer.list_entries(dir_path, limit=1 << 20):
            if len(collected) > limit:
                return
            if e.name.startswith("."):
                continue
            rel = f"{rel_prefix}{e.name}"
            if e.is_directory:
                d = rel + "/"
                # prune: subtree keys all start with d; they can match
                # only if d and prefix are prefixes of each other, and
                # some key > marker can exist under d
                if not (d.startswith(prefix) or prefix.startswith(d)):
                    continue
                if marker and not (marker < d or marker.startswith(d)):
                    continue
                self._walk_keys(e.full_path, d, prefix, marker, collected,
                                limit)
            elif rel > marker and rel.startswith(prefix):
                collected.append((rel, e))

    def list_objects(self, bucket: str, q: dict):
        self.filer.find_entry(self._bucket_path(bucket))
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", 1000))
        marker = q.get("continuation-token") or q.get("start-after") or \
            q.get("marker", "")
        collected: List[Tuple[str, Entry]] = []
        self._walk_keys(self._bucket_path(bucket), "", prefix, marker,
                        collected, max_keys * 4 + 16)
        keys = sorted(collected)
        contents: List[Tuple[str, Entry]] = []
        common: List[str] = []
        for k, e in keys:
            if delimiter:
                rest = k[len(prefix):]
                d = rest.find(delimiter)
                if d >= 0:
                    cp = prefix + rest[:d + len(delimiter)]
                    if not common or common[-1] != cp:
                        common.append(cp)
                    continue
            contents.append((k, e))
        truncated = len(contents) + len(common) > max_keys
        contents = contents[:max_keys]
        root = ET.Element("ListBucketResult", xmlns=XMLNS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = prefix
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "KeyCount").text = \
            str(len(contents) + len(common))
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        if truncated and contents:
            ET.SubElement(root, "NextContinuationToken").text = \
                contents[-1][0]
        for k, e in contents:
            el = ET.SubElement(root, "Contents")
            ET.SubElement(el, "Key").text = k
            ET.SubElement(el, "LastModified").text = _iso(e.attr.mtime)
            ET.SubElement(el, "ETag").text = f'"{e.attr.md5}"'
            ET.SubElement(el, "Size").text = str(e.size())
            ET.SubElement(el, "StorageClass").text = "STANDARD"
        for cp in common[:max_keys]:
            el = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(el, "Prefix").text = cp
        return _xml(root)

    # -- multipart (reference filer_multipart.go) ---------------------------

    def _upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{self._bucket_path(bucket)}/{UPLOADS_PREFIX}/{upload_id}"

    def initiate_multipart(self, bucket: str, key: str):
        self.filer.find_entry(self._bucket_path(bucket))
        upload_id = uuid.uuid4().hex
        d = new_dir_entry(self._upload_dir(bucket, upload_id))
        d.extended["key"] = key.encode()
        self.filer.create_entry(d)
        root = ET.Element("InitiateMultipartUploadResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        return _xml(root)

    def upload_part(self, bucket: str, key: str, q: dict, body: bytes):
        part_num = int(q["partNumber"])
        upload_id = q["uploadId"]
        updir = self._upload_dir(bucket, upload_id)
        self.filer.find_entry(updir)  # NoSuchUpload if missing
        chunks, md5_hex = split_and_upload(
            self.master_url, body, f"part{part_num}", self.chunk_size,
            collection=bucket)
        now = time.time()
        self.filer.create_entry(Entry(
            full_path=f"{updir}/{part_num:05d}.part",
            attr=Attr(mtime=now, crtime=now, md5=md5_hex),
            chunks=chunks))
        return Response(b"", 200, headers={"ETag": f'"{md5_hex}"'})

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           body: bytes):
        updir = self._upload_dir(bucket, upload_id)
        self.filer.find_entry(updir)
        parts = sorted(
            (e for e in self.filer.list_entries(updir, limit=100000)
             if e.name.endswith(".part")),
            key=lambda e: e.name)
        # compose zero-copy: re-base every part's chunks at the part's
        # cumulative offset (reference filer_multipart.go:63-103)
        offset = 0
        all_chunks: List[FileChunk] = []
        etags = hashlib.md5()
        for p in parts:
            for c in p.chunks:
                all_chunks.append(FileChunk(
                    fid=c.fid, offset=offset + c.offset, size=c.size,
                    mtime=c.mtime, etag=c.etag))
            offset += p.size()
            etags.update(bytes.fromhex(p.attr.md5))
        etag = f"{etags.hexdigest()}-{len(parts)}"
        now = time.time()
        self.filer.create_entry(Entry(
            full_path=self._object_path(bucket, key),
            attr=Attr(mtime=now, crtime=now, collection=bucket,
                      mime="application/octet-stream", md5=etag),
            chunks=all_chunks))
        # drop staging metadata only — chunks now belong to the object
        for p in parts:
            p.chunks = []
            self.filer.update_entry(p)
        self.filer.delete_entry(updir, recursive=True,
                                ignore_recursive_error=True)
        root = ET.Element("CompleteMultipartUploadResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = f'"{etag}"'
        return _xml(root)

    def abort_multipart(self, bucket: str, key: str, upload_id: str):
        try:
            self.filer.delete_entry(self._upload_dir(bucket, upload_id),
                                    recursive=True,
                                    ignore_recursive_error=True)
        except NotFoundError:
            return _err(404, "NoSuchUpload", upload_id)
        return Response(b"", 204)

    def list_multipart_uploads(self, bucket: str):
        root = ET.Element("ListMultipartUploadsResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        base = f"{self._bucket_path(bucket)}/{UPLOADS_PREFIX}"
        try:
            ups = self.filer.list_entries(base, limit=10000)
        except NotFoundError:
            ups = []
        for u in ups:
            el = ET.SubElement(root, "Upload")
            ET.SubElement(el, "UploadId").text = u.name
            ET.SubElement(el, "Key").text = \
                u.extended.get("key", b"").decode()
            ET.SubElement(el, "Initiated").text = _iso(u.attr.crtime)
        return _xml(root)

    def list_parts(self, bucket: str, key: str, upload_id: str):
        updir = self._upload_dir(bucket, upload_id)
        try:
            parts = self.filer.list_entries(updir, limit=100000)
        except NotFoundError:
            return _err(404, "NoSuchUpload", upload_id)
        root = ET.Element("ListPartsResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        for p in sorted(parts, key=lambda e: e.name):
            if not p.name.endswith(".part"):
                continue
            el = ET.SubElement(root, "Part")
            ET.SubElement(el, "PartNumber").text = \
                str(int(p.name.split(".")[0]))
            ET.SubElement(el, "ETag").text = f'"{p.attr.md5}"'
            ET.SubElement(el, "Size").text = str(p.size())
        return _xml(root)


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))
