"""Replication sinks: the JAX package's ``replication/sink.py``
(reference weed/replication/sink/). ``FilerSink`` writes into another
filer over its HTTP surface; ``S3Sink`` into any S3-compatible bucket
through the tier backend's SigV4 client, ``GcsSink`` and ``B2Sink``
through their S3 interfaces; ``AzureSink`` speaks the Blob REST API with
SharedKey signing (PutBlob, DeleteBlob)."""

from __future__ import annotations

import io
import posixpath

from ..server.http_util import HttpError, post_multipart_file


class SinkError(Exception):
    """`status` carries the HTTP status when the failure was an HTTP
    response (0 otherwise), so callers can branch on e.g. 404 without
    parsing the message."""

    def __init__(self, msg: str, status: int = 0):
        super().__init__(msg)
        self.status = int(status)


def _file_and_size(data):
    """Sinks take bytes (tests, small entries) or a (fileobj, size)
    pair (the replicator's spooled stream)."""
    if isinstance(data, (bytes, bytearray)):
        return io.BytesIO(data), len(data)
    return data


class ReplicationSink:
    kind = "?"

    def create_entry(self, key: str, entry: dict, data: bytes):
        raise NotImplementedError

    def update_entry(self, key: str, old: dict, new: dict, data):
        """Default: replace (reference sinks mostly delete+create).
        Directory updates are metadata-only — a recursive delete here
        would wipe the replicated subtree."""
        if old.get("IsDirectory") and new.get("IsDirectory"):
            self.create_entry(key, new, data)
            return
        self.delete_entry(key, old.get("IsDirectory", False))
        self.create_entry(key, new, data)

    def delete_entry(self, key: str, is_directory: bool):
        raise NotImplementedError


class FilerSink(ReplicationSink):
    """Write entries into a target filer over its public HTTP surface —
    uploads re-chunk on the target cluster, so the two clusters share
    nothing but this sink's HTTP calls."""

    kind = "filer"

    def __init__(self, filer_url: str, target_dir: str = "/"):
        from ..filer.filer_client import FilerClient
        self.filer_url = filer_url
        self.target_dir = "/" + target_dir.strip("/")
        self.client = FilerClient(filer_url)

    def _path(self, key: str) -> str:
        return posixpath.normpath(
            posixpath.join(self.target_dir, key.lstrip("/")))

    def create_entry(self, key: str, entry: dict, data):
        path = self._path(key)
        if entry.get("IsDirectory"):
            self.client.mkdir(path)
            return
        mime = entry.get("Mime") or "application/octet-stream"
        name = posixpath.basename(path) or "file"
        fileobj, size = _file_and_size(data)
        try:
            post_multipart_file(f"http://{self.filer_url}{path}",
                                name, fileobj, size, content_type=mime)
        except HttpError as e:
            raise SinkError(f"filer sink create {path}: {e}") from None

    def delete_entry(self, key: str, is_directory: bool):
        path = self._path(key)
        try:
            self.client.delete_entry(path, recursive=is_directory,
                                     ignore_recursive_error=True)
        except HttpError as e:
            if e.status != 404:
                raise SinkError(
                    f"filer sink delete {path}: {e}") from None


class S3Sink(ReplicationSink):
    """Replicate files as objects into an S3 bucket (reference s3sink)."""

    kind = "s3"

    def __init__(self, endpoint: str, bucket: str, access_key: str = "",
                 secret_key: str = "", directory: str = "",
                 region: str = "us-east-1"):
        from ..storage.backend import S3Backend
        self.s3 = S3Backend("replication", endpoint, bucket,
                            access_key=access_key, secret_key=secret_key,
                            region=region)
        self.directory = directory.strip("/")

    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.directory}/{key}" if self.directory else key

    def create_entry(self, key: str, entry: dict, data):
        if entry.get("IsDirectory"):
            return                     # S3 has no directories
        from ..storage.backend import BackendError
        try:
            self.s3._request("PUT", self._key(key), _file_and_size(data))
        except BackendError as e:
            raise SinkError(str(e), status=e.status) from None

    def delete_entry(self, key: str, is_directory: bool):
        if is_directory:
            return
        from ..storage.backend import BackendError
        try:
            self.s3.delete(self._key(key))
        except BackendError as e:
            if e.status != 404:
                raise SinkError(str(e), status=e.status) from None


class GcsSink(S3Sink):
    """Google Cloud Storage via its S3-interoperability XML API
    (storage.googleapis.com speaks SigV4 with HMAC interop keys) — a
    real sink over the same from-scratch S3 client, covering the
    reference's gcssink without the GCS SDK."""

    kind = "gcs"

    def __init__(self, bucket: str, access_key: str = "",
                 secret_key: str = "", directory: str = "",
                 endpoint: str = "https://storage.googleapis.com",
                 region: str = "auto"):
        super().__init__(endpoint, bucket, access_key=access_key,
                         secret_key=secret_key, directory=directory,
                         region=region)


class B2Sink(S3Sink):
    """Backblaze B2 via its S3-compatible API (reference b2sink)."""

    kind = "b2"

    def __init__(self, bucket: str, access_key: str = "",
                 secret_key: str = "", directory: str = "",
                 region: str = "us-west-004", endpoint: str = ""):
        endpoint = endpoint or f"https://s3.{region}.backblazeb2.com"
        super().__init__(endpoint, bucket, access_key=access_key,
                         secret_key=secret_key, directory=directory,
                         region=region)


def azure_shared_key_signature(account: str, key_b64: str, method: str,
                               path: str, headers: dict,
                               query: dict) -> str:
    """Azure Storage SharedKey string-to-sign + HMAC (the 2015+ scheme:
    Content-Length is the empty string when 0). `headers` keys must be
    lowercase; `path` is the URL path (/container/blob)."""
    import base64
    import hashlib
    import hmac as _hmac

    length = headers.get("content-length", "")
    if length in ("0", 0):
        length = ""
    canon_headers = "".join(
        f"{k}:{headers[k]}\n" for k in sorted(headers)
        if k.startswith("x-ms-"))
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    sts = "\n".join([
        method.upper(),
        headers.get("content-encoding", ""),
        headers.get("content-language", ""),
        str(length),
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        headers.get("date", ""),
        headers.get("if-modified-since", ""),
        headers.get("if-match", ""),
        headers.get("if-none-match", ""),
        headers.get("if-unmodified-since", ""),
        headers.get("range", ""),
    ]) + "\n" + canon_headers + canon_resource
    mac = _hmac.new(base64.b64decode(key_b64), sts.encode("utf-8"),
                    hashlib.sha256).digest()
    return base64.b64encode(mac).decode()


class AzureSink(ReplicationSink):
    """Replicate files as block blobs into an Azure Storage container —
    Blob REST API with SharedKey auth, no SDK (reference azuresink's
    CreateBlockBlobFromReader/DeleteBlob, sink/azuresink/azure_sink.go).
    `endpoint` is overridable for Azurite or test doubles."""

    kind = "azure"
    api_version = "2020-10-02"

    def __init__(self, account: str, account_key: str, container: str,
                 directory: str = "", endpoint: str = ""):
        import urllib.parse
        self.account = account
        self.account_key = account_key
        self.container = container
        self.directory = directory.strip("/")
        endpoint = (endpoint.rstrip("/") or
                    f"https://{account}.blob.core.windows.net")
        # split any path prefix out of the endpoint (Azurite uses
        # http://host:port/<account>): the prefix is part of the
        # request path and MUST be part of the signed canonical
        # resource, or every request 403s
        parsed = urllib.parse.urlparse(endpoint)
        self.endpoint = f"{parsed.scheme}://{parsed.netloc}"
        self.path_prefix = parsed.path.rstrip("/")

    def _blob_path(self, key: str) -> str:
        """Full request path (incl. any endpoint prefix) — signed and
        sent identically."""
        import urllib.parse
        key = key.lstrip("/")
        if self.directory:
            key = f"{self.directory}/{key}"
        return (f"{self.path_prefix}/{self.container}/"
                + urllib.parse.quote(key))

    def _request(self, method: str, path: str, body=None,
                 content_type: str = "", blob_type: str = ""):
        import email.utils
        import urllib.request

        body_file = body_len = None
        if isinstance(body, tuple):
            body_file, body_len = body
        elif body is not None:
            body_len = len(body)
        headers = {
            # formatdate, not strftime: RFC1123 day/month names must be
            # English regardless of LC_TIME — the server validates this
            # date as part of SharedKey auth
            "x-ms-date": email.utils.formatdate(usegmt=True),
            "x-ms-version": self.api_version,
        }
        if blob_type:
            headers["x-ms-blob-type"] = blob_type
        if content_type:
            headers["content-type"] = content_type
        if body_len is not None:
            headers["content-length"] = str(body_len)
        sig = azure_shared_key_signature(
            self.account, self.account_key, method, path, headers, {})
        headers["Authorization"] = f"SharedKey {self.account}:{sig}"
        data = body_file if body_file is not None else body
        req = urllib.request.Request(self.endpoint + path, data=data,
                                     method=method, headers=headers)
        import urllib.error
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")[:200]
            raise SinkError(
                f"azure {method} {path}: {e.code} {detail}",
                status=e.code) from None
        except (urllib.error.URLError, OSError) as e:
            raise SinkError(f"azure {method} {path}: {e}") from None

    def create_entry(self, key: str, entry: dict, data):
        if entry.get("IsDirectory"):
            return                     # blob storage has no directories
        mime = entry.get("Mime") or "application/octet-stream"
        self._request("PUT", self._blob_path(key), _file_and_size(data),
                      content_type=mime, blob_type="BlockBlob")

    def delete_entry(self, key: str, is_directory: bool):
        if is_directory:
            return
        try:
            self._request("DELETE", self._blob_path(key))
        except SinkError as e:
            if e.status != 404:
                raise


_SINKS = {"filer": FilerSink, "s3": S3Sink, "gcs": GcsSink, "b2": B2Sink,
          "azure": AzureSink}


def make_sink(cfg: dict) -> ReplicationSink:
    """cfg = {"type": "filer", ...kwargs} (reference replication.toml
    [sink.<type>] sections)."""
    kind = cfg.get("type")
    if kind not in _SINKS:
        raise SinkError(f"unknown sink type {kind!r}")
    kwargs = {k: v for k, v in cfg.items() if k != "type"}
    try:
        return _SINKS[kind](**kwargs)
    except TypeError as e:
        # config errors (missing bucket, reference-toml key names this
        # build doesn't take) must surface as SinkError, not TypeError —
        # callers validate configs by catching SinkError
        raise SinkError(f"{kind} sink config: {e}") from None
