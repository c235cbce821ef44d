"""Tiered storage backends: the volume .dat behind an abstraction.

The JAX package's ``storage/backend.py`` (reference
weed/storage/backend/backend.go): a ``BackendStorage`` is a remote tier a
readonly volume's .dat can be shipped to (reference s3_backend/) while
the .idx stays local and reads become range requests through a
``RemoteFile``. Backends are registered from config under dotted keys
like "s3.default" (reference master.toml [storage.backend.s3.default]).

Two remote kinds:

* dir: another directory (cold disk, an NFS mount; also the tests' tier)
* s3: a SigV4 client (PUT, GET, ranged GET, DELETE, HEAD for the size)
  against any S3-compatible endpoint

The registry is process-global, as in the JAX package: the in-process
servers of one process share it. The SigV4 signing recipe is the JAX
package's ``s3/auth.authorization_header_v4``, kept here since the port
has no S3 gateway.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import os
import shutil
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class BackendError(Exception):
    """``status`` carries the HTTP status when the failure was an HTTP
    response (0 otherwise), so callers branch on codes, not message
    text."""

    def __init__(self, msg: str, status: int = 0):
        super().__init__(msg)
        self.status = int(status)


# -- file-likes a Volume can own as .dat --------------------------------------


class MemoryFile(io.BytesIO):
    """A RAM-backed .dat (reference backend/memory_map)."""

    def __init__(self, data: bytes = b"", name: str = "<memory>"):
        super().__init__(data)
        self.name = name


class RemoteFile:
    """A read-only .dat that lives on a remote tier: seek and read become
    range requests. It has one position, so a reader holds the volume's
    lock across its seek and read, as for a local .dat. Writes raise: a
    tiered volume is readonly, which Volume enforces before any write
    path reaches here."""

    def __init__(self, backend: "BackendStorage", key: str, size: int):
        self.backend = backend
        self.key = key
        self._size = size
        self._pos = 0
        self.name = f"{backend.spec()}/{key}"

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = pos
        elif whence == os.SEEK_CUR:
            self._pos += pos
        elif whence == os.SEEK_END:
            self._pos = self._size + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int = -1) -> bytes:
        if size < 0:
            size = self._size - self._pos
        size = max(0, min(size, self._size - self._pos))
        if size == 0:
            return b""
        blob = self.backend.read_range(self.key, self._pos, size)
        self._pos += len(blob)
        return blob

    def write(self, blob: bytes):
        raise BackendError("remote-tier volume is read only")

    def truncate(self, size: int = None):
        raise BackendError("remote-tier volume is read only")

    def flush(self):
        pass

    def close(self):
        pass


# -- remote tiers -------------------------------------------------------------


class BackendStorage:
    """A remote object tier: whole-file upload and download, ranged
    read."""

    kind = "?"

    def __init__(self, backend_id: str):
        self.id = backend_id

    def spec(self) -> str:
        return f"{self.kind}.{self.id}"

    def upload_file(self, path: str, key: str) -> int:
        raise NotImplementedError

    def download_file(self, key: str, path: str) -> int:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def size(self, key: str) -> int:
        """Size of the stored object; BackendError if it is missing."""
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError


class DirBackend(BackendStorage):
    """A directory as a tier: cold disk, an NFS mount, a test double."""

    kind = "dir"

    def __init__(self, backend_id: str, path: str):
        super().__init__(backend_id)
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "_"))

    def upload_file(self, path: str, key: str) -> int:
        shutil.copyfile(path, self._p(key))
        return os.path.getsize(self._p(key))

    def download_file(self, key: str, path: str) -> int:
        shutil.copyfile(self._p(key), path)
        return os.path.getsize(path)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with open(self._p(key), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def size(self, key: str) -> int:
        try:
            return os.path.getsize(self._p(key))
        except OSError as e:
            raise BackendError(f"{self.spec()}/{key}: {e}",
                               status=404) from None

    def delete(self, key: str):
        p = self._p(key)
        if os.path.exists(p):
            os.remove(p)


# -- SigV4 (the JAX package's s3/auth client side) ----------------------------


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def authorization_header_v4(method: str, path: str, headers: Dict[str, str],
                            payload_hash: str, access_key: str,
                            secret_key: str, region: str,
                            service: str = "s3",
                            amz_date: Optional[str] = None) -> str:
    """The Authorization value of a request whose lowercase ``headers``
    (host, x-amz-date and x-amz-content-sha256 among them) are all
    signed; ``path`` exactly as sent on the wire, no query."""
    amz_date = amz_date or headers["x-amz-date"]
    date = amz_date[:8]
    signed: List[str] = sorted(headers)
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed)
    canon = "\n".join([method, path or "/", "", canon_headers,
                       ";".join(signed), payload_hash])
    scope = f"{date}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canon.encode()).hexdigest()])
    sig = _hmac(_signing_key(secret_key, date, region, service),
                to_sign).hex()
    return (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")


class S3Backend(BackendStorage):
    """A minimal SigV4 S3 client (PUT, GET, ranged GET, DELETE, HEAD):
    enough to park volume .dat files on any S3-compatible store
    (reference backend/s3_backend, which uses the AWS SDK; the calls on
    the wire are the same)."""

    kind = "s3"

    def __init__(self, backend_id: str, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1"):
        super().__init__(backend_id)
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.startswith("http"):
            self.endpoint = "http://" + self.endpoint
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _request(self, method: str, key: str, body=b"",
                 extra_headers: Optional[Dict[str, str]] = None,
                 payload_hash: Optional[str] = None,
                 stream_to: Optional[str] = None,
                 want_headers: bool = False):
        """``body`` is bytes or a (file object, length) pair: a volume
        .dat streams, never through RAM whole. With ``stream_to`` the
        response body goes to that path and the return is b''; with
        ``want_headers`` the return is the response's header dict (a
        HEAD)."""
        parsed = urllib.parse.urlparse(self.endpoint)
        # the path signed exactly as sent, an endpoint prefix included
        path = (parsed.path.rstrip("/")
                + f"/{self.bucket}/{urllib.parse.quote(key)}")
        url = f"{parsed.scheme}://{parsed.netloc}" + path
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
        body_file = body_len = None
        if isinstance(body, tuple):
            body_file, body_len = body
        if payload_hash is None:
            if body_file is not None:
                h = hashlib.sha256()
                while True:
                    chunk = body_file.read(1 << 20)
                    if not chunk:
                        break
                    h.update(chunk)
                body_file.seek(0)
                payload_hash = h.hexdigest()
            else:
                payload_hash = hashlib.sha256(body).hexdigest()
        headers = {"host": parsed.netloc,
                   "x-amz-content-sha256": payload_hash,
                   "x-amz-date": amz_date}
        if body_file is not None:
            headers["content-length"] = str(body_len)
        if extra_headers:
            headers.update({k.lower(): v for k, v in extra_headers.items()})
        headers["Authorization"] = authorization_header_v4(
            method, path, headers, payload_hash, self.access_key,
            self.secret_key, self.region, "s3", amz_date)
        data = body_file if body_file is not None else (body or None)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                if want_headers:
                    return dict(resp.headers)
                if stream_to is None:
                    return resp.read()
                with open(stream_to, "wb") as out:
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            return b""
                        out.write(chunk)
        except urllib.error.HTTPError as e:
            raise BackendError(
                f"{method} {url}: {e.code} "
                f"{e.read().decode('utf-8', 'replace')[:200]}",
                status=e.code) from None
        except urllib.error.URLError as e:
            raise BackendError(f"{method} {url}: {e}") from None
        except OSError as e:
            # a timeout or reset mid-stream, after the headers
            raise BackendError(f"{method} {url}: {e}") from None

    def upload_file(self, path: str, key: str) -> int:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            self._request("PUT", key, (f, size))
        return size

    def download_file(self, key: str, path: str) -> int:
        self._request("GET", key, payload_hash=EMPTY_SHA256,
                      stream_to=path)
        return os.path.getsize(path)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        return self._request(
            "GET", key, payload_hash=EMPTY_SHA256,
            extra_headers={"Range": f"bytes={offset}-{offset + size - 1}"})

    def size(self, key: str) -> int:
        hdrs = self._request("HEAD", key, payload_hash=EMPTY_SHA256,
                             want_headers=True)
        length = next((v for k, v in hdrs.items()
                       if k.lower() == "content-length"), None)
        if length is None:
            raise BackendError(
                f"HEAD {self.spec()}/{key}: no Content-Length")
        return int(length)

    def delete(self, key: str):
        self._request("DELETE", key, payload_hash=EMPTY_SHA256)


# -- the registry (reference backend.go InitBackendStorages) -----------------

_registry: Dict[str, BackendStorage] = {}
_registry_lock = threading.Lock()

_KINDS = {"dir": DirBackend, "s3": S3Backend}


def configure_backends(cfg: Dict[str, Dict[str, dict]]):
    """``cfg`` = {"s3": {"default": {...kwargs}}, "dir": {"cold": {...}}},
    the shape of the reference's [storage.backend.<kind>.<id>] TOML."""
    with _registry_lock:
        for kind, ids in cfg.items():
            if kind not in _KINDS:
                raise BackendError(f"unknown backend kind {kind!r}")
            for backend_id, kwargs in ids.items():
                _registry[f"{kind}.{backend_id}"] = \
                    _KINDS[kind](backend_id, **kwargs)


def get_backend(spec: str) -> BackendStorage:
    """``spec`` is '<kind>.<id>', e.g. 's3.default'."""
    with _registry_lock:
        b = _registry.get(spec)
    if b is None:
        raise BackendError(f"backend {spec!r} not configured")
    return b


def clear_backends():
    with _registry_lock:
        _registry.clear()
