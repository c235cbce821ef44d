"""The etcd v3 wire client: the client half of the JAX package's
``filer/etcd_store.py`` (``EtcdStore`` waits for the filer tier).

etcd serves its KV API over a JSON gateway: ``POST /v3/kv/{put,range,
deleterange,txn}`` with base64 keys and values, and
``/v3/auth/authenticate`` minting a bearer token. ``EtcdClient`` speaks
that over one kept-alive HTTP/1.1 connection, with password auth and a
re-auth when the server calls the token invalid."""

from __future__ import annotations

import base64
import http.client
import json
import threading
from typing import List, Optional


class EtcdError(Exception):
    pass


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def prefix_end(key: bytes) -> bytes:
    """etcd's WithPrefix() range_end: ``key`` with its last byte below
    0xff incremented (trailing 0xff bytes dropped); an all-0xff key scans
    to the end of the key space, spelled ``\\x00``."""
    out = bytearray(key)
    while out:
        if out[-1] != 0xFF:
            out[-1] += 1
            return bytes(out)
        out.pop()
    return b"\x00"


class EtcdClient:
    """A minimal etcd v3 JSON-gateway client (KV and password auth):
    one persistent connection under a lock, dropped and opened again
    once a call when the kept-alive socket died."""

    @classmethod
    def from_addr(cls, addr: str, **kw) -> "EtcdClient":
        """A client of ``host:port`` (an IPv6 host in brackets)."""
        host, _, port = addr.rpartition(":")
        host = host.strip("[]")
        if not host or not port.isdigit():
            raise ValueError(f"bad etcd addr {addr!r}: want host:port")
        return cls(host, int(port), **kw)

    def __init__(self, host: str, port: int, user: str = "",
                 password: str = "", timeout: float = 10.0,
                 api_prefix: str = "/v3"):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.timeout = timeout
        self.api_prefix = api_prefix.rstrip("/")
        self._lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._token = ""

    # -- transport -----------------------------------------------------------
    def _request(self, path: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = self._token
        last_err: Optional[Exception] = None
        for _ in range(2):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout)
            try:
                self._conn.request("POST", self.api_prefix + path, body,
                                   headers)
                resp = self._conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as exc:
                # a dead kept-alive socket: drop it and try once more
                try:
                    self._conn.close()
                finally:
                    self._conn = None
                last_err = exc
                continue
            try:
                reply = json.loads(data) if data else {}
            except ValueError:
                raise EtcdError(
                    f"etcd {path}: non-JSON reply (HTTP {resp.status})")
            if resp.status != 200:
                msg = reply.get("error") or reply.get("message") \
                    or data.decode("utf-8", "replace")
                raise EtcdError(f"etcd {path}: HTTP {resp.status}: {msg}")
            return reply
        raise EtcdError(f"etcd {self.host}:{self.port} unreachable: "
                        f"{last_err}")

    def _call(self, path: str, payload: dict) -> dict:
        with self._lock:
            try:
                return self._request(path, payload)
            except EtcdError as exc:
                # an expired or revoked token: authenticate once, retry
                if self.user and "invalid auth token" in str(exc):
                    self._token = ""
                    self._authenticate_locked()
                    return self._request(path, payload)
                raise

    def _authenticate_locked(self):
        reply = self._request("/auth/authenticate",
                              {"name": self.user,
                               "password": self.password})
        token = reply.get("token", "")
        if not token:
            raise EtcdError("etcd authenticate: no token in reply")
        self._token = token

    def authenticate(self):
        with self._lock:
            self._authenticate_locked()

    # -- KV ------------------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        self._call("/kv/put", {"key": _b64(key), "value": _b64(value)})

    def range(self, key: bytes, range_end: bytes = b"",
              limit: int = 0) -> List[tuple]:
        payload = {"key": _b64(key)}
        if range_end:
            payload["range_end"] = _b64(range_end)
        if limit:
            payload["limit"] = str(limit)
        reply = self._call("/kv/range", payload)
        return [(base64.b64decode(kv["key"]),
                 base64.b64decode(kv.get("value", "")))
                for kv in reply.get("kvs") or []]

    def delete_range(self, key: bytes, range_end: bytes = b"") -> int:
        payload = {"key": _b64(key)}
        if range_end:
            payload["range_end"] = _b64(range_end)
        reply = self._call("/kv/deleterange", payload)
        return int(reply.get("deleted", 0))

    def put_if(self, key: bytes, expect: Optional[bytes],
               new_value: bytes) -> bool:
        """Compare-and-swap of one key through ``/kv/txn``: put
        ``new_value`` iff the key holds ``expect`` (None: iff the key does
        not exist, its create_revision 0). Whether the txn succeeded."""
        if expect is None:
            compare = {"key": _b64(key), "target": "CREATE",
                       "create_revision": "0"}
        else:
            compare = {"key": _b64(key), "target": "VALUE",
                       "value": _b64(expect)}
        reply = self._call("/kv/txn", {
            "compare": [compare],
            "success": [{"request_put": {"key": _b64(key),
                                         "value": _b64(new_value)}}],
        })
        return bool(reply.get("succeeded"))

    def close(self):
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                finally:
                    self._conn = None
