"""Redis filer store over a from-scratch RESP client (no SDK).

Reference weed/filer2/redis/universal_redis_store.go (go-redis client):
entry bytes live at key = full path; each directory keeps a
lexicographic sorted set of child names at key = "<dir>\\x00children"
(score 0, so ZRANGEBYLEX gives ordered, cursorable listings — the same
layout the reference uses with its DIR_LIST_MARKER suffix).

The client speaks RESP2 over one TCP connection (SET/GET/MGET/DEL/
ZADD/ZREM/ZRANGEBYLEX/SCAN/PING/AUTH/SELECT), enough for the whole
FilerStore contract against any Redis-protocol server (Redis, KeyDB,
Valkey, DragonflyDB).
"""

from __future__ import annotations

import posixpath
import socket
from typing import List, Optional

from ..util.locks import make_lock
from .entry import Entry
from .filerstore import FilerStore, register_store

_CHILDREN_SUFFIX = "\x00children"


class RedisError(Exception):
    """A server error reply (-ERR/-OOM/...) — NOT retriable by
    reconnecting."""


class RedisConnectionError(RedisError):
    """Torn or half-closed connection — retriable with a reconnect."""


class RespClient:
    """Minimal RESP2 client: one connection, one in-flight command
    (guarded by a lock — the filer store serializes per call)."""

    def __init__(self, host: str, port: int, password: str = "",
                 db: int = 0, timeout: float = 10.0):
        self.addr = (host, int(port))
        self.password = password
        self.db = int(db)
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = make_lock("torch.redis_store._lock")

    # -- transport --------------------------------------------------------

    def _connect(self):
        self._sock = socket.create_connection(self.addr,
                                              timeout=self.timeout)
        self._sock.settimeout(self.timeout)
        self._buf = b""
        if self.password:
            self._exec("AUTH", self.password)
        if self.db:
            self._exec("SELECT", str(self.db))

    def close(self):
        with self._lock:
            self.close_nolock()

    def command(self, *args):
        """Run one command; reconnect-and-retry once on a torn
        connection (server restart, idle timeout)."""
        with self._lock:
            if self._sock is None:
                self._connect()
                return self._exec(*args)
            try:
                return self._exec(*args)
            except (OSError, RedisConnectionError):
                # only transport failures reconnect-and-retry: a server
                # error reply (-ERR/-OOM/-NOAUTH) came over a healthy
                # connection and can never be fixed by replaying
                self.close_nolock()
                self._connect()
                return self._exec(*args)

    def close_nolock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def transaction(self, *cmds):
        """MULTI/EXEC the given command tuples atomically (one
        pipelined write, one EXEC reply). Same reconnect policy as
        command(); any server error mid-transaction poisons the reply
        stream (unread QUEUED/EXEC replies), so the connection is
        dropped before the error propagates."""
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                    return self._exec_multi(cmds)
                try:
                    return self._exec_multi(cmds)
                except (OSError, RedisConnectionError):
                    self.close_nolock()
                    self._connect()
                    return self._exec_multi(cmds)
            except (OSError, RedisError):
                self.close_nolock()
                raise

    def _exec_multi(self, cmds):
        wire = [self._encode(("MULTI",))]
        wire += [self._encode(c) for c in cmds]
        wire.append(self._encode(("EXEC",)))
        self._sock.sendall(b"".join(wire))
        self._read_reply()               # +OK for MULTI
        for _ in cmds:
            self._read_reply()           # +QUEUED per command
        return self._read_reply()        # EXEC: array of results

    @staticmethod
    def _encode(args) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, (bytes, bytearray)) else \
                str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _exec(self, *args):
        self._sock.sendall(self._encode(args))
        return self._read_reply()

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisConnectionError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n + 2:]
        return out

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RedisError(f"bad reply type {line[:20]!r}")


def _children_key(dir_path: str) -> str:
    return (dir_path.rstrip("/") or "/") + _CHILDREN_SUFFIX


@register_store
class RedisStore(FilerStore):
    """`-store redis -redisAddr host:port [-redisPassword ..]
    [-redisDb N]`."""

    name = "redis"

    def initialize(self, addr: str = "127.0.0.1:6379", password: str = "",
                   db: int = 0, timeout: float = 10.0, **options):
        host, _, port = addr.rpartition(":")
        host = host.strip("[]")  # bracketed IPv6: [::1]:6379
        if not host or not port.isdigit():
            raise ValueError(f"bad redis addr {addr!r}: want host:port")
        self._client = RespClient(host, int(port), password=password,
                                  db=db, timeout=timeout)
        self._client.command("PING")  # fail fast on a bad endpoint

    # -- FilerStore -------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        # MULTI/EXEC: the entry and its directory-index membership must
        # land together — a crash between them would leave an entry that
        # GETs but never LISTs (or vice versa)
        self._client.transaction(
            ("SET", entry.full_path, entry.encode()),
            ("ZADD", _children_key(entry.dir_name), "0", entry.name))

    def update_entry(self, entry: Entry) -> None:
        # full upsert like every other store (and the reference's redis
        # UpdateEntry = InsertEntry): Filer.update_entry doesn't require
        # a prior insert, and a SET without the ZADD would mint an entry
        # that GETs but never LISTs
        self.insert_entry(entry)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        data = self._client.command("GET", full_path)
        if data is None:
            return None
        return Entry.decode(full_path, data)

    def delete_entry(self, full_path: str) -> None:
        d = posixpath.dirname(full_path) or "/"
        self._client.transaction(
            ("DEL", full_path),
            ("ZREM", _children_key(d), posixpath.basename(full_path)))

    @staticmethod
    def _glob_escape(s: str) -> str:
        out = []
        for ch in s:
            if ch in "*?[]\\":
                out.append("\\" + ch)
            else:
                out.append(ch)
        return "".join(out)

    def delete_folder_children(self, full_path: str) -> None:
        """Recursive prefix delete (the contract the filer relies on;
        sqlite/memory stores do the same with a LIKE/startswith). A
        child-set walk can't see subtrees whose intermediate directory
        entries were never materialized, so this scans the key space by
        prefix — entry keys AND per-directory children sets under the
        path both match '<base>/*'."""
        base = full_path.rstrip("/") or "/"
        pattern = self._glob_escape(base.rstrip("/")) + "/*"
        cursor = "0"
        while True:
            reply = self._client.command("SCAN", cursor, "MATCH",
                                         pattern, "COUNT", "1000")
            cursor = reply[0].decode() if isinstance(reply[0], bytes) \
                else str(reply[0])
            keys = reply[1] or []
            if keys:
                self._client.command("DEL", *keys)
            if cursor == "0":
                break
        self._client.command("DEL", _children_key(base))

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        if start_file_name:
            lo = ("[" if inclusive else "(") + start_file_name
        else:
            lo = "-"
        names = self._client.command(
            "ZRANGEBYLEX", _children_key(dir_path), lo, "+",
            "LIMIT", "0", str(limit)) or []
        if not names:
            return []
        base = dir_path.rstrip("/")
        paths = [f"{base}/" +
                 (raw.decode() if isinstance(raw, bytes) else raw)
                 for raw in names]
        # one MGET round trip for the whole page, not one GET per child
        values = self._client.command("MGET", *paths) or []
        return [Entry.decode(p, v)
                for p, v in zip(paths, values) if v is not None]

    def close(self):
        self._client.close()
