"""Cassandra filer store over a from-scratch CQL binary client.

Reference weed/filer2/cassandra/cassandra_store.go (gocql): table
`filemeta (directory, name, meta)` with DIRECTORY as the partition key
and NAME clustering — a directory listing is one partition's
clustering-ordered slice, exactly Cassandra's sweet spot.

The client speaks CQL native protocol v4 over one TCP connection with
zero dependencies: STARTUP, SASL PLAIN authentication
(PasswordAuthenticator), QUERY with inline literals (quote-doubling;
blobs as 0x… constants), and RESULT rows parsing (global-table-spec
and per-column metadata shapes). Inserts are upserts by Cassandra
semantics, so insert/update share one statement.

One semantic bridge: this filer's delete_folder_children contract is
RECURSIVE, but a partition-keyed table cannot prefix-scan its
partition keys. The filer materializes every parent directory entry
(filer.py ensure_parents), so the store recurses the directory tree
it can SEE — list children, descend into child directories, then drop
each directory's partition — the same walk the reference FILER does
for its recursive deletes (filer_delete_entry.go), pushed into the
store to honor the contract the other five backends implement with
key-space prefix deletes.
"""

from __future__ import annotations

import posixpath
import socket
import struct
from typing import List, Optional, Tuple

from ..util.locks import make_lock
from .entry import Entry
from .filerstore import FilerStore, register_store

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x01
RESULT_ROWS = 0x02

META_GLOBAL_TABLES_SPEC = 0x01
META_HAS_MORE_PAGES = 0x02
META_NO_METADATA = 0x04


class CassandraError(Exception):
    """Server ERROR frame — not fixable by reconnecting."""


class CassandraConnectionError(CassandraError):
    """Torn transport — retriable with a reconnect."""


def cql_escape(s: str) -> str:
    """CQL string literals escape by quote-doubling only."""
    return s.replace("'", "''")


class CqlClient:
    """Minimal CQL v4 client: one connection, one in-flight query
    (lock-guarded), reconnect-and-retry once on torn transport."""

    def __init__(self, host: str, port: int, user: str = "",
                 password: str = "", keyspace: str = "",
                 timeout: float = 10.0):
        self.addr = (host, int(port))
        self.user = user
        self.password = password
        # identifier context: double-quote doubling, NOT the string-
        # literal escaper — stored once so reconnects USE the same name
        self.keyspace = keyspace.replace('"', '""')
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._stream = 0
        self._lock = make_lock("torch.cassandra_store._lock")

    # -- framing ----------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise CassandraConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_frame(self) -> Tuple[int, bytes]:
        head = self._recv_exact(9)
        opcode = head[4]
        (length,) = struct.unpack(">I", head[5:9])
        return opcode, self._recv_exact(length)

    def _send_frame(self, opcode: int, body: bytes):
        self._stream = (self._stream + 1) & 0x7FFF
        self._sock.sendall(
            struct.pack(">BBhBI", 0x04, 0x00, self._stream, opcode,
                        len(body)) + body)

    @staticmethod
    def _string(s: str) -> bytes:
        b = s.encode()
        return struct.pack(">H", len(b)) + b

    @staticmethod
    def _long_string(s: str) -> bytes:
        b = s.encode()
        return struct.pack(">I", len(b)) + b

    # -- startup -----------------------------------------------------------

    def _connect(self):
        self._sock = socket.create_connection(self.addr,
                                              timeout=self.timeout)
        self._sock.settimeout(self.timeout)
        self._buf = b""
        body = struct.pack(">H", 1) + self._string("CQL_VERSION") \
            + self._string("3.0.0")
        self._send_frame(OP_STARTUP, body)
        opcode, payload = self._recv_frame()
        if opcode == OP_AUTHENTICATE:
            token = b"\x00" + self.user.encode() + b"\x00" \
                + self.password.encode()
            self._send_frame(OP_AUTH_RESPONSE,
                             struct.pack(">i", len(token)) + token)
            opcode, payload = self._recv_frame()
            if opcode == OP_ERROR:
                raise CassandraError(self._err_text(payload))
            if opcode != OP_AUTH_SUCCESS:
                raise CassandraError(
                    f"unexpected auth reply opcode {opcode:#x}")
        elif opcode == OP_ERROR:
            raise CassandraError(self._err_text(payload))
        elif opcode != OP_READY:
            raise CassandraError(
                f"unexpected startup reply opcode {opcode:#x}")
        if self.keyspace:
            # the keyspace selection is PER CONNECTION: a reconnect
            # after torn transport must re-issue it or every later
            # statement fails with "no keyspace specified"
            self._query_once(f'USE "{self.keyspace}"')

    @staticmethod
    def _err_text(payload: bytes) -> str:
        (code,) = struct.unpack(">i", payload[:4])
        (n,) = struct.unpack(">H", payload[4:6])
        return (f"cassandra error {code:#06x}: "
                f"{payload[6:6 + n].decode('utf-8', 'replace')}")

    # -- query -------------------------------------------------------------

    def query(self, cql: str):
        with self._lock:
            if self._sock is None:
                self._connect()
                return self._query_once(cql)
            try:
                return self._query_once(cql)
            except (OSError, CassandraConnectionError):
                self.close_nolock()
                self._connect()
                return self._query_once(cql)

    def _query_once(self, cql: str):
        # long string + consistency ONE + empty flags
        body = self._long_string(cql) + struct.pack(">HB", 0x0001, 0x00)
        self._send_frame(OP_QUERY, body)
        opcode, payload = self._recv_frame()
        if opcode == OP_ERROR:
            raise CassandraError(self._err_text(payload))
        if opcode != OP_RESULT:
            raise CassandraError(
                f"unexpected query reply opcode {opcode:#x}")
        (kind,) = struct.unpack(">i", payload[:4])
        if kind != RESULT_ROWS:
            return None
        return self._parse_rows(payload[4:])

    def _parse_rows(self, b: bytes) -> List[tuple]:
        pos = 0
        (flags,) = struct.unpack(">i", b[pos:pos + 4])
        (ncols,) = struct.unpack(">i", b[pos + 4:pos + 8])
        pos += 8
        if flags & META_HAS_MORE_PAGES:
            (n,) = struct.unpack(">i", b[pos:pos + 4])
            pos += 4 + max(0, n)
        if not flags & META_NO_METADATA:
            if flags & META_GLOBAL_TABLES_SPEC:
                for _ in range(2):          # keyspace, table
                    (n,) = struct.unpack(">H", b[pos:pos + 2])
                    pos += 2 + n
            for _ in range(ncols):
                if not flags & META_GLOBAL_TABLES_SPEC:
                    for _ in range(2):
                        (n,) = struct.unpack(">H", b[pos:pos + 2])
                        pos += 2 + n
                (n,) = struct.unpack(">H", b[pos:pos + 2])
                pos += 2 + n                # column name
                (tid,) = struct.unpack(">H", b[pos:pos + 2])
                pos += 2
                if tid == 0x0000:           # custom: string class
                    (n,) = struct.unpack(">H", b[pos:pos + 2])
                    pos += 2 + n
                # primitive types carry no extra option payload
        (nrows,) = struct.unpack(">i", b[pos:pos + 4])
        pos += 4
        out = []
        for _ in range(nrows):
            row = []
            for _ in range(ncols):
                (n,) = struct.unpack(">i", b[pos:pos + 4])
                pos += 4
                if n < 0:
                    row.append(None)
                else:
                    row.append(b[pos:pos + n])
                    pos += n
            out.append(tuple(row))
        return out

    def close_nolock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self.close_nolock()


@register_store
class CassandraStore(FilerStore):
    """`-store cassandra -cassandraAddr host:port [-cassandraUser ..
    -cassandraPassword ..] [-cassandraKeyspace seaweedfs]` — the 7th
    backend, completing the reference's store-family coverage."""

    name = "cassandra"

    def initialize(self, addr: str = "127.0.0.1:9042", user: str = "",
                   password: str = "", keyspace: str = "seaweedfs",
                   timeout: float = 10.0, **options):
        host, _, port = addr.rpartition(":")
        host = host.strip("[]")
        if not host or not port.isdigit():
            raise ValueError(
                f"bad cassandra addr {addr!r}: want host:port")
        # the keyspace must exist before any connection can USE it, so
        # bootstrap with a keyspace-less client first
        boot = CqlClient(host, int(port), user=user, password=password,
                         timeout=timeout)
        ks = keyspace.replace('"', '""')
        boot.query(
            f"CREATE KEYSPACE IF NOT EXISTS \"{ks}\" WITH replication "
            "= {'class': 'SimpleStrategy', 'replication_factor': 1}")
        boot.close()
        self._client = CqlClient(host, int(port), user=user,
                                 password=password, keyspace=keyspace,
                                 timeout=timeout)
        self._known_dirs = set()
        self._client.query(
            "CREATE TABLE IF NOT EXISTS filemeta ("
            "directory text, name text, meta blob, "
            "PRIMARY KEY (directory, name))")

    @staticmethod
    def _split(full_path: str) -> Tuple[str, str]:
        return (posixpath.dirname(full_path) or "/",
                posixpath.basename(full_path))

    def _upsert(self, entry: Entry):
        d, name = self._split(entry.full_path)
        self._client.query(
            "INSERT INTO filemeta (directory,name,meta) VALUES "
            f"('{cql_escape(d)}','{cql_escape(name)}',"
            f"0x{entry.encode().hex()})")
        self._materialize_ancestors(d)

    def _materialize_ancestors(self, d: str):
        """Directory-marker rows for every ancestor of `d` that lacks
        one. The partition-keyed layout can only recurse over
        directories it can SEE (delete_folder_children), so the store
        guarantees its own visibility instead of relying on callers
        going through the filer's ensure_parents — the contract the
        prefix-scanning stores get for free from their key spaces."""
        from .entry import new_dir_entry
        while d != "/" and d not in self._known_dirs:
            parent, name = self._split(d)
            rows = self._client.query(
                "SELECT meta FROM filemeta WHERE "
                f"directory='{cql_escape(parent)}' "
                f"AND name='{cql_escape(name)}'")
            if not rows:
                marker = new_dir_entry(d)
                self._client.query(
                    "INSERT INTO filemeta (directory,name,meta) VALUES "
                    f"('{cql_escape(parent)}','{cql_escape(name)}',"
                    f"0x{marker.encode().hex()})")
            self._known_dirs.add(d)
            d = parent

    def insert_entry(self, entry: Entry) -> None:
        self._upsert(entry)

    def update_entry(self, entry: Entry) -> None:
        self._upsert(entry)  # cassandra INSERT is an upsert

    def find_entry(self, full_path: str) -> Optional[Entry]:
        d, name = self._split(full_path)
        rows = self._client.query(
            "SELECT meta FROM filemeta WHERE "
            f"directory='{cql_escape(d)}' AND name='{cql_escape(name)}'")
        if not rows or rows[0][0] is None:
            return None
        return Entry.decode(full_path, rows[0][0])

    def delete_entry(self, full_path: str) -> None:
        d, name = self._split(full_path)
        self._client.query(
            "DELETE FROM filemeta WHERE "
            f"directory='{cql_escape(d)}' AND name='{cql_escape(name)}'")

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        # recursive walk over MATERIALIZED directory entries (the
        # filer guarantees them), then drop this directory's whole
        # partition — see the module docstring for why a partition key
        # cannot be prefix-scanned like the other stores' key spaces
        start = ""
        while True:
            batch = self.list_directory_entries(base, start, False,
                                                1000)
            for e in batch:
                if e.is_directory:
                    self.delete_folder_children(e.full_path)
            if len(batch) < 1000:
                break
            start = batch[-1].name
        self._client.query(
            f"DELETE FROM filemeta WHERE directory='{cql_escape(base)}'")
        # evict the subtree from the materialization cache: a later
        # insert under a deleted directory must re-create its markers
        prefix = base if base.endswith("/") else base + "/"
        self._known_dirs = {k for k in self._known_dirs
                            if k != base and not k.startswith(prefix)}

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        d = dir_path.rstrip("/") or "/"
        cond = ""
        if start_file_name:
            op = ">=" if inclusive else ">"
            cond = f" AND name{op}'{cql_escape(start_file_name)}'"
        rows = self._client.query(
            "SELECT name, meta FROM filemeta WHERE "
            f"directory='{cql_escape(d)}'{cond} "
            f"ORDER BY name ASC LIMIT {int(limit)}")
        base = d.rstrip("/")
        return [Entry.decode(f"{base}/{name.decode()}", meta)
                for name, meta in (rows or []) if meta is not None]

    def close(self):
        self._client.close()
