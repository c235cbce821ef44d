"""PostgreSQL filer store over a from-scratch wire-protocol client.

Reference weed/filer2/postgres/postgres_store.go + abstract_sql (lib/pq
driver): the same `filemeta` layout as the mysql store — (dirhash,
name) primary key with the md5-derived directory hash — behind the
FilerStore contract.

The client speaks the PostgreSQL frontend/backend protocol 3.0 over
one TCP connection with zero dependencies: startup, authentication
(trust, cleartext, md5, and SCRAM-SHA-256 — the modern default — via
hashlib.pbkdf2_hmac per RFC 5802/7677), and the Simple Query flow
(RowDescription/DataRow/CommandComplete/ReadyForQuery). Values ride
as literals: PostgreSQL defaults to standard_conforming_strings=on,
so string escaping is quote-doubling ONLY (no backslash modes — the
trap the mysql store has to mode-switch around), and bytea goes as
hex ('\\x…'::bytea) both ways. Upserts use ON CONFLICT DO UPDATE.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import posixpath
import socket
import struct
from typing import List, Optional, Tuple

from ..util.locks import make_lock
from .entry import Entry
from .filerstore import FilerStore, register_store
from .mysql_store import hash_string_to_long


class PostgresError(Exception):
    """Server ErrorResponse — not fixable by reconnecting."""


class PostgresConnectionError(PostgresError):
    """Torn transport — retriable with a reconnect."""


def pg_escape(s: str) -> str:
    """standard_conforming_strings=on: quote-doubling is the whole
    escape story (backslash is an ordinary character)."""
    return s.replace("'", "''")


def scram_client_proof(password: str, salt: bytes, iterations: int,
                       auth_message: bytes) -> Tuple[bytes, bytes]:
    """(ClientProof, ServerSignature) per RFC 5802 with SHA-256."""
    salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                                 iterations)
    client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
    stored_key = hashlib.sha256(client_key).digest()
    client_sig = hmac.new(stored_key, auth_message,
                          hashlib.sha256).digest()
    proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
    server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    server_sig = hmac.new(server_key, auth_message,
                          hashlib.sha256).digest()
    return proof, server_sig


class PostgresClient:
    """Minimal Simple-Query client: one connection, one in-flight
    statement (lock-guarded), reconnect-and-retry once on torn
    transport."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, timeout: float = 10.0):
        self.addr = (host, int(port))
        self.user = user
        self.password = password
        self.database = database
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = make_lock("torch.postgres_store._lock")

    # -- framing ----------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise PostgresConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_msg(self) -> Tuple[bytes, bytes]:
        """(type byte, payload)."""
        head = self._recv_exact(5)
        kind = head[:1]
        length = struct.unpack(">I", head[1:5])[0]
        return kind, self._recv_exact(length - 4)

    def _send_msg(self, kind: bytes, payload: bytes):
        self._sock.sendall(kind + struct.pack(">I", len(payload) + 4)
                           + payload)

    # -- startup + auth ----------------------------------------------------

    def _connect(self):
        self._sock = socket.create_connection(self.addr,
                                              timeout=self.timeout)
        self._sock.settimeout(self.timeout)
        self._buf = b""
        params = (f"user\x00{self.user}\x00database\x00"
                  f"{self.database}\x00\x00").encode()
        startup = struct.pack(">I", 196608) + params  # protocol 3.0
        self._sock.sendall(struct.pack(">I", len(startup) + 4) + startup)
        scram_state = None
        while True:
            kind, payload = self._recv_msg()
            if kind == b"E":
                raise PostgresError(self._err_text(payload))
            if kind == b"R":
                (auth,) = struct.unpack(">I", payload[:4])
                if auth == 0:            # AuthenticationOk
                    continue
                if auth == 3:            # cleartext
                    self._send_msg(b"p", self.password.encode() + b"\x00")
                    continue
                if auth == 5:            # md5(md5(pw+user)+salt)
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send_msg(b"p", b"md5" + outer.encode()
                                   + b"\x00")
                    continue
                if auth == 10:           # SASL: pick SCRAM-SHA-256
                    mechs = payload[4:].split(b"\x00")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PostgresError(
                            f"no supported SASL mechanism in {mechs}")
                    nonce = hashlib.sha256(os.urandom(32)) \
                        .hexdigest()[:24]
                    first_bare = f"n={self.user},r={nonce}".encode()
                    scram_state = {"nonce": nonce,
                                   "first_bare": first_bare}
                    initial = b"n,," + first_bare
                    self._send_msg(
                        b"p", b"SCRAM-SHA-256\x00"
                        + struct.pack(">I", len(initial)) + initial)
                    continue
                if auth == 11:           # SASLContinue (server-first)
                    server_first = payload[4:]
                    fields = dict(
                        kv.split(b"=", 1)
                        for kv in server_first.split(b","))
                    full_nonce = fields[b"r"].decode()
                    if not full_nonce.startswith(scram_state["nonce"]):
                        raise PostgresError(
                            "SCRAM nonce mismatch (MITM?)")
                    import base64
                    salt = base64.b64decode(fields[b"s"])
                    iters = int(fields[b"i"])
                    final_no_proof = f"c=biws,r={full_nonce}".encode()
                    auth_msg = (scram_state["first_bare"] + b","
                                + server_first + b"," + final_no_proof)
                    proof, server_sig = scram_client_proof(
                        self.password, salt, iters, auth_msg)
                    scram_state["server_sig"] = server_sig
                    self._send_msg(
                        b"p", final_no_proof + b",p="
                        + base64.b64encode(proof))
                    continue
                if auth == 12:           # SASLFinal: verify the server
                    import base64
                    fields = dict(kv.split(b"=", 1) for kv in
                                  payload[4:].split(b","))
                    if base64.b64decode(fields[b"v"]) != \
                            scram_state["server_sig"]:
                        raise PostgresError(
                            "SCRAM server signature mismatch")
                    continue
                raise PostgresError(f"unsupported auth method {auth}")
            if kind in (b"S", b"K", b"N"):   # params/keydata/notice
                continue
            if kind == b"Z":             # ReadyForQuery
                break
            raise PostgresError(f"unexpected startup message {kind!r}")
        # PIN the two session settings the literal/bytea shaping
        # assumes — a server (or role/database) configured with the
        # legacy values would otherwise turn quote-doubling into an
        # injection hole and hand back escape-format bytea garbage
        self._query_once("SET standard_conforming_strings = on")
        self._query_once("SET bytea_output = hex")

    @staticmethod
    def _err_text(payload: bytes) -> str:
        parts = {}
        for chunk in payload.split(b"\x00"):
            if chunk:
                parts[chr(chunk[0])] = chunk[1:].decode(
                    "utf-8", "replace")
        return (f"postgres error {parts.get('C', '?')}: "
                f"{parts.get('M', '')}")

    # -- simple query ------------------------------------------------------

    def query(self, sql: str):
        with self._lock:
            if self._sock is None:
                self._connect()
                return self._query_once(sql)
            try:
                return self._query_once(sql)
            except (OSError, PostgresConnectionError):
                self.close_nolock()
                self._connect()
                return self._query_once(sql)

    def _query_once(self, sql: str):
        self._send_msg(b"Q", sql.encode() + b"\x00")
        rows: List[tuple] = []
        result = None
        error = None
        while True:
            kind, payload = self._recv_msg()
            if kind == b"T":             # RowDescription (ignored)
                continue
            if kind == b"D":             # DataRow
                (ncols,) = struct.unpack(">H", payload[:2])
                pos, row = 2, []
                for _ in range(ncols):
                    (n,) = struct.unpack(">i", payload[pos:pos + 4])
                    pos += 4
                    if n < 0:
                        row.append(None)
                    else:
                        row.append(payload[pos:pos + n])
                        pos += n
                rows.append(tuple(row))
                continue
            if kind == b"C":             # CommandComplete
                tag = payload.rstrip(b"\x00").split()
                result = int(tag[-1]) if tag and \
                    tag[-1].isdigit() else 0
                continue
            if kind == b"E":
                error = PostgresError(self._err_text(payload))
                continue                 # Z still follows
            if kind in (b"N", b"S"):
                continue
            if kind == b"Z":             # ReadyForQuery: statement done
                if error is not None:
                    raise error
                return rows if rows else result
            raise PostgresError(f"unexpected message {kind!r}")

    def close_nolock(self):
        if self._sock is not None:
            try:
                self._send_msg(b"X", b"")   # Terminate
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self.close_nolock()


@register_store
class PostgresStore(FilerStore):
    """`-store postgres -postgresAddr host:port -postgresUser ..
    -postgresPassword .. -postgresDatabase ..` — the 6th real backend
    in the store matrix."""

    name = "postgres"

    CREATE = ("CREATE TABLE IF NOT EXISTS filemeta ("
              "dirhash BIGINT, name TEXT, directory TEXT, "
              "meta BYTEA, PRIMARY KEY (dirhash, name))")
    CREATE_IDX = ("CREATE INDEX IF NOT EXISTS filemeta_directory "
                  "ON filemeta (directory)")

    def initialize(self, addr: str = "127.0.0.1:5432",
                   user: str = "postgres", password: str = "",
                   database: str = "seaweedfs",
                   timeout: float = 10.0, **options):
        host, _, port = addr.rpartition(":")
        host = host.strip("[]")
        if not host or not port.isdigit():
            raise ValueError(
                f"bad postgres addr {addr!r}: want host:port")
        self._client = PostgresClient(host, int(port), user, password,
                                      database, timeout=timeout)
        self._client.query(self.CREATE)  # fail fast on a bad endpoint
        self._client.query(self.CREATE_IDX)

    @staticmethod
    def _split(full_path: str) -> Tuple[int, str, str]:
        d = posixpath.dirname(full_path) or "/"
        return hash_string_to_long(d), posixpath.basename(full_path), d

    def _upsert(self, entry: Entry):
        dirhash, name, d = self._split(entry.full_path)
        meta = entry.encode()
        self._client.query(
            "INSERT INTO filemeta (dirhash,name,directory,meta) VALUES "
            f"({dirhash},'{pg_escape(name)}','{pg_escape(d)}',"
            f"'\\x{meta.hex()}'::bytea) "
            "ON CONFLICT (dirhash, name) DO UPDATE SET "
            "directory=EXCLUDED.directory, meta=EXCLUDED.meta")

    def insert_entry(self, entry: Entry) -> None:
        self._upsert(entry)

    def update_entry(self, entry: Entry) -> None:
        self._upsert(entry)

    @staticmethod
    def _bytea(v: bytes) -> bytes:
        """DataRow bytea text format: \\x<hex>."""
        if v.startswith(b"\\x"):
            return bytes.fromhex(v[2:].decode())
        return v

    def find_entry(self, full_path: str) -> Optional[Entry]:
        dirhash, name, d = self._split(full_path)
        rows = self._client.query(
            "SELECT meta FROM filemeta WHERE "
            f"dirhash={dirhash} AND name='{pg_escape(name)}' "
            f"AND directory='{pg_escape(d)}'")
        if not isinstance(rows, list) or not rows or rows[0][0] is None:
            return None
        return Entry.decode(full_path, self._bytea(rows[0][0]))

    def delete_entry(self, full_path: str) -> None:
        dirhash, name, d = self._split(full_path)
        self._client.query(
            "DELETE FROM filemeta WHERE "
            f"dirhash={dirhash} AND name='{pg_escape(name)}' "
            f"AND directory='{pg_escape(d)}'")

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        # LIKE metacharacters escaped at the pattern level; the literal
        # level is quote-doubling only (standard_conforming_strings)
        like = base.rstrip("/").replace("\\", "\\\\") \
            .replace("%", "\\%").replace("_", "\\_")
        self._client.query(
            "DELETE FROM filemeta WHERE "
            f"directory='{pg_escape(base)}' OR "
            f"directory LIKE '{pg_escape(like)}/%' ESCAPE '\\'")

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        d = dir_path.rstrip("/") or "/"
        dirhash = hash_string_to_long(d)
        op = ">=" if inclusive else ">"
        rows = self._client.query(
            "SELECT name, meta FROM filemeta WHERE "
            f"dirhash={dirhash} AND name{op}"
            f"'{pg_escape(start_file_name)}' "
            f"AND directory='{pg_escape(d)}' "
            f"ORDER BY name ASC LIMIT {int(limit)}")
        if not isinstance(rows, list):
            return []
        base = d.rstrip("/")
        return [Entry.decode(f"{base}/{name.decode()}",
                             self._bytea(meta))
                for name, meta in rows if meta is not None]

    def close(self):
        self._client.close()
