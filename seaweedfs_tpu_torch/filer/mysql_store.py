"""MySQL filer store over a from-scratch wire-protocol client (no SDK).

Reference weed/filer2/mysql/mysql_store.go + abstract_sql/
abstract_sql_store.go (database/sql + go-sql-driver): one `filemeta`
table keyed by (dirhash, name) where dirhash is the md5-derived 64-bit
hash of the directory path (reference util.HashStringToLong,
weed/util/bytes.go:53) — listings become an indexed range scan on
(dirhash, name>start).

The client speaks the MySQL client/server protocol over one TCP
connection: handshake v10, mysql_native_password auth (+ auth-switch),
COM_QUERY text protocol with OK/ERR/resultset parsing — enough for the
whole FilerStore contract against MySQL/MariaDB/Percona/Vitess, with
zero dependencies. Values ride as escaped literals (blobs as X'..'
hex), so no prepared-statement round trips.

Layout difference from the reference, on purpose: this filer's
delete_folder_children contract is RECURSIVE (every store here —
memory/sqlite/sharded/redis — prefix-deletes the subtree), so the
delete targets `directory = base OR directory LIKE 'base/%'` instead
of the reference's direct-children-only `directory = ?`.
"""

from __future__ import annotations

import hashlib
import posixpath
import socket
import struct
from typing import List, Optional, Tuple

from ..util.locks import make_lock
from .entry import Entry
from .filerstore import FilerStore, register_store

# capability flags (mysql_com.h)
_CAP_LONG_PASSWORD = 0x1
_CAP_CONNECT_WITH_DB = 0x8
_CAP_PROTOCOL_41 = 0x200
_CAP_SECURE_CONNECTION = 0x8000
_CAP_PLUGIN_AUTH = 0x80000

# server status flag: sql_mode=NO_BACKSLASH_ESCAPES is active — the
# server treats backslash as a LITERAL inside string literals, so
# backslash-escaping would both corrupt stored names and reopen
# injection through quotes (go-sql-driver tracks the same flag)
SERVER_STATUS_NO_BACKSLASH_ESCAPES = 0x200


class MysqlError(Exception):
    """Server ERR packet — not fixable by reconnecting."""


class MysqlConnectionError(MysqlError):
    """Torn transport — retriable with a reconnect."""


def hash_string_to_long(s: str) -> int:
    """Reference util.HashStringToLong: first 8 md5 bytes, big-endian,
    as a SIGNED 64-bit value (it lands in a BIGINT column)."""
    b = hashlib.md5(s.encode()).digest()
    v = int.from_bytes(b[:8], "big")
    return v - (1 << 64) if v >> 63 else v


def _native_password(password: str, nonce: bytes) -> bytes:
    """mysql_native_password scramble:
    SHA1(pw) XOR SHA1(nonce + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def escape_string(s: str, no_backslash_escapes: bool = False) -> str:
    """String-literal escaping for the server's CURRENT sql_mode.
    Under NO_BACKSLASH_ESCAPES only quote-doubling is valid (and
    backslashes must stay literal); otherwise the classic backslash
    scheme."""
    if no_backslash_escapes:
        return s.replace("'", "''")
    out = []
    for ch in s:
        if ch in ("'", '"', "\\"):
            out.append("\\" + ch)
        elif ch == "\x00":
            out.append("\\0")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\x1a":
            out.append("\\Z")
        else:
            out.append(ch)
    return "".join(out)


class MysqlClient:
    """Minimal text-protocol client: one connection, one in-flight
    query (lock-guarded), reconnect-and-retry once on torn transport."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, timeout: float = 10.0):
        self.addr = (host, int(port))
        self.user = user
        self.password = password
        self.database = database
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._seq = 0
        self.status = 0   # server status flags (handshake + OK packets)
        self._lock = make_lock("torch.mysql_store._lock")

    def escape(self, s: str) -> str:
        return escape_string(
            s, bool(self.status & SERVER_STATUS_NO_BACKSLASH_ESCAPES))

    # -- packet framing ---------------------------------------------------

    def _recv_one(self) -> bytes:
        while len(self._buf) < 4:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise MysqlConnectionError("connection closed")
            self._buf += chunk
        size = int.from_bytes(self._buf[:3], "little")
        self._seq = (self._buf[3] + 1) & 0xFF
        while len(self._buf) < 4 + size:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise MysqlConnectionError("connection closed")
            self._buf += chunk
        payload = self._buf[4:4 + size]
        self._buf = self._buf[4 + size:]
        return payload

    def _recv_packet(self) -> bytes:
        """One logical packet: 0xFFFFFF-sized frames continue into the
        next frame (LONGBLOB meta can push a row past 16MB)."""
        payload = self._recv_one()
        if len(payload) < 0xFFFFFF:
            return payload
        out = [payload]
        while len(payload) == 0xFFFFFF:
            payload = self._recv_one()
            out.append(payload)
        return b"".join(out)

    def _send_packet(self, payload: bytes):
        # frames cap at 0xFFFFFF; a payload at exactly the cap needs an
        # empty continuation frame to mark the end
        out = []
        while True:
            frame, payload = payload[:0xFFFFFF], payload[0xFFFFFF:]
            out.append(len(frame).to_bytes(3, "little")
                       + bytes([self._seq]) + frame)
            self._seq = (self._seq + 1) & 0xFF
            if len(frame) < 0xFFFFFF:
                break
        self._sock.sendall(b"".join(out))

    # -- handshake --------------------------------------------------------

    def _connect(self):
        self._sock = socket.create_connection(self.addr,
                                              timeout=self.timeout)
        self._sock.settimeout(self.timeout)
        self._buf = b""
        self._seq = 0
        greeting = self._recv_packet()
        if greeting[:1] == b"\xff":
            raise MysqlError(self._err_text(greeting))
        if greeting[0] != 10:
            raise MysqlError(
                f"unsupported handshake protocol {greeting[0]}")
        pos = 1
        end = greeting.index(b"\x00", pos)          # server version
        pos = end + 1 + 4                           # connection id
        nonce = greeting[pos:pos + 8]
        pos += 8 + 1                                # filler
        caps = int.from_bytes(greeting[pos:pos + 2], "little")
        pos += 2
        plugin = "mysql_native_password"
        if len(greeting) > pos:
            pos += 1                                # charset
            self.status = int.from_bytes(greeting[pos:pos + 2],
                                         "little")
            pos += 2
            caps |= int.from_bytes(greeting[pos:pos + 2],
                                   "little") << 16
            pos += 2
            auth_len = greeting[pos]
            pos += 1 + 10                           # reserved
            if caps & _CAP_SECURE_CONNECTION:
                n = max(13, auth_len - 8)
                nonce += greeting[pos:pos + n].rstrip(b"\x00")
                pos += n
            if caps & _CAP_PLUGIN_AUTH:
                end = greeting.find(b"\x00", pos)
                if end < 0:
                    end = len(greeting)
                plugin = greeting[pos:end].decode()
        nonce = nonce[:20]

        my_caps = (_CAP_LONG_PASSWORD | _CAP_PROTOCOL_41
                   | _CAP_SECURE_CONNECTION | _CAP_PLUGIN_AUTH)
        if self.database:
            my_caps |= _CAP_CONNECT_WITH_DB
        auth = _native_password(self.password, nonce)
        resp = (struct.pack("<IIB", my_caps, 16 << 20, 33)
                + b"\x00" * 23 + self.user.encode() + b"\x00"
                + bytes([len(auth)]) + auth)
        if self.database:
            resp += self.database.encode() + b"\x00"
        resp += b"mysql_native_password\x00"
        self._send_packet(resp)

        pkt = self._recv_packet()
        if pkt[:1] == b"\xfe" and len(pkt) > 1:
            # AuthSwitchRequest: re-scramble with the new nonce
            end = pkt.index(b"\x00", 1)
            switch_plugin = pkt[1:end].decode()
            if switch_plugin != "mysql_native_password":
                raise MysqlError(
                    f"unsupported auth plugin {switch_plugin!r}")
            new_nonce = pkt[end + 1:].rstrip(b"\x00")[:20]
            self._send_packet(_native_password(self.password, new_nonce))
            pkt = self._recv_packet()
        if pkt[:1] == b"\xff":
            raise MysqlError(self._err_text(pkt))
        if pkt[:1] != b"\x00":
            raise MysqlError(f"unexpected auth reply {pkt[:1]!r}")
        self._parse_ok(pkt)

    @staticmethod
    def _err_text(pkt: bytes) -> str:
        code = int.from_bytes(pkt[1:3], "little")
        msg = pkt[3:]
        if msg[:1] == b"#":  # sql-state marker
            msg = msg[6:]
        return f"mysql error {code}: {msg.decode('utf-8', 'replace')}"

    # -- lenenc helpers ---------------------------------------------------

    @staticmethod
    def _lenenc(buf: bytes, pos: int) -> Tuple[Optional[int], int]:
        b = buf[pos]
        if b < 0xFB:
            return b, pos + 1
        if b == 0xFB:
            return None, pos + 1  # NULL
        if b == 0xFC:
            return int.from_bytes(buf[pos + 1:pos + 3], "little"), pos + 3
        if b == 0xFD:
            return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
        return int.from_bytes(buf[pos + 1:pos + 9], "little"), pos + 9

    # -- query ------------------------------------------------------------

    def query(self, sql: str):
        """Run one statement; returns rows (list of tuples of
        bytes/None) for resultsets, or the affected-row count for
        OK."""
        with self._lock:
            if self._sock is None:
                self._connect()
                return self._query_once(sql)
            try:
                return self._query_once(sql)
            except (OSError, MysqlConnectionError):
                self.close_nolock()
                self._connect()
                return self._query_once(sql)

    def _parse_ok(self, pkt: bytes) -> int:
        """OK packet: affected rows; tracks the server status flags
        (sql_mode changes like NO_BACKSLASH_ESCAPES ride here)."""
        affected, pos = self._lenenc(pkt, 1)
        _, pos = self._lenenc(pkt, pos)  # last insert id
        if pos + 2 <= len(pkt):
            self.status = int.from_bytes(pkt[pos:pos + 2], "little")
        return affected

    def _query_once(self, sql: str):
        self._seq = 0
        self._send_packet(b"\x03" + sql.encode())
        pkt = self._recv_packet()
        if pkt[:1] == b"\xff":
            raise MysqlError(self._err_text(pkt))
        if pkt[:1] == b"\x00":
            return self._parse_ok(pkt)
        ncols, _ = self._lenenc(pkt, 0)
        for _ in range(ncols):
            self._recv_packet()  # column definitions (unused)
        self._eof()
        rows = []
        while True:
            pkt = self._recv_packet()
            if pkt[:1] == b"\xfe" and len(pkt) < 9:
                break
            if pkt[:1] == b"\xff":
                raise MysqlError(self._err_text(pkt))
            row, pos = [], 0
            for _ in range(ncols):
                n, pos = self._lenenc(pkt, pos)
                if n is None:
                    row.append(None)
                else:
                    row.append(pkt[pos:pos + n])
                    pos += n
            rows.append(tuple(row))
        return rows

    def _eof(self):
        pkt = self._recv_packet()
        if not (pkt[:1] == b"\xfe" and len(pkt) < 9):
            raise MysqlError(f"expected EOF, got {pkt[:1]!r}")

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
class MysqlStore(FilerStore):
    """`-store mysql -mysqlAddr host:port -mysqlUser .. -mysqlPassword
    .. -mysqlDatabase ..` — the 5th real backend in the store matrix."""

    name = "mysql"

    CREATE = ("CREATE TABLE IF NOT EXISTS filemeta ("
              "dirhash BIGINT, name VARCHAR(1000), directory TEXT, "
              "meta LONGBLOB, PRIMARY KEY (dirhash, name), "
              # recursive deletes predicate on directory; without a
              # prefix index they would full-scan (and row-lock) the
              # whole table
              "KEY directory_prefix (directory(255)))")

    def initialize(self, addr: str = "127.0.0.1:3306", user: str = "root",
                   password: str = "", database: str = "seaweedfs",
                   timeout: float = 10.0, **options):
        host, _, port = addr.rpartition(":")
        host = host.strip("[]")
        if not host or not port.isdigit():
            raise ValueError(f"bad mysql addr {addr!r}: want host:port")
        self._client = MysqlClient(host, int(port), user, password,
                                   database, timeout=timeout)
        self._client.query(self.CREATE)  # fail fast on a bad endpoint

    # -- sql shaping -------------------------------------------------------

    @staticmethod
    def _split(full_path: str) -> Tuple[int, str, str]:
        d = posixpath.dirname(full_path) or "/"
        return hash_string_to_long(d), posixpath.basename(full_path), d

    def _upsert(self, entry: Entry):
        dirhash, name, d = self._split(entry.full_path)
        meta = entry.encode()
        esc = self._client.escape
        self._client.query(
            "INSERT INTO filemeta (dirhash,name,directory,meta) VALUES "
            f"({dirhash},'{esc(name)}',"
            f"'{esc(d)}',X'{meta.hex()}') "
            "ON DUPLICATE KEY UPDATE directory=VALUES(directory),"
            "meta=VALUES(meta)")

    # -- FilerStore --------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        self._upsert(entry)

    def update_entry(self, entry: Entry) -> None:
        # upsert like every other store here (the reference's UPDATE
        # would silently no-op for a missing row)
        self._upsert(entry)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        dirhash, name, d = self._split(full_path)
        esc = self._client.escape
        rows = self._client.query(
            "SELECT meta FROM filemeta WHERE "
            f"dirhash={dirhash} AND name='{esc(name)}' "
            f"AND directory='{esc(d)}'")
        if not rows or rows[0][0] is None:
            return None
        return Entry.decode(full_path, rows[0][0])

    def delete_entry(self, full_path: str) -> None:
        dirhash, name, d = self._split(full_path)
        esc = self._client.escape
        self._client.query(
            "DELETE FROM filemeta WHERE "
            f"dirhash={dirhash} AND name='{esc(name)}' "
            f"AND directory='{esc(d)}'")

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        esc = self._client.escape(base)
        # LIKE-level escaping FIRST (backslash, %, _ are pattern
        # metacharacters), THEN string-literal escaping — a path
        # containing a backslash would otherwise match (and delete)
        # an unrelated subtree
        like_raw = base.rstrip("/")
        like_raw = like_raw.replace("\\", "\\\\") \
            .replace("%", "\\%").replace("_", "\\_")
        like = self._client.escape(like_raw)
        self._client.query(
            "DELETE FROM filemeta WHERE "
            f"directory='{esc}' OR directory LIKE '{like}/%'")

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        d = dir_path.rstrip("/") or "/"
        dirhash = hash_string_to_long(d)
        op = ">=" if inclusive else ">"
        esc = self._client.escape
        rows = self._client.query(
            "SELECT name, meta FROM filemeta WHERE "
            f"dirhash={dirhash} AND name{op}"
            f"'{esc(start_file_name)}' "
            f"AND directory='{esc(d)}' "
            f"ORDER BY name ASC LIMIT {int(limit)}")
        base = d.rstrip("/")
        return [Entry.decode(f"{base}/{name.decode()}", meta)
                for name, meta in rows if meta is not None]

    def close(self):
        self._client.close()
