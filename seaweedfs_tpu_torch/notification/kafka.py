"""A produce-only Kafka client over the binary protocol: the JAX
package's ``notification/kafka.py`` (reference
weed/notification/kafka/kafka_queue.go, which uses sarama). It keeps its
own CRC32-C for record batches.

Version negotiation (KIP-35): on the first use of each broker
connection the client sends ApiVersions v0 and intersects the broker's
advertised [min,max] per api with what it speaks — Metadata v0 or v4,
Produce v0 (message-format-v0 sets) or v3 (record-batch v2 with
crc32c + varints). Classic brokers (<= 3.x, Redpanda) get the v0
forms; KIP-896 brokers (Kafka 4.x, which REMOVED Produce v0-v2) get
v3. No overlap fails loudly and permanently — silently "retrying" an
unsupported version can never succeed. A broker so old it resets on
ApiVersions itself is assumed v0-only, like sarama's fallback.

Wire shapes (big-endian):
  frame    = int32 size | payload
  request  = int16 api_key | int16 api_version | int32 correlation_id
           | STRING client_id | body
  response = int32 correlation_id | body
  STRING   = int16 len | bytes          (-1 = null)
  BYTES    = int32 len | bytes          (-1 = null)
  message  = int64 offset | int32 size | uint32 crc | int8 magic(0)
           | int8 attrs(0) | BYTES key | BYTES value
  batch(v2)= int64 baseOffset | int32 batchLen | int32 leaderEpoch(-1)
           | int8 magic(2) | uint32 crc32c | int16 attrs
           | int32 lastOffsetDelta | int64 baseTs | int64 maxTs
           | int64 producerId(-1) | int16 producerEpoch(-1)
           | int32 baseSeq(-1) | int32 count | records
  record   = varint len | int8 attrs | varint tsDelta | varint offDelta
           | varint keyLen | key | varint valLen | val | varint headers
"""

from __future__ import annotations

import socket
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple
from ..util import config
from ..util.locks import make_lock

API_PRODUCE = 0
API_METADATA = 3
API_VERSIONS = 18

ERR_UNSUPPORTED_VERSION = 35

# error codes that a metadata refresh + retry can fix
_RETRIABLE = {3, 5, 6, 7}  # unknown topic/partition, leader not
# available, not leader for partition, request timed out


class KafkaError(Exception):
    """retriable=False marks permanent broker verdicts (e.g.
    MESSAGE_TOO_LARGE) that re-sending the same payload can never fix —
    send() propagates those immediately instead of burning retries."""

    def __init__(self, msg: str, retriable: bool = True):
        super().__init__(msg)
        self.retriable = retriable


def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    """Cursor over a response payload."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise KafkaError("short response")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode()


def encode_message_set(pairs: List[Tuple[Optional[bytes], bytes]]) -> bytes:
    """Message-format-v0 set: one (key, value) message per pair."""
    out = []
    for key, value in pairs:
        body = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        msg = struct.pack(">I", crc) + body
        out.append(struct.pack(">qi", 0, len(msg)) + msg)
    return b"".join(out)


# -- record-batch v2 (Produce >= v3) -----------------------------------------

_CRC32C_TABLE = []


def _crc32c(data: bytes) -> int:
    """Castagnoli CRC (record-batch v2 checksums use it, not CRC-32)."""
    if not _CRC32C_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC32C_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _varint(n: int) -> bytes:
    """Zigzag varint (protobuf-style), as records use."""
    z = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, new_pos) — exported for the test broker's decoder."""
    shift = z = 0
    while True:
        b = buf[pos]
        pos += 1
        z |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (z >> 1) ^ -(z & 1), pos


def encode_record_batch(pairs: List[Tuple[Optional[bytes], bytes]],
                        ts_ms: int) -> bytes:
    """Message-format-v2 batch (the only format Produce v3+ accepts)."""
    records = []
    for i, (key, value) in enumerate(pairs):
        body = bytearray(b"\x00")                    # record attributes
        body += _varint(0)                           # timestamp delta
        body += _varint(i)                           # offset delta
        if key is None:
            body += _varint(-1)
        else:
            body += _varint(len(key)) + key
        body += _varint(len(value)) + value
        body += _varint(0)                           # no headers
        records.append(_varint(len(body)) + bytes(body))
    recs = b"".join(records)
    # attributes .. records — the crc32c covers exactly this span
    tail = (struct.pack(">hiqqqhii", 0, len(pairs) - 1, ts_ms, ts_ms,
                        -1, -1, -1, len(pairs)) + recs)
    head = struct.pack(">ib", -1, 2)  # partitionLeaderEpoch, magic
    inner = head + struct.pack(">I", _crc32c(tail)) + tail
    return struct.pack(">qi", 0, len(inner)) + inner


class KafkaProducer:
    """Produce-only client: leader discovery, per-key partitioning,
    retry with metadata refresh on retriable errors."""

    def __init__(self, bootstrap: str, client_id: str = "seaweedfs",
                 timeout: float = 10.0, acks: int = 1, retries: int = 3):
        # bootstrap: "host:port" or comma-separated list
        self.seeds = []
        for hp in bootstrap.split(","):
            hp = hp.strip()
            if not hp:
                continue
            host, _, port = hp.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"bad kafka bootstrap entry {hp!r}: want host:port")
            self.seeds.append((host, int(port)))
        if not self.seeds:
            raise ValueError("kafka producer needs bootstrap host:port")
        self.client_id = client_id
        self.timeout = float(timeout)
        self.acks = int(acks)
        self.retries = max(1, int(retries))
        self._corr = 0
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        # broker -> {api_key: (min, max)} from the ApiVersions probe
        self._api_ranges: Dict[Tuple[str, int],
                               Dict[int, Tuple[int, int]]] = {}
        # topic -> {partition: (host, port)} (leaderless partitions absent)
        self._leaders: Dict[str, Dict[int, Tuple[str, int]]] = {}
        # topic -> total partition count (incl. leaderless — the key->
        # partition mapping must be stable across leader elections)
        self._npartitions: Dict[str, int] = {}
        self._lock = make_lock("torch.kafka._lock")

    # -- transport --------------------------------------------------------

    def _conn(self, addr: Tuple[str, int]) -> socket.socket:
        sock = self._conns.get(addr)
        if sock is not None:
            return sock
        sock = socket.create_connection(addr, timeout=self.timeout)
        sock.settimeout(self.timeout)
        self._conns[addr] = sock
        if addr not in self._api_ranges:
            self._probe_versions(addr, sock)
        # the probe's legacy fallback may have replaced the socket
        return self._conns[addr]

    def _probe_versions(self, addr: Tuple[str, int],
                        sock: socket.socket):
        """ApiVersions v0 handshake (KIP-35): learn the broker's
        [min,max] per api before speaking anything else. A broker so
        ancient it drops the probe is assumed v0-only (sarama's
        fallback for pre-0.10 brokers)."""
        self._corr += 1
        corr = self._corr
        frame = struct.pack(">hhi", API_VERSIONS, 0, corr) + \
            _str(self.client_id)
        try:
            sock.sendall(struct.pack(">i", len(frame)) + frame)
            (size,) = struct.unpack(">i", self._recv_exact(sock, 4))
            payload = self._recv_exact(sock, size) if 4 <= size <= 1 << 20 \
                else None
        except OSError:
            # TRANSPORT failure only: a pre-KIP-35 broker severs on the
            # probe — reconnect and speak the classic v0 protocol. The
            # cache entry dies with the connection (_drop_conn), so a
            # transient hiccup against a modern broker re-probes on the
            # next reconnect instead of pinning it to v0. The v0 pin is
            # written only AFTER the reconnect succeeds — a failed
            # reconnect must leave no cache for the next attempt to
            # skip the probe on.
            self._drop_conn(addr)
            sock = socket.create_connection(addr, timeout=self.timeout)
            sock.settimeout(self.timeout)
            self._conns[addr] = sock
            self._api_ranges[addr] = {API_PRODUCE: (0, 0),
                                      API_METADATA: (0, 0)}
            return
        # a broker that ANSWERED but with garbage or an explicit
        # non-35 error is not a legacy broker — diagnose loudly,
        # permanently (guessing v0 would just retry-loop into severed
        # connections with a misleading error)
        if payload is None:
            self._drop_conn(addr)
            raise KafkaError(f"bad ApiVersions response size {size}",
                             retriable=False)
        r = _Reader(payload)
        if r.i32() != corr:
            self._drop_conn(addr)
            raise KafkaError("ApiVersions correlation mismatch",
                             retriable=False)
        err = r.i16()
        ranges: Dict[int, Tuple[int, int]] = {}
        for _ in range(r.i32()):
            api, lo, hi = r.i16(), r.i16(), r.i16()
            ranges[api] = (lo, hi)
        # KIP-511: err 35 still carries the supported table
        if (err and err != ERR_UNSUPPORTED_VERSION) or not ranges:
            self._drop_conn(addr)
            raise KafkaError(
                f"ApiVersions error {err}, {len(ranges)} entries",
                retriable=False)
        self._api_ranges[addr] = ranges

    # versions this client can speak, best first
    _SUPPORTED = {API_PRODUCE: (3, 0), API_METADATA: (4, 0)}

    def _pick_version(self, addr: Tuple[str, int], api_key: int) -> int:
        """Best mutually-supported version, or a LOUD permanent error —
        an unsupported version can never start working on retry."""
        lo, hi = self._api_ranges.get(addr, {}).get(api_key, (0, 0))
        for cand in self._SUPPORTED[api_key]:
            if lo <= cand <= hi:
                return cand
        raise KafkaError(
            f"no overlapping version for api {api_key}: broker "
            f"{addr[0]}:{addr[1]} supports [{lo},{hi}], client speaks "
            f"{sorted(self._SUPPORTED[api_key])}", retriable=False)

    def _drop_conn(self, addr: Tuple[str, int]):
        sock = self._conns.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        # version knowledge is per-connection: a fallback cached off a
        # TRANSIENT failure must not pin a modern broker to v0 forever,
        # so the next reconnect re-probes (one extra roundtrip)
        self._api_ranges.pop(addr, None)

    def _call(self, addr: Tuple[str, int], api_key: int, body: bytes,
              expect_response: bool = True,
              version: int = 0) -> Optional[_Reader]:
        self._corr += 1
        corr = self._corr
        header = struct.pack(">hhi", api_key, version, corr) + \
            _str(self.client_id)
        frame = header + body
        sock = self._conn(addr)
        try:
            sock.sendall(struct.pack(">i", len(frame)) + frame)
            if not expect_response:
                # produce with acks=0: the broker sends nothing back
                return None
            raw = self._recv_exact(sock, 4)
            (size,) = struct.unpack(">i", raw)
            if size < 4 or size > 64 << 20:
                raise KafkaError(f"bad response size {size}")
            payload = self._recv_exact(sock, size)
        except (OSError, KafkaError):
            self._drop_conn(addr)
            raise
        r = _Reader(payload)
        got = r.i32()
        if got != corr:
            self._drop_conn(addr)
            raise KafkaError(f"correlation mismatch {got} != {corr}")
        return r

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        chunks = []
        while n:
            c = sock.recv(n)
            if not c:
                # a TRANSPORT condition, not a protocol verdict: the
                # ApiVersions probe's legacy-broker fallback and the
                # retry loop both key on OSError for torn connections
                raise ConnectionError("connection closed by broker")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    # -- metadata ---------------------------------------------------------

    def _refresh_metadata(self, topic: str):
        last: Exception = KafkaError("no seed brokers")
        for addr in self.seeds:
            try:
                self._conn(addr)  # ensures the ApiVersions probe ran
                ver = self._pick_version(addr, API_METADATA)
                body = struct.pack(">i", 1) + _str(topic)
                if ver >= 4:
                    body += struct.pack(">b", 1)  # allow auto-create
                r = self._call(addr, API_METADATA, body, version=ver)
            except (OSError, KafkaError) as e:
                if isinstance(e, KafkaError) and not e.retriable:
                    raise
                last = e
                continue
            if ver >= 3:
                r.i32()  # throttle_time_ms
            brokers: Dict[int, Tuple[str, int]] = {}
            for _ in range(r.i32()):
                node = r.i32()
                host = r.string() or ""
                port = r.i32()
                if ver >= 1:
                    r.string()  # rack
                brokers[node] = (host, port)
            if ver >= 2:
                r.string()  # cluster_id
            if ver >= 1:
                r.i32()  # controller_id
            leaders: Dict[int, Tuple[str, int]] = {}
            topic_err = 0
            total = 0
            for _ in range(r.i32()):
                terr = r.i16()
                tname = r.string()
                if ver >= 1:
                    r._take(1)  # is_internal
                parts = {}
                nparts = r.i32()
                for _ in range(nparts):
                    perr = r.i16()
                    pid = r.i32()
                    leader = r.i32()
                    for _ in range(r.i32()):  # replicas
                        r.i32()
                    for _ in range(r.i32()):  # isr
                        r.i32()
                    if ver >= 5:
                        for _ in range(r.i32()):  # offline replicas
                            r.i32()
                    if perr in (0, 9) and leader in brokers:
                        # 9 = replica-not-available: leader still usable
                        parts[pid] = brokers[leader]
                if tname == topic:
                    topic_err = terr
                    leaders = parts
                    total = nparts
            if topic_err not in (0, 5) and not leaders:
                raise KafkaError(f"topic {topic!r}: broker error "
                                 f"{topic_err}")
            if leaders:
                self._leaders[topic] = leaders
                self._npartitions[topic] = total
                return
            last = KafkaError(f"no leaders for topic {topic!r}")
        raise last

    def _leader_for(self, topic: str, key: Optional[bytes]
                    ) -> Tuple[int, Tuple[str, int]]:
        parts = self._leaders.get(topic)
        if not parts:
            self._refresh_metadata(topic)
            parts = self._leaders.get(topic) or {}
        if not parts:
            raise KafkaError(f"no partitions for topic {topic!r}")
        total = self._npartitions.get(topic, len(parts))
        if key is None:
            # keyless: any currently-led partition will do
            pids = sorted(parts)
            pid = pids[int(time.monotonic() * 1000) % len(pids)]
        else:
            # keyed: hash over the TOTAL partition count so the key->
            # partition mapping (and per-key ordering) is stable across
            # leader elections; a leaderless target is a retriable
            # condition, not a remap (sarama's hash partitioner errors
            # the same way)
            pid = zlib.crc32(key) % total
            if pid not in parts:
                raise KafkaError(
                    f"partition {pid} of {topic!r} has no leader")
        return pid, parts[pid]

    # -- produce ----------------------------------------------------------

    def send(self, topic: str, key: Optional[bytes], value: bytes) -> int:
        """Publish one message; returns the broker-assigned base offset
        (-1 with acks=0). Retries with a metadata refresh on leadership
        errors — at-least-once, like the reference's sarama config."""
        last: Exception = KafkaError("unreachable")
        for attempt in range(self.retries):
            try:
                # the lock covers one wire attempt (socket + leader
                # cache); the backoff sleep happens OUTSIDE it so a
                # flapping leader can't stall every other producer
                # thread for the whole retry schedule
                with self._lock:
                    return self._send_once(topic, key, value)
            except (OSError, KafkaError) as e:
                if isinstance(e, KafkaError) and not e.retriable:
                    raise  # permanent verdict: retrying can't help
                last = e
                with self._lock:
                    self._leaders.pop(topic, None)
                if attempt + 1 < self.retries:
                    time.sleep(config.retry_backoff_s(
                        min(0.1 * (2 ** attempt), 1.0)))
        raise KafkaError(
            f"produce to {topic!r} failed after {self.retries} "
            f"attempts: {last}")

    def _send_once(self, topic: str, key: Optional[bytes],
                   value: bytes) -> int:
        pid, addr = self._leader_for(topic, key)
        self._conn(addr)  # ensures the ApiVersions probe ran
        ver = self._pick_version(addr, API_PRODUCE)
        if ver >= 3:
            recs = encode_record_batch([(key, value)],
                                       int(time.time() * 1000))
            body = _str(None)  # transactional_id
        else:
            recs = encode_message_set([(key, value)])
            body = b""
        body += (struct.pack(">hi", self.acks, int(self.timeout * 1000))
                 + struct.pack(">i", 1) + _str(topic)
                 + struct.pack(">i", 1)
                 + struct.pack(">i", pid) + struct.pack(">i", len(recs))
                 + recs)
        r = self._call(addr, API_PRODUCE, body,
                       expect_response=self.acks != 0, version=ver)
        if self.acks == 0:
            return -1
        for _ in range(r.i32()):
            r.string()  # topic name
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                offset = r.i64()
                if err:
                    if err in _RETRIABLE:
                        raise KafkaError(f"retriable broker error {err}")
                    raise KafkaError(
                        f"produce failed: broker error {err}",
                        retriable=False)
                return offset
        raise KafkaError("empty produce response")

    def close(self):
        with self._lock:
            for addr in list(self._conns):
                self._drop_conn(addr)
