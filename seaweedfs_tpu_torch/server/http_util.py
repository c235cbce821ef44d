"""Tiny stdlib HTTP server framework and the pooled cluster client.

The JAX package's ``server/http_util.py``, in the parts the data and EC
routes, the remote shard readers and the spread's shard writers use:
exact-path routing with a fallback on a ThreadingHTTPServer, request
bodies (``Content-Length`` or chunked, ``Request.json``, the first file
of a multipart upload or a raw body: ``Request.upload_payload``), JSON
and bytes responses (``Response``, with a streamed file range),
``parse_range``, a keep-alive connection pool behind ``http_call`` /
``http_get_with_headers`` (a GET or HEAD follows redirects, and a 307 or
308 keeps a replayable body), ``get_json``, ``post_json``,
``post_multipart`` (``post_multipart_file`` streams a file object's),
``post_chunked``, which streams a body of unknown size on a fresh
connection, and ``pull_file``, a volume server's file
copied in ranged pulls.

A router's ``before`` hook runs ahead of every route (the whitelist
guard). Every request runs inside a server span (``util/tracing``) that
continues the caller's ``traceparent``, stamped with the router's
``node``, and its ``observe(label, seconds, ok)`` hook feeds the
servers' request metrics; every pooled call sends the current span's
``traceparent`` (or a fresh root's). The shared handlers of every server
role: ``traces_handler`` (``/admin/traces``), ``traces_export_handler``
(``/admin/traces/export``), ``profile_handler`` (``POST /admin/profile``)
and ``process_memory_stats`` (``/stats/memory``); the pool's churn
counts (``pool_stats_snapshot``) feed ``/metrics``. The port reads no
knob from the environment: the accept-loop poll, the pool's idle cap and
the profile's longest window are module constants.

Transport security, as in JAX (reference weed/security/tls.go): one
process-wide configuration, ``configure_tls(cert, key, ca, mutual)``.
Every ``HttpServer`` made after it serves TLS with cert and key, and
every cluster call rewrites ``http://`` to ``https://`` (redirect
targets too) and verifies the server against ``ca`` (or the cert
itself), presenting cert and key as its own identity. With ``mutual``
the server asks each connection for a certificate the CA signed: one it
cannot verify fails the handshake, and ``require_client_cert`` answers
403 on the cluster-internal routes to a connection that presented none,
while the public routes stay server-TLS on the same listener.
``reset_tls`` turns it off; both drop the pooled connections. A call
with ``external=True`` keeps its URL's scheme and verifies https with
the default context. The handshake runs on the connection's own
thread, with a deadline (the JAX server runs it in its accept loop, so
a client that connects and sends nothing stalls every other
connection).
"""

from __future__ import annotations

import http.client as _httpc
import io
import json
import os
import re
import select
import socket
import ssl
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from ..util import tracing
from ..util.locks import make_lock

#: Accept-loop poll of ``HttpServer``: bounds how long ``stop()`` waits
#: for the loop (the JAX SW_HTTP_POLL_S is 0.5; its tests set 0.02).
POLL_S = 0.05
#: A pooled idle connection older than this is closed, not reused (the
#: JAX SW_HTTP_POOL_MAX_IDLE_S default).
POOL_MAX_IDLE_S = 60.0
_POOL_MAX_PER_HOST = 32
#: Longest ``POST /admin/profile`` window, seconds (SW_PROFILE_MAX_S).
PROFILE_MAX_S = 30.0
#: A TLS handshake that has not finished by then closes its connection.
HANDSHAKE_TIMEOUT_S = 10.0


class HttpError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(message)
        self.status = status
        self.message = message


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler):
        self.handler = handler
        parsed = urllib.parse.urlparse(handler.path)
        self.path = parsed.path
        self.raw_query = parsed.query
        self.query: Dict[str, str] = {
            k: v[0] for k, v in
            urllib.parse.parse_qs(parsed.query,
                                  keep_blank_values=True).items()}
        self.method = handler.command
        self.headers = handler.headers
        self._body: Optional[bytes] = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            if self._chunked():
                self._body = self._read_chunked()
                return self._body
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            if length < 0:
                # malformed or negative: the framing is unknowable, so
                # refuse and sever rather than read until EOF
                self.handler.close_connection = True
                self._body = b""
                raise HttpError(400, "bad Content-Length header")
            self._body = self.handler.rfile.read(length) if length else b""
        return self._body

    def _chunked(self) -> bool:
        return "chunked" in \
            (self.headers.get("Transfer-Encoding") or "").lower()

    def _read_chunked(self) -> bytes:
        """Decode a chunked transfer-encoded body (what ``post_chunked``
        sends). Any framing violation severs the connection: a kept-alive
        stream cannot be resynchronized after a bad chunk header."""
        rfile = self.handler.rfile
        out: List[bytes] = []
        while True:
            line = rfile.readline(1 << 16)
            if not line or not line.endswith(b"\n"):
                self.handler.close_connection = True
                raise HttpError(400, "truncated chunked body")
            size_s = line.split(b";", 1)[0].strip()
            try:
                size = int(size_s, 16)
            except ValueError:
                self.handler.close_connection = True
                raise HttpError(400, "bad chunk size") from None
            if size == 0:
                # consume optional trailers up to the blank line
                while True:
                    t = rfile.readline(1 << 16)
                    if t in (b"\r\n", b"\n", b""):
                        break
                return b"".join(out)
            data = rfile.read(size)
            if len(data) != size:
                self.handler.close_connection = True
                raise HttpError(400, "truncated chunk")
            out.append(data)
            rfile.read(2)  # the chunk's terminating CRLF

    def drain(self, cap: int = 4 << 20):
        """Discard any unread request body, so it cannot prepend itself
        to the next request on the kept-alive connection. Past ``cap``,
        or with an unread chunked or malformed body, close the
        connection instead: reading a rejected volume-sized upload to
        its end would stall the thread for the whole transfer."""
        if self._body is not None:
            return
        if self._chunked():
            # an unread chunked body's size is unknowable up front
            self.handler.close_connection = True
            self._body = b""
            return
        try:
            left = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.handler.close_connection = True
            self._body = b""
            return
        if left > cap:
            self.handler.close_connection = True
            self._body = b""
            return
        while left > 0:
            chunk = self.handler.rfile.read(min(left, 1 << 20))
            if not chunk:
                break
            left -= len(chunk)
        self._body = b""

    def json(self) -> dict:
        if not self.body:
            return {}
        return json.loads(self.body)

    def multipart_file(self) -> Optional[Tuple[str, str, bytes]]:
        """(filename, content type, data) of the first file part of a
        multipart/form-data body, or None."""
        ctype = self.headers.get("Content-Type", "")
        if not ctype.startswith("multipart/form-data"):
            return None
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return None
        for part in self.body.split(b"--" + m.group(1).encode()):
            # an inner part is b"\r\n<headers>\r\n\r\n<data>\r\n": one
            # CRLF comes off each side, since data may begin or end with
            # newline bytes of its own
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if not part or part in (b"--", b"--\r\n") or \
                    b"\r\n\r\n" not in part:
                continue
            head, data = part.split(b"\r\n\r\n", 1)
            head_s = head.decode("utf-8", "replace")
            fn = re.search(r'filename="((?:[^"\\]|\\.)*)"', head_s)
            ct = re.search(r"Content-Type:\s*([^\r\n]+)", head_s, re.I)
            if fn is not None:
                name = fn.group(1).replace('\\"', '"') \
                    .replace("\\\\", "\\")
                return name, ct.group(1).strip() if ct else "", data
        return None

    def upload_payload(self) -> Tuple[str, str, bytes]:
        """(filename, content type, data) of a multipart upload, else of
        the raw body (the reference takes both)."""
        mp = self.multipart_file()
        if mp is not None:
            return mp
        return "", self.headers.get("Content-Type", ""), self.body


def traces_handler(req: Request) -> dict:
    """JSON view of the in-process trace ring, shared by every server
    role: ``/admin/traces?n=20`` for the newest traces, or
    ``/admin/traces?trace=<id>`` for one trace's spans."""
    tid = req.query.get("trace")
    if tid:
        return {"trace_id": tid, "spans": tracing.RING.get(tid)}
    n = int(req.query.get("n", "20"))
    return {"traces": tracing.RING.recent(n)}


def traces_export_handler(req: Request) -> dict:
    """Chrome trace-event JSON for one trace from this node's ring
    (``/admin/traces/export?trace=<id>``): loadable in Perfetto as it
    is, and carrying in its event args what shell ``trace.export`` needs
    to merge several nodes' exports into one skew-normalized timeline."""
    from ..util import trace_export
    tid = req.query.get("trace")
    if not tid:
        raise HttpError(400, "trace query parameter required")
    return trace_export.chrome_trace_events(tracing.RING.get(tid))


# one profile at a time a process: concurrent samplers would double the
# stack-walk overhead and interleave their counts
_PROFILE_LOCK = make_lock("torch.http_util._profile_lock")


def profile_handler(req: Request) -> "Response":
    """On-demand all-thread sampling profile, shared by every server
    role: ``POST /admin/profile?seconds=N`` samples for N seconds
    (at most ``PROFILE_MAX_S``) and answers the collapsed stacks as
    text/plain, the folded format flamegraph.pl and speedscope read. A
    request while one runs answers 409."""
    from ..util.profiling import SamplingProfiler
    try:
        seconds = float(req.query.get("seconds", "2"))
    except ValueError:
        raise HttpError(400, "seconds must be a number")
    if seconds <= 0:
        raise HttpError(400, "seconds must be > 0")
    seconds = min(seconds, PROFILE_MAX_S)
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise HttpError(409, "a profile is already running")
    try:
        folded = SamplingProfiler.run_for(seconds)
    finally:
        _PROFILE_LOCK.release()
    return Response(folded.encode("utf-8"), 200,
                    "text/plain; charset=utf-8")


def process_memory_stats() -> dict:
    """Peak RSS of this process (reference statsMemoryHandler);
    ru_maxrss is kilobytes on Linux, bytes on macOS."""
    import resource
    import sys
    ru = resource.getrusage(resource.RUSAGE_SELF)
    kb = ru.ru_maxrss // 1024 if sys.platform == "darwin" \
        else ru.ru_maxrss
    return {"maxrss_kb": kb}


class Router:
    """Exact-path routes; a request no route takes goes to the fallback
    (the volume server's ``/<fid>`` data routes), else answers 404.
    ``before(req)``, when set, runs ahead of every route and may raise
    HttpError (the servers' whitelist guard). Each request runs in a
    server span named by its route's label (``"<METHOD> <path>"``,
    ``"<METHOD> data"`` for the fallback), which continues an incoming
    ``traceparent`` and carries ``node`` (the owning server's
    host:port, set once its port is known); ``observe(label, seconds,
    ok)`` runs after every request, the span still current."""

    def __init__(self):
        self.routes: List[Tuple[str, str, Callable]] = []
        self.fallback: Optional[Callable] = None
        self.before: Optional[Callable] = None
        self.observe: Optional[Callable] = None
        self.node: Optional[str] = None

    def add(self, method: str, path: str, fn: Callable):
        self.routes.append((method, path, fn))

    def set_fallback(self, fn: Callable):
        self.fallback = fn

    def dispatch(self, req: Request):
        # the span becomes the handler thread's current span, so spans
        # made inside the handler (EC phases, peer fetches) link to it
        srv_span = tracing.start_span(
            f"{req.method} {req.path}",
            traceparent=req.headers.get(tracing.TRACEPARENT_HEADER))
        if self.node:
            srv_span.tags.setdefault("node", self.node)
        t0 = time.monotonic()
        label = None
        try:
            label, fn = self._route(req)
            srv_span.name = label
            out = fn(req)
            if self.observe is not None:
                self.observe(label, time.monotonic() - t0, True)
            return out
        except Exception as e:
            srv_span.tags.setdefault("error", type(e).__name__)
            if self.observe is not None:
                # the label stays low-cardinality: a raw path would mint
                # a series per fid or 404 probe
                self.observe(label or f"{req.method} unrouted",
                             time.monotonic() - t0, False)
            raise
        finally:
            tracing.finish_span(srv_span)

    def _route(self, req: Request):
        """(metric label, handler) of a request; raises 404."""
        if self.before is not None:
            self.before(req)
        for method, path, fn in self.routes:
            if method in ("*", req.method) and req.path == path:
                return f"{method} {path}", fn
        if self.fallback is not None:
            return f"{req.method} data", self.fallback
        raise HttpError(404, f"no route for {req.method} {req.path}")


class Response:
    """Non-JSON response: bytes, or ``body_range`` (offset, size) of the
    file at ``body_path`` streamed without buffering it.
    ``content_length`` overrides the advertised length of a bytes body:
    a HEAD advertises the size a GET would send, and sends none."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[dict] = None,
                 body_path: Optional[str] = None,
                 body_range: Optional[tuple] = None,
                 content_length: Optional[int] = None):
        self.body = body
        self.content_length = content_length
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}
        self.body_path = body_path
        self.body_range = body_range

    def send(self, handler: BaseHTTPRequestHandler):
        src = None
        if self.body_path is not None:
            # open and size the file before any header goes out, so a
            # vanished file is a clean error and Content-Length is what
            # the stream can deliver
            try:
                src = open(self.body_path, "rb")
                file_size = os.fstat(src.fileno()).st_size
            except OSError as e:
                if src is not None:
                    src.close()
                handler.send_error(404, str(e))
                return
            off, size = self.body_range or (0, file_size)
            off = min(off, file_size)
            length = size = min(size, file_size - off)
        else:
            length = len(self.body) if self.content_length is None \
                else self.content_length
        try:
            handler.send_response(self.status)
            handler.send_header("Content-Type", self.content_type)
            handler.send_header("Content-Length", str(length))
            for k, v in self.headers.items():
                handler.send_header(k, v)
            handler.end_headers()
            if handler.command == "HEAD":
                return
            if src is not None:
                src.seek(off)
                left = size
                while left > 0:
                    chunk = src.read(min(1 << 20, left))
                    if not chunk:
                        break
                    handler.wfile.write(chunk)
                    left -= len(chunk)
            else:
                handler.wfile.write(self.body)
        except OSError:  # the peer went away mid-response
            pass
        finally:
            if src is not None:
                src.close()


def _make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body go out in separate writes; without NODELAY,
        # Nagle holds the second behind the peer's delayed ACK
        disable_nagle_algorithm = True
        # reap idle keep-alive connections, each of which pins a thread
        timeout = 75

        def log_message(self, fmt, *args):  # quiet
            pass

        def _run(self):
            req = Request(self)
            try:
                try:
                    result = router.dispatch(req)
                finally:
                    req.drain()
            except HttpError as e:
                self._send_json({"error": e.message or str(e)}, e.status)
                return
            except BrokenPipeError:
                return
            except Exception as e:  # noqa: BLE001 - answered as a 500
                self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)
                return
            if isinstance(result, Response):
                result.send(self)
            else:
                self._send_json({} if result is None else result, 200)

        def _send_json(self, obj, status: int):
            data = json.dumps(obj).encode()
            try:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except (BrokenPipeError, ConnectionResetError):
                pass

        do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _run
        # the WebDAV gateway's verbs
        do_OPTIONS = do_PROPFIND = do_PROPPATCH = do_MKCOL = _run
        do_MOVE = do_COPY = do_LOCK = do_UNLOCK = _run

    return Handler


# -- transport security ------------------------------------------------------

_TLS = {"client_ctx": None, "server_ctx": None, "mutual": False}


def configure_tls(cert_file: str = "", key_file: str = "",
                  ca_file: str = "", mutual: bool = False):
    """TLS for this process: servers present ``cert_file`` and
    ``key_file``; clients verify servers against ``ca_file`` (or the cert
    itself, self-signed) and present the same pair. A cert without its
    key, or the reverse, is refused (it would serve plain HTTP while the
    clients speak https); ``mutual`` needs a CA to verify clients
    against."""
    clear_conn_pool()  # their contexts are the previous configuration's
    if bool(cert_file) != bool(key_file):
        raise ValueError("TLS needs BOTH cert and key (got only one); "
                         "pass just ca for a client-only configuration")
    if mutual and not ca_file:
        raise ValueError("mutual TLS needs a CA to verify client "
                         "certificates against")
    _TLS["mutual"] = bool(mutual)
    if cert_file and key_file:
        sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        sctx.load_cert_chain(cert_file, key_file)
        if mutual:
            # optional at the handshake, required by route: a cert the
            # CA did not sign still fails the handshake
            sctx.verify_mode = ssl.CERT_OPTIONAL
            sctx.load_verify_locations(ca_file)
        _TLS["server_ctx"] = sctx
    cctx = ssl.create_default_context(cafile=ca_file or cert_file or None)
    cctx.check_hostname = False  # peers are addressed by ip:port
    if cert_file and key_file:
        cctx.load_cert_chain(cert_file, key_file)
    _TLS["client_ctx"] = cctx


def reset_tls():
    _TLS.update({"client_ctx": None, "server_ctx": None, "mutual": False})
    clear_conn_pool()


def tls_enabled() -> bool:
    return _TLS["server_ctx"] is not None


def mtls_enabled() -> bool:
    return tls_enabled() and _TLS["mutual"]


def require_client_cert(req: "Request"):
    """403 for a cluster-internal request whose connection presented no
    certificate, under mutual TLS (else nothing): the handshake already
    refused one the CA did not sign, so any peer cert here is
    verified."""
    if not mtls_enabled():
        return
    conn = req.handler.connection
    cert = conn.getpeercert() if hasattr(conn, "getpeercert") else None
    if not cert:
        raise HttpError(403, "client certificate required on "
                             "cluster-internal routes")


def _client_url(url: str) -> str:
    if _TLS["client_ctx"] is not None and url.startswith("http://"):
        return "https://" + url[len("http://"):]
    return url


class _TunedHTTPServer(ThreadingHTTPServer):
    # the stdlib backlog of 5 drops SYNs under concurrent clients
    request_queue_size = 128
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._client_socks: set = set()
        self._conn_lock = make_lock("torch.http_util._conn_lock")
        super().__init__(*args, **kwargs)

    # track live client sockets so stop() can sever keep-alive
    # connections: shutdown() only stops the accept loop
    def get_request(self):
        sock, addr = super().get_request()
        with self._conn_lock:
            self._client_socks.add(sock)
        return sock, addr

    def shutdown_request(self, request):
        with self._conn_lock:
            self._client_socks.discard(request)
        super().shutdown_request(request)

    def finish_request(self, request, client_address):
        # a TLS connection's handshake, here on its own thread: a client
        # that never finishes it holds only this thread
        if isinstance(request, ssl.SSLSocket):
            request.settimeout(HANDSHAKE_TIMEOUT_S)
            try:
                request.do_handshake()
            except OSError:  # refused, cut or timed out
                return
        super().finish_request(request, client_address)

    def close_all_connections(self):
        # shutdown only, never close(): the owning handler thread closes
        # the fd once, so a reused fd number cannot receive its bytes
        with self._conn_lock:
            socks = list(self._client_socks)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class HttpServer:
    def __init__(self, port: int, router: Router, host: str = "127.0.0.1"):
        self.router = router
        self.httpd = _TunedHTTPServer((host, port), _make_handler(router))
        if _TLS["server_ctx"] is not None:
            self.httpd.socket = _TLS["server_ctx"].wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, args=(POLL_S,),
            daemon=True, name=f"http-serve-{self.port}")
        self._thread.start()
        return self

    def stop(self):
        # shutdown() waits for serve_forever()'s ack: only when it runs
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.close_all_connections()


def parse_range(rng: str, size: int) -> Optional[Tuple[int, int]]:
    """Parse a ``bytes=a-b`` Range header against a ``size``-byte
    resource: (offset, length), or None when the header is absent or not
    a bytes range. Malformed or unsatisfiable ranges raise
    HttpError(416). Only the first range of a multi-range spec counts."""
    if not rng or not rng.startswith("bytes="):
        return None
    spec = rng[6:].split(",")[0]
    s, _, e = spec.partition("-")
    try:
        if s == "":
            offset = max(size - int(e), 0)
            length = size - offset
        else:
            offset = int(s)
            end = min(int(e), size - 1) if e else size - 1
            length = end - offset + 1
    except ValueError:
        raise HttpError(416, f"bad range {rng}") from None
    if length < 0 or (offset >= size and size > 0):
        raise HttpError(416, f"unsatisfiable range {rng}")
    return offset, length


# -- the pooled client -------------------------------------------------------
#
# Cluster calls ride keep-alive connections: a fresh TCP connection per
# range read would cap the gather at connection-churn rate. Entries are
# (conn, parked_at); the park time drives idle-age eviction.

_POOL: Dict[Tuple[str, str], List] = {}
_POOL_LOCK = make_lock("torch.http_util._POOL_LOCK")
# churn counts, mirrored into /metrics (http_pool_churn_total{event=})
POOL_STATS: Dict[str, int] = {"created": 0, "reused": 0,
                              "evicted_stale": 0, "evicted_idle": 0,
                              "evicted_overflow": 0}


def _pool_count(event: str, n: int = 1):
    with _POOL_LOCK:
        POOL_STATS[event] += n


def pool_stats_snapshot() -> Dict[str, int]:
    with _POOL_LOCK:
        return dict(POOL_STATS)
_RETRIABLE_STALE = (_httpc.RemoteDisconnected, _httpc.BadStatusLine,
                    ConnectionResetError, BrokenPipeError)


def _sock_is_stale(sock) -> bool:
    """An idle pooled socket that polls readable has a FIN (the peer
    closed it) or stray bytes: either way, not reusable."""
    try:
        r, _, _ = select.select([sock], [], [], 0)
        return bool(r)
    except (OSError, ValueError):
        return True


def _new_conn(scheme: str, netloc: str, timeout: float):
    if scheme == "https":
        return _httpc.HTTPSConnection(netloc, timeout=timeout,
                                      context=_TLS["client_ctx"])
    return _httpc.HTTPConnection(netloc, timeout=timeout)


def _pool_get(scheme: str, netloc: str, timeout: float):
    """-> (conn, reused). Newest first; entries past the idle cap or
    failing the stale check are evicted."""
    while True:
        with _POOL_LOCK:
            stack = _POOL.get((scheme, netloc))
            entry = stack.pop() if stack else None
        if entry is None:
            _pool_count("created")
            return _new_conn(scheme, netloc, timeout), False
        conn, parked_at = entry
        if time.monotonic() - parked_at > POOL_MAX_IDLE_S:
            conn.close()
            _pool_count("evicted_idle")
            continue
        if conn.sock is not None and _sock_is_stale(conn.sock):
            conn.close()
            _pool_count("evicted_stale")
            continue
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        _pool_count("reused")
        return conn, True


def _pool_put(scheme: str, netloc: str, conn):
    """Park a connection, sweeping aged entries off the bottom of the
    stack (newest-first reuse never pops them under steady load)."""
    now = time.monotonic()
    aged, overflow = [], None
    with _POOL_LOCK:
        stack = _POOL.setdefault((scheme, netloc), [])
        while stack and now - stack[0][1] > POOL_MAX_IDLE_S:
            aged.append(stack.pop(0)[0])
        if len(stack) < _POOL_MAX_PER_HOST:
            stack.append((conn, now))
        else:
            overflow = conn
        POOL_STATS["evicted_idle"] += len(aged)
        if overflow is not None:
            POOL_STATS["evicted_overflow"] += 1
    for c in aged:
        c.close()
    if overflow is not None:
        overflow.close()


def clear_conn_pool():
    """Drop every pooled connection."""
    with _POOL_LOCK:
        for stack in _POOL.values():
            for conn, _ in stack:
                conn.close()
        _POOL.clear()


def _traced_headers(headers: Optional[dict]) -> dict:
    """The W3C ``traceparent`` on a cluster call, so the receiving
    server's span continues the caller's trace (kept when the caller set
    one: a reader thread passes its span's, a redirect its own)."""
    h = dict(headers) if headers else {}
    if tracing.TRACEPARENT_HEADER not in h:
        h[tracing.TRACEPARENT_HEADER] = tracing.outbound_traceparent()
    return h


def _pooled_call(method: str, url: str, body, headers: dict,
                 timeout: float, want_headers: bool = False,
                 encode_chunked: bool = False, max_redirects: int = 5):
    headers = _traced_headers(headers)
    parsed = urllib.parse.urlsplit(url)
    scheme, netloc = parsed.scheme, parsed.netloc
    target = parsed.path or "/"
    if parsed.query:
        target += "?" + parsed.query
    # a stale kept-alive connection fails at send or first byte: retry
    # once on a fresh one, but only for idempotent methods with a
    # replayable body; a POST whose server died after acting must not
    # run twice. A streamed body cannot be re-sent at all, so it always
    # goes out on a FRESH connection (its transfer dwarfs the handshake)
    replayable = not encode_chunked and \
        (body is None or isinstance(body, (bytes, bytearray)))
    attempts = 2 if replayable and \
        method in ("GET", "HEAD", "DELETE", "PUT") else 1
    for attempt in range(attempts):
        if replayable:
            conn, reused = _pool_get(scheme, netloc, timeout)
        else:
            conn, reused = _new_conn(scheme, netloc, timeout), False
        try:
            if conn.sock is None:
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            conn.request(method, target, body=body, headers=headers,
                         encode_chunked=encode_chunked)
            resp = conn.getresponse()
            data = resp.read()
        except _RETRIABLE_STALE:
            conn.close()
            if reused and attempt + 1 < attempts:
                continue
            raise
        except Exception:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            _pool_put(scheme, netloc, conn)
        # a GET or HEAD follows a redirect (a master's /<fid>, a volume
        # server's read of a volume it does not hold); 307 and 308 keep
        # the method and a replayable body
        follow = method in ("GET", "HEAD") or \
            (resp.status in (307, 308) and replayable)
        if 300 <= resp.status < 400 and resp.getheader("Location") \
                and follow and max_redirects > 0:
            # a redirect names plain http (a volume server's read of a
            # volume held elsewhere): the cluster's scheme applies again
            loc = _client_url(urllib.parse.urljoin(
                url, resp.getheader("Location")))
            return _pooled_call(method, loc, body, headers, timeout,
                                want_headers, max_redirects=max_redirects - 1)
        if resp.status >= 400:
            detail = data.decode("utf-8", "replace")[:500]
            raise HttpError(resp.status, f"{method} {url}: {detail}")
        if want_headers:
            return data, dict(resp.getheaders())
        return data
    raise HttpError(503, f"{method} {url}: retries exhausted")


def http_get_with_headers(url: str, timeout: float = 30.0,
                          headers: Optional[dict] = None):
    """Cluster GET returning (body, response headers), for callers that
    need what the body does not carry (Content-Range on ranged reads)."""
    url = _client_url(url)
    try:
        return _pooled_call("GET", url, None, headers or {}, timeout,
                            want_headers=True)
    except HttpError:
        raise
    except (OSError, _httpc.HTTPException) as e:
        raise HttpError(503, f"GET {url}: {e}") from None


def http_call(method: str, url: str, body: bytes = None,
              headers: dict = None, timeout: float = 30.0,
              external: bool = False) -> bytes:
    """A cluster call through the keep-alive pool; a status >= 400 or a
    transport failure raises HttpError (503 for the latter).
    ``external=True`` marks an endpoint outside the cluster (a webhook, a
    third party): its URL keeps its scheme and an https one is verified
    with the default context, host name included."""
    if external:
        return _external_call(method, url, body, headers or {}, timeout)
    url = _client_url(url)
    try:
        return _pooled_call(method, url, body, headers or {}, timeout)
    except HttpError:
        raise
    except (OSError, _httpc.HTTPException) as e:
        raise HttpError(503, f"{method} {url}: {e}") from None


def _external_call(method: str, url: str, body, headers: dict,
                   timeout: float) -> bytes:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        detail = e.read().decode("utf-8", "replace")[:500]
        raise HttpError(e.code, f"{method} {url}: {detail}") from None
    except (urllib.error.URLError, socket.timeout, ConnectionError) as e:
        raise HttpError(503, f"{method} {url}: {e}") from None


def get_json(url: str, timeout: float = 30.0) -> dict:
    return json.loads(http_call("GET", url, timeout=timeout) or b"{}")


def post_json(url: str, obj=None, timeout: float = 30.0) -> dict:
    body = json.dumps(obj or {}).encode()
    out = http_call("POST", url, body,
                    {"Content-Type": "application/json"}, timeout)
    return json.loads(out or b"{}")


def pull_file(source: str, name: str, dest: str,
              chunk: int = 64 << 20) -> int:
    """Copy the file ``name`` a volume server serves at ``/admin/file``
    to ``dest`` in ranged pulls of ``chunk`` bytes, so a whole volume
    never sits in memory; the bytes copied."""
    total = get_json(f"http://{source}/admin/file?name={name}"
                     f"&stat=true")["size"]
    with open(dest, "wb") as f:
        off = 0
        while off < total:
            data = http_call(
                "GET", f"http://{source}/admin/file?name={name}"
                       f"&offset={off}&size={min(chunk, total - off)}",
                timeout=600)
            if not data:
                raise HttpError(502, f"short pull of {name} at {off}")
            f.write(data)
            off += len(data)
    return total


def _quote_name(name: str) -> str:
    """Escape a filename for a quoted-string header parameter."""
    return name.replace("\\", "\\\\").replace('"', '\\"')


def _multipart_frame(boundary: str, filename: str,
                     content_type: str) -> Tuple[bytes, bytes]:
    """The bytes before and after the one file of a multipart body."""
    return ((f"--{boundary}\r\n"
             f'Content-Disposition: form-data; name="file"; '
             f'filename="{_quote_name(filename or "file")}"\r\n'
             f"Content-Type: {content_type}\r\n\r\n").encode(),
            f"\r\n--{boundary}--\r\n".encode())


def post_multipart(url: str, filename: str, data: bytes,
                   content_type: str = "application/octet-stream",
                   timeout: float = 60.0, headers: dict = None) -> dict:
    """POST ``data`` as the one file of a multipart/form-data body;
    returns the JSON answer."""
    boundary = uuid.uuid4().hex
    prologue, epilogue = _multipart_frame(boundary, filename, content_type)
    body = prologue + data + epilogue
    all_headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    all_headers.update(headers or {})
    return json.loads(http_call("POST", url, body, all_headers, timeout)
                      or b"{}")


class _ChainReader:
    """A read()-able concatenation of byte strings and (file object,
    size) pairs of a known total length: a multipart body that streams."""

    def __init__(self, parts):
        self.parts = []
        self.len = 0
        for p in parts:
            if isinstance(p, bytes):
                self.parts.append(io.BytesIO(p))
                self.len += len(p)
            else:
                f, size = p
                self.parts.append(f)
                self.len += size
        self.i = 0

    def __len__(self):
        return self.len

    def read(self, n: int = -1) -> bytes:
        out = b""
        while self.i < len(self.parts):
            chunk = self.parts[self.i].read(n if n >= 0 else (1 << 20))
            if chunk:
                out += chunk
                if n >= 0:
                    return out
            else:
                self.i += 1
        return out


def post_multipart_file(url: str, filename: str, fileobj, size: int,
                        content_type: str = "application/octet-stream",
                        timeout: float = 600.0,
                        headers: dict = None) -> dict:
    """``post_multipart`` for a file object of ``size`` bytes: the body
    streams, so a volume-sized upload never sits in memory whole."""
    boundary = uuid.uuid4().hex
    prologue, epilogue = _multipart_frame(boundary, filename, content_type)
    body = _ChainReader([prologue, (fileobj, size), epilogue])
    all_headers = {
        "Content-Type": f"multipart/form-data; boundary={boundary}",
        "Content-Length": str(len(body)),
    }
    all_headers.update(headers or {})
    out = http_call("POST", url, body, all_headers, timeout)
    return json.loads(out or b"{}")


def post_chunked(url: str, chunks, headers: Optional[dict] = None,
                 timeout: float = 300.0) -> bytes:
    """POST an iterable of byte chunks with chunked transfer-encoding:
    the body can start flowing before its total size is known (the EC
    spread pushes shard ranges as the encode makes them). A chunked body
    is not replayable, so the call always goes out on a fresh
    connection and is never retried here; the spread owns retry."""
    h = dict(headers or {})
    h["Transfer-Encoding"] = "chunked"
    url = _client_url(url)
    try:
        return _pooled_call("POST", url, iter(chunks), h, timeout,
                            encode_chunked=True)
    except HttpError:
        raise
    except (OSError, _httpc.HTTPException) as e:
        raise HttpError(503, f"POST {url}: {e}") from None
