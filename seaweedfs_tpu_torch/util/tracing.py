"""Lightweight distributed tracing for the EC data path.

Spans are cheap structs (two os.urandom calls, a dict of tags) linked
by W3C-style ``traceparent`` ids: the HTTP client injects the header on
every cluster-internal call and every server router continues it, so a
shell-initiated ``ec.rebuild`` yields one trace spanning the shell,
master, rebuilder volume server, and the peer fetches it triggers.

The current span rides a contextvar, which means it follows ordinary
call chains within a thread but does NOT cross the pipeline's reader /
drain worker threads — phase work that interleaves across threads is
accumulated as plain seconds and materialized with ``record_span``
instead.

Finished spans fan out three ways (see ``_export``):

* a bounded in-memory ring of recent traces (``RING``), served as JSON
  at ``/admin/traces`` and rendered in the status UI;
* per-phase Prometheus histograms/counters (lazy import of
  ``stats.metrics`` to avoid an import cycle — this module is imported
  by ``server.http_util`` which ``stats.metrics`` uses for pushes);
* caller-registered hooks (``add_finish_hook``) for tests and tuners.

The JAX package's ``util/tracing.py``: span names, tags and ids are
its own, so a trace of a port cluster reads like one of a JAX cluster.
This module must stay dependency-free: stdlib only, nothing else of the
port at module level.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

# EC phase names instrumented across the encode/rebuild hot paths.
PHASES = ("gather", "plan", "dispatch", "drain", "write")

TRACEPARENT_HEADER = "traceparent"

_current: contextvars.ContextVar = contextvars.ContextVar(
    "sw_current_span", default=None)


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One timed operation. ``finish()`` is idempotent; a span created
    by ``start_span`` is the thread's current span until finished."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "tags",
                 "start_wall", "start_mono", "duration_s", "_token")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 tags: Optional[Dict] = None):
        self.name = name
        self.trace_id = trace_id or _hex_id(16)     # 32 hex chars
        self.span_id = _hex_id(8)                   # 16 hex chars
        self.parent_id = parent_id
        self.tags = dict(tags or {})
        self.start_wall = time.time()
        self.start_mono = time.perf_counter()
        self.duration_s: Optional[float] = None
        self._token = None

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> Dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start_wall,
            "duration_s": self.duration_s,
            "tags": dict(self.tags),
        }


_LOWER_HEX = frozenset("0123456789abcdef")


def parse_traceparent(header) -> Optional[Tuple[str, str]]:
    """``00-<trace>-<span>-<flags>`` -> (trace_id, parent_span_id).

    Strictly W3C (trace-context §3.2): ids must be lowercase hex —
    uppercase is invalid on the wire, and ``int(x, 16)`` would happily
    continue a bogus trace under a casing no other participant can
    match — and all-zero trace/span ids mean "not sampled / invalid"
    and must start a fresh root instead of threading onto id 0."""
    if not header:
        return None
    parts = str(header).strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    if not (_LOWER_HEX.issuperset(version)
            and _LOWER_HEX.issuperset(trace_id)
            and _LOWER_HEX.issuperset(span_id)
            and _LOWER_HEX.issuperset(flags)):
        return None
    if version == "ff":          # forbidden version value
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def current_span() -> Optional[Span]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    s = _current.get()
    return s.trace_id if s is not None else None


def outbound_traceparent() -> str:
    """Header value for an outbound call: the current span's ids, or a
    fresh root so downstream spans still group into one trace."""
    s = _current.get()
    if s is not None:
        return s.traceparent()
    return f"00-{_hex_id(16)}-{_hex_id(8)}-01"


def start_span(name: str, parent: Optional[Span] = None,
               traceparent: Optional[str] = None, **tags) -> Span:
    """Start a span and make it the current one for this context.

    Parent resolution order: explicit ``parent`` span, then a remote
    ``traceparent`` header, then the context's current span, else a
    new root trace.
    """
    if parent is not None:
        s = Span(name, trace_id=parent.trace_id,
                 parent_id=parent.span_id, tags=tags)
    else:
        remote = parse_traceparent(traceparent)
        if remote is not None:
            s = Span(name, trace_id=remote[0], parent_id=remote[1],
                     tags=tags)
        else:
            cur = _current.get()
            if cur is not None:
                s = Span(name, trace_id=cur.trace_id,
                         parent_id=cur.span_id, tags=tags)
            else:
                s = Span(name, tags=tags)
    s._token = _current.set(s)
    return s


def finish_span(span: Optional[Span]):
    """Close the span, restore the previous current span, export."""
    if span is None or span.duration_s is not None:
        return
    span.duration_s = time.perf_counter() - span.start_mono
    if span._token is not None:
        try:
            _current.reset(span._token)
        except ValueError:       # finished from a different context
            pass
        span._token = None
    _export(span.to_dict())


@contextlib.contextmanager
def span(name: str, parent: Optional[Span] = None,
         traceparent: Optional[str] = None, **tags):
    s = start_span(name, parent=parent, traceparent=traceparent, **tags)
    try:
        yield s
    except BaseException as e:
        s.tags.setdefault("error", type(e).__name__)
        raise
    finally:
        finish_span(s)


def record_span(name: str, duration_s: float,
                parent: Optional[Span] = None,
                start_wall: Optional[float] = None, **tags):
    """Materialize an already-measured duration as a finished span.

    Used for phase durations accumulated across worker threads (the
    pipeline's reader and drain threads don't inherit the contextvar),
    where start/stop bracketing a single code region is impossible.
    """
    parent = parent if parent is not None else _current.get()
    d = {
        "trace_id": parent.trace_id if parent else _hex_id(16),
        "span_id": _hex_id(8),
        "parent_id": parent.span_id if parent else None,
        "name": name,
        "start": (start_wall if start_wall is not None
                  else time.time() - duration_s),
        "duration_s": float(duration_s),
        "tags": dict(tags),
    }
    _export(d)
    return d


class TraceRing:
    """Bounded map of trace_id -> span list; oldest trace evicted."""

    def __init__(self, max_traces: int = 64, max_spans: int = 512):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Dict]]" = OrderedDict()

    def add(self, span_dict: Dict):
        tid = span_dict.get("trace_id")
        if not tid:
            return
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                spans = self._traces[tid] = []
            if len(spans) < self.max_spans:
                spans.append(span_dict)
            self._traces.move_to_end(tid)

    def get(self, trace_id: str) -> List[Dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def recent(self, n: int = 20) -> List[Dict]:
        """Newest-first list of {trace_id, spans: [...]} dicts."""
        with self._lock:
            items = list(self._traces.items())[-n:]
        out = []
        for tid, spans in reversed(items):
            total = max((s.get("duration_s") or 0.0) for s in spans)
            root = next((s for s in spans if not s.get("parent_id")),
                        spans[0])
            out.append({"trace_id": tid, "root": root.get("name"),
                        "spans": list(spans), "span_count": len(spans),
                        "max_span_s": total})
        return out

    def clear(self):
        with self._lock:
            self._traces.clear()


# Big enough that steady-state heartbeat/poll traces (one span each)
# don't evict a rebuild trace before an operator can look at it.
RING = TraceRing(max_traces=256)

_FINISH_HOOKS: List[Callable[[Dict], None]] = []
_metrics_export = None      # resolved lazily; False = unavailable


def add_finish_hook(fn: Callable[[Dict], None]):
    _FINISH_HOOKS.append(fn)


def remove_finish_hook(fn: Callable[[Dict], None]):
    try:
        _FINISH_HOOKS.remove(fn)
    except ValueError:
        pass


def _export(span_dict: Dict):
    RING.add(span_dict)
    global _metrics_export
    if _metrics_export is None:
        try:
            from ..stats import metrics as _m
            _metrics_export = _m.observe_span
        except Exception:
            _metrics_export = False
    if _metrics_export:
        try:
            _metrics_export(span_dict)
        except Exception:
            pass
    for fn in list(_FINISH_HOOKS):
        try:
            fn(span_dict)
        except Exception:
            pass
