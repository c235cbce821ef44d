"""The port's tracing (``util/tracing``, ``util/trace_export``) against the
JAX package's.

- ``parse_traceparent``: the strictness cases of the JAX
  ``tests/test_fleet_health.py`` (lowercase hex only, all-zero ids and
  version ff refused, every malformed shape refused) give the same
  answer in both packages.
- Spans: one script of nested spans, a recorded span, an error and a
  remote parent through both packages' ``span`` / ``start_span`` /
  ``record_span``; what their finish hooks and rings see is equal in
  names, parent links and tags (ids are random, so links are compared
  by name).
- ``chrome_trace_events``, ``spans_from_chrome`` and
  ``merged_chrome_trace`` give equal JSON on the same span dicts (fixed
  ids and times), and the skew normalization puts a child served by
  another node (its clock 5 s ahead) inside its parent.
- The router: a port server continues an incoming ``traceparent`` in a
  server span named by its route and tagged with its node, as a JAX
  server does; a pooled call made inside a span sends that span's
  ``traceparent``, and one made outside any span a fresh root's.

Tolerances: none."""

import json

import pytest

TRACE = "0af7651916cd43dd8448eb211c80319c"
SPAN = "b7ad6b7169203331"

TRACEPARENTS = [
    f"00-{TRACE}-{SPAN}-01",
    f"00-{TRACE.upper()}-{SPAN}-01",
    f"00-{TRACE}-{SPAN.upper()}-01",
    f"00-{'0' * 32}-{SPAN}-01",
    f"00-{TRACE}-{'0' * 16}-01",
    f"ff-{TRACE}-{SPAN}-01",
    None,
    "",
    "00-abc-def",
    f"00-{TRACE[:-2]}-{SPAN}-01",
    f"00-{TRACE}-{SPAN}xx-01",
    f"00-{TRACE}-{SPAN}-01-extra",
    f"0g-{TRACE}-{SPAN}-01",
    f"  00-{TRACE}-{SPAN}-00  ",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_parse_traceparent_matches_jax(header):
    from seaweedfs_tpu.util.tracing import parse_traceparent as ref
    from seaweedfs_tpu_torch.util.tracing import parse_traceparent
    assert parse_traceparent(header) == ref(header)
    valid = header is not None and header.strip() in (
        f"00-{TRACE}-{SPAN}-01", f"00-{TRACE}-{SPAN}-00")
    assert (parse_traceparent(header) is not None) == valid


def _span_script(tracing):
    """One script through a tracing module; the finished span dicts its
    hook saw, in finish order."""
    seen = []
    tracing.add_finish_hook(seen.append)
    try:
        with tracing.span("ec.rebuild", volume=7, mode="stream") as root:
            with tracing.span("plan", backend="cuda"):
                pass
            tracing.record_span("gather", 0.25, op="ec.rebuild",
                                bytes=1024)
            child = tracing.start_span("dispatch", parent=root, path="host")
            tracing.finish_span(child)
            tracing.finish_span(child)      # idempotent
            with pytest.raises(KeyError):
                with tracing.span("write", op="ec.rebuild"):
                    raise KeyError("x")
        assert tracing.current_span() is None
        with tracing.span("GET /admin/ec/shard_read",
                          traceparent=f"00-{TRACE}-{SPAN}-01"):
            assert tracing.current_trace_id() == TRACE
            hdr = tracing.outbound_traceparent()
        assert hdr.startswith(f"00-{TRACE}-")
        fresh = tracing.outbound_traceparent()
        assert tracing.parse_traceparent(fresh) is not None
        assert tracing.parse_traceparent(fresh)[0] != TRACE
    finally:
        tracing.remove_finish_hook(seen.append)
    return seen


def _shape(spans):
    """Names, parents by name, trace grouping and tags of span dicts."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    traces = {}
    out = []
    for s in spans:
        group = traces.setdefault(s["trace_id"], len(traces))
        out.append((s["name"], by_id.get(s["parent_id"], s["parent_id"]),
                    group, s["tags"], s["duration_s"] is not None))
    return out


def test_span_script_matches_jax():
    from seaweedfs_tpu.util import tracing as ref
    from seaweedfs_tpu_torch.util import tracing
    mine, theirs = _span_script(tracing), _span_script(ref)
    assert _shape(mine) == _shape(theirs)
    assert [s["name"] for s in mine] == [
        "plan", "gather", "dispatch", "write", "ec.rebuild",
        "GET /admin/ec/shard_read"]
    assert mine[3]["tags"]["error"] == "KeyError"
    remote = mine[-1]
    assert (remote["trace_id"], remote["parent_id"]) == (TRACE, SPAN)
    assert tracing.PHASES == ref.PHASES
    assert tracing.TRACEPARENT_HEADER == ref.TRACEPARENT_HEADER


def test_trace_ring_matches_jax():
    from seaweedfs_tpu.util import tracing as ref
    from seaweedfs_tpu_torch.util import tracing
    views = []
    for mod in (ref, tracing):
        ring = mod.TraceRing(max_traces=3, max_spans=2)
        for t in range(5):
            for i in range(3):
                ring.add({"trace_id": f"t{t}", "span_id": f"s{t}{i}",
                          "parent_id": None if i == 0 else f"s{t}0",
                          "name": f"n{i}", "start": float(t),
                          "duration_s": 0.5 * (i + 1), "tags": {}})
        views.append((ring.recent(10), ring.get("t4"), ring.get("t0")))
    assert views[0] == views[1]
    assert [t["trace_id"] for t in views[1][0]] == ["t4", "t3", "t2"]
    assert tracing.RING.max_traces == ref.RING.max_traces == 256


def _spans_two_nodes():
    """A shell root, a server span on node A under it, and a peer read on
    node B whose clock runs 5 s ahead of A's."""
    return [
        {"trace_id": TRACE, "span_id": "a" * 16, "parent_id": None,
         "name": "ec.rebuild", "start": 100.0, "duration_s": 2.0,
         "tags": {"volume": 7}},
        {"trace_id": TRACE, "span_id": "b" * 16, "parent_id": "a" * 16,
         "name": "POST /admin/ec/rebuild", "start": 100.2,
         "duration_s": 1.5, "tags": {"node": "10.0.0.1:80"}},
        {"trace_id": TRACE, "span_id": "c" * 16, "parent_id": "b" * 16,
         "name": "dispatch", "start": 100.9, "duration_s": 0.4,
         "tags": {"op": "ec.rebuild", "backend": "cuda"}},
        {"trace_id": TRACE, "span_id": "d" * 16, "parent_id": "b" * 16,
         "name": "GET /admin/ec/shard_read", "start": 105.4,
         "duration_s": 0.3, "tags": {"node": "10.0.0.2:80"}},
    ]


def test_chrome_export_and_merge_match_jax():
    from seaweedfs_tpu.util import trace_export as ref
    from seaweedfs_tpu_torch.util import trace_export
    spans = _spans_two_nodes()
    assert trace_export.assign_nodes(spans) == ref.assign_nodes(spans)
    mine = trace_export.chrome_trace_events(spans)
    assert json.dumps(mine, sort_keys=True) == \
        json.dumps(ref.chrome_trace_events(spans), sort_keys=True)
    # a node's export parses back into the same span dicts
    back = trace_export.spans_from_chrome(mine)
    assert back == ref.spans_from_chrome(mine)
    assert sorted(s["span_id"] for s in back) == \
        sorted(s["span_id"] for s in spans)
    # the shell's, A's and B's views merged, duplicates by span id
    lists = [spans[:3], spans[1:], [spans[3]]]
    merged = trace_export.merged_chrome_trace(lists)
    assert json.dumps(merged, sort_keys=True) == \
        json.dumps(ref.merged_chrome_trace(lists), sort_keys=True)
    meta = merged["metadata"]
    assert meta["span_count"] == 4
    assert sorted(meta["nodes"]) == ["10.0.0.1:80", "10.0.0.2:80",
                                     "client"]
    # nesting bounds B's offset to [100.2 - 105.4, 101.7 - 105.7]
    assert -5.2 - 1e-9 <= meta["clock_offsets_s"]["10.0.0.2:80"] \
        <= -4.0 + 1e-9
    ev = {e["args"]["span_id"]: e for e in merged["traceEvents"]
          if e.get("ph") == "X"}
    parent, child = ev["b" * 16], ev["d" * 16]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in ev.values())


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_router_continues_a_traceparent(kind):
    """The same request to a JAX and a port router: one server span,
    named by the route's label, the caller's trace and parent, the
    node's tag."""
    if kind == "ref":
        from seaweedfs_tpu.server import http_util as hu
        from seaweedfs_tpu.util import tracing
    else:
        from seaweedfs_tpu_torch.server import http_util as hu
        from seaweedfs_tpu_torch.util import tracing
    from seaweedfs_tpu_torch.server.http_util import http_call
    seen = []
    observed = []
    router = hu.Router()
    router.add("GET", "/ping", lambda req: {"trace": tracing.current_trace_id()})
    router.observe = lambda label, secs, ok: observed.append((label, ok))
    server = hu.HttpServer(0, router)
    router.node = f"127.0.0.1:{server.port}"
    server.start()
    tracing.add_finish_hook(seen.append)
    try:
        out = json.loads(http_call(
            "GET", f"http://127.0.0.1:{server.port}/ping",
            headers={"traceparent": f"00-{TRACE}-{SPAN}-01"}))
        assert out == {"trace": TRACE}
        with pytest.raises(Exception):
            http_call("GET", f"http://127.0.0.1:{server.port}/nope")
    finally:
        tracing.remove_finish_hook(seen.append)
        server.stop()
    ping = next(s for s in seen if s["trace_id"] == TRACE)
    assert (ping["name"], ping["parent_id"]) == ("GET /ping", SPAN)
    assert ping["tags"] == {"node": router.node}
    miss = next(s for s in seen if s["name"] == "GET /nope")
    assert miss["tags"]["error"] == "HttpError"
    assert observed == [("GET /ping", True), ("GET unrouted", False)]


def test_pooled_calls_carry_the_current_span():
    from seaweedfs_tpu_torch.server import http_util as hu
    from seaweedfs_tpu_torch.util import tracing
    got = []
    router = hu.Router()
    router.add("GET", "/h", lambda req: got.append(
        req.headers.get("traceparent")) or {})
    server = hu.HttpServer(0, router).start()
    try:
        with tracing.span("caller") as s:
            hu.get_json(f"http://127.0.0.1:{server.port}/h")
        hu.get_json(f"http://127.0.0.1:{server.port}/h")
        hu.get_json(f"http://127.0.0.1:{server.port}/h",)
    finally:
        server.stop()
    assert tracing.parse_traceparent(got[0]) == (s.trace_id, s.span_id)
    roots = [tracing.parse_traceparent(h) for h in got[1:]]
    assert all(r is not None for r in roots)
    assert roots[0][0] != roots[1][0] != s.trace_id
