"""Merged Perfetto trace export (fleet health plane, half three).

A cluster ``ec.rebuild`` leaves its spans shredded across N servers'
in-process trace rings.  This module turns one trace's span dicts
(util.tracing ``Span.to_dict()`` shape) into Chrome trace-event JSON —
the ``{"traceEvents": [...]}`` format Perfetto and chrome://tracing
load directly — and merges per-node exports into one timeline:

  * every span becomes an "X" (complete) event, ``ts``/``dur`` in
    microseconds; each node becomes a Perfetto *process* with a
    ``process_name`` metadata event, and overlapping spans within a
    node spread across *thread* lanes so nothing stacks invisibly;
  * event ``args`` carry the original span/parent ids, node, and
    absolute wall start, so a merger can reconstruct span dicts from a
    node's export losslessly (``spans_from_chrome``);
  * node wall clocks disagree, so the merger estimates one offset per
    node from parent/child span overlap: a child span served by node B
    for a parent on node A must nest inside the parent, which bounds
    ``offset_B - offset_A`` to ``[parent.start - child.start,
    parent.end - child.end]``.  Offsets propagate by BFS from the root
    span's node (pinned at 0), preferring 0 inside the feasible
    interval and clamping to the nearest bound otherwise.

Stdlib only — this sits next to util.tracing and must import nothing
from the rest of the tree.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

CLIENT_NODE = "client"


def _span_end(s: Dict) -> float:
    return (s.get("start") or 0.0) + (s.get("duration_s") or 0.0)


def assign_nodes(spans: Sequence[Dict]) -> Dict[str, str]:
    """span_id -> node name.  Server spans are tagged with their node at
    creation; untagged spans (EC phases, client-side fetch spans)
    inherit the nearest tagged ancestor, and untagged roots — the shell
    process — fall back to "client"."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    out: Dict[str, str] = {}

    def resolve(sid: str, hops: int = 0) -> str:
        if sid in out:
            return out[sid]
        s = by_id.get(sid)
        if s is None:
            return CLIENT_NODE
        node = (s.get("tags") or {}).get("node")
        if not node:
            parent = s.get("parent_id")
            # hop cap guards a malformed parent cycle
            node = (resolve(parent, hops + 1)
                    if parent and hops < 64 else CLIENT_NODE)
        out[sid] = node
        return node

    for sid in by_id:
        resolve(sid)
    return out


def merge_spans(span_lists: Sequence[Sequence[Dict]]) -> List[Dict]:
    """Union per-node span lists, deduplicating by span_id (every node
    of an in-process test cluster shares one ring, so the same span
    arrives N times).  A copy that carries a node tag wins over one
    that doesn't."""
    by_id: Dict[str, Dict] = {}
    extras: List[Dict] = []
    for spans in span_lists:
        for s in spans or ():
            sid = s.get("span_id")
            if not sid:
                extras.append(s)
                continue
            prev = by_id.get(sid)
            if prev is None or (
                    not (prev.get("tags") or {}).get("node")
                    and (s.get("tags") or {}).get("node")):
                by_id[sid] = s
    merged = list(by_id.values()) + extras
    merged.sort(key=lambda s: (s.get("start") or 0.0))
    return merged


def estimate_node_offsets(spans: Sequence[Dict],
                          nodes: Optional[Dict[str, str]] = None
                          ) -> Dict[str, float]:
    """Per-node wall-clock offset (seconds to ADD to that node's
    timestamps) that makes cross-node child spans nest inside their
    parents.  The root span's node anchors the timeline at offset 0."""
    nodes = nodes if nodes is not None else assign_nodes(spans)
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}

    # collect feasible (lo, hi) bounds on offset[child] - offset[parent]
    # per directed node pair
    bounds: Dict[Tuple[str, str], List[float]] = {}
    for s in spans:
        pid = s.get("parent_id")
        if not pid or pid not in by_id:
            continue
        parent = by_id[pid]
        a = nodes.get(parent.get("span_id"), CLIENT_NODE)
        b = nodes.get(s.get("span_id"), CLIENT_NODE)
        if a == b:
            continue
        lo = (parent.get("start") or 0.0) - (s.get("start") or 0.0)
        hi = _span_end(parent) - _span_end(s)
        if hi < lo:     # child outlives parent (async tail): the start
            hi = lo     # constraint is the trustworthy one
        key = (a, b)
        cur = bounds.get(key)
        if cur is None:
            bounds[key] = [lo, hi]
        else:           # intersect; if empty, fall back to the
            cur[0] = max(cur[0], lo)        # tightest-start compromise
            cur[1] = min(cur[1], hi)
            if cur[1] < cur[0]:
                cur[1] = cur[0]

    adjacency: Dict[str, List[Tuple[str, float, float]]] = {}
    for (a, b), (lo, hi) in bounds.items():
        adjacency.setdefault(a, []).append((b, lo, hi))
        adjacency.setdefault(b, []).append((a, -hi, -lo))

    root = next((s for s in sorted(spans,
                                   key=lambda x: x.get("start") or 0.0)
                 if not s.get("parent_id")), None)
    root_node = (nodes.get(root["span_id"], CLIENT_NODE)
                 if root and root.get("span_id") else CLIENT_NODE)

    offsets: Dict[str, float] = {}
    all_nodes = sorted(set(nodes.values()))
    # BFS from the root node, then any still-unvisited component
    for seed in [root_node] + all_nodes:
        if seed in offsets:
            continue
        offsets[seed] = 0.0
        q = deque([seed])
        while q:
            a = q.popleft()
            for b, lo, hi in adjacency.get(a, ()):
                if b in offsets:
                    continue
                base = offsets[a]
                # prefer "no skew" when feasible, else nearest bound
                delta = 0.0 - base
                delta = min(max(delta, lo), hi)
                offsets[b] = base + delta
                q.append(b)
    return offsets


def chrome_trace_events(spans: Sequence[Dict],
                        offsets: Optional[Dict[str, float]] = None,
                        nodes: Optional[Dict[str, str]] = None) -> Dict:
    """Render span dicts as a Chrome trace-event JSON object."""
    spans = [s for s in spans if s.get("start") is not None]
    nodes = nodes if nodes is not None else assign_nodes(spans)
    offsets = offsets or {}

    def adj_start(s: Dict) -> float:
        node = nodes.get(s.get("span_id"), CLIENT_NODE)
        return (s.get("start") or 0.0) + offsets.get(node, 0.0)

    if spans:
        t0 = min(adj_start(s) for s in spans)
    else:
        t0 = 0.0

    node_order = sorted(set(nodes.values()) or {CLIENT_NODE})
    pid_of = {n: i + 1 for i, n in enumerate(node_order)}

    events: List[Dict] = []
    for node in node_order:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pid_of[node], "tid": 0,
                       "args": {"name": node}})

    # greedy lane assignment per node so concurrent spans get their own
    # thread rows
    lanes: Dict[str, List[float]] = {}
    for s in sorted(spans, key=adj_start):
        node = nodes.get(s.get("span_id"), CLIENT_NODE)
        start = adj_start(s)
        dur = s.get("duration_s") or 0.0
        node_lanes = lanes.setdefault(node, [])
        tid = None
        for i, busy_until in enumerate(node_lanes):
            if start >= busy_until - 1e-9:
                tid = i
                node_lanes[i] = start + dur
                break
        if tid is None:
            tid = len(node_lanes)
            node_lanes.append(start + dur)
        events.append({
            "ph": "X",
            "name": s.get("name") or "?",
            "cat": "span",
            "pid": pid_of[node],
            "tid": tid + 1,
            "ts": round((start - t0) * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "args": {
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "trace_id": s.get("trace_id"),
                "node": node,
                "start": s.get("start"),
                "duration_s": dur,
                "tags": dict(s.get("tags") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_from_chrome(obj: Dict) -> List[Dict]:
    """Reconstruct span dicts from a per-node export's args — the
    lossless inverse of chrome_trace_events for merging."""
    spans = []
    for ev in obj.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if not args.get("span_id"):
            continue
        tags = dict(args.get("tags") or {})
        if args.get("node") and "node" not in tags:
            tags["node"] = args["node"]
        spans.append({
            "trace_id": args.get("trace_id"),
            "span_id": args["span_id"],
            "parent_id": args.get("parent_id"),
            "name": ev.get("name"),
            "start": args.get("start"),
            "duration_s": args.get("duration_s"),
            "tags": tags,
        })
    return spans


def merged_chrome_trace(span_lists: Sequence[Sequence[Dict]]) -> Dict:
    """Merge per-node span lists into one skew-normalized Chrome trace."""
    spans = merge_spans(span_lists)
    nodes = assign_nodes(spans)
    offsets = estimate_node_offsets(spans, nodes)
    out = chrome_trace_events(spans, offsets=offsets, nodes=nodes)
    out["metadata"] = {
        "nodes": sorted(set(nodes.values())),
        "clock_offsets_s": {n: round(o, 6)
                            for n, o in sorted(offsets.items())},
        "span_count": len(spans),
    }
    return out
