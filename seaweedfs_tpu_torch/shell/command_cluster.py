"""The shell's cluster commands, in the lines of the JAX package's
``shell/command_cluster.py``: ``cluster.health`` (the master's
per-holder health fold), ``cluster.repairs`` (its repair queue),
``cluster.devices`` (each server's ``/admin/devices``),
``cluster.profile`` (every node's threads sampled through ``POST
/admin/profile``, merged into one folded file) and ``trace.export``
(one trace's spans from every node's ``/admin/traces/export``, merged by
span id and skew-normalized into one Chrome trace-event file)."""

from __future__ import annotations

import json
from typing import List

from ..server.http_util import HttpError, http_call
from ..util import trace_export
from .command_env import CommandEnv, command, parse_flags


@command("cluster.health",
         "[-refresh false]: per-holder health scores aggregated across "
         "the fleet (latency/error/hedge-loss EWMAs from every node's "
         "reader stack; worst observer wins)")
def cluster_health(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    path = "/cluster/health"
    if flags.get("refresh", "true") != "false":
        path += "?refresh=1"
    view = env.master_get(path)
    holders = view.get("holders") or {}
    nodes = view.get("nodes") or []
    fresh = sum(1 for n in nodes if not n.get("stale"))
    env.write(f"cluster.health: {len(holders)} holders scored by "
              f"{fresh}/{len(nodes)} fresh nodes")
    for n in nodes:
        if n.get("stale"):
            err = n.get("last_error") or "no fresh scrape"
            env.write(f"  node {n['node']}  STALE ({err})")
    for holder in sorted(holders, key=lambda h: holders[h]["score"]):
        h = holders[holder]
        lats = " ".join(f"{kind}={ms:.1f}ms" for kind, ms in
                        sorted(h.get("latency_ewma_ms", {}).items()))
        ev = h.get("events", {})
        env.write(
            f"  {holder}  score={h['score']:.3f}"
            f"{('  ' + lats) if lats else ''}"
            f"  reads={int(ev.get('reads', 0))}"
            f" errors={int(ev.get('errors', 0))}"
            f" hedges_lost={int(ev.get('hedges_lost', 0))}")


@command("cluster.repairs",
         "[-refresh false]: the master's repair queue — open durability "
         "incidents by priority (corruption > lost shard > at-risk "
         "holder) and time-to-re-protection over recent repairs")
def cluster_repairs(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    path = "/cluster/repairs"
    if flags.get("refresh", "true") != "false":
        path += "?refresh=1"
    view = env.master_get(path)
    open_incs = view.get("open") or []
    ttr = view.get("time_to_re_protection") or {}
    counters = view.get("counters") or {}
    env.write(f"cluster.repairs: {len(open_incs)} open, "
              f"{int(counters.get('resolved', 0))} resolved "
              f"(ttr p50={ttr.get('p50_s', 0.0):.1f}s "
              f"p99={ttr.get('p99_s', 0.0):.1f}s "
              f"over {int(ttr.get('count', 0))})")
    for inc in open_incs:
        where = f"volume {inc.get('volume')}.{inc.get('shard')}" \
            if inc.get("volume") is not None else inc.get("holder", "?")
        env.write(f"  [{inc.get('kind')}] {where}"
                  f"  attempts={int(inc.get('attempts', 0))}"
                  f"  since={inc.get('detected_at', 0.0):.0f}"
                  + (f"  err={inc['last_error']}"
                     if inc.get("last_error") else ""))
    for inc in (view.get("resolved_recent") or [])[-5:]:
        env.write(f"  done [{inc.get('kind')}] volume "
                  f"{inc.get('volume')}.{inc.get('shard')} via "
                  f"{inc.get('via')} "
                  f"ttr={inc.get('time_to_re_protection_s', 0.0):.1f}s")


@command("cluster.devices",
         ": device-runtime snapshot per node (GET /admin/devices) — "
         "platform, device kind×count, kernel builds and plan recompiles "
         "with the latched sentinel, and cached constant bytes")
def cluster_devices(env: CommandEnv, args: List[str]):
    nodes = env.cluster_nodes()
    env.write(f"cluster.devices: {len(nodes)} nodes")
    for n in nodes:
        url = n["url"]
        try:
            snap = env.node_get(url, "/admin/devices")
        except HttpError as e:
            env.write(f"  {url}  unreachable: {e}")
            continue
        inv = snap.get("inventory") or {}
        stats = snap.get("stats") or {}
        kinds = " ".join(f"{kind}x{count}" for kind, count in
                         sorted((inv.get("device_kinds") or {}).items()))
        compiles = sum((stats.get("compiles") or {}).values())
        recompiles = sum((stats.get("recompiles") or {}).values())
        occ = stats.get("const_cache_occupancy") or {}
        sentinel = "  SENTINEL" if stats.get("sentinel") else ""
        env.write(
            f"  {url}  platform={inv.get('platform')}"
            f"  devices={kinds or 'none'}"
            f"  compiles={compiles} recompiles={recompiles}"
            f"  const_cache={occ.get('entries', 0)}"
            f"/{occ.get('bytes', 0)}B{sentinel}")
        for off in (stats.get("offenders") or []):
            env.write(f"    recompile offender: {off}")


@command("cluster.profile",
         "[-seconds 2] [-o <file>]: sample every server's Python "
         "threads (POST /admin/profile) and merge the collapsed stacks "
         "into one flamegraph/speedscope-ready folded file, each stack "
         "prefixed with its node")
def cluster_profile_cmd(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    try:
        seconds = float(flags.get("seconds", "2"))
    except ValueError:
        env.write("usage: cluster.profile [-seconds N] [-o <file>]")
        return
    out_path = flags.get("o") or "cluster_profile.folded"
    targets = [env.master_url] + \
        [n["url"] for n in env.cluster_nodes()]
    # serial on purpose: the profiler is serialized per PROCESS (409 on
    # overlap), and a test cluster runs every server in one process —
    # a parallel fan-out there would profile one node and bounce off
    # the rest
    merged: List[str] = []
    sampled = 0
    for url in targets:
        try:
            folded = http_call(
                "POST",
                f"http://{url}/admin/profile?seconds={seconds:g}",
                timeout=seconds + 30.0).decode("utf-8", "replace")
        except Exception as e:  # noqa: BLE001 - a down node must not
            # abort the sweep
            env.write(f"  {url}  unreachable: {e}")
            continue
        lines = [ln for ln in folded.splitlines() if ln.strip()]
        if lines:
            sampled += 1
        merged.extend(f"{url};{ln}" for ln in lines)
    if not merged:
        env.write("cluster.profile: no samples collected")
        return
    with open(out_path, "w") as f:
        f.write("\n".join(merged) + "\n")
    env.write(f"cluster.profile: {len(merged)} stacks from "
              f"{sampled}/{len(targets)} nodes over {seconds:g}s "
              f"-> {out_path}")


@command("trace.export",
         "-trace <id> [-o <file>]: merge one trace's spans from every "
         "cluster node into a single skew-normalized Chrome trace-event "
         "file (open in Perfetto / chrome://tracing)")
def trace_export_cmd(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    tid = flags.get("trace")
    if not tid:
        env.write("usage: trace.export -trace <id> [-o <file>]")
        return
    out_path = flags.get("o") or f"trace_{tid[:12]}.json"
    targets = [env.master_url] + \
        [n["url"] for n in env.cluster_nodes()]
    span_lists = []
    reached = 0
    for url in targets:
        try:
            obj = env.node_get(url,
                               f"/admin/traces/export?trace={tid}")
        except HttpError as e:
            env.write(f"  {url}  unreachable: {e}")
            continue
        reached += 1
        span_lists.append(trace_export.spans_from_chrome(obj))
    if not any(span_lists):
        env.write(f"trace.export: no spans for trace {tid} on "
                  f"{reached} reachable nodes")
        return
    merged = trace_export.merged_chrome_trace(span_lists)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    meta = merged.get("metadata", {})
    env.write(
        f"trace.export: {meta.get('span_count', 0)} spans from "
        f"{len(meta.get('nodes', []))} nodes -> {out_path} "
        f"(clock offsets: "
        f"{json.dumps(meta.get('clock_offsets_s', {}))})")
