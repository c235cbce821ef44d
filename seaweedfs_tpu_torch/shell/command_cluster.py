"""The shell's cluster commands: ``cluster.repairs`` (the master's repair
queue) and ``cluster.devices`` (each server's ``/admin/devices``), in the
lines of the JAX package's ``shell/command_cluster.py``. Its
``cluster.health``, ``cluster.profile`` and ``trace.export`` wait for the
health, profiling and tracing planes."""

from __future__ import annotations

from typing import List

from ..server.http_util import HttpError
from .command_env import CommandEnv, command, parse_flags


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
