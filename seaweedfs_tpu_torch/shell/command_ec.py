"""The shell's EC commands: ``ec.encode`` (freeze the volume's replicas,
encode on the source and stream each shard to its holder, or generate
then copy, mount, drop the originals; unwound on failure), ``ec.rebuild``
(regenerate missing shards on the freest server, streamed with ``-repair
auto|trace|piggyback|full``, or by copies), ``ec.decode`` (back to a
plain volume on the server holding the most data shards) and
``ec.balance`` (even shard counts across racks, then within each). The
JAX package's ``shell/command_ec.py``: ``ec.encode`` and ``ec.rebuild``
of a volume each run in a root span (``ec.encode``, ``ec.rebuild``)
whose ``traceparent`` every call below it carries, so one operation is
one trace across the shell, the master and the servers; a survivor copy
is a ``gather`` span under it. Its knob defaults are constants here: ``SPREAD_MODE`` (SW_EC_SPREAD_MODE), ``GATHER_MODE``
(SW_EC_GATHER_MODE) and ``REPAIR_MODE`` (SW_EC_REPAIR_MODE). Also each
server's degraded-read engine (``volume.ec.degraded``) and syndrome scrub
(``volume.ec.scrub [-trigger] [-volumeId N]``), in the JAX lines."""

from __future__ import annotations

import math
import time
from typing import Dict, List

from ..ec.constants import DATA_SHARDS, TOTAL_SHARDS
from ..server.http_util import HttpError
from ..util import tracing
from ..util.fanout import fan_out_must_succeed
from .command_env import CommandEnv, command, parse_flags

SPREAD_MODE = "stream"   # ec.encode: stream | copy
GATHER_MODE = "stream"   # ec.rebuild: stream | copy
REPAIR_MODE = "auto"     # ec.rebuild: auto | trace | piggyback | full


def _free_nodes(env: CommandEnv) -> List[dict]:
    return sorted(env.cluster_nodes(), key=lambda n: -n.get("free", 0))


def _volume_replicas(env: CommandEnv, vid: int) -> List[dict]:
    return env.all_volumes().get(str(vid), [])


def balanced_ec_distribution(nodes: List[dict]) -> List[str]:
    """The 14 shards' holders, round robin over ``nodes`` (freest first)
    while each has a free EC slot (a volume slot is 10)."""
    if not nodes:
        raise ValueError("no volume servers")
    picked: Dict[str, int] = {n["url"]: 0 for n in nodes}
    free_slots = {n["url"]: max(n.get("free", 0), 0) * 10 for n in nodes}
    urls = [n["url"] for n in nodes]
    out: List[str] = []
    i = 0
    spins = 0
    while len(out) < TOTAL_SHARDS:
        url = urls[i % len(urls)]
        i += 1
        if free_slots[url] - picked[url] >= 1:
            out.append(url)
            picked[url] += 1
            spins = 0
        else:
            spins += 1
            if spins > len(urls):
                raise ValueError("not enough free EC slots in the cluster")
    return out


def collect_volume_ids_for_ec_encode(env: CommandEnv, collection: str,
                                     full_percent: float = 0.95,
                                     quiet_seconds: float = 3600,
                                     size_limit: int = None) -> List[int]:
    """The collection's volumes that are nearly full and quiet."""
    if size_limit is None:
        status = env.master_get("/dir/status")
        size_limit = status.get("volumeSizeLimit") \
            or 30 * 1024 * 1024 * 1024
    now = time.time()
    out = []
    for vid_s, replicas in env.all_volumes().items():
        vi = replicas[0]
        if vi.get("collection", "") != collection:
            continue
        if vi.get("size", 0) < full_percent * size_limit:
            continue
        modified = vi.get("modified_at", 0)
        if modified and now - modified < quiet_seconds:
            continue
        out.append(int(vid_s))
    return out


@command("ec.encode",
         "-volumeId <id> | -collection <name> [-fullPercent 0.95] "
         "[-mode stream|copy] : erasure-code volumes and spread 14 "
         "shards across the cluster (stream = push shard ranges to "
         "holders while later slabs encode; copy = legacy "
         "generate-then-pull)")
def ec_encode(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    if "volumeId" in flags:
        vids = [int(flags["volumeId"])]
    elif "collection" in flags:
        vids = collect_volume_ids_for_ec_encode(
            env, flags["collection"], float(flags.get("fullPercent", 0.95)),
            quiet_seconds=float(flags.get("quietFor", 3600)))
    else:
        env.write("usage: ec.encode -volumeId <id> | -collection <name>")
        return
    for vid in vids:
        do_ec_encode(env, vid, mode=flags.get("mode"))


def do_ec_encode(env: CommandEnv, vid: int, mode: str = None,
                 timings: Dict = None, rate_mbps: float = 0.0):
    """Freeze, encode and spread, mount, drop the originals.

    ``mode`` "stream" (SPREAD_MODE by default) sends the shard
    assignment to the source, which pushes each shard's slab ranges to
    its holder while later slabs encode: a remote shard never touches
    the source's disk. "copy" generates all 14 shards on the source,
    then each target pulls its files whole; a stream that fails falls
    back to it.

    A failure after the freeze unwinds: the shard files and ``.part``
    stages go on every server involved, and each replica's readonly
    flag returns to its own prior state.

    ``timings``, when given, receives ``mode``, the encode's and the
    spread's busy seconds, ``overlap_frac`` and the spread's counters
    (the source's ``stats``), ``encode_wall_s`` and the root span's
    ``trace_id``. ``rate_mbps`` > 0 paces the streaming spread (the
    tierer's cap); copy mode ignores it."""
    mode = (mode or SPREAD_MODE).lower()
    replicas = _volume_replicas(env, vid)
    if not replicas:
        env.write(f"volume {vid} not found")
        return
    collection = replicas[0].get("collection", "")
    source = replicas[0]["url"]
    root = tracing.start_span("ec.encode", volume=vid, mode=mode)
    if timings is not None:
        timings["mode"] = mode
    try:
        # 1. freeze every replica, noting each holder's own prior state
        # (not the master's view, a heartbeat late) so that a failure
        # thaws exactly what this command froze
        froze: List[str] = []
        for r in replicas:
            out = env.node_post(r["url"],
                                f"/admin/volume/readonly?volume={vid}")
            if not (out or {}).get("was_readonly"):
                froze.append(r["url"])
        assignment = balanced_ec_distribution(_free_nodes(env))
        by_node: Dict[str, List[int]] = {}
        for sid, url in enumerate(assignment):
            by_node.setdefault(url, []).append(sid)
        try:
            # 2, 3. encode, spread, mount
            if mode == "copy":
                _encode_spread_copy(env, vid, collection, source, by_node,
                                    timings)
            else:
                try:
                    _encode_spread_streaming(env, vid, collection, source,
                                             assignment, timings, rate_mbps)
                except HttpError as e:
                    env.write(f"volume {vid}: streaming encode failed "
                              f"({e.status}); falling back to copy mode")
                    root.tags["fallback"] = "copy"
                    _cleanup_partial_encode(env, vid, collection,
                                            set(assignment) | {source})
                    _encode_spread_copy(env, vid, collection, source,
                                        by_node, timings)
        except BaseException as e:
            _cleanup_partial_encode(env, vid, collection,
                                    set(assignment) | {source})
            for url in froze:
                try:
                    env.node_post(url, f"/admin/volume/readonly?volume="
                                       f"{vid}&readonly=false")
                except HttpError:
                    pass
            root.tags.setdefault("error", type(e).__name__)
            raise
        # 4. drop the original volume everywhere
        for r in replicas:
            env.node_post(r["url"], f"/admin/delete_volume?volume={vid}")
        if timings is not None:
            timings["trace_id"] = root.trace_id
    finally:
        tracing.finish_span(root)
    env.write(f"volume {vid}: ec encoded, original removed")


def _cleanup_partial_encode(env: CommandEnv, vid: int, collection: str,
                            nodes):
    """Best-effort removal of every shard file and ``.part`` stage a
    failed encode may have left on any involved node."""
    all_shards = ",".join(map(str, range(TOTAL_SHARDS)))
    for url in nodes:
        try:
            env.node_post(url, f"/admin/ec/delete_shards?volume={vid}"
                               f"&collection={collection}"
                               f"&shards={all_shards}")
        except HttpError:
            pass


def _encode_spread_streaming(env: CommandEnv, vid: int, collection: str,
                             source: str, assignment: List[str],
                             timings: Dict = None, rate_mbps: float = 0.0):
    """One POST: the source encodes and pushes each shard's slab ranges
    to its assigned holder while later slabs encode, paced at
    ``rate_mbps`` when > 0. Afterwards only the KB-scale index sidecars
    (.ecx/.vif) are copied to remote holders, then every holder mounts
    its shards."""
    spares = [n["url"] for n in _free_nodes(env)
              if n["url"] not in assignment]
    t0 = time.perf_counter()
    out = env.node_post(
        source, f"/admin/ec/generate?volume={vid}"
                f"&collection={collection}",
        body={"assignment": {str(s): u
                             for s, u in enumerate(assignment)},
              "spares": spares, "rate_mbps": rate_mbps})
    wall = time.perf_counter() - t0
    stats = out.get("stats") or {}
    # grouped by the final placement: a failover may have moved a dead
    # target's shards to a spare ('' = the source kept them)
    final = {int(s): (u or source)
             for s, u in (out.get("assignment") or {}).items()}
    if not final:
        final = dict(enumerate(assignment))
    by_node: Dict[str, List[int]] = {}
    for sid in sorted(final):
        by_node.setdefault(final[sid], []).append(sid)
    env.write(f"volume {vid}: streamed {len(final)} shards from "
              f"{source} (encode {stats.get('encode_busy_s', 0.0)}s ∥ "
              f"spread {stats.get('spread_busy_s', 0.0)}s, overlap "
              f"{stats.get('overlap_frac', 0.0)})")

    def mount(target):
        url, shards = target
        s = ",".join(map(str, shards))
        if url != source:
            # the shard bytes are there already: only the sidecars
            env.node_post(url, f"/admin/ec/copy?volume={vid}"
                               f"&collection={collection}"
                               f"&source={source}&shards="
                               f"&copy_ecx=true")
        env.node_post(url, f"/admin/ec/mount?volume={vid}"
                           f"&collection={collection}&shards={s}")
        return s

    for (url, _), s in zip(
            by_node.items(),
            fan_out_must_succeed(mount, list(by_node.items()),
                                 what=f"ec shard mount for volume {vid}",
                                 dedicated=True)):
        env.write(f"volume {vid}: shards {s} -> {url}")
    if source not in by_node:
        # the source kept no shards: drop its now-orphan index sidecars
        env.node_post(source, f"/admin/ec/delete_shards?volume={vid}"
                              f"&collection={collection}&shards=")
    if timings is not None:
        timings["encode_wall_s"] = timings.get("encode_wall_s", 0) + wall
        _merge_stats(timings, out)


def _merge_stats(timings: Dict, out: dict):
    """Fold a server's ``stats`` into the shell's timings: numbers sum
    across volumes, the per-phase seconds and per-holder counts merge by
    key, anything else is the latest."""
    for key, val in (out.get("stats") or {}).items():
        if key == "phases" and isinstance(val, dict):
            agg = timings.setdefault("phases", {})
            for ph, secs in val.items():
                agg[ph] = round(agg.get(ph, 0.0) + secs, 6)
        elif key in ("holder_fetches", "holder_errors") and \
                isinstance(val, dict):
            agg = timings.setdefault(key, {})
            for holder, n in val.items():
                agg[holder] = agg.get(holder, 0) + n
        elif isinstance(val, (int, float)):
            timings[key] = timings.get(key, 0) + val
        else:
            timings[key] = val


def _encode_spread_copy(env: CommandEnv, vid: int, collection: str,
                        source: str, by_node: Dict[str, List[int]],
                        timings: Dict = None):
    """Two phases: all 14 shards generated on the source, then every
    target pulls and mounts its shards, all targets at once."""
    t0 = time.perf_counter()
    env.node_post(source, f"/admin/ec/generate?volume={vid}"
                          f"&collection={collection}")
    t1 = time.perf_counter()
    env.write(f"volume {vid}: generated {TOTAL_SHARDS} shards on "
              f"{source}")

    def spread(target):
        url, shards = target
        s = ",".join(map(str, shards))
        if url != source:
            env.node_post(url, f"/admin/ec/copy?volume={vid}"
                               f"&collection={collection}&source={source}"
                               f"&shards={s}")
        env.node_post(url, f"/admin/ec/mount?volume={vid}"
                           f"&collection={collection}&shards={s}")
        return s

    for (url, _), s in zip(
            by_node.items(),
            fan_out_must_succeed(spread, list(by_node.items()),
                                 what=f"ec shard spread for volume {vid}",
                                 dedicated=True)):
        env.write(f"volume {vid}: shards {s} -> {url}")
    # the source's shard files it does not keep
    source_keeps = set(by_node.get(source, []))
    extra = [s for s in range(TOTAL_SHARDS) if s not in source_keeps]
    if extra:
        env.node_post(source, f"/admin/ec/delete_shards?volume={vid}"
                              f"&collection={collection}"
                              f"&shards={','.join(map(str, extra))}")
    t2 = time.perf_counter()
    if timings is not None:
        timings["encode_busy_s"] = timings.get("encode_busy_s", 0) + t1 - t0
        timings["spread_busy_s"] = timings.get("spread_busy_s", 0) + t2 - t1
        timings["encode_wall_s"] = timings.get("encode_wall_s", 0) + t2 - t0
        timings.setdefault("overlap_frac", 0.0)


@command("ec.rebuild",
         "[-collection <name>] [-mode stream|copy] "
         "[-repair auto|trace|piggyback|full] : regenerate missing "
         "shards (stream = ranged survivor gather overlapped with the "
         "decode; copy = legacy whole-shard copies; repair = "
         "single-shard strategy — trace ships projected sub-shard "
         "symbols from all survivors on flat volumes, piggyback ships "
         "half-shard planes on piggyback-layout volumes, full pulls k "
         "whole ranges, auto picks by the volume's layout)")
def ec_rebuild(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    for vid_s, info in env.ec_volumes().items():
        vid = int(vid_s)
        collection = info.get("collection", "")
        if "collection" in flags and collection != flags["collection"]:
            continue
        shards = {int(s): urls for s, urls in info["shards"].items()}
        missing = [s for s in range(TOTAL_SHARDS) if s not in shards]
        if not missing:
            continue
        if len(shards) < DATA_SHARDS:
            env.write(f"volume {vid}: only {len(shards)} shards left, "
                      f"cannot rebuild")
            continue
        do_ec_rebuild(env, vid, collection, shards, missing,
                      mode=flags.get("mode"),
                      repair=flags.get("repair"))


def do_ec_rebuild(env: CommandEnv, vid: int, collection: str,
                  shards: Dict[int, List[str]], missing: List[int],
                  mode: str = None, repair: str = None):
    """``mode`` "stream" (GATHER_MODE by default) sends the survivors'
    holder map to the rebuilder, which pulls slab ranges and decodes
    them overlapped: no whole-shard copies. "copy" copies the survivors
    whole, rebuilds, and deletes the copies; a stream that fails falls
    back to it.

    ``repair`` "auto" (REPAIR_MODE by default) lets the
    rebuilder pick the cheapest single-shard strategy for the volume's
    layout — trace repair (projected sub-shard symbols from all
    survivors) on flat volumes, plane repair (half-shard planes from
    k+1 helpers) on piggyback volumes. "trace"/"piggyback" force the
    matching strategy and error on the other layout; "full" forces the
    k-survivor gather on either. Stream mode only."""
    mode = (mode or GATHER_MODE).lower()
    repair = (repair or REPAIR_MODE).lower()
    # the trace's root: the gather, the rebuild and the mount below all
    # carry its traceparent
    root = tracing.start_span("ec.rebuild", volume=vid, mode=mode,
                              repair=repair)
    try:
        # the rebuilder: the server with the most free slots
        rebuilder = _free_nodes(env)[0]["url"]
        if mode == "copy":
            rebuilt = _rebuild_via_copy(env, vid, collection, shards,
                                        rebuilder, root)
        else:
            try:
                rebuilt = _rebuild_streaming(env, vid, collection, shards,
                                             rebuilder, repair=repair)
            except HttpError as e:
                env.write(f"volume {vid}: streaming rebuild failed "
                          f"({e.status}); falling back to copy mode")
                root.tags["fallback"] = "copy"
                rebuilt = _rebuild_via_copy(env, vid, collection, shards,
                                            rebuilder, root)
    except BaseException as e:
        root.tags.setdefault("error", type(e).__name__)
        raise
    finally:
        tracing.finish_span(root)
    env.write(f"volume {vid}: rebuilt shards {rebuilt} on {rebuilder}")


def _rebuild_streaming(env: CommandEnv, vid: int, collection: str,
                       shards: Dict[int, List[str]], rebuilder: str,
                       repair: str = "auto") -> List[int]:
    """One POST: the rebuilder pulls slab-aligned survivor ranges from
    the holder map and feeds them straight into the pipelined decode
    (or, single-shard loss with ``repair`` auto/trace/piggyback, pulls
    projected repair symbols or half-shard planes from the helpers the
    volume's layout prescribes)."""
    sources = {str(sid): urls for sid, urls in shards.items()
               if rebuilder not in urls}
    out = env.node_post(
        rebuilder,
        f"/admin/ec/rebuild?volume={vid}&collection={collection}",
        body={"sources": sources, "repair": repair})
    rebuilt = out.get("rebuilt", [])
    if rebuilt:
        env.node_post(rebuilder,
                      f"/admin/ec/mount?volume={vid}"
                      f"&collection={collection}"
                      f"&shards={','.join(map(str, rebuilt))}")
    return rebuilt


def _rebuild_via_copy(env: CommandEnv, vid: int, collection: str,
                      shards: Dict[int, List[str]], rebuilder: str,
                      root=None) -> List[int]:
    """Copy every survivor the rebuilder lacks whole, rebuild there,
    delete the copies."""
    local = {s for s, urls in shards.items() if rebuilder in urls}
    # the copies from distinct sources run at once; the .ecx rides with
    # exactly one
    to_copy = [(sid, urls[0]) for sid, urls in shards.items()
               if sid not in local]
    copied = [sid for sid, _ in to_copy]

    def pull(job):
        (sid, src), with_ecx = job
        # fan-out threads do not inherit the tracing contextvar: each
        # copy's span is parented on the root explicitly
        with tracing.span("gather", parent=root, shard=sid, source=src):
            env.node_post(
                rebuilder,
                f"/admin/ec/copy?volume={vid}&collection={collection}"
                f"&source={src}&shards={sid}"
                f"&copy_ecx={'true' if with_ecx else 'false'}")

    jobs = [(item, (not local) and i == 0)
            for i, item in enumerate(to_copy)]
    fan_out_must_succeed(pull, jobs,
                         what=f"survivor shard copy for volume {vid}",
                         dedicated=True)
    # rebuild, and mount only the shards that were missing
    out = env.node_post(rebuilder,
                        f"/admin/ec/rebuild?volume={vid}"
                        f"&collection={collection}")
    rebuilt = out.get("rebuilt", [])
    if rebuilt:
        env.node_post(rebuilder,
                      f"/admin/ec/mount?volume={vid}"
                      f"&collection={collection}"
                      f"&shards={','.join(map(str, rebuilt))}")
    # the survivor copies go (they were not mounted here)
    if copied:
        env.node_post(rebuilder,
                      f"/admin/ec/delete_shards?volume={vid}"
                      f"&collection={collection}"
                      f"&shards={','.join(map(str, copied))}")
    return rebuilt


@command("ec.decode",
         "-volumeId <id> | -collection <name> : decode EC back to volumes")
def ec_decode(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    for vid_s, info in env.ec_volumes().items():
        vid = int(vid_s)
        collection = info.get("collection", "")
        if "volumeId" in flags and vid != int(flags["volumeId"]):
            continue
        if "collection" in flags and collection != flags["collection"]:
            continue
        shards = {int(s): urls for s, urls in info["shards"].items()}
        data_shards = {s: u for s, u in shards.items() if s < DATA_SHARDS}
        if len(data_shards) < DATA_SHARDS:
            env.write(f"volume {vid}: missing data shards; run ec.rebuild "
                      f"first")
            continue
        # pick the node holding the most data shards as the decode target
        counts: Dict[str, int] = {}
        for sid, urls in data_shards.items():
            for u in urls:
                counts[u] = counts.get(u, 0) + 1
        target = max(counts, key=counts.get)
        held = {s for s, urls in shards.items() if target in urls}
        for sid, urls in data_shards.items():
            if sid in held:
                continue
            env.node_post(target,
                          f"/admin/ec/copy?volume={vid}"
                          f"&collection={collection}&source={urls[0]}"
                          f"&shards={sid}&copy_ecx=false")
        data_ids = ",".join(str(s) for s in range(DATA_SHARDS))
        env.node_post(target, f"/admin/ec/mount?volume={vid}"
                              f"&collection={collection}"
                              f"&shards={data_ids}")
        env.node_post(target, f"/admin/ec/to_volume?volume={vid}"
                              f"&collection={collection}")
        # remove EC shards cluster-wide
        all_shards = ",".join(map(str, range(TOTAL_SHARDS)))
        holders = {u for urls in shards.values() for u in urls} | {target}
        for u in holders:
            env.node_post(u, f"/admin/ec/delete_shards?volume={vid}"
                             f"&collection={collection}&shards={all_shards}")
        env.write(f"volume {vid}: decoded back to a normal volume on "
                  f"{target}")


def _move_shard(env: CommandEnv, vid: int, collection: str, sid: int,
                src: str, dst: str):
    env.node_post(dst, f"/admin/ec/copy?volume={vid}"
                       f"&collection={collection}&source={src}"
                       f"&shards={sid}")
    env.node_post(dst, f"/admin/ec/mount?volume={vid}"
                       f"&collection={collection}&shards={sid}")
    env.node_post(src, f"/admin/ec/delete_shards?volume={vid}"
                       f"&collection={collection}&shards={sid}")


def _balance_one_ec_volume(env: CommandEnv, vid: int, collection: str,
                           shards: Dict[int, List[str]],
                           node_rack: Dict[str, str]) -> int:
    """Balance one EC volume in two phases: shards evened across racks
    (a lost rack costs no more than its share), then node counts evened
    within each rack. Returns the moves made."""
    moves = 0
    racks = sorted(set(node_rack.values()))
    nodes_in_rack = {r: sorted(u for u, rr in node_rack.items()
                               if rr == r) for r in racks}

    # replicated shards count EVERY holder (a shard may briefly — or by
    # policy — live on several nodes); a move relocates one replica and
    # must never target a node already holding the shard
    def rack_counts() -> Dict[str, int]:
        c = {r: 0 for r in racks}
        for sid, urls in shards.items():
            for u in urls:
                r = node_rack.get(u)
                if r is not None:
                    c[r] += 1
        return c

    def node_counts(urls) -> Dict[str, int]:
        c = {u: 0 for u in urls}
        for sid, holders in shards.items():
            for h in holders:
                if h in c:
                    c[h] += 1
        return c

    def relocate(sid: int, src: str, dst: str):
        _move_shard(env, vid, collection, sid, src, dst)
        shards[sid] = [dst if u == src else u for u in shards[sid]]

    # phase 1: across racks
    if len(racks) > 1:
        ceil_per_rack = math.ceil(len(shards) / len(racks))
        while True:
            rc = rack_counts()
            hi = max(racks, key=lambda r: rc[r])
            lo = min(racks, key=lambda r: rc[r])
            if rc[hi] <= ceil_per_rack or rc[hi] - rc[lo] <= 1:
                break
            nc = node_counts(nodes_in_rack[lo])
            job = None
            for s in sorted(shards):
                src = next((u for u in shards[s]
                            if node_rack.get(u) == hi), None)
                if src is None:
                    continue
                # racks already holding ANOTHER replica of s (besides
                # the one being moved) are off limits — two replicas of
                # one shard in a rack is exactly the fault-domain
                # collapse this phase exists to prevent
                other_racks = {node_rack.get(u) for u in shards[s]
                               if u != src}
                if lo in other_racks:
                    continue
                dst = min((u for u in nodes_in_rack[lo]
                           if u not in shards[s]),
                          key=lambda u: nc[u], default=None)
                if dst is not None:
                    job = (s, src, dst)
                    break
            if job is None:
                break  # nothing movable without double-placing a shard
            relocate(*job)
            moves += 1

    # phase 2: within each rack
    for r in racks:
        urls = nodes_in_rack[r]
        if len(urls) < 2:
            continue
        while True:
            nc = node_counts(urls)
            hi = max(urls, key=lambda u: nc[u])
            lo = min(urls, key=lambda u: nc[u])
            if nc[hi] - nc[lo] <= 1:
                break
            sid = next((s for s in sorted(shards)
                        if hi in shards[s] and lo not in shards[s]),
                       None)
            if sid is None:
                break
            relocate(sid, hi, lo)
            moves += 1
    return moves


@command("ec.balance",
         "[-collection <name>] : spread EC shards evenly across racks, "
         "then across nodes within each rack")
def ec_balance(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    cluster = env.cluster_nodes()
    if not cluster:
        env.write("no volume servers")
        return
    node_rack = {n["url"]: n.get("rack", "") or "DefaultRack"
                 for n in cluster}
    moves = 0
    for vid_s, info in env.ec_volumes().items():
        vid = int(vid_s)
        collection = info.get("collection", "")
        if "collection" in flags and collection != flags["collection"]:
            continue
        shards = {int(s): list(urls)
                  for s, urls in info["shards"].items()}
        moves += _balance_one_ec_volume(env, vid, collection, shards,
                                        node_rack)
    env.write(f"ec.balance: {moves} shard moves")


@command("volume.ec.degraded",
         ": per-server degraded-read engine status (reconstruct-on-read "
         "batching, slab cache, survivor traffic)")
def volume_ec_degraded(env: CommandEnv, args: List[str]):
    nodes = env.cluster_nodes()
    if not nodes:
        env.write("no volume servers")
        return
    for node in nodes:
        url = node["url"]
        try:
            snap = env.node_get(url, "/status").get("ec_degraded") or {}
        except HttpError as e:
            env.write(f"{url}  unreachable: {e}")
            continue
        reads = int(snap.get("reads", 0))
        batches = int(snap.get("batches", 0))
        coalesced = int(snap.get("batched_requests", 0))
        avg_w = coalesced / batches if batches else 0.0
        env.write(
            f"{url}  reads={reads} batches={batches} "
            f"width(avg/max)={avg_w:.1f}/"
            f"{int(snap.get('max_batch_requests', 0))} "
            f"hit_ratio={snap.get('cache_hit_ratio', 0.0):.2f} "
            f"cache={int(snap.get('cache_bytes', 0)) >> 10}KB/"
            f"{int(snap.get('cache_entries', 0))} slabs "
            f"survivor={int(snap.get('survivor_bytes', 0)) >> 10}KB "
            f"(remote {int(snap.get('remote_bytes', 0)) >> 10}KB) "
            f"dispatch(host/dev)={int(snap.get('host_dispatches', 0))}/"
            f"{int(snap.get('device_dispatches', 0))} "
            f"p99={snap.get('p99_ms', 0.0):.1f}ms "
            f"errors={int(snap.get('errors', 0))}")


@command("volume.ec.scrub",
         "[-trigger] [-volumeId <id>]: per-server syndrome-scrub status "
         "(passes, bytes verified, corruption found); -trigger runs a "
         "synchronous pass on every server first")
def volume_ec_scrub(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    nodes = env.cluster_nodes()
    if not nodes:
        env.write("no volume servers")
        return
    vid = flags.get("volumeId")
    for node in nodes:
        url = node["url"]
        try:
            if "trigger" in flags:
                q = f"?volume={int(vid)}" if vid else ""
                env.node_post(url, f"/admin/ec/scrub{q}")
            snap = env.node_get(url, "/admin/ec/scrub_status") or {}
        except HttpError as e:
            env.write(f"{url}  unreachable: {e}")
            continue
        env.write(
            f"{url}  passes={int(snap.get('passes', 0))} "
            f"volumes={int(snap.get('volumes_scrubbed', 0))} "
            f"slabs={int(snap.get('slabs', 0))} "
            f"verified={int(snap.get('bytes_verified', 0)) >> 20}MB "
            f"@{snap.get('last_pass_mbps', 0.0):.1f}MB/s "
            f"corrupt(slabs/cols)={int(snap.get('corrupt_slabs', 0))}/"
            f"{int(snap.get('corrupt_columns', 0))} "
            f"findings={int(snap.get('findings', 0))} "
            f"dispatch(host/dev)={int(snap.get('host_dispatches', 0))}/"
            f"{int(snap.get('device_dispatches', 0))} "
            f"skipped(owner/missing)="
            f"{int(snap.get('skipped_not_owner', 0))}/"
            f"{int(snap.get('skipped_missing', 0))} "
            f"errors={int(snap.get('errors', 0))}")
