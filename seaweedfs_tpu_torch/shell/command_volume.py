"""volume.* shell commands (the JAX package's ``shell/command_volume.py``,
reference weed/shell/command_volume_*.go): list, copy,
configure.replication, move, balance, fix.replication, fsck [-deep],
vacuum, delete, tier.upload and tier.download, mount and unmount, over
the master's ``/cluster/*`` views and the volume servers' admin routes.
Lines printed are the JAX package's."""

from __future__ import annotations

from typing import List

from ..server.http_util import HttpError
from ..storage.types import ReplicaPlacement
from .command_env import CommandEnv, command, parse_flags


@command("volume.list", ": list volumes per server")
def volume_list(env: CommandEnv, args: List[str]):
    for node in env.cluster_nodes():
        env.write(f"{node['url']}  volumes={node['volumes']} "
                  f"ec_shards={node['ec_shards']} free={node['free']:.1f}")
    for vid_s, replicas in sorted(env.all_volumes().items(),
                                  key=lambda kv: int(kv[0])):
        vi = replicas[0]
        env.write(f"  volume {vid_s}: collection={vi.get('collection', '')!r}"
                  f" size={vi.get('size', 0)} files={vi.get('file_count', 0)}"
                  f" deleted={vi.get('delete_count', 0)}"
                  f" rp={vi.get('replica_placement', '000')}"
                  f" replicas={[r['url'] for r in replicas]}"
                  f"{' readonly' if vi.get('read_only') else ''}")
    for vid_s, info in sorted(env.ec_volumes().items(),
                              key=lambda kv: int(kv[0])):
        env.write(f"  ec volume {vid_s}: "
                  f"collection={info.get('collection', '')!r} shards="
                  + ", ".join(f"{s}@{','.join(u)}"
                              for s, u in sorted(info["shards"].items(),
                                                 key=lambda kv: int(kv[0]))))


@command("volume.copy",
         "-volumeId <id> -target <url> [-source <url>] : copy a volume "
         "to another server (source kept)")
def volume_copy(env: CommandEnv, args: List[str]):
    """Reference command_volume_copy.go: target pulls the volume's
    files from the source; unlike volume.move the source stays. Shares
    volume.move's audited freeze/copy/thaw sequence."""
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    target = flags["target"]
    replicas = env.all_volumes().get(str(vid), [])
    if not replicas:
        env.write(f"volume {vid} not found")
        return
    source = flags.get("source", replicas[0]["url"])
    collection = replicas[0].get("collection", "")
    _frozen_copy(env, vid, collection, source, target, replicas,
                 delete_source=False)
    env.write(f"volume {vid}: copied {source} -> {target}")


@command("volume.configure.replication",
         "-volumeId <id> -replication <xyz> : change a volume's "
         "replica placement")
def volume_configure_replication(env: CommandEnv, args: List[str]):
    """Reference command_volume_configure_replication.go: rewrite the
    superblock placement byte on every holder; the master adopts the
    new placement from the next heartbeats (repair to the new level is
    then volume.fix.replication's job)."""
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    replication = flags["replication"]
    replicas = env.all_volumes().get(str(vid), [])
    if not replicas:
        env.write(f"volume {vid} not found")
        return
    done, failed = [], []
    for r in replicas:
        try:
            env.node_post(r["url"],
                          f"/admin/volume/configure_replication"
                          f"?volume={vid}&replication={replication}")
            done.append(r["url"])
        except Exception as e:  # noqa: BLE001 - per-holder report
            failed.append((r["url"], str(e)))
    env.write(f"volume {vid}: replication -> {replication} on "
              f"{len(done)} holder(s)")
    for url, err in failed:
        env.write(f"  FAILED on {url}: {err}")
    if done and failed:
        env.write(f"  WARNING: holders now disagree on placement — "
                  f"fix the failures and re-run")


@command("volume.move",
         "-volumeId <id> -target <url> : move a volume to another server")
def volume_move(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    target = flags["target"]
    replicas = env.all_volumes().get(str(vid), [])
    if not replicas:
        env.write(f"volume {vid} not found")
        return
    source = flags.get("source", replicas[0]["url"])
    collection = replicas[0].get("collection", "")
    _move_volume(env, vid, collection, source, target, replicas)
    env.write(f"volume {vid}: {source} -> {target}")


def _frozen_copy(env: CommandEnv, vid: int, collection: str, source: str,
                 target: str, replicas, delete_source: bool):
    """Freeze -> copy [-> delete source] -> thaw exactly what WE froze.
    Without the freeze, writes landing after the .idx snapshot would be
    lost (the copy is .idx-then-.dat). Replicas that were already
    readonly (an operator's deliberate freeze, a keep-local tiered
    volume) are left untouched — and left frozen afterwards."""
    froze = []
    deleted = False
    try:
        for r in replicas:
            # freeze unconditionally (idempotent); the response's
            # was_readonly — the holder's OWN prior state, not the
            # master's heartbeat-delayed view — decides what to thaw
            out = env.node_post(r["url"],
                                f"/admin/volume/readonly?volume={vid}")
            if not (out or {}).get("was_readonly"):
                froze.append(r["url"])
        env.node_post(target, f"/admin/volume/copy?volume={vid}"
                              f"&collection={collection}&source={source}")
        if delete_source:
            env.node_post(source, f"/admin/delete_volume?volume={vid}")
            deleted = True
    finally:
        # thaw our freezes even when the copy or delete blew up mid-way
        for url in froze:
            if deleted and url == source:
                continue
            try:
                env.node_post(url, f"/admin/volume/readonly?volume={vid}"
                                   f"&readonly=false")
            except Exception:
                pass


def _move_volume(env: CommandEnv, vid: int, collection: str, source: str,
                 target: str, replicas):
    _frozen_copy(env, vid, collection, source, target, replicas,
                 delete_source=True)


@command("volume.balance", ": even out volume counts across servers")
def volume_balance(env: CommandEnv, args: List[str]):
    moves = 0
    while True:
        nodes = env.cluster_nodes()
        if len(nodes) < 2:
            break
        counts = {n["url"]: n["volumes"] for n in nodes}
        hi = max(counts, key=counts.get)
        lo = min(counts, key=counts.get)
        if counts[hi] - counts[lo] <= 1:
            break
        # pick a volume on hi that lo doesn't hold
        movable = None
        for vid_s, replicas in env.all_volumes().items():
            urls = [r["url"] for r in replicas]
            if hi in urls and lo not in urls:
                movable = (int(vid_s), replicas[0].get("collection", ""),
                           replicas)
                break
        if movable is None:
            break
        vid, collection, replicas = movable
        _move_volume(env, vid, collection, hi, lo, replicas)
        env.write(f"moved volume {vid}: {hi} -> {lo}")
        moves += 1
        if moves > 100:
            break
    env.write(f"volume.balance: {moves} moves")


@command("volume.fix.replication",
         ": re-replicate under-replicated volumes")
def volume_fix_replication(env: CommandEnv, args: List[str]):
    fixed = 0
    nodes = env.cluster_nodes()
    for vid_s, replicas in env.all_volumes().items():
        vi = replicas[0]
        rp = ReplicaPlacement.parse(vi.get("replica_placement", "000"))
        have = [r["url"] for r in replicas]
        if len(have) >= rp.copy_count:
            continue
        candidates = [n["url"] for n in
                      sorted(nodes, key=lambda n: -n.get("free", 0))
                      if n["url"] not in have and n.get("free", 0) >= 1]
        needed = rp.copy_count - len(have)
        for target in candidates[:needed]:
            env.node_post(target,
                          f"/admin/volume/copy?volume={vid_s}"
                          f"&collection={vi.get('collection', '')}"
                          f"&source={have[0]}")
            env.write(f"volume {vid_s}: replicated to {target}")
            fixed += 1
    env.write(f"volume.fix.replication: {fixed} copies made")


@command("volume.fsck", "[-deep] : check volume integrity cluster-wide")
def volume_fsck(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    total = bad = 0
    for vid_s, replicas in sorted(env.all_volumes().items(),
                                  key=lambda kv: int(kv[0])):
        for r in replicas:
            total += 1
            if flags.get("deep"):
                out = env.node_post(r["url"],
                                    f"/admin/volume/verify?volume={vid_s}")
                status = f"checked={out['checked']} errors={out['errors']}"
                if out["errors"]:
                    bad += 1
            else:
                status = f"files={r.get('file_count', 0)}"
            env.write(f"volume {vid_s} @ {r['url']}: {status}")
    env.write(f"volume.fsck: {total} replicas, {bad} with errors")


@command("volume.vacuum", "[-garbageThreshold 0.3] : trigger vacuum")
def volume_vacuum(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    q = f"?garbageThreshold={flags.get('garbageThreshold', 0.3)}"
    out = env.master_post(f"/vol/vacuum{q}")
    for r in out.get("vacuumed", []):
        env.write(f"volume {r['volume']}: "
                  f"{'vacuumed' if r['ok'] else 'FAILED'}")


@command("volume.delete", "-volumeId <id> : delete a volume everywhere")
def volume_delete(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    for r in env.all_volumes().get(str(vid), []):
        env.node_post(r["url"], f"/admin/delete_volume?volume={vid}")
        env.write(f"volume {vid}: deleted on {r['url']}")


@command("volume.tier.upload",
         "-volumeId <id> -dest <kind.id> [-keepLocalDatFile] : move a "
         "volume's .dat to a remote tier backend")
def volume_tier_upload(env: CommandEnv, args: List[str]):
    """Reference command_volume_tier_upload.go: freeze every replica,
    then ship from one of them (replica .dat files are not byte-equal in
    general: two uploaders on one backend key would corrupt the tier for
    whichever .idx loses). A failure anywhere, a later freeze included,
    thaws exactly the replicas this command froze, judged by each
    holder's own ``was_readonly``; one unreachable holder neither stops
    the others' thaw nor hides the first error."""
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    dest = flags["dest"]
    replicas = env.all_volumes().get(str(vid), [])
    if not replicas:
        env.write(f"volume {vid} not found")
        return
    frozen = []
    keep = "true" if flags.get("keepLocalDatFile") else "false"
    try:
        for r in replicas:
            out = env.node_post(r["url"],
                                f"/admin/volume/readonly?volume={vid}")
            if not (out or {}).get("was_readonly"):
                frozen.append(r["url"])
        r = replicas[0]
        info = env.node_post(
            r["url"], f"/admin/volume/tier_upload?volume={vid}"
                      f"&dest={dest}&keep_local={keep}")
    except Exception:
        for url in frozen:
            try:
                env.node_post(url, f"/admin/volume/readonly?volume={vid}"
                                   f"&readonly=false")
            except Exception:  # noqa: BLE001 - the first error is raised
                pass
        raise
    env.write(f"volume {vid} @ {r['url']}: .dat -> "
              f"{info['remote']['backend']}/{info['remote']['key']} "
              f"({info['remote']['file_size']} bytes)")


@command("volume.tier.download",
         "-volumeId <id> [-deleteRemote] : bring a tiered volume's .dat "
         "back to local disk")
def volume_tier_download(env: CommandEnv, args: List[str]):
    """Reference command_volume_tier_download.go: every replica whose
    .dat is remote pulls it back; a replica that kept its local .dat
    ("no remote tier") is passed by."""
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    delete = "true" if flags.get("deleteRemote") else "false"
    replicas = env.all_volumes().get(str(vid), [])
    if not replicas:
        env.write(f"volume {vid} not found")
        return
    brought = 0
    for r in replicas:
        try:
            out = env.node_post(
                r["url"], f"/admin/volume/tier_download?volume={vid}"
                          f"&delete_remote={delete}")
        except HttpError as e:
            if "no remote tier" in str(e):
                continue
            raise
        brought += 1
        env.write(f"volume {vid} @ {r['url']}: .dat local again "
                  f"({out['size']} bytes)")
    if not brought:
        env.write(f"volume {vid}: no replica is tiered")


@command("volume.mount",
         "-volumeId <id> -node <url> : serve an on-disk volume")
def volume_mount(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    out = env.node_post(
        flags["node"],
        f"/admin/volume/mount?volume={flags['volumeId']}")
    env.write(f"volume {flags['volumeId']}: mounted={out.get('mounted')}")


@command("volume.unmount",
         "-volumeId <id> -node <url> : stop serving (files stay on disk)")
def volume_unmount(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    out = env.node_post(
        flags["node"],
        f"/admin/volume/unmount?volume={flags['volumeId']}")
    env.write(f"volume {flags['volumeId']}: "
              f"unmounted={out.get('unmounted')}")
