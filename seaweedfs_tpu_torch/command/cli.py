"""The ``weed``-style CLI: ``python3 -m seaweedfs_tpu_torch.command.cli
<command> [flags]``, with the JAX package's single-dash flags.

Commands:

- ``master``: a master (raft with ``-peers``, ``-sequencer etcd``);
- ``volume``: a volume server heartbeating to ``-mserver``;
- ``server``: a master and a volume server in one process, and with
  ``-filer`` a filer, with ``-s3`` an S3 gateway over it;
- ``filer``: a filer over ``-store memory|sqlite|sharded`` (``-s3`` adds
  a gateway in its process);
- ``s3``: a gateway over a remote filer (``FilerClient``);
- ``shell``: the admin shell (``-c`` runs ``;``-separated lines);
- ``version``.

A server runs until SIGTERM or SIGINT, then stops (a volume server says
goodbye to its master) and the process exits 0.

The volume server's EC codec is ``-ec.backend cuda|numpy|mesh``: the
kernel on the card (the default), the host's NumPy codec (the CPU: no
card is touched), or the kernel at every card's position. Without a
card, ``cuda`` and ``mesh`` refuse to start. ``-index memory|disk`` is
the needle map. A master started here takes its repair loop's period
from ``SW_REPAIR_INTERVAL_S``, as the JAX master does.

Not ported yet, so absent from the parser: the config files
(``security.toml``, ``master.toml``, ``notification.toml``), TLS
(``-tlsCert``, ``-tlsKey``, ``-tlsCa``, ``-tlsMutual``), the filer
stores redis, mysql, postgres, cassandra and etcd and their flags,
``-mesh.coordinator`` / ``-mesh.processes`` / ``-mesh.processId``, the
WebDAV gateway (``server -webdav``, ``-webdavPort``), the shell's
``-filer`` (its ``fs.*`` commands), and the other subcommands.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading

EC_BACKENDS = ("cuda", "numpy", "mesh")
INDEX_KINDS = ("memory", "disk")
FILER_STORES = ("memory", "sqlite", "sharded")


def _whitelist(spec: str):
    return [w for w in spec.split(",") if w]


def _load_tier_config(path: str):
    if path:
        from ..storage.backend import configure_backends
        with open(path) as f:
            configure_backends(json.load(f))


def _volume_device(ec_backend: str) -> str:
    """Where a volume server's EC work runs: the CPU only when asked
    for (``numpy``); a card otherwise, which must be there."""
    if ec_backend == "numpy":
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"-ec.backend {ec_backend} needs a CUDA device; "
                           f"pass -ec.backend numpy to run on the CPU")
    return "cuda"


def _sequencer(args):
    """``-sequencer etcd``: file keys from CAS blocks on an etcd every
    master shares; else None (memory, or raft with -peers)."""
    if getattr(args, "sequencer", "auto") != "etcd":
        return None
    from ..server.master import default_meta_dir
    from ..topology.topology import EtcdSequencer
    meta_dir = getattr(args, "mdir", "") or default_meta_dir()
    os.makedirs(meta_dir, exist_ok=True)
    print(f"sequencer: etcd at {args.sequencerEtcd} (ceiling file in "
          f"{meta_dir})", flush=True)
    return EtcdSequencer(args.sequencerEtcd, user=args.sequencerEtcdUser,
                         password=args.sequencerEtcdPassword,
                         meta_dir=meta_dir)


def _repair_interval() -> float:
    from ..util import config
    return config.env_float("SW_REPAIR_INTERVAL_S")


def _profiler(args):
    path = getattr(args, "cpuprofile", "")
    if not path:
        return None
    from ..util.profiling import SamplingProfiler
    return SamplingProfiler(path).start()


def _stop_profiler(prof, args):
    if prof is not None:
        prof.stop()
        print(f"cpu profile (collapsed stacks) -> {args.cpuprofile}",
              flush=True)


def cmd_master(args):
    from ..server.master import MasterServer
    m = MasterServer(port=args.port, host=args.ip,
                     sequencer=_sequencer(args),
                     volume_size_limit_mb=args.volumeSizeLimitMB,
                     default_replication=args.defaultReplication,
                     pulse_seconds=args.pulseSeconds,
                     repair_interval=_repair_interval(),
                     jwt_signing_key=args.jwtKey,
                     peers=args.peers, raft_dir=args.mdir,
                     maintenance_scripts=args.maintenanceScripts,
                     maintenance_interval=args.maintenanceIntervalSeconds,
                     vacuum_interval=args.vacuumIntervalSeconds,
                     garbage_threshold=args.garbageThreshold,
                     whitelist=_whitelist(args.whiteList),
                     metrics_address=args.metricsAddress,
                     metrics_interval=args.metricsInterval).start()
    print(f"master listening on {m.url}", flush=True)
    _wait(m)


def cmd_volume(args):
    from ..server.volume_server import VolumeServer
    _load_tier_config(args.tierConfig)
    device = _volume_device(args.ec_backend)
    dirs = args.dir.split(",")
    maxes = [int(x) for x in args.max.split(",")] if args.max else None
    if maxes and len(maxes) == 1:
        maxes = maxes * len(dirs)
    vs = VolumeServer(port=args.port, host=args.ip, directories=dirs,
                      master_url=args.mserver, data_center=args.dataCenter,
                      rack=args.rack, max_volume_counts=maxes,
                      pulse_seconds=args.pulseSeconds,
                      ec_backend=args.ec_backend, device=device,
                      jwt_signing_key=args.jwtKey,
                      index_kind=args.index, fast_port=args.fastPort,
                      public_url=args.publicUrl,
                      read_redirect=args.readRedirect == "true",
                      file_size_limit_mb=args.fileSizeLimitMB,
                      compaction_mbps=args.compactionMBps,
                      whitelist=_whitelist(args.whiteList)).start()
    print(f"volume server listening on {vs.url}, heartbeating to "
          f"{args.mserver}", flush=True)
    if vs.fast_plane is not None:
        print(f"native read plane on {vs.fast_url}", flush=True)
    prof = _profiler(args)
    _wait(vs)
    _stop_profiler(prof, args)


def cmd_server(args):
    """A master and a volume server (and a filer, an S3 gateway) in one
    process."""
    from ..server.master import MasterServer
    from ..server.volume_server import VolumeServer
    _load_tier_config(args.tierConfig)
    device = _volume_device(args.ec_backend)
    m = MasterServer(port=args.masterPort, host=args.ip,
                     default_replication=args.defaultReplication,
                     repair_interval=_repair_interval(),
                     jwt_signing_key=args.jwtKey).start()
    dirs = args.dir.split(",")
    vs = VolumeServer(port=args.port, host=args.ip, directories=dirs,
                      master_url=m.url, data_center=args.dataCenter,
                      rack=args.rack, pulse_seconds=args.pulseSeconds,
                      max_volume_counts=[int(args.max)] * len(dirs),
                      ec_backend=args.ec_backend, device=device,
                      fast_port=args.fastPort,
                      jwt_signing_key=args.jwtKey).start()
    print(f"master on {m.url}, volume server on {vs.url}", flush=True)
    if vs.fast_plane is not None:
        print(f"native read plane on {vs.fast_url}", flush=True)
    stoppables = [vs]
    if args.filer or args.s3:
        from ..server.filer_server import FilerServer
        f = FilerServer(port=args.filerPort, host=args.ip,
                        master_url=m.url,
                        jwt_signing_key=args.jwtKey).start()
        print(f"filer on {f.url}", flush=True)
        if args.s3:
            s3 = _start_s3(f, args.s3Port, args.ip, args.s3Config)
            print(f"s3 gateway on {s3.url}", flush=True)
            stoppables.append(s3)
        stoppables.append(f)
    stoppables.append(m)
    prof = _profiler(args)
    _wait(*stoppables)
    _stop_profiler(prof, args)


def _iam(config_path: str):
    from ..s3.auth import Iam
    if not config_path:
        return Iam()
    with open(config_path) as fh:
        return Iam.from_config(json.load(fh))


def _start_s3(filer_server, port: int, host: str, config_path: str):
    from ..s3.s3_server import S3ApiServer
    return S3ApiServer(filer_server.filer, filer_server.master_url,
                       port=port, host=host,
                       iam=_iam(config_path)).start()


def _store_options(args) -> dict:
    if args.store == "sharded":
        # a directory of shard databases, not the sqlite file's name
        db = "./filer_meta" if args.db == "./filer.db" else args.db
        return {"path": db, "shards": args.storeShards}
    if args.store == "sqlite":
        return {"path": args.db}
    return {}


def cmd_filer(args):
    from ..server.filer_server import FilerServer
    f = FilerServer(port=args.port, host=args.ip, master_url=args.master,
                    store=args.store, store_options=_store_options(args),
                    collection=args.collection,
                    replication=args.defaultReplicaPlacement,
                    chunk_size=args.maxMB << 20,
                    jwt_signing_key=args.jwtKey,
                    cipher=args.encryptVolumeData,
                    compress=args.compress).start()
    print(f"filer listening on {f.url}, master {args.master}", flush=True)
    stoppables = [f]
    if args.s3:
        s3 = _start_s3(f, args.s3Port, args.ip, args.s3Config)
        print(f"s3 gateway on {s3.url}", flush=True)
        stoppables.insert(0, s3)
    _wait(*stoppables)


def _filer_master(filer_url: str) -> str:
    """The master a filer names in its ``/filer/status``."""
    from ..server.http_util import get_json
    url = filer_url if filer_url.startswith("http") \
        else "http://" + filer_url
    return get_json(f"{url}/filer/status").get("master", "")


def cmd_s3(args):
    """A gateway over a remote filer."""
    from ..filer.filer_client import FilerClient
    from ..s3.s3_server import S3ApiServer
    s3 = S3ApiServer(FilerClient(args.filer),
                     args.master or _filer_master(args.filer),
                     port=args.port, host=args.ip,
                     iam=_iam(args.config)).start()
    print(f"s3 gateway on {s3.url}, filer {args.filer}", flush=True)
    _wait(s3)


def cmd_shell(args):
    from ..shell import CommandEnv, run_command, split_script
    env = CommandEnv(args.master)
    if args.c:
        for line in split_script(args.c):
            if not run_command(env, line):
                break
        return
    print("seaweedfs_tpu_torch shell; 'help' lists commands, 'exit' quits")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not run_command(env, line):
            break


def cmd_version(args):
    from .. import VERSION
    print(f"seaweedfs_tpu_torch {VERSION}")


def _wait(*stoppables):
    """Park until SIGTERM or SIGINT, then stop each server in turn."""
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    while not done.wait(1.0):
        pass
    for s in stoppables:
        try:
            s.stop()
        except Exception as e:  # noqa: BLE001 - the others still stop
            logging.getLogger(__name__).warning("stopping %s: %s", s, e)


def _set_verbosity(v: int, vmodule: str):
    """``-v``: 0 warnings, 1 info, 2 and up debug; ``-vmodule
    volume_server=3,filer=1``: the same per module (a logger whose name
    ends with it)."""
    def level(n: int) -> int:
        return (logging.WARNING, logging.INFO)[n] if n < 2 \
            else logging.DEBUG
    logging.basicConfig(level=level(v),
                        format="%(levelname)s %(name)s: %(message)s")
    for item in filter(None, vmodule.split(",")):
        name, _, n = item.partition("=")
        for logger_name in list(logging.root.manager.loggerDict) + [
                f"seaweedfs_tpu_torch.{name}"]:
            if logger_name.split(".")[-1] == name.split(".")[-1]:
                logging.getLogger(logger_name).setLevel(level(int(n or 0)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="weed-tpu")
    p.add_argument("-v", type=int, default=0,
                   help="log verbosity: 0 warnings, 1 info, 2 debug")
    p.add_argument("-vmodule", default="",
                   help="per-module verbosity, e.g. volume_server=3")
    sub = p.add_subparsers(dest="command", required=True)

    m = sub.add_parser("master", help="start a master server")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-pulseSeconds", type=int, default=5)
    m.add_argument("-jwtKey", default="",
                   help="HS256 key for per-fid write tokens")
    m.add_argument("-peers", default="",
                   help="every master's host:port, comma-separated: a "
                        "raft group")
    m.add_argument("-mdir", default="",
                   help="directory for raft state persistence")
    m.add_argument("-maintenanceScripts", default="",
                   help="';'-separated shell lines run on the leader on "
                        'an interval, e.g. "volume.vacuum; ec.rebuild"')
    m.add_argument("-maintenanceIntervalSeconds", type=float,
                   default=17 * 60)
    m.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs allowed on the client "
                        "routes; heartbeats and raft stay open")
    m.add_argument("-metrics.address", dest="metricsAddress", default="",
                   help="push-gateway address named to volume servers")
    m.add_argument("-metrics.intervalSeconds", dest="metricsInterval",
                   type=int, default=15)
    m.add_argument("-vacuumIntervalSeconds", type=float, default=15 * 60,
                   help="vacuum and TTL-reap interval on the leader "
                        "(0: none)")
    m.add_argument("-garbageThreshold", type=float, default=0.3)
    m.add_argument("-sequencer", default="auto", choices=["auto", "etcd"],
                   help="file keys from memory (raft with -peers), or CAS "
                        "blocks on an etcd every master shares")
    m.add_argument("-sequencerEtcd", default="127.0.0.1:2379",
                   help="etcd endpoint for -sequencer etcd")
    m.add_argument("-sequencerEtcdUser", default="")
    m.add_argument("-sequencerEtcdPassword", default="")
    m.set_defaults(fn=cmd_master)

    v = sub.add_parser("volume", help="start a volume server")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-dir", default="./data")
    v.add_argument("-max", default="7")
    v.add_argument("-mserver", default="127.0.0.1:9333")
    v.add_argument("-dataCenter", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-pulseSeconds", type=int, default=5)
    v.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=list(EC_BACKENDS),
                   help="the EC codec: the kernel on the card, the host's "
                        "NumPy codec (the CPU), or the kernel at every "
                        "card's position")
    v.add_argument("-fastPort", type=int, default=0,
                   help="native plane port (0 picks one, -1: none)")
    v.add_argument("-publicUrl", default="",
                   help="the address advertised to clients")
    v.add_argument("-read.redirect", dest="readRedirect", default="true",
                   choices=["true", "false"],
                   help="redirect reads of volumes held elsewhere to a "
                        "replica")
    v.add_argument("-fileSizeLimitMB", type=int, default=256,
                   help="refuse uploads above this size, 0: no limit")
    v.add_argument("-compactionMBps", type=int, default=0,
                   help="vacuum copy pace in MB/s, 0: unpaced")
    v.add_argument("-index", default="memory", choices=list(INDEX_KINDS),
                   help="the needle map: in memory, or on disk for "
                        "indexes larger than RAM")
    v.add_argument("-cpuprofile", default="",
                   help="write an all-thread collapsed-stack CPU profile "
                        "here on shutdown")
    v.add_argument("-jwtKey", default="")
    v.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs allowed to call")
    v.add_argument("-tierConfig", default="",
                   help="JSON file of remote tier backends, e.g. "
                        '{"s3": {"default": {"endpoint": ..., '
                        '"bucket": ...}}}')
    v.set_defaults(fn=cmd_volume)

    s = sub.add_parser("server", help="master + volume (+filer) combined")
    s.add_argument("-cpuprofile", default="",
                   help="write an all-thread collapsed-stack CPU profile "
                        "here on shutdown")
    s.add_argument("-ip", default="127.0.0.1")
    s.add_argument("-masterPort", type=int, default=9333)
    s.add_argument("-port", type=int, default=8080)
    s.add_argument("-dir", default="./data")
    s.add_argument("-max", default="50", help="volume slots per directory")
    s.add_argument("-defaultReplication", default="000")
    s.add_argument("-dataCenter", default="")
    s.add_argument("-rack", default="")
    s.add_argument("-pulseSeconds", type=int, default=5)
    s.add_argument("-filer", action="store_true")
    s.add_argument("-filerPort", type=int, default=8888)
    s.add_argument("-s3", action="store_true")
    s.add_argument("-s3Port", type=int, default=8333)
    s.add_argument("-s3Config", default="",
                   help="IAM identities JSON (the reference's s3 config)")
    s.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=list(EC_BACKENDS))
    s.add_argument("-fastPort", type=int, default=0,
                   help="native plane port (0 picks one, -1: none)")
    s.add_argument("-jwtKey", default="")
    s.add_argument("-tierConfig", default="")
    s.set_defaults(fn=cmd_server)

    f = sub.add_parser("filer", help="start a filer server")
    f.add_argument("-port", type=int, default=8888)
    f.add_argument("-ip", default="127.0.0.1")
    f.add_argument("-master", default="127.0.0.1:9333")
    f.add_argument("-store", default="sqlite", choices=list(FILER_STORES))
    f.add_argument("-db", default="./filer.db",
                   help="metadata path: a sqlite file, or a directory of "
                        "shard databases for -store sharded (default "
                        "./filer_meta there)")
    f.add_argument("-storeShards", type=int, default=8,
                   help="shard count for -store sharded (kept per store "
                        "directory)")
    f.add_argument("-collection", default="")
    f.add_argument("-defaultReplicaPlacement", default="")
    f.add_argument("-maxMB", type=int, default=32,
                   help="autochunk split size")
    f.add_argument("-s3", action="store_true")
    f.add_argument("-s3Port", type=int, default=8333)
    f.add_argument("-s3Config", default="")
    f.add_argument("-jwtKey", default="")
    f.add_argument("-encryptVolumeData", action="store_true",
                   help="AES-256-GCM encrypt chunk data; volume servers "
                        "only see ciphertext")
    f.add_argument("-compress", action="store_true",
                   help="gzip compressible chunks before storing")
    f.set_defaults(fn=cmd_filer)

    s3 = sub.add_parser("s3", help="standalone S3 gateway over a filer")
    s3.add_argument("-port", type=int, default=8333)
    s3.add_argument("-ip", default="127.0.0.1")
    s3.add_argument("-filer", default="127.0.0.1:8888")
    s3.add_argument("-master", default="",
                    help="master url (default: ask the filer)")
    s3.add_argument("-config", default="", help="IAM identities JSON")
    s3.set_defaults(fn=cmd_s3)

    sh = sub.add_parser("shell", help="admin shell")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("-c", default="", help="run one command and exit")
    sh.set_defaults(fn=cmd_shell)

    ver = sub.add_parser("version", help="print version")
    ver.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _set_verbosity(args.v, args.vmodule)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
