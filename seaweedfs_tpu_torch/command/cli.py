"""The ``weed``-style CLI: ``python3 -m seaweedfs_tpu_torch.command.cli
<command> [flags]``, with the JAX package's single-dash flags.

Commands:

- ``master``: a master (raft with ``-peers``, ``-sequencer etcd``);
- ``volume``: a volume server heartbeating to ``-mserver``;
- ``server``: a master and a volume server in one process, and with
  ``-filer`` a filer, with ``-s3`` an S3 gateway, with ``-webdav`` a
  WebDAV gateway over it;
- ``filer``: a filer over ``-store memory|sqlite|sharded`` or the
  network stores ``redis|mysql|postgres|cassandra|etcd`` (their
  ``-redisAddr``, ``-mysqlUser``... flags; ``-s3`` adds a gateway in its
  process);
- ``s3``: a gateway over a remote filer (``FilerClient``);
- ``webdav``: a WebDAV gateway over a remote filer;
- ``shell``: the admin shell (``-c`` runs ``;``-separated lines;
  ``-filer`` for the fs.* and bucket.* commands);
- ``watch``: print a filer's metadata events as they come;
- ``filer.replicate``: apply a filer's events to a sink (another filer,
  S3, GCS, B2, Azure), from a JSON config;
- ``msgBroker``: the topic broker (``/queue/*``);
- ``benchmark``: assign and upload ``-n`` files, then read them back at
  random (``-native``: the load generator);
- ``upload`` (above ``-maxMB``, chunks behind a manifest), ``download``
  (into ``-dir``, under the stored name's last part);
- ``filer.copy``: local files and directories into a filer folder;
- the offline volume tools ``backup``, ``see``, ``export``, ``fix``,
  ``compact`` (``command/volume_tools``);
- ``scaffold``: an example config file; ``version``.

A server runs until SIGTERM or SIGINT, then stops (a volume server says
goodbye to its master) and the process exits 0.

Configuration, as in JAX: ``security.toml`` (or ``.json``) and
``master.toml`` from ``util/config.SEARCH_DIRS`` (``.``,
``~/.seaweedfs_tpu``, ``/etc/seaweedfs_tpu``), with ``WEED_*``
variables on top; an explicit flag always wins. ``security`` gives the
write-token key (``[jwt.signing] key``) and TLS (``[https] cert``,
``key``, ``ca``, ``mutual``), which every command applies, clients
included, so ``upload`` or ``shell`` reach a TLS cluster; ``-tlsCert``,
``-tlsKey``, ``-tlsCa`` and ``-tlsMutual`` on the server commands.
``master`` gives the maintenance scripts and interval, the etcd
sequencer, the growth counts (``[master.volume_growth]``), the tier
backends (``[storage.backend.<kind>.<id>]``) and the maintenance
shell's filer. ``notification`` (or ``WEED_NOTIFICATION_*``) enables
one publisher of a filer's metadata events (``filer``, ``server
-filer``).

The volume server's EC codec is ``-ec.backend
auto|cuda|numpy|native|mesh``: the kernel on the card (``cuda``, the
default), the host's AVX2 codec (``native``, ops/rs_native) or NumPy
codec (the CPU: no card is touched), the kernel at every card's position
(``mesh``), or ``auto``, the JAX package's choice with its TPU read as
the card: the card, else native, else numpy. Without a card, ``cuda``
and ``mesh`` refuse to start. ``-index memory|compact|sortedfile|disk``
is the needle map (storage/compact_map). A master started here takes its
repair loop's period from ``SW_REPAIR_INTERVAL_S``, as the JAX master
does.

Not ported yet, so absent from the parser: ``-mesh.coordinator`` /
``-mesh.processes`` / ``-mesh.processId``, and the subcommand
``mount``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading

EC_BACKENDS = ("auto", "cuda", "numpy", "native", "mesh")
INDEX_KINDS = ("memory", "compact", "sortedfile", "disk")
FILER_STORES = ("memory", "sqlite", "sharded", "redis", "mysql", "postgres",
                "cassandra", "etcd")


def _whitelist(spec: str):
    return [w for w in spec.split(",") if w]


def _security_cfg(args):
    """security.toml/json and WEED_*, loaded once a process (kept on
    ``args``)."""
    if not hasattr(args, "_security_cfg_cache"):
        from ..util.config import load_config
        args._security_cfg_cache = load_config("security")
    return args._security_cfg_cache


def _apply_security_config(args):
    """The write-token key: the flag, else the config."""
    from ..util.config import config_get
    if not getattr(args, "jwtKey", ""):
        args.jwtKey = config_get(_security_cfg(args),
                                 "jwt.signing.key", "") or ""


def _apply_tls_config(args):
    """TLS for every command (reference security/tls.go): servers serve
    cert and key, and clients need the CA and their identity to reach a
    TLS cluster. Each flag beats the config's key."""
    from ..util.config import config_get
    cfg = _security_cfg(args)
    cert = getattr(args, "tlsCert", "") or \
        config_get(cfg, "https.cert", "") or ""
    key = getattr(args, "tlsKey", "") or \
        config_get(cfg, "https.key", "") or ""
    ca = getattr(args, "tlsCa", "") or \
        config_get(cfg, "https.ca", "") or ""
    mutual = getattr(args, "tlsMutual", False) or \
        str(config_get(cfg, "https.mutual", "")).lower() in ("true", "1")
    if cert or ca:
        from ..server.http_util import configure_tls
        configure_tls(cert, key, ca, mutual=mutual)


def _apply_master_config(args) -> dict:
    """master.toml / WEED_MASTER_* (reference scaffold.go
    MASTER_TOML_EXAMPLE, master_server.go:187-232) for what the flags
    left at their defaults: an explicit flag always wins. Configures the
    tier backends it names; returns the master's keyword arguments that
    have no flag (``growth_counts``, ``maintenance_filer_url``)."""
    from urllib.parse import urlparse

    from ..util.config import config_get, load_config
    cfg = load_config("master")
    scripts = str(config_get(cfg, "master.maintenance.scripts", "")
                  or "")
    if scripts.strip() and not getattr(args, "maintenanceScripts", ""):
        # the file's lines, the flag's ';'
        args.maintenanceScripts = ";".join(
            ln.strip() for ln in scripts.splitlines() if ln.strip())
    sleep_m = config_get(cfg, "master.maintenance.sleep_minutes", None)
    if sleep_m is not None and \
            getattr(args, "maintenanceIntervalSeconds", 17 * 60) \
            == 17 * 60:
        args.maintenanceIntervalSeconds = float(sleep_m) * 60
    if str(config_get(cfg, "master.sequencer.type", "")) == "etcd" \
            and getattr(args, "sequencer", "auto") == "auto":
        args.sequencer = "etcd"
        urls = str(config_get(
            cfg, "master.sequencer.sequencer_etcd_urls", "") or "")
        if urls and getattr(args, "sequencerEtcd", "") \
                in ("", "127.0.0.1:2379"):
            first = urls.split(",")[0].strip()
            p = urlparse(first if "//" in first else "//" + first)
            if p.hostname:
                args.sequencerEtcd = f"{p.hostname}:{p.port or 2379}"
    growth = {}
    for copies, key in ((1, "copy_1"), (2, "copy_2"), (3, "copy_3"),
                        ("other", "copy_other")):
        val = config_get(cfg, f"master.volume_growth.{key}", None)
        if val is not None:
            growth[copies] = int(val)
    # [storage.backend.<kind>.<id>] back into configure_backends' nested
    # shape; past the id, the segments are one parameter's name whose
    # underscores a WEED_* variable turned into dots
    nested = {}
    for key, val in cfg.items():
        parts = key.split(".")
        if parts[:2] == ["storage", "backend"] and len(parts) >= 5:
            _, _, kind, bid = parts[:4]
            nested.setdefault(kind, {}).setdefault(bid, {})[
                "_".join(parts[4:])] = val
    backends = {}
    rename = {"aws_access_key_id": "access_key",
              "aws_secret_access_key": "secret_key"}
    for kind, ids in nested.items():
        for bid, params in ids.items():
            enabled = params.pop("enabled", False)
            if str(enabled).lower() not in ("true", "1"):
                continue
            backends.setdefault(kind, {})[bid] = {
                rename.get(k, k): v for k, v in params.items()}
    if backends:
        from ..storage.backend import configure_backends
        configure_backends(backends)
    filer_url = str(config_get(cfg, "master.filer.default_filer_url",
                               "") or "")
    maintenance_filer = ""
    if filer_url:
        p = urlparse(filer_url if "//" in filer_url else "//" + filer_url)
        if p.hostname:
            maintenance_filer = f"{p.hostname}:{p.port or 8888}"
    return {"growth_counts": growth or None,
            "maintenance_filer_url": maintenance_filer}


def _load_tier_config(path: str):
    if path:
        from ..storage.backend import configure_backends
        with open(path) as f:
            configure_backends(json.load(f))


def _volume_codec(ec_backend: str):
    """A volume server's EC codec and where its work runs, as
    ``(backend, device)`` from ``ops.codec.resolve_backend``; ``cuda``
    and ``mesh`` need a card, which must be there."""
    from ..ops.codec import resolve_backend
    backend, device = resolve_backend(ec_backend)
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"-ec.backend {ec_backend} needs a CUDA "
                               f"device; pass -ec.backend native or numpy "
                               f"to run on the CPU")
    return backend, device


def _sequencer(args):
    """``-sequencer etcd`` (or master.toml's): file keys from CAS blocks
    on an etcd every master shares; else None (memory, or raft with
    -peers). The ceiling file goes to ``-mdir``; ``server``, which has
    none, keeps it under its first data directory."""
    if getattr(args, "sequencer", "auto") != "etcd":
        return None
    from ..server.master import default_meta_dir
    from ..topology.topology import EtcdSequencer
    meta_dir = getattr(args, "mdir", "")
    if not meta_dir:
        data_dirs = getattr(args, "dir", "")
        meta_dir = os.path.join(data_dirs.split(",")[0].strip(),
                                "master-meta") if data_dirs \
            else default_meta_dir()
    os.makedirs(meta_dir, exist_ok=True)
    endpoint = getattr(args, "sequencerEtcd", "") or "127.0.0.1:2379"
    print(f"sequencer: etcd at {endpoint} (ceiling file in {meta_dir})",
          flush=True)
    return EtcdSequencer(endpoint,
                         user=getattr(args, "sequencerEtcdUser", ""),
                         password=getattr(args, "sequencerEtcdPassword", ""),
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
    _apply_security_config(args)
    master_cfg = _apply_master_config(args)
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
                     metrics_interval=args.metricsInterval,
                     **master_cfg).start()
    print(f"master listening on {m.url}", flush=True)
    _wait(m)


def cmd_volume(args):
    _apply_security_config(args)
    from ..server.volume_server import VolumeServer
    _load_tier_config(args.tierConfig)
    backend, device = _volume_codec(args.ec_backend)
    dirs = args.dir.split(",")
    maxes = [int(x) for x in args.max.split(",")] if args.max else None
    if maxes and len(maxes) == 1:
        maxes = maxes * len(dirs)
    vs = VolumeServer(port=args.port, host=args.ip, directories=dirs,
                      master_url=args.mserver, data_center=args.dataCenter,
                      rack=args.rack, max_volume_counts=maxes,
                      pulse_seconds=args.pulseSeconds,
                      ec_backend=backend, device=device,
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
    _apply_security_config(args)
    master_cfg = _apply_master_config(args)
    from ..server.master import MasterServer
    from ..server.volume_server import VolumeServer
    _load_tier_config(args.tierConfig)
    backend, device = _volume_codec(args.ec_backend)
    m = MasterServer(port=args.masterPort, host=args.ip,
                     default_replication=args.defaultReplication,
                     repair_interval=_repair_interval(),
                     jwt_signing_key=args.jwtKey,
                     sequencer=_sequencer(args),
                     maintenance_scripts=getattr(
                         args, "maintenanceScripts", ""),
                     maintenance_interval=getattr(
                         args, "maintenanceIntervalSeconds", 17 * 60),
                     **master_cfg).start()
    dirs = args.dir.split(",")
    vs = VolumeServer(port=args.port, host=args.ip, directories=dirs,
                      master_url=m.url, data_center=args.dataCenter,
                      rack=args.rack, pulse_seconds=args.pulseSeconds,
                      max_volume_counts=[int(args.max)] * len(dirs),
                      ec_backend=backend, device=device,
                      fast_port=args.fastPort,
                      jwt_signing_key=args.jwtKey).start()
    print(f"master on {m.url}, volume server on {vs.url}", flush=True)
    if vs.fast_plane is not None:
        print(f"native read plane on {vs.fast_url}", flush=True)
    stoppables = [vs]
    if args.filer or args.s3 or args.webdav:
        from ..server.filer_server import FilerServer
        f = FilerServer(port=args.filerPort, host=args.ip,
                        master_url=m.url,
                        jwt_signing_key=args.jwtKey,
                        notify_publisher=_notification_publisher()).start()
        print(f"filer on {f.url}", flush=True)
        if args.s3:
            s3 = _start_s3(f, args.s3Port, args.ip, args.s3Config)
            print(f"s3 gateway on {s3.url}", flush=True)
            stoppables.append(s3)
        if args.webdav:
            from ..server.webdav_server import WebDavServer
            w = WebDavServer(f.filer, m.url, port=args.webdavPort,
                             host=args.ip).start()
            print(f"webdav on {w.url}", flush=True)
            stoppables.append(w)
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


def _notification_publisher():
    """The filer's event publisher: the one ``[notification.<kind>]``
    section of notification.toml (or ``WEED_NOTIFICATION_*``) with
    ``enabled = true``; None when there is none."""
    from ..notification.queues import publisher_from_config
    from ..util.config import load_config
    pub = publisher_from_config(load_config("notification"))
    if pub is not None:
        print(f"notification -> {pub.name}", flush=True)
    return pub


def _store_options(args) -> dict:
    if args.store == "sharded":
        # a directory of shard databases, not the sqlite file's name
        db = "./filer_meta" if args.db == "./filer.db" else args.db
        return {"path": db, "shards": args.storeShards}
    if args.store == "sqlite":
        return {"path": args.db}
    # the network stores: -<store>Addr, User, Password and their database
    fields = {"redis": ("addr", "password", "db"),
              "mysql": ("addr", "user", "password", "database"),
              "postgres": ("addr", "user", "password", "database"),
              "cassandra": ("addr", "user", "password", "keyspace"),
              "etcd": ("addr", "user", "password")}.get(args.store, ())
    return {key: getattr(args, args.store + key.capitalize())
            for key in fields}


def cmd_filer(args):
    _apply_security_config(args)
    from ..server.filer_server import FilerServer
    f = FilerServer(port=args.port, host=args.ip, master_url=args.master,
                    store=args.store, store_options=_store_options(args),
                    collection=args.collection,
                    replication=args.defaultReplicaPlacement,
                    chunk_size=args.maxMB << 20,
                    jwt_signing_key=args.jwtKey,
                    cipher=args.encryptVolumeData,
                    compress=args.compress,
                    notify_publisher=_notification_publisher()).start()
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


def cmd_webdav(args):
    """A WebDAV gateway over a remote filer."""
    from ..filer.filer_client import FilerClient
    from ..server.webdav_server import WebDavServer
    w = WebDavServer(FilerClient(args.filer),
                     args.master or _filer_master(args.filer),
                     port=args.port, host=args.ip,
                     collection=args.collection,
                     chunk_size=args.maxMB << 20).start()
    print(f"webdav on {w.url}, filer {args.filer}", flush=True)
    _wait(w)


def cmd_shell(args):
    from ..shell import CommandEnv, run_command, split_script
    env = CommandEnv(args.master, filer_url=args.filer)
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


def cmd_benchmark(args):
    from .benchmark import run_benchmark, run_native_benchmark
    prof = _profiler(args)
    try:
        if args.native:
            run_native_benchmark(args.master, file_size=args.size,
                                 concurrency=args.c,
                                 collection=args.collection,
                                 seconds=args.seconds, pool=args.pool,
                                 assign_batch=args.assignBatch)
        else:
            run_benchmark(args.master, num_files=args.n,
                          file_size=args.size, concurrency=args.c,
                          collection=args.collection,
                          assign_batch=args.assignBatch)
    finally:
        _stop_profiler(prof, args)


def cmd_upload(args):
    from ..client import operation as op
    max_bytes = args.maxMB << 20
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        if max_bytes and len(data) > max_bytes:
            from ..client.chunked import submit_chunked
            fid = submit_chunked(args.master, data, filename=path,
                                 collection=args.collection,
                                 replication=args.replication,
                                 ttl=args.ttl, chunk_size=max_bytes)
        else:
            fid = op.upload_data(args.master, data, filename=path,
                                 collection=args.collection,
                                 replication=args.replication,
                                 ttl=args.ttl)
        print(f"{path} -> {fid}")


def cmd_download(args):
    from ..client import operation as op
    os.makedirs(args.dir, exist_ok=True)
    for fid in args.fids:
        data, name = op.read_file_named(args.master, fid)
        # the stored name is the uploader's: only its last part, so that
        # it cannot climb out of -dir
        name = os.path.basename(name.replace("\\", "/"))
        out = os.path.join(args.dir, name or fid.replace(",", "_"))
        with open(out, "wb") as f:
            f.write(data)
        print(f"{fid} -> {out} ({len(data)} bytes)")


def cmd_backup(args):
    from .volume_tools import backup_volume
    out = backup_volume(args.server, args.volumeId, args.dir,
                        collection=args.collection)
    print(f"volume {out['volume']}: {out['mode']} sync, "
          f"{out['applied']} records, {out['size']} bytes")


def cmd_see(args):
    """An index (``.idx``, ``.ecx``) or a ``.dat``, by its name."""
    from . import volume_tools
    if args.file.endswith((".idx", ".ecx")):
        n = volume_tools.see_idx(args.file, offset_width=args.offsetWidth,
                                 limit=args.limit)
        print(f"{n} index records")
    else:
        n = volume_tools.see_dat(args.file, limit=args.limit)
        print(f"{n} needles")


def cmd_export(args):
    from .volume_tools import export_volume
    listed = export_volume(args.dir, args.volumeId,
                           collection=args.collection,
                           tar_path=args.o or None)
    for fid, name, size in listed:
        print(f"{fid}\t{name}\t{size}")
    print(f"exported {len(listed)} files")


def cmd_fix(args):
    from .volume_tools import fix_volume
    n = fix_volume(args.dir, args.volumeId, collection=args.collection)
    print(f"walked {n} records")


def cmd_compact(args):
    from .volume_tools import compact_volume
    out = compact_volume(args.dir, args.volumeId,
                         collection=args.collection, method=args.method)
    print(f"volume {out['volume']}: {out['before']} -> "
          f"{out['after']} bytes")


def cmd_filer_copy(args):
    """Local files and directories into a filer folder (reference
    ``weed filer.copy``): the last path is the destination
    (``[http://]filer:port/dir/``), the ones before it the sources; a
    directory goes in whole under its own name, ``-include`` keeps the
    names its glob matches, ``-c`` files upload at once. Exits 1 when
    any file failed."""
    import fnmatch
    import mimetypes
    import posixpath
    import urllib.parse
    from concurrent.futures import ThreadPoolExecutor

    from ..server.http_util import http_call

    if len(args.paths) < 2:
        raise SystemExit("usage: filer.copy <src>... http://filer/dir/")
    dest = args.paths[-1]
    parsed = urllib.parse.urlparse(
        dest if "://" in dest else "http://" + dest)
    filer = parsed.netloc
    # unquoted here: put() quotes the whole path once
    dest_dir = urllib.parse.unquote(parsed.path).rstrip("/") or "/"

    work = []  # (local path, remote path)
    for src in args.paths[:-1]:
        if os.path.isdir(src):
            base = os.path.basename(os.path.abspath(src))
            for root, _dirs, files in os.walk(src):
                rel_root = os.path.relpath(root, src)
                for name in files:
                    if args.include and not fnmatch.fnmatch(
                            name, args.include):
                        continue
                    rel = name if rel_root == "." else \
                        os.path.join(rel_root, name)
                    work.append((os.path.join(root, name),
                                 posixpath.join(dest_dir, base,
                                                rel.replace(os.sep, "/"))))
        elif os.path.isfile(src):
            if args.include and not fnmatch.fnmatch(
                    os.path.basename(src), args.include):
                continue
            work.append((src, posixpath.join(dest_dir,
                                             os.path.basename(src))))
        else:
            raise SystemExit(f"no such file or directory: {src}")

    q = [f"{k}={urllib.parse.quote(v)}" for k, v in (
        ("collection", args.collection), ("replication", args.replication),
        ("ttl", args.ttl)) if v]
    suffix = ("?" + "&".join(q)) if q else ""

    def put(item):
        local, remote = item
        size = os.path.getsize(local)
        mime = mimetypes.guess_type(local)[0] or "application/octet-stream"
        # the file object streams: -c workers must not each hold a
        # whole file
        with open(local, "rb") as f:
            http_call("PUT", f"http://{filer}"
                             f"{urllib.parse.quote(remote)}{suffix}",
                      f, {"Content-Type": mime,
                          "Content-Length": str(size)}, timeout=600)
        return remote, size

    copied = errors = 0
    with ThreadPoolExecutor(max_workers=args.c) as pool:
        for fut in [pool.submit(put, item) for item in work]:
            try:
                remote, n = fut.result()
                copied += 1
                print(f"{remote} ({n} bytes)")
            except Exception as e:  # noqa: BLE001 - reported per file
                errors += 1
                print(f"ERROR: {e}", file=sys.stderr)
    print(f"copied {copied} files to {filer}{dest_dir}"
          + (f", {errors} failed" if errors else ""))
    if errors:
        raise SystemExit(1)


def cmd_watch(args):
    """Print each metadata event of a filer as a line, from ``-since``
    on, until SIGTERM or SIGINT."""
    from ..replication.sub import EventSubscriber, format_event
    sub = EventSubscriber(args.filer, since=args.since,
                          path_prefix=args.pathPrefix)
    _interrupt_on_sigterm()
    try:
        for ts, event in sub.follow():
            print(format_event(ts, event), flush=True)
    except KeyboardInterrupt:
        pass


def cmd_filer_replicate(args):
    """Apply a filer's events to a sink (``-config``: ``{"source":
    {"filer", "master", "path"}, "sink": {"type", ...}}``). A batch's
    cursor moves only once every event of it is applied: a sink that is
    down stalls replication, with retries, and skips nothing."""
    import time

    from ..replication import (EventSubscriber, FilerSource, Replicator,
                               make_sink)
    from ..server.http_util import HttpError
    with open(args.config) as f:
        cfg = json.load(f)
    src_cfg = cfg["source"]
    source = FilerSource(src_cfg["filer"], src_cfg["master"],
                         path_prefix=src_cfg.get("path", "/"))
    sink = make_sink(cfg["sink"])
    rep = Replicator(source, sink)
    # the replicator routes by source.path_prefix; the filer's own
    # prefix filter keeps other paths' events off the wire
    sub = EventSubscriber(src_cfg["filer"], since=args.since,
                          path_prefix=(source.path_prefix
                                       if source.path_prefix != "/"
                                       else ""))
    print(f"replicating {src_cfg['filer']}{source.path_prefix} "
          f"-> {sink.kind} sink", flush=True)
    _interrupt_on_sigterm()
    try:
        while True:
            try:
                batch = sub.poll_once(advance=False)
            except HttpError:
                time.sleep(1.0)
                continue
            for e in batch:
                delay = 1.0
                while True:
                    try:
                        action = rep.replicate(e["event"])
                        break
                    except Exception as err:  # noqa: BLE001 - retried
                        print(f"RETRY in {delay:.0f}s: {err}", flush=True)
                        time.sleep(delay)
                        delay = min(delay * 2, 30.0)
                if action != "skip":
                    path = (e["event"].get("newEntry")
                            or e["event"].get("oldEntry")
                            or {}).get("FullPath", "?")
                    print(f"{action} {path}", flush=True)
            sub.commit(batch)
    except KeyboardInterrupt:
        pass


def cmd_msg_broker(args):
    from ..server.msg_broker import MsgBrokerServer
    b = MsgBrokerServer(port=args.port, host=args.ip).start()
    print(f"message broker on {b.url}", flush=True)
    _wait(b)


def cmd_scaffold(args):
    from .scaffold import print_scaffold
    print(print_scaffold(args.config), end="")


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


def _interrupt_on_sigterm():
    """SIGTERM ends a follower as SIGINT does, even inside a long poll:
    the loop leaves by KeyboardInterrupt and the process exits 0."""
    def interrupt(*_):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, interrupt)


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


def _tls_flags(p):
    p.add_argument("-tlsCert", default="")
    p.add_argument("-tlsKey", default="")
    p.add_argument("-tlsCa", default="")
    p.add_argument("-tlsMutual", action="store_true",
                   help="require CA-verified client certificates on the "
                        "cluster-internal routes")


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
    _tls_flags(m)
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
                   help="the EC codec: the kernel on the card (cuda), the "
                        "host's AVX2 codec (native) or NumPy codec, the "
                        "kernel at every card's position (mesh), or auto: "
                        "the card, else native, else numpy")
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
                   help="the needle map: a dict in memory, 16-byte "
                        "sorted arrays (compact), an mmap'd sorted file "
                        "(sortedfile), or on disk for indexes larger "
                        "than RAM")
    v.add_argument("-cpuprofile", default="",
                   help="write an all-thread collapsed-stack CPU profile "
                        "here on shutdown")
    v.add_argument("-jwtKey", default="")
    _tls_flags(v)
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
    s.add_argument("-webdav", action="store_true")
    s.add_argument("-webdavPort", type=int, default=7333)
    s.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=list(EC_BACKENDS))
    s.add_argument("-fastPort", type=int, default=0,
                   help="native plane port (0 picks one, -1: none)")
    s.add_argument("-jwtKey", default="")
    _tls_flags(s)
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
    f.add_argument("-redisAddr", default="127.0.0.1:6379",
                   help="redis endpoint for -store redis")
    f.add_argument("-redisPassword", default="")
    f.add_argument("-redisDb", type=int, default=0)
    f.add_argument("-mysqlAddr", default="127.0.0.1:3306",
                   help="mysql endpoint for -store mysql")
    f.add_argument("-mysqlUser", default="root")
    f.add_argument("-mysqlPassword", default="")
    f.add_argument("-mysqlDatabase", default="seaweedfs")
    f.add_argument("-postgresAddr", default="127.0.0.1:5432",
                   help="postgres endpoint for -store postgres")
    f.add_argument("-postgresUser", default="postgres")
    f.add_argument("-postgresPassword", default="")
    f.add_argument("-postgresDatabase", default="seaweedfs")
    f.add_argument("-cassandraAddr", default="127.0.0.1:9042",
                   help="cassandra endpoint for -store cassandra")
    f.add_argument("-cassandraUser", default="")
    f.add_argument("-cassandraPassword", default="")
    f.add_argument("-cassandraKeyspace", default="seaweedfs")
    f.add_argument("-etcdAddr", default="127.0.0.1:2379",
                   help="etcd endpoint for -store etcd (its v3 JSON "
                        "gateway)")
    f.add_argument("-etcdUser", default="")
    f.add_argument("-etcdPassword", default="")
    f.add_argument("-collection", default="")
    f.add_argument("-defaultReplicaPlacement", default="")
    f.add_argument("-maxMB", type=int, default=32,
                   help="autochunk split size")
    f.add_argument("-s3", action="store_true")
    f.add_argument("-s3Port", type=int, default=8333)
    f.add_argument("-s3Config", default="")
    f.add_argument("-jwtKey", default="")
    _tls_flags(f)
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

    w = sub.add_parser("webdav", help="WebDAV gateway over a filer")
    w.add_argument("-port", type=int, default=7333)
    w.add_argument("-ip", default="127.0.0.1")
    w.add_argument("-filer", default="127.0.0.1:8888")
    w.add_argument("-master", default="",
                   help="master url (default: ask the filer)")
    w.add_argument("-collection", default="")
    w.add_argument("-maxMB", type=int, default=8,
                   help="a PUT's chunk size")
    w.set_defaults(fn=cmd_webdav)

    sh = sub.add_parser("shell", help="admin shell")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("-filer", default="",
                    help="filer host:port for the fs.* and bucket.* "
                         "commands")
    sh.add_argument("-c", default="", help="run one command and exit")
    sh.set_defaults(fn=cmd_shell)

    b = sub.add_parser("benchmark", help="cluster load test")
    b.add_argument("-master", default="127.0.0.1:9333")
    b.add_argument("-n", type=int, default=1024)
    b.add_argument("-size", type=int, default=1024)
    b.add_argument("-c", type=int, default=16)
    b.add_argument("-collection", default="benchmark")
    b.add_argument("-assignBatch", type=int, default=1,
                   help="files per assign (?count=, then fid_N): above 1 "
                        "the tool measures the data plane rather than "
                        "its own assigns")
    b.add_argument("-cpuprofile", default="",
                   help="write an all-thread collapsed-stack CPU profile "
                        "of the run here")
    b.add_argument("-native", action="store_true",
                   help="drive the cluster with the C++ keep-alive load "
                        "generator, for -seconds a phase")
    b.add_argument("-seconds", type=float, default=10.0,
                   help="a phase's duration with -native")
    b.add_argument("-pool", type=int, default=4096,
                   help="fids assigned for -native")
    b.set_defaults(fn=cmd_benchmark)

    u = sub.add_parser("upload", help="upload files")
    u.add_argument("-master", default="127.0.0.1:9333")
    u.add_argument("-collection", default="")
    u.add_argument("-replication", default="")
    u.add_argument("-ttl", default="")
    u.add_argument("-maxMB", type=int, default=32,
                   help="a larger file is stored as chunks behind a "
                        "manifest fid")
    u.add_argument("files", nargs="+")
    u.set_defaults(fn=cmd_upload)

    d = sub.add_parser("download", help="download files by fid")
    d.add_argument("-master", default="127.0.0.1:9333")
    d.add_argument("-dir", default=".",
                   help="output directory; a file keeps its stored name "
                        "when it has one")
    d.add_argument("fids", nargs="+")
    d.set_defaults(fn=cmd_download)

    wt = sub.add_parser("watch", help="follow a filer's metadata events")
    wt.add_argument("-filer", default="127.0.0.1:8888")
    wt.add_argument("-since", type=float, default=0.0,
                    help="resume after this event timestamp")
    wt.add_argument("-pathPrefix", default="",
                    help="only events under this path (filtered by the "
                         "filer)")
    wt.set_defaults(fn=cmd_watch)

    fc = sub.add_parser("filer.copy",
                        help="copy local files and directories into a "
                             "filer")
    fc.add_argument("paths", nargs="+",
                    help="src... then http://filer:8888/dest/dir/")
    fc.add_argument("-include", default="",
                    help="glob of the file names to copy, e.g. *.pdf")
    fc.add_argument("-collection", default="")
    fc.add_argument("-replication", default="")
    fc.add_argument("-ttl", default="")
    fc.add_argument("-c", type=int, default=8,
                    help="files uploaded at once")
    fc.set_defaults(fn=cmd_filer_copy)

    fr = sub.add_parser("filer.replicate",
                        help="apply a filer's changes to a sink (another "
                             "filer, an S3 bucket, GCS, B2, Azure)")
    fr.add_argument("-config", required=True,
                    help='JSON: {"source": {"filer": ..., "master": ..., '
                         '"path": ...}, "sink": {"type": "filer"|"s3"|'
                         '"gcs"|"b2"|"azure", ...}}')
    fr.add_argument("-since", type=float, default=0.0)
    fr.set_defaults(fn=cmd_filer_replicate)

    bk = sub.add_parser("backup",
                        help="incremental local copy of a live volume")
    bk.add_argument("-server", default="127.0.0.1:9333",
                    help="master url")
    bk.add_argument("-dir", default=".")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.add_argument("-collection", default="")
    bk.set_defaults(fn=cmd_backup)

    se = sub.add_parser("see", help="print a .dat's or an .idx's records")
    se.add_argument("file", help="path to a .dat or .idx file")
    se.add_argument("-offsetWidth", type=int, default=4, choices=[4, 5],
                    help="idx entry offset width")
    se.add_argument("-limit", type=int, default=0,
                    help="stop after N records (0 = all)")
    se.set_defaults(fn=cmd_see)

    ex = sub.add_parser("export", help="export volume needles to tar")
    ex.add_argument("-dir", default=".")
    ex.add_argument("-volumeId", type=int, required=True)
    ex.add_argument("-collection", default="")
    ex.add_argument("-o", default="", help="tar output path")
    ex.set_defaults(fn=cmd_export)

    fx = sub.add_parser("fix", help="rebuild .idx from .dat")
    fx.add_argument("-dir", default=".")
    fx.add_argument("-volumeId", type=int, required=True)
    fx.add_argument("-collection", default="")
    fx.set_defaults(fn=cmd_fix)

    cp = sub.add_parser("compact", help="force-vacuum a local volume")
    cp.add_argument("-dir", default=".")
    cp.add_argument("-volumeId", type=int, required=True)
    cp.add_argument("-collection", default="")
    cp.add_argument("-method", type=int, default=1, choices=[0, 1],
                    help="0 = scan the .dat (reference Compact), "
                         "1 = copy by the index (reference Compact2)")
    cp.set_defaults(fn=cmd_compact)

    mb = sub.add_parser("msgBroker", help="message queue broker")
    mb.add_argument("-port", type=int, default=17777)
    mb.add_argument("-ip", default="127.0.0.1")
    mb.set_defaults(fn=cmd_msg_broker)

    sc = sub.add_parser("scaffold", help="print example config files")
    sc.add_argument("-config", default="replication",
                    choices=["tier", "s3", "replication", "security",
                             "notification", "filer", "master"])
    sc.set_defaults(fn=cmd_scaffold)

    ver = sub.add_parser("version", help="print version")
    ver.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _set_verbosity(args.v, args.vmodule)
    _apply_tls_config(args)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
