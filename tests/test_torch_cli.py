"""The port's ``weed``-style CLI against the JAX package's parser.

For the subcommands the port has (master, volume, server, filer, s3,
webdav, shell, benchmark, upload, download, watch, filer.copy,
filer.replicate, backup, see, export, fix, compact, msgBroker,
scaffold, version) and the top-level flags, every flag's option
strings, destination, default, type, choices and action must equal the
JAX ``build_parser()``'s, except:

- the flags that wait for later slices, named in ``ABSENT`` (the mesh
  and store flags);
- ``-ec.backend``, whose choices are the port's ``cuda|numpy|mesh`` and
  whose default is ``cuda`` (the card) where JAX's is ``auto``;
- ``-index``, whose choices are the port's ``memory|disk``;
- the filer's ``-store`` choices, the three stores ported.

Then ``server -filer -s3 -ec.backend numpy`` runs as a subprocess on
free ports and answers a SigV4 PUT and GET, the filer's GET of the
object, and exits 0 on SIGTERM; ``version`` prints the port's name;
the volume flags the port's server took on for the CLI (data center,
rack, public url, read redirect, compaction pace) reach it;
``server -webdav -webdavPort`` and the shell's ``-filer`` parse and reach
their servers and the shell's ``CommandEnv``.

Tolerances: none.
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
COMMANDS = ("master", "volume", "server", "filer", "s3", "webdav",
            "shell", "benchmark", "upload", "download", "watch",
            "filer.copy", "filer.replicate", "backup", "see", "export",
            "fix", "compact", "msgBroker", "scaffold", "version")
# the JAX commands whose modules come in a later slice
WAITING = ("mount",)
STORE_FLAGS = tuple(
    f"-{db}{what}" for db, whats in (
        ("redis", ("Addr", "Password", "Db")),
        ("mysql", ("Addr", "User", "Password", "Database")),
        ("postgres", ("Addr", "User", "Password", "Database")),
        ("cassandra", ("Addr", "User", "Password", "Keyspace")),
        ("etcd", ("Addr", "User", "Password"))) for what in whats)
ABSENT = {
    "volume": ("-mesh.coordinator", "-mesh.processes", "-mesh.processId"),
    "filer": STORE_FLAGS,
}
# (command, flag) -> the port's (choices, default) where they differ
DIFFERENT = {
    ("volume", "-ec.backend"): (["cuda", "numpy", "mesh"], "cuda"),
    ("server", "-ec.backend"): (["cuda", "numpy", "mesh"], "cuda"),
    ("volume", "-index"): (["memory", "disk"], "memory"),
    ("filer", "-store"): (["memory", "sqlite", "sharded"], "sqlite"),
}


def _flags(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        key = a.option_strings[0] if a.option_strings else a.dest
        out[key] = {"options": tuple(a.option_strings), "dest": a.dest,
                    "default": a.default, "type": a.type,
                    "choices": list(a.choices) if a.choices else None,
                    "action": type(a).__name__, "nargs": a.nargs,
                    "required": a.required}
    return out


def _subparsers(parser):
    act = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return act.choices


def test_parser_matches_jax():
    from seaweedfs_tpu.command.cli import build_parser as ref_build
    from seaweedfs_tpu_torch.command.cli import build_parser
    ref, port = ref_build(), build_parser()
    assert _flags(port) == _flags(ref)      # -v, -vmodule
    ref_sub, port_sub = _subparsers(ref), _subparsers(port)
    assert sorted(port_sub) == sorted(COMMANDS)
    assert sorted(ref_sub) == sorted(COMMANDS + WAITING)
    for cmd in COMMANDS:
        r, p = _flags(ref_sub[cmd]), _flags(port_sub[cmd])
        for flag in ABSENT.get(cmd, ()):
            assert flag in r and flag not in p, (cmd, flag)
            del r[flag]
        for (c, flag), (choices, default) in DIFFERENT.items():
            if c == cmd:
                assert p[flag]["choices"] == choices, (cmd, flag)
                assert p[flag]["default"] == default, (cmd, flag)
                assert r[flag]["choices"] != choices
                for d in (r[flag], p[flag]):
                    d.pop("choices")
                    d.pop("default")
        assert p == r, cmd


def test_unported_store_is_refused():
    from seaweedfs_tpu_torch.command.cli import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["filer", "-store", "redis"])
    args = build_parser().parse_args(
        ["server", "-filer", "-s3", "-ec.backend", "numpy"])
    assert (args.filer, args.s3, args.ec_backend) == (True, True, "numpy")


@pytest.mark.parametrize("argv, want", [
    (["server", "-filer", "-webdav", "-ec.backend", "numpy"],
     {"webdav": True, "webdavPort": 7333, "filer": True}),
    (["server", "-webdav", "-webdavPort", "17333"],
     {"webdav": True, "webdavPort": 17333, "filer": False}),
    (["server"], {"webdav": False, "webdavPort": 7333}),
    (["shell", "-filer", "127.0.0.1:8888", "-c", "fs.ls /"],
     {"filer": "127.0.0.1:8888", "c": "fs.ls /"}),
    (["shell"], {"filer": "", "master": "127.0.0.1:9333"}),
    (["webdav", "-filer", "h:1", "-port", "0", "-maxMB", "2"],
     {"filer": "h:1", "port": 0, "maxMB": 2, "master": ""}),
    (["watch", "-since", "12.5", "-pathPrefix", "/buckets"],
     {"since": 12.5, "pathPrefix": "/buckets", "filer": "127.0.0.1:8888"}),
    (["filer.replicate", "-config", "r.json"],
     {"config": "r.json", "since": 0.0}),
    (["msgBroker", "-port", "0"], {"port": 0, "ip": "127.0.0.1"}),
])
def test_parser_cases_match_jax(argv, want):
    """The new commands' flags parse to the same values in both CLIs."""
    from seaweedfs_tpu.command.cli import build_parser as ref_build
    from seaweedfs_tpu_torch.command.cli import build_parser
    port, ref = build_parser().parse_args(argv), ref_build().parse_args(argv)
    for key, value in want.items():
        assert getattr(port, key) == getattr(ref, key) == value, key


def test_shell_filer_reaches_command_env(monkeypatch):
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch import shell
    seen = []

    class Env(shell.CommandEnv):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)
    monkeypatch.setattr(shell, "CommandEnv", Env)
    monkeypatch.setattr(shell, "run_command", lambda env, line: True)
    cli.main(["shell", "-master", "m:1", "-filer", "f:2", "-c", "fs.pwd"])
    assert [(e.master_url, e.filer_url, e.cwd) for e in seen] == \
        [("m:1", "f:2", "/")]


def test_card_backend_without_a_card_raises(monkeypatch):
    import torch
    from seaweedfs_tpu_torch.command import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "mesh"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            cli._volume_device(backend)
    assert cli._volume_device("numpy") == "cpu"


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_server_filer_s3_subprocess(tmp_path):
    from seaweedfs_tpu_torch.s3.auth import sign_request_v4
    from seaweedfs_tpu_torch.server.http_util import http_call
    iam = tmp_path / "iam.json"
    iam.write_text(json.dumps({"identities": [{
        "name": "cli", "actions": ["Admin"],
        "credentials": [{"accessKey": "AK", "secretKey": "SK"}]}]}))
    mport, vport, fport, sport = _free_ports(4)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.command.cli", "server",
         "-filer", "-s3", "-s3Config", str(iam), "-ec.backend", "numpy",
         "-dir", str(tmp_path / "data"), "-masterPort", str(mport),
         "-port", str(vport), "-filerPort", str(fport), "-s3Port",
         str(sport), "-pulseSeconds", "1", "-fastPort", "-1"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        lines, deadline = [], time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("s3 gateway on"):
                break
        assert lines[-1].strip() == f"s3 gateway on 127.0.0.1:{sport}"
        assert lines[0].strip() == (f"master on 127.0.0.1:{mport}, volume "
                                    f"server on 127.0.0.1:{vport}")
        base = f"http://127.0.0.1:{sport}"

        def s3(method, path, body=b""):
            h = sign_request_v4(method, base + path, {}, body, "AK", "SK")
            return http_call(method, base + path, body=body or None,
                             headers=h)
        data = os.urandom(300_000)
        s3("PUT", "/clibucket")
        s3("PUT", "/clibucket/k/obj.bin", data)
        assert s3("GET", "/clibucket/k/obj.bin") == data
        assert http_call("GET", f"http://127.0.0.1:{fport}/buckets/"
                         f"clibucket/k/obj.bin") == data
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(60)
        finally:
            proc.kill()
            proc.stdout.close()
    assert rc == 0


def test_version():
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.command.cli", "version"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0
    assert out.stdout.strip() == "seaweedfs_tpu_torch 0.1.0"


def test_volume_flags_reach_the_server(tmp_path):
    """The flags the JAX CLI passes to its volume server and the port's
    now takes too: the data center and rack in the heartbeat (and the
    master's topology), the advertised url, no redirect with
    ``-read.redirect false``, and the vacuum pace."""
    from seaweedfs_tpu_torch.command.cli import build_parser
    from seaweedfs_tpu_torch.server.http_util import HttpError, get_json, \
        http_call
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    args = build_parser().parse_args(
        ["volume", "-dataCenter", "dc9", "-rack", "r3", "-read.redirect",
         "false", "-compactionMBps", "4", "-publicUrl", "pub.example:80",
         "-ec.backend", "numpy"])
    m = MasterServer(port=0, pulse_seconds=1, repair_interval=0).start()
    kw = dict(port=0, master_url=m.url, pulse_seconds=1, device="cpu",
              fast_port=-1, ec_backend=args.ec_backend)
    a = VolumeServer(directories=[str(tmp_path / "a")],
                     data_center=args.dataCenter, rack=args.rack,
                     public_url=args.publicUrl,
                     read_redirect=args.readRedirect == "true",
                     compaction_mbps=args.compactionMBps, **kw).start()
    b = VolumeServer(directories=[str(tmp_path / "b")], **kw).start()
    try:
        hb = a.store.collect_heartbeat()
        assert (hb["data_center"], hb["rack"], hb["public_url"]) == \
            ("dc9", "r3", "pub.example:80")
        assert a.compaction_bps == 4 << 20
        http_call("POST", f"http://{b.url}/admin/assign_volume?volume=5")
        a.heartbeat_once()
        b.heartbeat_once()
        topo = json.dumps(get_json(f"http://{m.url}/dir/status"))
        assert '"dc9"' in topo and '"r3"' in topo
        with pytest.raises(HttpError) as e:
            http_call("GET", f"http://{a.url}/5,0123456789abcdef")
        assert e.value.status == 404
        # the default still sends a reader on to a replica
        import http.client
        http_call("POST", f"http://{a.url}/admin/assign_volume?volume=6")
        a.heartbeat_once()
        conn = http.client.HTTPConnection(b.url, timeout=10)
        conn.request("GET", "/6,0123456789abcdef")
        r = conn.getresponse()
        r.read()
        conn.close()
        assert (r.status, r.getheader("Location")) == \
            (301, f"http://{a.url}/6,0123456789abcdef")
    finally:
        b.stop()
        a.stop()
        m.stop()
