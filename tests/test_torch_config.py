"""The port's config-file tier and ``scaffold`` against the JAX package's.

- ``util/config.load_config`` / ``config_get`` / ``find_config_file``
  read the same TOML and JSON files and ``WEED_*`` variables into equal
  dicts and values (the flow of JAX ``test_aux_subsystems.py``'s config
  test);
- ``command/scaffold.print_scaffold`` prints every example string for
  string, and the master's parses through the loader;
- the CLI's ``_apply_master_config``, ``_apply_security_config`` and
  ``_apply_tls_config`` leave the same flags and return the same
  keyword arguments on the same Namespaces and files (each package run
  from the file's directory, ``monkeypatch.chdir``), and the tier
  backends a ``master.toml`` enables reach ``configure_backends`` alike;
- a master's ``growth_counts`` grows as many volumes on a first assign
  in either package.

Tolerances: none.
"""

import argparse

import pytest

from seaweedfs_tpu.command import cli as ref_cli
from seaweedfs_tpu.command import scaffold as ref_scaffold
from seaweedfs_tpu.util import config as ref_config
from seaweedfs_tpu_torch.command import cli
from seaweedfs_tpu_torch.command import scaffold
from seaweedfs_tpu_torch.util import config

SECURITY_TOML = ('[jwt.signing]\nkey = "from-file"\n[https]\n'
                 'cert = "/c.pem"\nkey = "/k.pem"\nca = "/ca.pem"\n'
                 'mutual = true\n')
SECURITY_JSON = '{"jwt": {"signing": {"key": "j"}}, "HTTPS": {"CA": "/a"}}'
MASTER_TOMLS = {
    "scaffold": ref_scaffold.print_scaffold("master"),
    "etcd": ('[master.maintenance]\nscripts = "volume.vacuum"\n'
             'sleep_minutes = 2\n[master.sequencer]\ntype = "etcd"\n'
             'sequencer_etcd_urls = "http://etcd-a:2390,http://etcd-b:2390"'
             '\n[master.volume_growth]\ncopy_1 = 2\ncopy_other = 5\n'),
    "backends": ('[master.filer]\ndefault_filer_url = "filer-x"\n'
                 '[storage.backend.s3.cold]\nenabled = true\n'
                 'aws_access_key_id = "AK"\naws_secret_access_key = "SK"\n'
                 'bucket = "b"\nendpoint = "http://s3.example:8333"\n'
                 '[storage.backend.dir.off]\nenabled = false\n'
                 'path = "/nowhere"\n[storage.backend.dir.on]\n'
                 'enabled = "true"\npath = "/cold"\n'),
}
# (flags the Namespace starts with, WEED_* variables)
NAMESPACES = {
    "defaults": ({}, {}),
    "flags": ({"maintenanceScripts": "volume.list",
               "maintenanceIntervalSeconds": 60.0, "sequencer": "etcd",
               "sequencerEtcd": "me:2379"}, {}),
    "env": ({}, {"WEED_MASTER_MAINTENANCE_SLEEP_MINUTES": "3",
                 "WEED_STORAGE_BACKEND_DIR_ENV_ENABLED": "1",
                 "WEED_STORAGE_BACKEND_DIR_ENV_PATH": "/env",
                 "WEED_MASTER_VOLUME_GROWTH_COPY_2": "4"}),
}


def _ns(flags):
    base = {"maintenanceScripts": "", "maintenanceIntervalSeconds": 17 * 60,
            "sequencer": "auto", "sequencerEtcd": "127.0.0.1:2379"}
    return argparse.Namespace(**{**base, **flags})


@pytest.fixture
def clean_weed_env(monkeypatch):
    import os
    for k in list(os.environ):
        if k.startswith("WEED_"):
            monkeypatch.delenv(k)


@pytest.mark.parametrize("case", ["toml", "json", "env", "env_only",
                                  "missing"])
def test_load_config_matches_jax(tmp_path, case):
    if case in ("toml", "env"):
        (tmp_path / "security.toml").write_text(SECURITY_TOML)
    if case == "json":
        (tmp_path / "security.json").write_text(SECURITY_JSON)
    env = {"WEED_JWT_SIGNING_KEY": "from-env", "WEED_HTTPS_CA": "/e.pem",
           "OTHER": "x"} if case.startswith("env") else {}
    got = {}
    for name, mod in (("ref", ref_config), ("port", config)):
        cfg = mod.load_config("security", dirs=[str(tmp_path)], env=env)
        got[name] = (cfg, [mod.config_get(cfg, k, "-") for k in (
            "jwt.signing.key", "jwt_signing_key", "JWT.Signing.Key",
            "https.cert", "https.ca", "https.mutual", "nope")],
            mod.find_config_file("security", [str(tmp_path)]))
    assert got["port"] == got["ref"]
    if case == "env":
        assert got["port"][1][:2] == ["from-env", "from-env"]
    assert config.SEARCH_DIRS == ref_config.SEARCH_DIRS
    assert config.ENV_PREFIX == ref_config.ENV_PREFIX == "WEED_"


def test_load_config_search_order(tmp_path):
    """The first directory that holds the file wins; .toml before .json
    in one directory."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    (b / "master.toml").write_text('[master.filer]\ndefault_filer_url = "b"\n')
    (a / "master.json").write_text('{"master": {"filer": {"x": 1}}}')
    (b / "master.json").write_text('{"other": 2}')
    for dirs in ([str(a), str(b)], [str(b), str(a)]):
        assert config.load_config("master", dirs=dirs, env={}) == \
            ref_config.load_config("master", dirs=dirs, env={})
    assert config.find_config_file("master", [str(b)]).endswith(".toml")


@pytest.mark.parametrize("name", sorted(ref_scaffold.SCAFFOLDS))
def test_scaffold_matches_jax(name, tmp_path):
    assert scaffold.print_scaffold(name) == ref_scaffold.print_scaffold(name)
    out = argparse.Namespace(config=name)
    import contextlib
    import io
    printed = []
    for fn in (ref_cli.cmd_scaffold, cli.cmd_scaffold):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(out)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    if name == "master":
        (tmp_path / "master.toml").write_text(printed[1])
        cfg = config.load_config("master", dirs=[str(tmp_path)], env={})
        assert config.config_get(cfg, "master.volume_growth.copy_1") == 7


def test_unknown_scaffold_is_refused():
    with pytest.raises(SystemExit):
        scaffold.print_scaffold("nope")


@pytest.mark.usefixtures("clean_weed_env")
@pytest.mark.parametrize("ns", sorted(NAMESPACES))
@pytest.mark.parametrize("toml", sorted(MASTER_TOMLS) + ["none"])
def test_apply_master_config_matches_jax(tmp_path, monkeypatch, toml, ns):
    from seaweedfs_tpu.storage import backend as ref_backend
    from seaweedfs_tpu_torch.storage import backend
    if toml != "none":
        (tmp_path / "master.toml").write_text(MASTER_TOMLS[toml])
    flags, env = NAMESPACES[ns]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    got = {}
    for name, mod, bmod in (("ref", ref_cli, ref_backend),
                            ("port", cli, backend)):
        configured = []
        monkeypatch.setattr(bmod, "configure_backends", configured.append)
        args = _ns(flags)
        kw = mod._apply_master_config(args)
        got[name] = (vars(args), kw, configured)
    assert got["port"] == got["ref"]
    if toml == "scaffold" and ns == "defaults":
        args, kw, configured = got["port"]
        assert args["maintenanceScripts"] == \
            "ec.rebuild;volume.balance;volume.vacuum -garbageThreshold 0.3"
        assert kw == {"growth_counts": {1: 7, 2: 6, 3: 3, "other": 1},
                      "maintenance_filer_url": "localhost:8888"}
        assert configured == []
    if toml == "backends" and ns == "defaults":
        assert got["port"][2] == [{
            "s3": {"cold": {"access_key": "AK", "secret_key": "SK",
                            "bucket": "b",
                            "endpoint": "http://s3.example:8333"}},
            "dir": {"on": {"path": "/cold"}}}]


@pytest.mark.usefixtures("clean_weed_env")
@pytest.mark.parametrize("case", ["file", "flags", "client_only", "none"])
def test_apply_security_and_tls_config_matches_jax(tmp_path, monkeypatch,
                                                   case):
    from seaweedfs_tpu.server import http_util as ref_http
    from seaweedfs_tpu_torch.server import http_util
    if case in ("file", "flags"):
        (tmp_path / "security.toml").write_text(SECURITY_TOML)
    if case == "client_only":
        (tmp_path / "security.toml").write_text('[https]\nca = "/ca.pem"\n')
    monkeypatch.chdir(tmp_path)
    flags = {"jwtKey": "flag-key", "tlsCert": "/fc", "tlsKey": "/fk",
             "tlsCa": "", "tlsMutual": False} if case == "flags" else \
        {"jwtKey": "", "tlsCert": "", "tlsKey": "", "tlsCa": "",
         "tlsMutual": False}
    got = {}
    for name, mod, hmod in (("ref", ref_cli, ref_http),
                            ("port", cli, http_util)):
        calls = []
        monkeypatch.setattr(hmod, "configure_tls",
                            lambda *a, **k: calls.append((a, k)))
        args = argparse.Namespace(**flags)
        mod._apply_security_config(args)
        mod._apply_tls_config(args)
        got[name] = (args.jwtKey, calls)
    assert got["port"] == got["ref"]
    want = {"file": ("from-file", [(("/c.pem", "/k.pem", "/ca.pem"),
                                    {"mutual": True})]),
            "flags": ("flag-key", [(("/fc", "/fk", "/ca.pem"),
                                    {"mutual": True})]),
            "client_only": ("", [(("", "", "/ca.pem"), {"mutual": False})]),
            "none": ("", [])}[case]
    assert got["port"] == want


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_growth_counts_reach_the_first_assign(tmp_path, kind):
    """``growth_counts`` (master.toml's [master.volume_growth]) sets how
    many volumes a first assign grows."""
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        m = MasterServer(port=0, pulse_seconds=1,
                         growth_counts={1: 2, "other": 5}).start()
        vs = VolumeServer(port=0, directories=[str(tmp_path)],
                          master_url=m.url, pulse_seconds=1,
                          ec_backend="numpy", fast_port=-1).start()
    else:
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        m = MasterServer(port=0, pulse_seconds=1, repair_interval=0,
                         growth_counts={1: 2, "other": 5}).start()
        vs = VolumeServer(port=0, directories=[str(tmp_path)],
                          master_url=m.url, pulse_seconds=1, device="cpu",
                          fast_port=-1).start()
    try:
        vs.heartbeat_once()
        op.assign(m.url)
        vs.heartbeat_once()
        assert len(vs.store.locations[0].volumes) == 2
        assert m.growth_counts == {1: 2, "other": 5}
    finally:
        vs.stop()
        m.stop()
