"""The port's operator commands against the JAX package's:

- ``benchmark`` (``command/benchmark.run_benchmark``) against a port
  cluster and a JAX cluster: the same counts, no failure, and the same
  report lines once the numbers are taken out; ``-native``
  (``run_native_benchmark``) over the port's own load generator against
  a volume server with its native plane;
- ``upload`` and ``download``: the same printed lines and bytes, a file
  above ``-maxMB`` stored as chunks behind a manifest, and a stored name
  that climbs out of ``-dir`` written inside it;
- ``see``, ``fix``, ``export`` and ``compact`` on copies of one volume:
  the JAX commands' output and files;
- ``filer.copy`` into a port filer and a JAX filer: the same printed
  lines, tree and bytes (recursive, ``-include``, ``-c``);
- ``backup`` of a live volume, full then incremental: the same lines.

Each package's cluster (a master, a volume server, a filer) runs in
this process, the JAX one on NumPy, the port's on the CPU; commands run
as the CLI's ``cmd_*`` on a parsed Namespace.

Tolerances: none.
"""

import contextlib
import io
import os
import re
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.command import cli as ref_cli
from seaweedfs_tpu_torch.command import cli

KINDS = ("ref", "port")


def _stack(kind, d, fast_port=-1):
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server import http_util as hu
        from seaweedfs_tpu.server.filer_server import FilerServer
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        m = MasterServer(port=0, pulse_seconds=1).start()
        vkw = {"ec_backend": "numpy"}
    else:
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server import http_util as hu
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        m = MasterServer(port=0, pulse_seconds=1, repair_interval=0).start()
        vkw = {"device": "cpu"}
    vs = VolumeServer(port=0, directories=[str(d)], master_url=m.url,
                      pulse_seconds=1, max_volume_counts=[64],
                      fast_port=fast_port, **vkw).start()
    vs.heartbeat_once()
    f = FilerServer(port=0, master_url=m.url).start()
    return {"m": m, "vs": vs, "f": f, "op": op, "hu": hu,
            "cli": ref_cli if kind == "ref" else cli}


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    out = {}
    try:
        for kind in KINDS:
            out[kind] = _stack(kind, tmp_path_factory.mktemp(kind))
        yield out
    finally:
        for s in out.values():
            for srv in ("f", "vs", "m"):
                s[srv].stop()


def _run(mod, argv):
    """A command of ``mod``'s parser on ``argv``: what it printed."""
    args = mod.build_parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args.fn(args)
    return buf.getvalue()


def _numbers_out(text):
    return re.sub(r"\d+(\.\d+)?", "N", text)


@pytest.mark.parametrize("batch", [1, 8])
def test_benchmark_matches_jax(stacks, batch):
    from seaweedfs_tpu.command import benchmark as ref_bench
    from seaweedfs_tpu_torch.command import benchmark
    got = {}
    for kind, mod in (("ref", ref_bench), ("port", benchmark)):
        buf = io.StringIO()
        fids = mod.run_benchmark(stacks[kind]["m"].url, num_files=40,
                                 file_size=1500, concurrency=4,
                                 collection=f"bench{batch}",
                                 assign_batch=batch, out=buf)
        assert len(fids) == len(set(fids)) == 40
        got[kind] = buf.getvalue()
    for text in got.values():
        assert "requests: 40 ok, 0 failed" in text
        assert text.count("requests: 40 ok, 0 failed") == 2
    assert _numbers_out(got["port"]) == _numbers_out(got["ref"])
    assert "--- random read ---" in got["port"]


@pytest.mark.parametrize("kind", KINDS)
def test_benchmark_fewer_files_than_threads(stacks, kind):
    """Three files over eight threads: the read phase splits the reads
    eight ways, five of them empty. The JAX tool names each reader thread
    by its first read and raises IndexError on an empty one (ROADMAP §3);
    the port's names them by number."""
    from seaweedfs_tpu.command import benchmark as ref_bench
    from seaweedfs_tpu_torch.command import benchmark
    mod = ref_bench if kind == "ref" else benchmark
    buf = io.StringIO()
    run = lambda: mod.run_benchmark(  # noqa: E731
        stacks[kind]["m"].url, num_files=3, file_size=100, concurrency=8,
        collection="few", out=buf)
    if kind == "ref":
        with pytest.raises(IndexError):
            run()
    else:
        assert len(run()) == 3
        assert buf.getvalue().count("requests: 3 ok, 0 failed") == 2


def test_benchmark_command_with_cpuprofile(stacks, tmp_path):
    prof = tmp_path / "bench.folded"
    out = _run(cli, ["benchmark", "-master", stacks["port"]["m"].url,
                     "-n", "16", "-size", "512", "-c", "2",
                     "-collection", "cmd", "-cpuprofile", str(prof)])
    assert out.count("requests: 16 ok, 0 failed") == 2
    assert f"cpu profile (collapsed stacks) -> {prof}" in out
    assert prof.exists()


def test_native_benchmark_over_the_port_loadgen(tmp_path):
    """``benchmark -native``: the load generator (built from
    csrc/loadgen.cc) writes the pool through the volume server's native
    plane and reads it back, with no error."""
    import json
    from seaweedfs_tpu_torch.command import benchmark
    s = _stack("port", tmp_path, fast_port=0)
    try:
        assert s["vs"].fast_plane is not None
        s["vs"].heartbeat_once()
        buf = io.StringIO()
        errors = benchmark.run_native_benchmark(
            s["m"].url, file_size=2048, concurrency=3,
            collection="native", seconds=1.0, pool=96, assign_batch=40,
            out=buf)
    finally:
        for srv in ("f", "vs", "m"):
            s[srv].stop()
    text = buf.getvalue()
    phases = [json.loads(ln) for ln in text.splitlines()
              if ln.startswith("{")]
    assert errors == 0
    assert [p["phase"] for p in phases] == ["write", "random read"]
    assert phases[0]["requests"] == 96 and phases[0]["errors"] == 0
    assert all(p["connections"] == 3 and p["targets"] == 1
               for p in phases)
    assert phases[1]["requests"] > 0
    assert "--- native write: 1 target(s), 3 connections ---" in text


def test_upload_download_matches_jax(stacks, tmp_path):
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    src.mkdir()
    files = {"small.txt": rng.bytes(3000), "big.bin": rng.bytes(2_500_000),
             "edge.bin": rng.bytes(1 << 20)}
    for name, data in files.items():
        (src / name).write_bytes(data)
    got = {}
    for kind in KINDS:
        s = stacks[kind]
        murl = s["m"].url
        paths = [str(src / n) for n in files]
        out = _run(s["cli"], ["upload", "-master", murl, "-maxMB", "1",
                              "-collection", "up", *paths])
        fids = [ln.split(" -> ")[1] for ln in out.splitlines()]
        # a stored name that would climb out of -dir
        a = s["op"].assign(murl, collection="up")
        s["op"].upload(a["url"], a["fid"], b"evil", filename="../../evil.txt")
        dest = tmp_path / kind / "out"
        down = _run(s["cli"], ["download", "-master", murl, "-dir",
                               str(dest), *fids, a["fid"]])
        assert not (tmp_path / "evil.txt").exists()
        assert sorted(os.listdir(dest)) == sorted(list(files) + ["evil.txt"])
        for name, data in files.items():
            assert (dest / name).read_bytes() == data, (kind, name)
        assert (dest / "evil.txt").read_bytes() == b"evil"
        # big.bin is a manifest of 1 MiB chunks: its needle is small
        big = fids[list(files).index("big.bin")]
        raw = s["hu"].http_call(
            "GET", f"http://{s['vs'].url}/{big}?cm=false")
        assert b'"chunks"' in raw and len(raw) < 4096
        norm = (out + down).replace(str(tmp_path / kind), "T")
        for fid in fids + [a["fid"]]:
            norm = norm.replace(fid, "FID")
        got[kind] = norm.replace(str(tmp_path), "T")
    assert got["port"] == got["ref"]


@pytest.fixture
def clock(monkeypatch):
    from test_torch_volume_admin import Clock
    c = Clock()
    monkeypatch.setattr(time, "time_ns", c.ns)
    monkeypatch.setattr(time, "time", c.s)
    return c


def test_offline_tools_match_jax(tmp_path, clock):
    """``see`` (an index and a .dat), ``export``, ``fix`` and ``compact``
    on copies of one volume with deletions: the same output and files."""
    from test_torch_volume_admin import _files, _make, _mods
    m = _mods("port")
    v = _make(m, tmp_path / "files", count=8)
    for nid in (2, 5):
        v.delete_needle(m.Needle(cookie=0x100 + nid - 1, id=nid))
    v.close()
    got = {}
    for kind in KINDS:
        d = str(tmp_path / kind)
        shutil.copytree(tmp_path / "files", d)
        mod = ref_cli if kind == "ref" else cli
        clock.reset()
        lines = [_run(mod, argv) for argv in (
            ["see", os.path.join(d, "7.idx"), "-limit", "5"],
            ["see", os.path.join(d, "7.dat")],
            ["export", "-dir", d, "-volumeId", "7", "-o",
             os.path.join(d, "x.tar")],
            ["fix", "-dir", d, "-volumeId", "7"],
            ["compact", "-dir", d, "-volumeId", "7", "-method", "0"],
            ["compact", "-dir", d, "-volumeId", "7"])]
        got[kind] = ([ln.replace(d, "D") for ln in lines], _files(d))
    assert got["port"] == got["ref"]
    assert got["port"][0][0].endswith("5 index records\n")


def _tree(tmp_path):
    top = tmp_path / "top"
    (top / "sub" / "deep").mkdir(parents=True)
    rng = np.random.default_rng(9)
    for rel, n in (("a.txt", 100), ("b.pdf", 5000), ("sub/c.pdf", 70_000),
                   ("sub/deep/d.txt", 1), ("sub/deep/e.pdf", 0)):
        (top / rel).write_bytes(rng.bytes(n))
    (tmp_path / "one.pdf").write_bytes(b"single")
    return top


def _filer_tree(hu, filer, path):
    """{path: bytes} of every file under ``path`` of a filer."""
    import json
    out = {}
    listing = json.loads(hu.http_call("GET", f"http://{filer}{path}/",
                                      headers={"Accept":
                                               "application/json"}))
    for e in listing["entries"]:
        full = e["FullPath"]
        if e["Mode"] & 0o040000:
            out.update(_filer_tree(hu, filer, full))
        else:
            out[full] = hu.http_call("GET", f"http://{filer}{full}")
    return out


@pytest.mark.parametrize("flags", [[], ["-include", "*.pdf", "-c", "3"]],
                         ids=["all", "include"])
def test_filer_copy_matches_jax(stacks, tmp_path, flags):
    top = _tree(tmp_path)
    dest_dir = "/copied-" + ("all" if not flags else "pdf")
    got = {}
    for kind in KINDS:
        s = stacks[kind]
        out = _run(s["cli"], ["filer.copy", *flags, str(top),
                              str(tmp_path / "one.pdf"),
                              f"http://{s['f'].url}{dest_dir}/"])
        tree = _filer_tree(s["hu"], s["f"].url, dest_dir)
        got[kind] = (out.replace(s["f"].url, "FILER"), tree)
    assert got["port"] == got["ref"]
    tree = got["port"][1]
    want = {f"{dest_dir}/top/{p.relative_to(top).as_posix()}":
            p.read_bytes() for p in top.rglob("*") if p.is_file()}
    want[f"{dest_dir}/one.pdf"] = b"single"
    if flags:
        want = {k: v for k, v in want.items() if k.endswith(".pdf")}
    assert tree == want
    assert got["port"][0].splitlines()[-1] == \
        f"copied {len(want)} files to FILER{dest_dir}"


def test_filer_copy_refusals(stacks, tmp_path):
    for argv in (["filer.copy", "http://x/"],
                 ["filer.copy", str(tmp_path / "missing"), "http://x/"]):
        with pytest.raises(SystemExit):
            _run(cli, argv)


def test_backup_matches_jax(stacks, tmp_path):
    """A full backup of a live volume, then an incremental one after two
    more writes and a delete: the same lines, the records and bytes each
    moved."""
    got = {}
    for kind in KINDS:
        s = stacks[kind]
        murl, op = s["m"].url, s["op"]
        a = op.assign(murl, count=8, collection="bk")
        fids = list(op.expand_batch_fids(a["fid"], 8))
        vid = int(a["fid"].split(",")[0])
        for i, fid in enumerate(fids[:6]):
            op.upload(a["url"], fid, bytes([i]) * (1000 + i),
                      filename=f"f{i}")
        argv = ["backup", "-server", murl, "-dir", str(tmp_path / kind),
                "-volumeId", str(vid), "-collection", "bk"]
        lines = [_run(s["cli"], argv)]
        for i, fid in enumerate(fids[6:], 6):
            op.upload(a["url"], fid, bytes([i]) * 500, filename=f"f{i}")
        op.delete_file(murl, fids[0])
        lines.append(_run(s["cli"], argv))
        got[kind] = [ln.replace(f"volume {vid}:", "volume V:")
                     for ln in lines]
    assert got["port"] == got["ref"]
    assert got["port"][0].startswith("volume V: full sync, 6 records")
    assert "incremental" in got["port"][1]
