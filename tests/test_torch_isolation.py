"""The port stands alone: nothing under seaweedfs_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package, and the port encodes and
rebuilds (from local files and streamed), trace-repairs, plane-repairs
and decodes, on the flat and the piggyback layout, serves a needle
through a lost shard and scrubs, trace-repairs from a holder over HTTP,
streams an encode from one server's readonly volume to another server,
drives a volume server's needle data plane (create, write, read,
delete, vacuum, encode, a GET through a lost shard), and runs a cluster
(a master, three heartbeating volume servers, replicated writes, the
shell's ec.encode, ec.rebuild, ec.balance and ec.decode) and its
integrity plane (scrubs, a finding drained into a repair, a lost shard
rebuilt by the master's repair queue, naive degraded reads, the device
accounting and a torch.profiler trace) and its volume control plane
(vacuum, fsck, move, fix.replication, backup, /submit and
collection.delete), and runs the multi-device tier
(MeshCodec, the distributed EC step, two processes over gloo), and a
highly available cluster (three masters in a raft group, write tokens,
the leader stopped, a write and an ec.rebuild after), and its
observability plane (``/metrics``, ``/cluster/metrics``,
``/admin/traces`` and the shell's ``trace.export``), and its hot→warm
lifecycle (``volume.tier.upload`` / ``.download`` on a ``dir`` backend,
and one demotion through ``/cluster/tiering?scan=1``), and its filer and
S3 gateway (a sealed chunk, a multipart upload, a standalone gateway
over ``FilerClient``, a GET through a lost shard and the ``s3`` tier on
the port's own gateway), and its operator surface (config files, mutual
TLS, the status pages, ``benchmark``, ``upload``, ``download``,
``filer.copy``, the offline tools and ``scaffold``), and its filer's
event plane and gateways (the webhook publisher into ``msgBroker``,
``watch``, ``filer.replicate`` into an ``s3`` sink, WebDAV and ``shell
-filer``), and its host codec, ``compact`` and ``sortedfile`` needle
maps, lock-order recorder and network filer stores, with both made
unimportable."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "seaweedfs_tpu")


def _port_files():
    pkg = ROOT / "seaweedfs_tpu_torch"
    # build/ holds what the package generates at run time, not its source
    files = sorted(p for p in pkg.rglob("*.py")
                   if p.relative_to(pkg).parts[0] != "build")
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("seaweedfs_tpu_torch/ops/rs_hopper.py",
                 "seaweedfs_tpu_torch/ops/gf_plan.py",
                 "seaweedfs_tpu_torch/ops/rs_bitplane.py",
                 "seaweedfs_tpu_torch/ops/codec.py",
                 "seaweedfs_tpu_torch/ec/encoder.py",
                 "seaweedfs_tpu_torch/ec/decoder.py",
                 "seaweedfs_tpu_torch/ec/gather.py",
                 "seaweedfs_tpu_torch/ec/transport.py",
                 "seaweedfs_tpu_torch/ec/spread.py",
                 "seaweedfs_tpu_torch/ec/layout.py",
                 "seaweedfs_tpu_torch/ec/degraded.py",
                 "seaweedfs_tpu_torch/ec/scrub.py",
                 "seaweedfs_tpu_torch/ec/ec_volume.py",
                 "seaweedfs_tpu_torch/ec/locate.py",
                 "seaweedfs_tpu_torch/ec/shard_cache.py",
                 "seaweedfs_tpu_torch/storage/needle.py",
                 "seaweedfs_tpu_torch/storage/needle_map.py",
                 "seaweedfs_tpu_torch/storage/compact_map.py",
                 "seaweedfs_tpu_torch/storage/crc.py",
                 "seaweedfs_tpu_torch/storage/types.py",
                 "seaweedfs_tpu_torch/util/throttler.py",
                 "seaweedfs_tpu_torch/storage/store.py",
                 "seaweedfs_tpu_torch/storage/volume.py",
                 "seaweedfs_tpu_torch/server/http_util.py",
                 "seaweedfs_tpu_torch/server/volume_server.py",
                 "seaweedfs_tpu_torch/stats/health.py",
                 "seaweedfs_tpu_torch/ec/shard_bits.py",
                 "seaweedfs_tpu_torch/util/fanout.py",
                 "seaweedfs_tpu_torch/topology/node.py",
                 "seaweedfs_tpu_torch/topology/volume_layout.py",
                 "seaweedfs_tpu_torch/topology/volume_growth.py",
                 "seaweedfs_tpu_torch/topology/topology.py",
                 "seaweedfs_tpu_torch/server/watch_hub.py",
                 "seaweedfs_tpu_torch/server/master.py",
                 "seaweedfs_tpu_torch/client/operation.py",
                 "seaweedfs_tpu_torch/client/vid_map.py",
                 "seaweedfs_tpu_torch/shell/command_env.py",
                 "seaweedfs_tpu_torch/shell/command_ec.py",
                 "seaweedfs_tpu_torch/shell/command_cluster.py",
                 "seaweedfs_tpu_torch/shell/__main__.py",
                 "seaweedfs_tpu_torch/ops/device_stats.py",
                 "seaweedfs_tpu_torch/stats/repair_queue.py",
                 "seaweedfs_tpu_torch/util/profiling.py",
                 "seaweedfs_tpu_torch/tools/kernel_exp.py",
                 "seaweedfs_tpu_torch/parallel/mesh.py",
                 "seaweedfs_tpu_torch/parallel/sharded_ec.py",
                 "seaweedfs_tpu_torch/parallel/mesh_codec.py",
                 "seaweedfs_tpu_torch/parallel/multihost.py",
                 "seaweedfs_tpu_torch/storage/volume_backup.py",
                 "seaweedfs_tpu_torch/shell/command_volume.py",
                 "seaweedfs_tpu_torch/shell/command_collection.py",
                 "seaweedfs_tpu_torch/command/volume_tools.py",
                 "seaweedfs_tpu_torch/topology/raft.py",
                 "seaweedfs_tpu_torch/security/guard.py",
                 "seaweedfs_tpu_torch/security/jwt.py",
                 "seaweedfs_tpu_torch/filer/etcd_store.py",
                 "seaweedfs_tpu_torch/util/tracing.py",
                 "seaweedfs_tpu_torch/util/trace_export.py",
                 "seaweedfs_tpu_torch/stats/metrics.py",
                 "seaweedfs_tpu_torch/stats/aggregate.py",
                 "seaweedfs_tpu_torch/storage/backend.py",
                 "seaweedfs_tpu_torch/storage/volume_tier.py",
                 "seaweedfs_tpu_torch/server/tiering.py",
                 "seaweedfs_tpu_torch/util/config.py",
                 "seaweedfs_tpu_torch/server/native_plane.py",
                 "seaweedfs_tpu_torch/client/chunked.py",
                 "seaweedfs_tpu_torch/storage/needle_map_disk.py",
                 "seaweedfs_tpu_torch/query/json_query.py",
                 "seaweedfs_tpu_torch/images/resizing.py",
                 "seaweedfs_tpu_torch/util/compression.py",
                 "seaweedfs_tpu_torch/util/cipher.py",
                 "seaweedfs_tpu_torch/filer/entry.py",
                 "seaweedfs_tpu_torch/filer/filechunks.py",
                 "seaweedfs_tpu_torch/filer/filerstore.py",
                 "seaweedfs_tpu_torch/filer/memory_store.py",
                 "seaweedfs_tpu_torch/filer/sqlite_store.py",
                 "seaweedfs_tpu_torch/filer/sharded_store.py",
                 "seaweedfs_tpu_torch/filer/filer.py",
                 "seaweedfs_tpu_torch/filer/log_buffer.py",
                 "seaweedfs_tpu_torch/filer/upload.py",
                 "seaweedfs_tpu_torch/filer/stream.py",
                 "seaweedfs_tpu_torch/filer/filer_client.py",
                 "seaweedfs_tpu_torch/server/filer_server.py",
                 "seaweedfs_tpu_torch/s3/auth.py",
                 "seaweedfs_tpu_torch/s3/s3_server.py",
                 "seaweedfs_tpu_torch/command/cli.py",
                 "seaweedfs_tpu_torch/command/scaffold.py",
                 "seaweedfs_tpu_torch/command/benchmark.py",
                 "seaweedfs_tpu_torch/server/status_ui.py",
                 "seaweedfs_tpu_torch/notification/__init__.py",
                 "seaweedfs_tpu_torch/notification/queues.py",
                 "seaweedfs_tpu_torch/notification/kafka.py",
                 "seaweedfs_tpu_torch/notification/google_pub_sub.py",
                 "seaweedfs_tpu_torch/replication/__init__.py",
                 "seaweedfs_tpu_torch/replication/sub.py",
                 "seaweedfs_tpu_torch/replication/source.py",
                 "seaweedfs_tpu_torch/replication/sink.py",
                 "seaweedfs_tpu_torch/replication/replicator.py",
                 "seaweedfs_tpu_torch/server/webdav_server.py",
                 "seaweedfs_tpu_torch/server/msg_broker.py",
                 "seaweedfs_tpu_torch/shell/command_fs.py",
                 "seaweedfs_tpu_torch/shell/command_bucket.py",
                 "seaweedfs_tpu_torch/ops/rs_native.py",
                 "seaweedfs_tpu_torch/util/locks.py",
                 "seaweedfs_tpu_torch/util/host_build.py",
                 "seaweedfs_tpu_torch/filer/redis_store.py",
                 "seaweedfs_tpu_torch/filer/mysql_store.py",
                 "seaweedfs_tpu_torch/filer/postgres_store.py",
                 "seaweedfs_tpu_torch/filer/cassandra_store.py",
                 "chip_smoke.py"):
        assert want in names
    for source in ("gf_matmul.cu", "gf_bitplane.cu", "crc32c.cc",
                   "http_plane.cc", "loadgen.cc", "seaweed_ec.cc"):
        assert (ROOT / "seaweedfs_tpu_torch/csrc" / source).exists()


@pytest.mark.parametrize("path", _port_files() + sorted(
    (ROOT / "seaweedfs_tpu_torch/csrc").iterdir()),
    ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_port_file_names_the_jax_plane(path):
    """The port builds and loads its own plane: no file of it names the
    JAX package's (its sources, library or load generator)."""
    assert "seaweedfs_tpu/server/native" not in path.read_text(
        encoding="utf-8")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_runs_with_jax_unimportable(tmp_path):
    script = textwrap.dedent(f"""
        import os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.ec import (rebuild_ec_files, to_ext,
                                            write_ec_files)
        from seaweedfs_tpu_torch.ops import TorchCodec, gf_matmul
        base = {str(tmp_path / "1")!r}
        rng = np.random.default_rng(0)
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, 100_003, dtype=np.uint8).tobytes())
        codec = TorchCodec(10, 4, device="cpu")
        write_ec_files(base, codec=codec, large_block=16 << 10,
                       small_block=4 << 10, slab=8 << 10)
        want = [open(base + to_ext(i), "rb").read() for i in range(14)]
        for sid in (1, 4, 10, 13):
            os.remove(base + to_ext(sid))
        assert sorted(rebuild_ec_files(base, codec=codec, slab=8 << 10)) \\
            == [1, 4, 10, 13]
        got = [open(base + to_ext(i), "rb").read() for i in range(14)]
        assert got == want
        # trace repair of one shard, then a streaming rebuild of four
        from seaweedfs_tpu_torch.ec import (
            LocalRepairReader, LocalShardReader, RepairGatherSource,
            StripedGatherSource, rebuild_ec_file_repair,
            rebuild_ec_files_streaming)
        from seaweedfs_tpu_torch.ops.codec import (piggyback_repair_plan,
                                                   repair_plan)
        size = len(want[0])
        plan = repair_plan(10, 4, 6)
        os.remove(base + to_ext(6))
        source = RepairGatherSource(
            [LocalRepairReader(base + to_ext(i), plan.masks[i])
             for i in plan.helpers], size, plan, slab=5000, window=2)
        assert rebuild_ec_file_repair(base, 6, source, plan, codec=codec,
                                      slab=5000) == [6]
        lost = (0, 5, 11, 12)
        for sid in lost:
            os.remove(base + to_ext(sid))
        present = [i not in lost for i in range(14)]
        source = StripedGatherSource(
            [LocalShardReader(base + to_ext(i)) for i in range(14)
             if present[i]][:10], size, slab=5000, window=2)
        assert rebuild_ec_files_streaming(base, present, list(lost), source,
                                          codec=codec, slab=5000) \
            == list(lost)
        assert [open(base + to_ext(i), "rb").read() for i in range(14)] \
            == want
        # the piggyback layout: encode, sidecars, coupled rebuild
        from seaweedfs_tpu_torch.ec.layout import (volume_layout,
                                                   write_layout_sidecars)
        write_ec_files(base, codec=codec, large_block=16 << 10,
                       small_block=4 << 10, slab=8 << 10, layout="piggyback")
        open(base + ".ecx", "wb").close()
        write_layout_sidecars(base, "piggyback", 4 << 10, 5)
        pb = [open(base + to_ext(i), "rb").read() for i in range(14)]
        assert pb[:10] == want[:10] and pb[10:] != want[10:]
        for sid in (0, 7, 11, 12):
            os.remove(base + to_ext(sid))
        assert rebuild_ec_files(base, codec=codec, slab=8 << 10,
                                layout=volume_layout(base, 10)) \
            == [0, 7, 11, 12]
        assert [open(base + to_ext(i), "rb").read() for i in range(14)] == pb
        # plane repair of a coupled data shard
        from seaweedfs_tpu_torch.ec import (LocalPlaneReader,
                                            PlaneGatherSource,
                                            rebuild_ec_file_piggyback)
        rplan = piggyback_repair_plan(10, 4, 3)
        os.remove(base + to_ext(3))
        source = PlaneGatherSource(
            [LocalPlaneReader(base + to_ext(h), rplan.alpha, 4 << 10,
                              rplan.plane_bit, rplan.plane_side)
             for h in rplan.helpers], size, rplan, 4 << 10, slab=8 << 10,
            gather_window=2)
        assert rebuild_ec_file_piggyback(base, 3, source, rplan, 4 << 10,
                                         codec=codec,
                                         slab=source.slab) == [3]
        assert [open(base + to_ext(i), "rb").read() for i in range(14)] == pb
        from seaweedfs_tpu_torch.tools import kernel_exp  # noqa: F401
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_degraded_read_and_scrub_with_jax_unimportable(tmp_path):
    """A needle GET through a lost shard (EcVolume + DegradedReadEngine)
    and a scrub that finds a flipped byte, on the port's plain version."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.ec import (DegradedReadEngine, EcVolume,
                                            ScrubEngine, to_ext,
                                            write_ec_files,
                                            write_sorted_file_from_idx)
        from seaweedfs_tpu_torch.ops import TorchCodec, gf_matmul
        from seaweedfs_tpu_torch.storage import SuperBlock, entry_to_bytes
        base = {str(tmp_path / "1")!r}
        rng = np.random.default_rng(0)
        dat = SuperBlock().to_bytes() + rng.bytes((2 << 20) - 8)
        open(base + ".dat", "wb").write(dat)
        nid, off, size = 77, (1 << 20) + 8, 300_000
        open(base + ".idx", "wb").write(entry_to_bytes(nid, off, size))
        write_sorted_file_from_idx(base)
        codec = TorchCodec(10, 4, device="cpu")
        write_ec_files(base, codec=codec)
        os.remove(base + to_ext(1))
        ev = EcVolume({str(tmp_path)!r}, "", 1)
        for sid in range(14):
            if sid != 1:
                ev.add_shard(sid)

        class Store:
            locations = [type("Loc", (), {{"ec_volumes": {{1: ev}}}})]

            def find_ec_volume(self, vid):
                return ev

        eng = DegradedReadEngine(Store(), lambda vid: {{}}, lambda: codec)
        blob = ev.read_needle_blob(nid, reconstruct_fetch=eng.read)
        assert blob == dat[off:off + len(blob)] and len(blob) > size
        assert eng.snapshot()["device_dispatches"] == 1
        # the shard rebuilt and mounted again; a flipped parity byte
        from seaweedfs_tpu_torch.ec import rebuild_ec_files
        assert rebuild_ec_files(base, codec=codec) == [1]
        ev.add_shard(1)
        eng.invalidate(1)
        with open(base + to_ext(12), "r+b") as f:
            f.seek(5)
            b = f.read(1)[0]
            f.seek(5)
            f.write(bytes([b ^ 1]))
        scrub = ScrubEngine(Store(), lambda vid: {{}}, lambda: codec,
                            lambda: "me", rate_mbps=0)
        res = scrub.scrub_volume(1, force=True)
        assert res["corrupt_shards"] == [12] and res["corrupt_slabs"] == [0]
        assert res["path"] == "device"
        eng.close()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_network_repair_with_jax_unimportable(tmp_path):
    """One port holder in the process serves the survivors; the port's
    Store trace-repairs a lost shard from it (-repair auto), pulling the
    index sidecars and only the projected symbol planes over HTTP."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.ec import to_ext, write_ec_files
        from seaweedfs_tpu_torch.ops import TorchCodec, gf_matmul
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.storage.store import Store
        hdir, sdir = {str(tmp_path / "holder")!r}, {str(tmp_path / "store")!r}
        os.makedirs(hdir)
        os.makedirs(sdir)
        base = os.path.join(hdir, "1")
        rng = np.random.default_rng(0)
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, 100_003, dtype=np.uint8).tobytes())
        codec = TorchCodec(10, 4, device="cpu")
        write_ec_files(base, codec=codec, large_block=16 << 10,
                       small_block=4 << 10, slab=8 << 10)
        open(base + ".ecx", "wb").close()
        want = open(base + to_ext(6), "rb").read()
        vs = VolumeServer(port=0, directories=[hdir], fast_port=-1).start()
        try:
            stats = {{}}
            got = Store([sdir], codec=codec).rebuild_ec_shards_streaming(
                1, sources={{i: [vs.url] for i in range(14) if i != 6}},
                stats=stats, slab=5000)
        finally:
            vs.stop()
        assert got == [6] and stats["repair_mode"] == "trace"
        assert open(os.path.join(sdir, "1" + to_ext(6)), "rb").read() == want
        assert 0 < stats["gather_remote_bytes"] < 10 * len(want)
        assert sorted(os.listdir(sdir)) == ["1.ec06", "1.ecx"]
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_streaming_spread_with_jax_unimportable(tmp_path):
    """Two port servers in the process: the source freezes its volume and
    streams its encode (/admin/ec/generate with an assignment), the
    holder takes shards 5-13 over /admin/ec/shard_write, copies the
    sidecars and mounts them; every shard equals the local encode's."""
    script = textwrap.dedent(f"""
        import json, os, shutil, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.ec import to_ext, write_ec_files
        from seaweedfs_tpu_torch.ops import TorchCodec, gf_matmul
        from seaweedfs_tpu_torch.server.http_util import http_call
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.storage import SuperBlock
        src, hdir, odir = ({str(tmp_path / "src")!r},
                           {str(tmp_path / "holder")!r},
                           {str(tmp_path / "oracle")!r})
        for d in (src, hdir, odir):
            os.makedirs(d)
        rng = np.random.default_rng(0)
        with open(os.path.join(src, "1.dat"), "wb") as f:
            f.write(SuperBlock().to_bytes())
            f.write(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
        open(os.path.join(src, "1.idx"), "wb").close()
        shutil.copy(os.path.join(src, "1.dat"), os.path.join(odir, "1.dat"))
        codec = TorchCodec(10, 4, device="cpu")
        write_ec_files(os.path.join(odir, "1"), codec=codec)
        source = VolumeServer(port=0, directories=[src], device="cpu",
                              codec=codec, fast_port=-1).start()
        holder = VolumeServer(port=0, directories=[hdir],
                              device="cpu", fast_port=-1).start()
        try:
            post = lambda url, body=None: json.loads(http_call(
                "POST", "http://" + url, body))
            assert post(source.url + "/admin/volume/readonly?volume=1")[
                "readonly"]
            place = {{str(s): holder.url for s in range(5, 14)}}
            out = post(source.url + "/admin/ec/generate?volume=1",
                       json.dumps({{"assignment": place}}).encode())
            assert out["stats"]["spread_remote_shards"] == 9
            post(holder.url + "/admin/ec/copy?volume=1&shards=&source="
                 + source.url)
            got = post(holder.url + "/admin/ec/mount?volume=1&shards="
                       + ",".join(map(str, range(5, 14))))
            assert got["mounted"] == list(range(5, 14))
        finally:
            source.stop()
            holder.stop()
        for sid in range(14):
            d = src if sid < 5 else hdir
            want = open(os.path.join(odir, "1" + to_ext(sid)), "rb").read()
            assert open(os.path.join(d, "1" + to_ext(sid)), "rb").read() \\
                == want, sid
        assert not [f for d in (src, hdir) for f in os.listdir(d)
                    if f.endswith(".part")]
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_data_plane_with_jax_unimportable(tmp_path):
    """One port VolumeServer in the process, on the CPU: a volume is
    created, needles written, read, deleted and vacuumed over HTTP, the
    volume encoded and mounted, and a needle read through a lost shard."""
    script = textwrap.dedent(f"""
        import json, os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.ops import gf_matmul
        from seaweedfs_tpu_torch.server.http_util import (
            HttpError, http_call, post_multipart)
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        vs = VolumeServer(port=0, directories=[{str(tmp_path / "d")!r}],
                          device="cpu", fast_port=-1).start()
        post = lambda t: json.loads(http_call("POST", "http://" + vs.url + t))
        try:
            assert post("/admin/assign_volume?volume=3") == {{"volume": 3}}
            rng = np.random.default_rng(0)
            fids = {{}}
            for i in range(1, 7):
                fid = "3,%x0000abcd" % i
                fids[fid] = rng.bytes(250_000)
                out = post_multipart("http://" + vs.url + "/" + fid,
                                     "n%d.bin" % i, fids[fid])
                assert out["size"] == 250_000
            for fid, data in fids.items():
                assert http_call("GET", "http://" + vs.url + "/" + fid) \\
                    == data
            gone = "3,20000abcd"
            http_call("DELETE", "http://" + vs.url + "/" + gone)
            del fids[gone]
            assert post("/admin/vacuum/check?volume=3")["garbage"] > 0
            post("/admin/vacuum/compact?volume=3")
            post("/admin/vacuum/commit?volume=3")
            assert post("/admin/vacuum/check?volume=3")["garbage"] == 0
            post("/admin/volume/readonly?volume=3")
            post("/admin/ec/generate?volume=3")
            post("/admin/ec/mount?volume=3&shards=" +
                 ",".join(map(str, range(14))))
            post("/admin/delete_volume?volume=3")
            post("/admin/ec/delete_shards?volume=3&shards=1")
            for fid, data in fids.items():
                assert http_call("GET", "http://" + vs.url + "/" + fid) \\
                    == data
            assert vs.degraded.snapshot()["reads"] > 0
            try:
                http_call("GET", "http://" + vs.url + "/" + gone)
                raise AssertionError("a deleted needle was served")
            except HttpError as e:
                assert e.status == 404
        finally:
            vs.stop()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_cluster_with_jax_unimportable(tmp_path):
    """A port master and three heartbeating port VolumeServers on the CPU
    in one process: needles written through /dir/assign, a 001 volume
    written on both replicas, then the shell's ec.encode, a lost shard,
    ec.rebuild, ec.balance and ec.decode, every needle read back."""
    script = textwrap.dedent(f"""
        import io, os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.ops import gf_matmul
        from seaweedfs_tpu_torch.server.http_util import http_call, post_json
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        root = {str(tmp_path)!r}
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0).start()
        servers = [VolumeServer(port=0, directories=[root + "/v%d" % i],
                                master_url=m.url, pulse_seconds=1,
                                max_volume_counts=[20],
                                device="cpu",
                                fast_port=-1).start() for i in range(3)]

        def shell(line):
            out = io.StringIO()
            run_command(CommandEnv(m.url, out=out), line)
            return out.getvalue()

        try:
            rng = np.random.default_rng(0)
            data = {{}}
            for i in range(10):
                body = rng.bytes(20_000)
                data[op.upload_data(m.url, body, filename="n%d" % i,
                                    collection="iso")] = body
            assert post_json("http://" + m.url + "/vol/grow?collection=r"
                             "&replication=001")["count"] == 1
            a = op.assign(m.url, collection="r", replication="001")
            body = rng.bytes(5000)
            op.upload(a["url"], a["fid"], body, filename="r.bin")
            vid = int(a["fid"].split(",")[0])
            holders = op.lookup(m.url, vid)
            assert len(holders) == 2
            for u in holders:
                assert http_call("GET", "http://%s/%s" % (u, a["fid"])) \\
                    == body
            by_vid = {{}}
            for fid in data:
                by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
            vid = max(by_vid, key=lambda v: len(by_vid[v]))
            assert "ec encoded" in shell("ec.encode -volumeId %d" % vid)
            victim = servers[0]
            lost = victim.store.find_ec_volume(vid).shard_ids()[:2]
            victim.store.unmount_ec_shards(vid, lost)
            for loc in victim.store.locations:
                for name in os.listdir(loc.directory):
                    if any(name.endswith(".ec%02d" % s) for s in lost):
                        os.remove(os.path.join(loc.directory, name))
            victim.heartbeat_once()
            assert "rebuilt shards" in shell("ec.rebuild")
            assert "shard moves" in shell("ec.balance")
            assert "decoded back" in shell("ec.decode -volumeId %d" % vid)
            for fid, body in data.items():
                assert op.read_file(m.url, fid) == body
        finally:
            for vs in servers:
                vs.stop()
            m.stop()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_ha_cluster_with_jax_unimportable(tmp_path):
    """Three port masters in a raft group with write tokens and three
    port VolumeServers on the CPU in one process, the leader their first
    seed: needles written through a follower's assigns with their tokens,
    ec.encode through the follower; then the leader stopped, two shards
    lost, ec.rebuild through a survivor once the new leader has the
    servers, a write after, every needle read back."""
    script = textwrap.dedent(f"""
        import io, os, socket, sys, time
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.http_util import (HttpError,
                                                          post_multipart)
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        root = {str(tmp_path)!r}
        socks = [socket.socket() for _ in range(3)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        peers = ",".join("127.0.0.1:%d" % p for p in ports)
        masters = [MasterServer(port=p, pulse_seconds=1, seed=i,
                                peers=peers, raft_dir=root + "/raft",
                                jwt_signing_key="k", repair_interval=0,
                                vacuum_interval=0).start()
                   for i, p in enumerate(ports)]

        def leader(alive, timeout=30):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                got = [m for m in alive if m.is_leader()]
                if len(got) == 1 and all(m.leader_url() == got[0].url
                                         for m in alive):
                    return got[0]
                time.sleep(0.05)
            raise AssertionError("no leader")

        def until(pred, timeout=30):
            deadline = time.monotonic() + timeout
            while not pred():
                assert time.monotonic() < deadline
                time.sleep(0.05)

        first = leader(masters)
        rest = [m for m in masters if m is not first]
        follower = rest[0]
        seeds = ",".join([first.url] + [m.url for m in rest])
        servers = [VolumeServer(port=0, directories=[root + "/v%d" % i],
                                master_url=seeds, pulse_seconds=1,
                                max_volume_counts=[20], device="cpu",
                                jwt_signing_key="k", fast_port=-1).start()
                   for i in range(3)]

        def shell(master, line):
            out = io.StringIO()
            run_command(CommandEnv(master.url, out=out), line)
            return out.getvalue()

        try:
            until(lambda: len(first.topology.all_nodes()) == 3)
            rng = np.random.default_rng(0)
            data = {{}}
            for i in range(10):
                body = rng.bytes(20_000)
                data[op.upload_data(follower.url, body, filename="n%d" % i,
                                    collection="iso")] = body
            a = op.assign(follower.url, collection="iso")
            try:
                post_multipart("http://%s/%s" % (a["url"], a["fid"]), "x",
                               b"x")
                raise AssertionError("a write without its token")
            except HttpError as e:
                assert e.status == 401
            by_vid = {{}}
            for fid in data:
                by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
            vid = max(by_vid, key=lambda v: len(by_vid[v]))
            assert "ec encoded" in shell(follower,
                                         "ec.encode -volumeId %d" % vid)
            first.stop()
            new = leader(rest)
            until(lambda: len(new.topology.all_nodes()) == 3 and
                  len(new.topology.lookup_ec_shards(vid) or {{}}) == 14)
            victim = next(vs for vs in servers
                          if vs.store.find_ec_volume(vid) is not None)
            lost = victim.store.find_ec_volume(vid).shard_ids()[:2]
            victim.store.unmount_ec_shards(vid, lost)
            for loc in victim.store.locations:
                for name in os.listdir(loc.directory):
                    if any(name.endswith(".ec%02d" % s) for s in lost):
                        os.remove(os.path.join(loc.directory, name))
            victim.heartbeat_once()
            until(lambda: len(new.topology.lookup_ec_shards(vid)) == 12)
            assert "rebuilt shards" in shell(follower, "ec.rebuild")
            until(lambda: len(new.topology.lookup_ec_shards(vid)) == 14)
            body = rng.bytes(7000)
            data[op.upload_data(follower.url, body, collection="iso")] = \
                body
            for fid, body in data.items():
                assert op.read_file(follower.url, fid) == body
        finally:
            for vs in servers:
                vs.stop()
            for m in masters:
                m.stop()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_volume_control_plane_with_jax_unimportable(tmp_path):
    """A port master and three port VolumeServers on the CPU in one
    process: a 001 volume written, backed up in full, needles deleted,
    backed up incrementally (the tombstones only), vacuumed through the
    shell, fsck'd, moved, brought back to two replicas by
    volume.fix.replication after one replica's delete; a second
    collection written through /submit and deleted."""
    script = textwrap.dedent(f"""
        import io, os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.command.volume_tools import backup_volume
        from seaweedfs_tpu_torch.server.http_util import (http_call,
                                                          post_json,
                                                          post_multipart)
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        root = {str(tmp_path)!r}
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0, vacuum_interval=0).start()
        servers = [VolumeServer(port=0, directories=[root + "/v%d" % i],
                                master_url=m.url, pulse_seconds=1,
                                max_volume_counts=[20],
                                device="cpu",
                                fast_port=-1).start() for i in range(3)]

        def shell(line):
            for vs in servers:
                vs.heartbeat_once()
            out = io.StringIO()
            run_command(CommandEnv(m.url, out=out), line)
            assert "error:" not in out.getvalue(), out.getvalue()
            return out.getvalue()

        try:
            assert post_json("http://" + m.url + "/vol/grow?collection=r"
                             "&replication=001")["count"] == 1
            rng = np.random.default_rng(0)
            data = {{}}
            for i in range(10):
                a = op.assign(m.url, collection="r", replication="001")
                body = rng.bytes(4000)
                op.upload(a["url"], a["fid"], body, filename="n%d" % i)
                data[a["fid"]] = body
            vid = int(next(iter(data)).split(",")[0])
            full = backup_volume(m.url, vid, root + "/bk", "r")
            assert full["mode"] == "full" and full["applied"] == 10
            for fid in list(data)[:4]:
                assert op.delete_file(m.url, fid)
                data.pop(fid)
            inc = backup_volume(m.url, vid, root + "/bk", "r")
            assert inc["mode"] == "incremental" and inc["applied"] == 4
            assert "vacuumed" in shell("volume.vacuum -garbageThreshold 0.1")
            assert "2 replicas, 0 with errors" in shell("volume.fsck -deep")
            holders = op.lookup(m.url, vid)
            free = [vs.url for vs in servers if vs.url not in holders][0]
            shell("volume.move -volumeId %d -source %s -target %s"
                  % (vid, holders[1], free))
            assert sorted(op.lookup(m.url, vid)) == sorted(
                [holders[0], free])
            post_json("http://%s/admin/delete_volume?volume=%d"
                      % (free, vid))
            assert "1 copies made" in shell("volume.fix.replication")
            assert len(op.lookup(m.url, vid)) == 2
            for fid, body in data.items():
                for u in op.lookup(m.url, vid):
                    assert http_call("GET", "http://%s/%s" % (u, fid)) \
                        == body
            out = post_multipart("http://" + m.url + "/submit?collection=t",
                                 "s.txt", b"submitted")
            assert op.read_file(m.url, out["fid"]) == b"submitted"
            assert "deleted volumes" in shell(
                "collection.delete -collection t")
            assert "collection 't'" not in shell("collection.list")
        finally:
            for vs in servers:
                vs.stop()
            m.stop()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_integrity_with_jax_unimportable(tmp_path):
    """A port master with a 0.2 s repair loop and three port
    VolumeServers on the CPU (background scrub off): ec.encode, a clean
    volume.ec.scrub -trigger, a flipped byte found by a scrub and
    repaired by the master's drain, a deleted shard rebuilt by it, the
    shell's cluster.repairs, cluster.devices and volume.ec.degraded,
    GET /admin/devices, a naive degraded read, and a torch.profiler
    trace."""
    script = textwrap.dedent(f"""
        import hashlib, io, os, sys, time
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.ops.device_stats import K1
        from seaweedfs_tpu_torch.server.http_util import (get_json,
                                                          http_call,
                                                          post_json)
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.util.profiling import annotate, maybe_trace
        root = {str(tmp_path)!r}
        # no at-risk advisories: the health fold scores holders by their
        # read latencies, and on a loaded host it opens advisories that
        # cluster.repairs below would count as open incidents
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0.2, at_risk_score=0).start()
        servers = [VolumeServer(port=0, directories=[root + "/v%d" % i],
                                master_url=m.url, pulse_seconds=1,
                                max_volume_counts=[20], device="cpu",
                                scrub_idle_s=0, scrub_rate_mbps=0,
                                degraded_mode="naive" if i == 2
                                else "batch",
                                fast_port=-1).start() for i in range(3)]

        def shell(line):
            out = io.StringIO()
            run_command(CommandEnv(m.url, out=out), line)
            assert "error:" not in out.getvalue(), out.getvalue()
            return out.getvalue()

        def wait(pred):
            t0 = time.monotonic()
            while not pred():
                assert time.monotonic() - t0 < 60
                time.sleep(0.05)

        def resolved(kind):
            return [i for i in get_json("http://" + m.url +
                                        "/cluster/repairs")[
                "resolved_recent"] if i["kind"] == kind]

        try:
            rng = np.random.default_rng(0)
            data = {{}}
            for i in range(8):
                data[op.upload_data(m.url, rng.bytes(30_000),
                                    collection="iso")] = None
            for fid in data:
                data[fid] = op.read_file(m.url, fid)
            by_vid = {{}}
            for fid in data:
                by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
            vid = max(by_vid, key=lambda v: len(by_vid[v]))
            assert "ec encoded" in shell("ec.encode -volumeId %d" % vid)
            wait(lambda: len(get_json("http://%s/cluster/ec_lookup"
                                      "?volumeId=%d" % (m.url, vid))[
                "shards"]) == 14)
            with maybe_trace("scrub", root + "/trace"):
                with annotate("scrub"):
                    lines = shell("volume.ec.scrub -trigger")
            assert os.path.exists(root + "/trace/scrub/trace.json")
            assert lines.count("findings=0") == 3, lines
            vs = next(v for v in servers
                      if v.store.find_ec_volume(vid) is not None)
            ev = vs.store.find_ec_volume(vid)
            sid = sorted(ev.shards)[0]
            path = ev.base_name + ".ec%02d" % sid
            want = hashlib.sha256(open(path, "rb").read()).hexdigest()
            with open(path, "r+b") as f:
                f.seek(os.path.getsize(path) // 2)
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 1]))
            out = post_json("http://%s/admin/ec/scrub?volume=%d"
                            % (vs.url, vid))
            assert out["corrupt_shards"] == [sid], out
            wait(lambda: resolved("corruption"))
            assert resolved("corruption")[0]["via"] == "scrub_repair"
            assert hashlib.sha256(open(path, "rb").read()).hexdigest() \
                == want
            post_json("http://%s/admin/ec/delete_shards?volume=%d"
                      "&collection=iso&shards=%d" % (vs.url, vid, sid))
            wait(lambda: resolved("lost_shard"))
            assert "0 open, 2 resolved" in shell("cluster.repairs")
            assert shell("cluster.devices").count("platform=cpu") == 3
            shell("volume.ec.degraded")
            devices = get_json("http://%s/admin/devices" % vs.url)
            assert devices["stats"]["dispatches"][K1] > 0
            assert not devices["stats"]["launches"]   # all on the CPU
            for fid, body in data.items():
                assert http_call("GET", "http://%s/%s"
                                 % (servers[2].url, fid)) == body
        finally:
            m.stop()
            for v in servers:
                v.stop()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_mesh_and_multihost_with_jax_unimportable(tmp_path):
    """MeshCodec over eight CPU positions encodes and rebuilds a volume,
    distributed_ec_step runs on a (2, 2) mesh of CPU positions, and two
    processes (each with jax and the JAX package unimportable too) run
    multihost_ec_step over gloo on a (1, 2) mesh; no K1 launch."""
    child = textwrap.dedent(f"""
        import json, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        torch.set_num_threads(1)
        from seaweedfs_tpu_torch.parallel import (init_distributed,
                                                  multihost_ec_step)
        from seaweedfs_tpu_torch.parallel.multihost import shutdown
        init_distributed(sys.argv[1], 2, int(sys.argv[2]), devices=["cpu"])
        out = multihost_ec_step(k=10, m=4, n_per_device=4096)
        shutdown()
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("RANK " + json.dumps(out), flush=True)
    """)
    script = textwrap.dedent(f"""
        import json, os, socket, subprocess, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from seaweedfs_tpu_torch.ec import (rebuild_ec_files, to_ext,
                                            write_ec_files)
        from seaweedfs_tpu_torch.ops import NumpyCodec
        from seaweedfs_tpu_torch.parallel import (MeshCodec,
                                                  distributed_ec_step,
                                                  make_mesh)
        from seaweedfs_tpu_torch.parallel.mesh import make_codec_mesh
        base = {str(tmp_path / "1")!r}
        rng = np.random.default_rng(0)
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes())
        codec = MeshCodec(10, 4, mesh=make_codec_mesh(["cpu"] * 8))
        st = {{}}
        write_ec_files(base, codec=codec, large_block=1 << 20,
                       small_block=64 << 10, slab=256 << 10, stats=st)
        assert st["mesh_dispatches"] > 0 and \
            st["dispatch_width_devices"] == 8
        want = [open(base + to_ext(i), "rb").read() for i in range(14)]
        data = np.stack([np.frombuffer(w, dtype=np.uint8)
                         for w in want[:10]])
        assert np.array_equal(NumpyCodec(10, 4).encode(data),
                              np.stack([np.frombuffer(w, dtype=np.uint8)
                                        for w in want[10:]]))
        for sid in (2, 7, 10, 12):
            os.remove(base + to_ext(sid))
        assert rebuild_ec_files(base, codec=codec, slab=256 << 10) == \
            [2, 7, 10, 12]
        assert [open(base + to_ext(i), "rb").read()
                for i in range(14)] == want
        mesh = make_mesh((2, 2), devices=["cpu"] * 4)
        assert distributed_ec_step(mesh, 10, 4, 1024)[2] == 0
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coord = "127.0.0.1:%d" % s.getsockname()[1]
        s.close()
        procs = [subprocess.Popen([sys.executable, "-c", {child!r}, coord,
                                   str(r)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        outs = [p.communicate(timeout=240)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
            r = json.loads(line[0][5:])
            assert r["ok"] and r["mesh_shape"] == {{"data": 1, "shard": 2}}
            assert r["k1_launches"] == 0
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert sys.modules["seaweedfs_tpu_torch.ops.device_stats"] \
            .DEVICE_STATS.launch_count("rs_hopper.gf_matmul") == 0
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    assert "PORT-OK" in proc.stdout


def test_observability_with_jax_unimportable(tmp_path):
    """A port master and two port VolumeServers on the CPU: an encode
    and a rebuild through the shell, then each server's ``/metrics``
    parsed, the master's ``/cluster/metrics?refresh=1`` (K1's series the
    servers' sum), ``/admin/traces`` naming the rebuild's trace and
    ``trace.export`` merging it."""
    script = textwrap.dedent(f"""
        import io, json, os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.http_util import get_json, http_call
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.stats.metrics import parse_prometheus_text
        root = {str(tmp_path)!r}
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0).start()
        servers = [VolumeServer(port=0, directories=[root + "/v%d" % i],
                                master_url=m.url, pulse_seconds=1,
                                max_volume_counts=[20],
                                device="cpu",
                                fast_port=-1).start() for i in range(2)]

        def shell(line):
            out = io.StringIO()
            run_command(CommandEnv(m.url, out=out), line)
            return out.getvalue()

        def k1(text):
            for fam in parse_prometheus_text(text):
                if fam["name"].endswith("_ec_xla_dispatches_total"):
                    return sum(v for _, lab, v in fam["samples"]
                               if dict(lab)["entry"] ==
                               "rs_hopper.gf_matmul")
            return 0

        try:
            rng = np.random.default_rng(0)
            fids = [op.upload_data(m.url, rng.bytes(20_000),
                                   filename="n%d" % i, collection="iso")
                    for i in range(6)]
            vid = int(fids[0].split(",")[0])
            assert "ec encoded" in shell("ec.encode -volumeId %d" % vid)
            victim = servers[0]
            lost = victim.store.find_ec_volume(vid).shard_ids()[:1]
            victim.store.unmount_ec_shards(vid, lost)
            for loc in victim.store.locations:
                for name in os.listdir(loc.directory):
                    if name.endswith(".ec%02d" % lost[0]):
                        os.remove(os.path.join(loc.directory, name))
            victim.heartbeat_once()
            assert "rebuilt shards" in shell("ec.rebuild")
            traces = get_json("http://%s/admin/traces?n=50"
                              % servers[1].url)["traces"]
            tid = next(t["trace_id"] for t in traces
                       if t["root"] == "ec.rebuild")
            per = [k1(http_call("GET", "http://%s/metrics"
                                % vs.url).decode()) for vs in servers]
            merged = http_call("GET", "http://%s/cluster/metrics?refresh=1"
                               % m.url).decode()
            assert per[0] > 0 and k1(merged) == sum(per)
            out = shell("trace.export -trace %s -o %s/t.json" % (tid, root))
            assert out.startswith("trace.export: ")
            with open(root + "/t.json") as f:
                nodes = json.load(f)["metadata"]["nodes"]
            assert "client" in nodes and m.url in nodes
        finally:
            for vs in servers:
                vs.stop()
            m.stop()
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_tiering_with_jax_unimportable(tmp_path):
    """A port master and two port VolumeServers on the CPU: a volume
    tiered onto a ``dir`` backend through the shell and read back, brought
    home with -deleteRemote (its .dat byte-equal to the one uploaded);
    then a second volume sealed and demoted by the master's tierer
    (``/cluster/tiering?scan=1``), every needle read back from its EC
    shards."""
    script = textwrap.dedent(f"""
        import io, os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.http_util import get_json, post_json
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.storage.backend import configure_backends
        root = {str(tmp_path)!r}
        configure_backends({{"dir": {{"cold": {{"path": root + "/tier"}}}}}})
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0, tier_rate_mbps=0,
                         tier_age=0).start()
        servers = [VolumeServer(port=0, directories=[root + "/v%d" % i],
                                master_url=m.url, pulse_seconds=1,
                                max_volume_counts=[20],
                                device="cpu",
                                fast_port=-1).start() for i in range(2)]

        def shell(line):
            for vs in servers:
                vs.heartbeat_once()
            out = io.StringIO()
            run_command(CommandEnv(m.url, out=out), line)
            assert "error:" not in out.getvalue(), out.getvalue()
            return out.getvalue()

        def fill(collection):
            post_json("http://%s/vol/grow?collection=%s&count=1"
                      % (m.url, collection))
            data = {{}}
            for i in range(8):
                body = rng.bytes(3000)
                data[op.upload_data(m.url, body, filename="n%d" % i,
                                    collection=collection)] = body
            vids = {{int(fid.split(",")[0]) for fid in data}}
            assert len(vids) == 1, vids
            return vids.pop(), data

        try:
            rng = np.random.default_rng(0)
            vid, data = fill("cold")
            holder = next(vs for vs in servers if vs.store.find_volume(vid))
            dat = holder.store.find_volume(vid).dat_path
            with open(dat, "rb") as f:
                want = f.read()
            assert "-> dir.cold/" in shell(
                "volume.tier.upload -volumeId %d -dest dir.cold" % vid)
            assert not os.path.exists(dat)
            for fid, body in data.items():
                assert op.read_file(m.url, fid) == body
            assert "local again" in shell(
                "volume.tier.download -volumeId %d -deleteRemote" % vid)
            with open(dat, "rb") as f:
                assert f.read() == want
            assert os.listdir(root + "/tier") == []
            # the download leaves the volume frozen, as in JAX: thawed
            # here, so that the tierer's scan passes it by
            post_json("http://%s/admin/volume/readonly?volume=%d"
                      "&readonly=false" % (holder.url, vid))
            vid, data = fill("warm")
            for vs in servers:
                if vs.store.find_volume(vid):
                    post_json("http://%s/admin/volume/readonly?volume=%d"
                              % (vs.url, vid))
                vs.heartbeat_once()
            out = get_json("http://%s/cluster/tiering?scan=1" % m.url)
            assert out["volumes"][str(vid)]["state"] == "warm", out
            assert str(vid) in get_json(
                "http://%s/cluster/ec_status" % m.url)["volumes"]
            for fid, body in data.items():
                assert op.read_file(m.url, fid) == body
        finally:
            for vs in servers:
                vs.stop()
            m.stop()
        assert sys.modules["seaweedfs_tpu_torch.ops.rs_hopper"]._lib is None
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_native_data_plane_with_jax_unimportable(tmp_path):
    """A port master and a port VolumeServer on the CPU with its native
    plane and ``-index disk``: a file stored as chunks and a manifest
    (``cm=``) read whole and by Range; JSON needles written through the
    plane and queried (``/query``); the volume encoded and a shard lost,
    a cold GET through the plane reconstructed and a warm one served in
    the plane; the .ndb checkpoint there."""
    script = textwrap.dedent(f"""
        import json, os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import http.client
        import numpy as np
        from seaweedfs_tpu_torch.client import chunked
        from seaweedfs_tpu_torch.server.http_util import (http_call,
                                                          post_multipart)
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        root = {str(tmp_path)!r}
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0).start()
        vs = VolumeServer(port=0, directories=[root + "/v"],
                          master_url=m.url, pulse_seconds=1,
                          max_volume_counts=[20], device="cpu",
                          index_kind="disk").start()

        def raw_get(path):
            c = http.client.HTTPConnection(*vs.fast_url.split(":"))
            c.request("GET", path)
            r = c.getresponse()
            out = r.status, r.read()
            c.close()
            return out

        try:
            assert vs.fast_plane is not None
            data = np.random.default_rng(1).bytes(50_000)
            fid = chunked.submit_chunked(m.url, data, filename="f",
                                         chunk_size=20_000)
            assert http_call("GET", "http://%s/%s" % (vs.fast_url, fid)) \
                == data
            assert http_call("GET", "http://%s/%s" % (vs.url, fid),
                             headers={{"Range": "bytes=19990-20009"}}) == \
                data[19990:20010]
            http_call("POST", "http://%s/admin/assign_volume?volume=9"
                      % vs.url)
            bodies = {{}}
            for i in range(6):
                rows = [json.dumps({{"id": i * 1000 + j, "v": j % 97}})
                        for j in range(12_000)]
                body = ("\\n".join(rows) + "\\n").encode()
                f = "9,%x1234abcd" % (i + 1)
                post_multipart("http://%s/%s" % (vs.fast_url, f), "q", body)
                bodies[f] = body
            assert vs.fast_plane.written >= 6
            assert os.path.exists(root + "/v/9.ndb")
            ask = json.dumps({{"fids": list(bodies),
                               "sql": "SELECT id FROM t WHERE v = 96"}})
            before = http_call("POST", "http://%s/query" % vs.url,
                               ask.encode())
            assert before.count(b"\\n") == 6 * 123
            for route in ("volume/readonly", "ec/generate"):
                http_call("POST", "http://%s/admin/%s?volume=9"
                          % (vs.url, route))
            http_call("POST", "http://%s/admin/ec/mount?volume=9&shards=%s"
                      % (vs.url, ",".join(map(str, range(14)))))
            http_call("POST", "http://%s/admin/delete_volume?volume=9"
                      % vs.url)
            http_call("POST", "http://%s/admin/ec/delete_shards?volume=9"
                      "&shards=0" % vs.url)
            assert http_call("POST", "http://%s/query" % vs.url,
                             ask.encode()) == before
            f = "9,11234abcd"
            assert http_call("GET", "http://%s/%s" % (vs.fast_url, f)) \
                == bodies[f]
            served = vs.fast_plane.cache_stats()["degraded_served"]
            assert raw_get("/" + f) == (200, bodies[f])
            assert vs.fast_plane.cache_stats()["degraded_served"] > served
        finally:
            vs.stop()
            m.stop()
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_filer_and_s3_with_jax_unimportable(tmp_path):
    """A port master, a volume server on the CPU, a filer that seals its
    chunks and an S3 gateway: SigV4 PUTs, a multipart upload, a GET
    through the filer, a standalone gateway over ``FilerClient``, the
    volume encoded and a shard under an object lost, a GET through it,
    and a volume tiered onto the ``s3`` backend at the port's own
    gateway."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import io
        import numpy as np
        from seaweedfs_tpu_torch.filer.filer_client import FilerClient
        from seaweedfs_tpu_torch.s3.auth import Iam, Identity, sign_request_v4
        from seaweedfs_tpu_torch.s3.s3_server import S3ApiServer
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.http_util import get_json, http_call
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        from seaweedfs_tpu_torch.storage import backend
        from seaweedfs_tpu_torch.storage.types import parse_file_id
        root = {str(tmp_path)!r}
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0).start()
        vs = VolumeServer(port=0, directories=[root + "/v"],
                          master_url=m.url, pulse_seconds=1,
                          max_volume_counts=[20], device="cpu",
                          fast_port=-1).start()
        f = FilerServer(port=0, master_url=m.url, cipher=True).start()
        iam = Iam([Identity("i", "AK", "SK")])
        s3 = S3ApiServer(f.filer, m.url, port=0, iam=iam).start()
        alone = S3ApiServer(FilerClient(f.url), m.url, port=0,
                            iam=iam).start()

        def call(gw, method, path, body=b""):
            url = "http://%s%s" % (gw.url, path)
            h = sign_request_v4(method, url, {{}}, body, "AK", "SK")
            return http_call(method, url, body=body or None, headers=h)

        try:
            rng = np.random.default_rng(2)
            call(s3, "PUT", "/b")
            objs = {{"o%d" % i: rng.bytes(300_000) for i in range(8)}}
            for k, d in objs.items():
                call(s3, "PUT", "/b/" + k, d)
            up = call(s3, "POST", "/b/mp?uploads")
            uid = up.split(b"<UploadId>")[1].split(b"<")[0].decode()
            for i in (1, 2):
                call(s3, "PUT", "/b/mp?partNumber=%d&uploadId=%s" % (i, uid),
                     objs["o%d" % i])
            call(s3, "POST", "/b/mp?uploadId=" + uid, b"<x/>")
            assert call(alone, "GET", "/b/mp") == objs["o1"] + objs["o2"]
            assert http_call("GET", "http://%s/buckets/b/o3" % f.url) \
                == objs["o3"]
            # a file written through the filer is sealed on the volume
            # server and opens through the filer
            http_call("PUT", "http://%s/sealed/f" % f.url, objs["o4"])
            sealed = f.filer.find_entry("/sealed/f").chunks[0]
            assert sealed.cipher_key and objs["o4"][:64] not in http_call(
                "GET", "http://%s/%s" % (vs.url, sealed.fid))
            assert http_call("GET", "http://%s/sealed/f" % f.url) \
                == objs["o4"]
            c = f.filer.find_entry("/buckets/b/o0").chunks[0]
            vid = parse_file_id(c.fid)[0]
            out = io.StringIO()
            run_command(CommandEnv(m.url, out=out),
                        "ec.encode -volumeId %d" % vid)
            ev = vs.store.find_ec_volume(vid)
            assert ev is not None, out.getvalue()
            sid = ev.locate_needle(parse_file_id(c.fid)[1])[2][0]
            sid = sid.block_index % 10
            os.remove(ev.base_name + ".ec%02d" % sid)
            http_call("POST", "http://%s/admin/ec/unmount?volume=%d"
                      "&shards=%d" % (vs.url, vid, sid))
            for k, d in objs.items():
                assert call(alone, "GET", "/b/" + k) == d
            assert get_json("http://%s/status" % vs.url)[
                "ec_degraded"]["reads"] > 0
            backend.configure_backends({{"s3": {{"t": {{
                "endpoint": s3.url, "bucket": "tier", "access_key": "AK",
                "secret_key": "SK"}}}}}})
            call(s3, "PUT", "/tier")
            b = backend.get_backend("s3.t")
            src = os.path.join(root, "x.dat")
            with open(src, "wb") as fh:
                fh.write(objs["o5"])
            assert b.upload_file(src, "x.dat") == len(objs["o5"])
            assert b.read_range("x.dat", 10, 20) == objs["o5"][10:30]
        finally:
            for srv in (alone, s3, f, vs, m):
                srv.stop()
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_operator_surface_with_jax_unimportable(tmp_path):
    """A mutual-TLS cluster configured from ``security.toml`` and
    ``master.toml`` (a master, a volume server on the CPU, a filer, all
    in one process), then the CLI's ``benchmark``, ``upload`` (one file
    chunked), ``download``, ``filer.copy``, the status pages, ``see``,
    ``fix`` and ``scaffold``; a certificate-less client refused on the
    admin routes."""
    import shutil as _shutil
    if _shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    script = textwrap.dedent(f"""
        import os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import contextlib, io, ssl, subprocess, http.client
        root = {str(tmp_path)!r}
        os.chdir(root)

        def run(*cmd):
            subprocess.run(cmd, check=True, capture_output=True)
        run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", "ca.key", "-out", "ca.pem", "-days", "1", "-subj",
            "/CN=ca")
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout",
            "srv.key", "-out", "srv.csr", "-subj", "/CN=127.0.0.1")
        run("openssl", "x509", "-req", "-in", "srv.csr", "-CA", "ca.pem",
            "-CAkey", "ca.key", "-CAcreateserial", "-out", "srv.pem",
            "-days", "1")
        with open("security.toml", "w") as f:
            f.write('[jwt.signing]\\nkey = "k"\\n[https]\\n'
                    'cert = "srv.pem"\\nkey = "srv.key"\\nca = "ca.pem"\\n'
                    'mutual = true\\n')
        with open("master.toml", "w") as f:
            f.write("[master.volume_growth]\\ncopy_1 = 2\\n")
        from seaweedfs_tpu_torch.command import cli
        from seaweedfs_tpu_torch.server import http_util
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer

        def cmd(*argv):
            args = cli.build_parser().parse_args(list(argv))
            cli._apply_tls_config(args)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                args.fn(args)
            return out.getvalue()
        args = cli.build_parser().parse_args(["master"])
        cli._apply_tls_config(args)
        cli._apply_security_config(args)
        kw = cli._apply_master_config(args)
        assert http_util.mtls_enabled() and args.jwtKey == "k"
        m = MasterServer(port=0, pulse_seconds=1, repair_interval=0,
                         jwt_signing_key=args.jwtKey, **kw).start()
        vs = VolumeServer(port=0, directories=[root + "/v"],
                          master_url=m.url, pulse_seconds=1, device="cpu",
                          jwt_signing_key=args.jwtKey).start()
        f = FilerServer(port=0, master_url=m.url,
                        jwt_signing_key=args.jwtKey).start()
        try:
            assert vs.fast_plane is None
            vs.heartbeat_once()
            out = cmd("benchmark", "-master", m.url, "-n", "12", "-size",
                      "700", "-c", "3", "-collection", "b")
            assert out.count("requests: 12 ok, 0 failed") == 2, out
            assert len(vs.store.locations[0].volumes) == 2
            with open("big.bin", "wb") as fh:
                fh.write(os.urandom(1_500_000))
            with open("small.txt", "wb") as fh:
                fh.write(b"small")
            up = cmd("upload", "-master", m.url, "-maxMB", "1", "big.bin",
                     "small.txt")
            fids = [ln.split(" -> ")[1] for ln in up.splitlines()]
            cmd("download", "-master", m.url, "-dir", "dl", *fids)
            for name in ("big.bin", "small.txt"):
                assert open("dl/" + name, "rb").read() == \\
                    open(name, "rb").read()
            os.makedirs("tree/sub")
            with open("tree/sub/x.txt", "wb") as fh:
                fh.write(b"x" * 99)
            out = cmd("filer.copy", "tree", "http://%s/in/" % f.url)
            assert "copied 1 files" in out
            page = http_util.http_call(
                "GET", "http://%s/in/tree/sub/" % f.url,
                headers={{"Accept": "text/html"}}).decode()
            assert ">x.txt</a>" in page
            assert vs.url in http_util.http_call(
                "GET", "http://%s/ui" % m.url).decode()
            assert "Volumes" in http_util.http_call(
                "GET", "http://%s/ui" % vs.url).decode()
            ctx = ssl.create_default_context(cafile="ca.pem")
            ctx.check_hostname = False
            c = http.client.HTTPSConnection(
                "127.0.0.1", vs.port, context=ctx, timeout=10)
            c.request("GET", "/admin/devices")
            assert c.getresponse().status == 403
            c.close()
            vid = fids[1].split(",")[0]
            d = vs.store.locations[0].directory
            assert "needles" in cmd("see", "%s/%s.dat" % (d, vid))
            assert "index records" in cmd("see", "%s/%s.idx" % (d, vid))
            assert "[master.volume_growth]" in cmd("scaffold", "-config",
                                                   "master")
        finally:
            for srv in (f, vs, m):
                srv.stop()
            http_util.reset_tls()
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_event_plane_with_jax_unimportable(tmp_path):
    """A port stack (master, volume server on the CPU, a filer whose
    webhook publisher, enabled by ``WEED_NOTIFICATION_WEBHOOK_*``, posts
    into a ``MsgBrokerServer``, an S3 gateway and a WebDAV gateway), and
    the CLI's ``watch``, ``filer.replicate`` (an ``s3`` sink on the
    stack's own gateway, seeded by ``fs.meta.notify``) and ``shell
    -filer`` as processes, each with both packages unimportable too:
    every replicated object equal, the WebDAV verbs, the shell's output,
    and the broker's events and watch's lines equal to the filer's."""
    script = textwrap.dedent(f"""
        import os, sys
        BLOCK = "import sys\\nfor n in {FORBIDDEN!r}: sys.modules[n] = None\\n"
        exec(BLOCK)
        sys.path.insert(0, {str(ROOT)!r})
        import base64, http.client, json, re, signal, subprocess, time
        root = {str(tmp_path)!r}
        from seaweedfs_tpu_torch.command import cli
        from seaweedfs_tpu_torch.replication.sub import format_event
        from seaweedfs_tpu_torch.s3.auth import Iam, Identity, sign_request_v4
        from seaweedfs_tpu_torch.s3.s3_server import S3ApiServer
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.http_util import get_json, http_call
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.msg_broker import MsgBrokerServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
        broker = MsgBrokerServer(port=0).start()
        os.environ["WEED_NOTIFICATION_WEBHOOK_ENABLED"] = "true"
        os.environ["WEED_NOTIFICATION_WEBHOOK_URL"] = (
            "http://%s/queue/publish?topic=ev" % broker.url)
        os.chdir(root)
        m = MasterServer(port=0, pulse_seconds=1, seed=1,
                         repair_interval=0).start()
        vs = VolumeServer(port=0, directories=[root + "/v"],
                          master_url=m.url, pulse_seconds=1,
                          max_volume_counts=[20], device="cpu",
                          fast_port=-1).start()
        pub = cli._notification_publisher()
        assert pub.name == "webhook", pub
        f = FilerServer(port=0, master_url=m.url,
                        notify_publisher=pub).start()
        s3 = S3ApiServer(f.filer, m.url, port=0,
                         iam=Iam([Identity("i", "AK", "SK")])).start()
        dav = WebDavServer(f.filer, m.url, port=0, chunk_size=4096).start()
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)

        def proc(*argv):
            code = (BLOCK + "sys.path.insert(0, %r)\\n" % {str(ROOT)!r}
                    + "from seaweedfs_tpu_torch.command.cli import main\\n"
                    + "sys.exit(main(sys.argv[1:]))")
            return subprocess.Popen([sys.executable, "-c", code] + list(argv),
                                    stdout=subprocess.PIPE, text=True,
                                    env=env)

        def call(method, path, body=b""):
            url = "http://%s%s" % (s3.url, path)
            h = sign_request_v4(method, url, {{}}, body, "AK", "SK")
            return http_call(method, url, body=body or None, headers=h)

        def dav_req(method, path, body=b"", headers=None):
            c = http.client.HTTPConnection(dav.url[7:], timeout=30)
            c.request(method, path, body=body or None, headers=headers or {{}})
            r = c.getresponse()
            out = (r.status, dict(r.getheaders()), r.read())
            c.close()
            return out

        def events():
            return get_json("http://%s/filer/events?since=0&timeout=0"
                            % f.url)["events"]
        watch = proc("watch", "-filer", f.url, "-since", "0")
        procs = [watch]
        try:
            import random
            rng = random.Random(7)
            objs = {{"d/o%d.bin" % i: rng.randbytes(rng.randrange(1, 200_000))
                     for i in range(6)}}
            objs["t/notes.txt"] = b"line one\\nline two\\n" * 500
            call("PUT", "/src")
            for k, d in objs.items():
                call("PUT", "/src/" + k, d)
            call("PUT", "/replica")
            cfg = os.path.join(root, "rep.json")
            with open(cfg, "w") as fh:
                json.dump({{"source": {{"filer": f.url, "master": m.url,
                                        "path": "/buckets/src"}},
                           "sink": {{"type": "s3", "endpoint":
                                    "http://" + s3.url, "bucket": "replica",
                                    "access_key": "AK",
                                    "secret_key": "SK"}}}}, fh)
            rep = proc("filer.replicate", "-config", cfg, "-since",
                       repr(events()[-1]["ts"]))
            procs.append(rep)
            assert rep.stdout.readline().startswith("replicating ")
            sh = proc("shell", "-master", m.url, "-filer", f.url, "-c",
                      "fs.meta.notify /buckets/src")
            assert sh.wait(60) == 0
            assert "notified" in sh.stdout.read()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    if all(call("GET", "/replica/" + k) == d
                           for k, d in objs.items()):
                        break
                except Exception:
                    pass
                time.sleep(0.1)
            for k, d in objs.items():
                assert call("GET", "/replica/" + k) == d, k
            rep.send_signal(signal.SIGTERM)
            assert rep.wait(30) == 0
            # WebDAV
            st, _, body = dav_req("PROPFIND", "/buckets/src",
                                  headers={{"Depth": "1"}})
            assert st == 207 and b"/buckets/src/d/" in body, body
            assert dav_req("GET", "/buckets/src/d/o1.bin")[2] == \\
                objs["d/o1.bin"]
            st, h, part = dav_req("GET", "/buckets/src/t/notes.txt",
                                  headers={{"Range": "bytes=5-14"}})
            assert (st, part) == (206, objs["t/notes.txt"][5:15])
            lock = (b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
                    b'<D:owner>t</D:owner></D:lockinfo>')
            codes = [dav_req("MKCOL", "/dav")[0],
                     dav_req("PUT", "/dav/a.bin", b"a" * 9000)[0],
                     dav_req("MOVE", "/dav/a.bin", headers={{
                         "Destination": dav.url + "/dav/b.bin"}})[0],
                     dav_req("COPY", "/dav/b.bin", headers={{
                         "Destination": dav.url + "/dav/c.bin"}})[0]]
            st, h, _ = dav_req("LOCK", "/dav/b.bin", lock)
            codes += [st, dav_req("PUT", "/dav/b.bin", b"x")[0],
                      dav_req("UNLOCK", "/dav/b.bin", headers={{
                          "Lock-Token": h["Lock-Token"]}})[0],
                      dav_req("DELETE", "/dav/c.bin")[0]]
            assert codes == [201, 201, 201, 201, 200, 423, 204, 204], codes
            # shell -filer
            sh = proc("shell", "-master", m.url, "-filer", f.url, "-c",
                      "fs.ls /buckets/src; fs.du /buckets/src; bucket.list;"
                      " bucket.create -name nb; bucket.delete -name nb; "
                      "fs.cat /buckets/src/t/notes.txt")
            out, _ = sh.communicate(timeout=60)
            assert sh.returncode == 0
            size = sum(len(d) for d in objs.values())
            assert out.startswith("d/\\nt/\\n%d bytes\\t7 files\\t/buckets/src"
                                  "\\nreplica\\nsrc\\ncreated bucket nb\\n"
                                  "deleted bucket nb\\n" % size), out[:300]
            assert out.endswith(objs["t/notes.txt"].decode() + "\\n")
            # events: the broker's and watch's against the filer's
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                evs = events()
                msgs = get_json("http://%s/queue/subscribe?topic=ev&since=0"
                                "&timeout=0" % broker.url)["messages"]
                if len(msgs) >= len(evs):
                    break
                time.sleep(0.05)
            evs = events()
            got = [json.loads(base64.b64decode(x["data"])) for x in msgs]
            assert [g["event"] for g in got] == [e["event"] for e in evs]
            assert [g["key"] for g in got] == [
                (e["event"]["newEntry"] or e["event"]["oldEntry"])["path"]
                for e in evs]
            time.sleep(0.5)
            watch.send_signal(signal.SIGTERM)
            lines = watch.stdout.read().splitlines()
            assert watch.wait(30) == 0
            assert lines == [format_event(e["ts"], e["event"]) for e in evs]
            assert len(evs) > 20
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for srv in (dav, s3, f, vs, m, broker):
                srv.stop()
        assert not any(mod.split(".")[0] in {FORBIDDEN!r}
                       for mod, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


def test_host_codec_maps_locks_and_stores_with_jax_unimportable(tmp_path):
    """The native codec (an encode and a rebuild equal to the numpy
    oracle's), a sortedfile volume's write, reload and compaction, the
    lock-order recorder's cycle report, and the etcd store against a
    stub of the etcd v3 JSON gateway kept in this test, all with both
    packages unimportable."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import base64, http.server, json, threading
        import numpy as np
        root = {str(tmp_path)!r}
        # the native codec
        from seaweedfs_tpu_torch.ec import (rebuild_ec_files, to_ext,
                                            write_ec_files)
        from seaweedfs_tpu_torch.ops.codec import NumpyCodec, get_codec
        from seaweedfs_tpu_torch.ops.rs_native import NativeCodec
        base = os.path.join(root, "1")
        with open(base + ".dat", "wb") as f:
            f.write(np.random.default_rng(0).integers(
                0, 256, 100_003, dtype=np.uint8).tobytes())
        blocks = dict(large_block=16 << 10, small_block=4 << 10,
                      slab=8 << 10)
        codec = get_codec(10, 4, "native")
        assert type(codec) is NativeCodec
        write_ec_files(base, codec=codec, **blocks)
        want = [open(base + to_ext(i), "rb").read() for i in range(14)]
        data = np.frombuffer(b"".join(want[:10]), np.uint8).reshape(10, -1)
        parity = NumpyCodec(10, 4).encode(data)
        assert [bytes(r) for r in parity] == want[10:]
        for sid in (0, 6, 12):
            os.remove(base + to_ext(sid))
        assert sorted(rebuild_ec_files(base, codec=codec, slab=8 << 10)) \\
            == [0, 6, 12]
        assert [open(base + to_ext(i), "rb").read()
                for i in range(14)] == want
        # a sortedfile volume: write, reload, compaction
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.storage.volume import Volume
        vdir = os.path.join(root, "v")
        os.makedirs(vdir)
        v = Volume(vdir, "", 3, create=True, index_kind="sortedfile")
        for i in range(1, 30):
            v.write_needle(Needle(id=i, cookie=5, data=b"n%d" % i * 50))
        v.delete_needle(Needle(id=7, cookie=5))
        v.close()
        v = Volume(vdir, "", 3, index_kind="sortedfile")
        assert os.path.exists(v.file_name() + ".sdx")
        v.compact()
        v.commit_compact()
        for i in range(1, 30):
            if i != 7:
                assert v.read_needle(Needle(id=i, cookie=5)).data == \\
                    b"n%d" % i * 50
        assert v.nm.kind == "sortedfile"
        v.close()
        # the recorder's cycle report
        from seaweedfs_tpu_torch.util import locks
        rec = locks.LockGraphRecorder()
        a = locks.make_lock("torch.a", recorder=rec)
        b = locks.make_lock("torch.b", recorder=rec)
        for x, y in ((a, b), (b, a)):
            with x:
                with y:
                    pass
        assert rec.cycles() == [["torch.a", "torch.b"]]
        assert rec.cycles(allowed={{("torch.b", "torch.a")}}) == []
        # the etcd store on a stub of etcd's v3 JSON gateway
        kv, lock = {{}}, threading.Lock()

        class Etcd(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                req = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                key = base64.b64decode(req["key"])
                end = base64.b64decode(req.get("range_end", ""))
                inside = (lambda k: k == key) if not end else (
                    lambda k: k >= key and (end == b"\\0" or k < end))
                with lock:
                    if self.path.endswith("/put"):
                        kv[key] = base64.b64decode(req["value"])
                        out = {{}}
                    elif self.path.endswith("/range"):
                        keys = sorted(k for k in kv if inside(k))
                        keys = keys[:int(req.get("limit", 0)) or None]
                        out = {{"kvs": [
                            {{"key": base64.b64encode(k).decode(),
                              "value": base64.b64encode(kv[k]).decode()}}
                            for k in keys]}}
                    else:
                        gone = [k for k in kv if inside(k)]
                        for k in gone:
                            del kv[k]
                        out = {{"deleted": str(len(gone))}}
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Etcd)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        from seaweedfs_tpu_torch.filer.entry import Attr, Entry
        from seaweedfs_tpu_torch.filer.filerstore import make_store
        store = make_store("etcd", addr="127.0.0.1:%d" % srv.server_address[1])
        for p in ("/d/a", "/d/b", "/d/sub/c", "/e/x"):
            store.insert_entry(Entry(full_path=p, attr=Attr(mime=p)))
        assert store.find_entry("/d/b").attr.mime == "/d/b"
        assert [e.name for e in store.list_directory_entries(
            "/d", "a", False, 10)] == ["b"]
        store.delete_folder_children("/d")
        assert store.find_entry("/d/sub/c") is None
        assert store.find_entry("/e/x") is not None
        store.close()
        srv.shutdown()
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("PORT-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout
