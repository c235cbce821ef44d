"""The f4 hot→warm lifecycle on a port cluster (the JAX
``tests/test_tiering.py`` cases), held against a JAX cluster.

Each package runs ``test_torch_cluster.Cluster`` (a master and two
volume servers on 127.0.0.1; the port's on ``device="cpu"``, the JAX ones
on their numpy codec), one seed for both masters' draws and one fixed
clock, so both fill the same volume with the same seeded needles. The
master's ``VolumeTierer`` is driven through ``GET
/cluster/tiering?scan=1``:

- a sealed volume is demoted to ``warm``: the payloads' keys, states,
  ``hot_bytes`` and knob values equal the JAX master's; the hot replica is
  gone, every needle reads back through the master, the shards are
  mounted, and each demoted shard equals the JAX package's
  ``write_ec_files`` (``NumpyCodec``) over a copy of the .dat taken
  before the demotion, byte for byte; the master's ``tier_*`` families
  count the demotion;
- a writable volume and a sealed but young one are passed by, as by the
  JAX master;
- under a 4 MB/s cap, a reader hammering the volume and a writer landing
  needles in another collection see no failure and no wrong byte
  through the whole demotion (no drain window), and the sealed volume
  takes no write;
- a fresh master's payload equals the JAX one's, and a follower of a raft
  group forwards ``/cluster/tiering`` to its leader.

No test sleeps across a pulse (``wait_until``, ``heartbeat_once``).
Tolerances: none."""

import shutil
import threading
import time

import numpy as np
import pytest

from conftest import wait_until
from test_torch_cluster import (SEED, Cluster, seed_jax,  # noqa: F401
                                torch_one_thread)


@pytest.fixture
def fixed_clock(monkeypatch):
    seed_jax(monkeypatch, SEED)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_250_000_000)


def _fill_volume(c, collection, n=20, nbytes=3000, seed=2):
    """Needles into ONE volume of the collection: (vid, {fid: data})."""
    rng = np.random.default_rng(seed)
    a0 = c.op.assign(c.master.url, collection=collection)
    vid = int(a0["fid"].split(",")[0])
    payloads = {}
    for i, a in enumerate(
            [a0] + [c.op.assign(c.master.url, collection=collection)
                    for _ in range(n)]):
        if int(a["fid"].split(",")[0]) != vid:
            continue
        data = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
        c.op.upload(a["url"], a["fid"], data, filename=f"t{i}")
        payloads[a["fid"]] = data
    assert payloads
    return vid, payloads


def _seal(c, vid):
    """Freeze the volume on its holders; the master's view (which the
    tierer scans) shows it read_only after their heartbeats."""
    from seaweedfs_tpu_torch.server.http_util import post_json
    for vs in c.servers:
        if vs.store.find_volume(vid):
            post_json(f"http://{vs.url}/admin/volume/readonly?volume={vid}")
    for vs in c.servers:
        vs.heartbeat_once()
    assert wait_until(lambda: any(
        r.get("read_only") for r in c.volumes().get(str(vid), [])),
        timeout=10)


def _tiering(c, scan=False):
    return c.master_json("/cluster/tiering" + ("?scan=1" if scan else ""))


def _shape(payload):
    """What the packages must agree on: every key, the knobs, each
    volume's state keys, state, collection, hot_bytes and replicas."""
    return {"keys": sorted(payload), "enabled": payload["enabled"],
            "scans": payload["scans"], "ok": payload["demotions_ok"],
            "failed": payload["demotions_failed"],
            "knobs": payload["knobs"],
            "volumes": {vid: (sorted(st), st["state"], st["collection"],
                              st["hot_bytes"], st["replicas"])
                        for vid, st in payload["volumes"].items()}}


def _tier_series(c):
    from seaweedfs_tpu_torch.server.http_util import http_call
    from seaweedfs_tpu_torch.stats.metrics import parse_prometheus_text
    text = http_call("GET", f"http://{c.master.url}/metrics").decode()
    out = {}
    for fam in parse_prometheus_text(text):
        if fam["name"].startswith("SeaweedFS_master_tier_"):
            for name, labels, value in fam["samples"]:
                out[(name, tuple(labels))] = value
    return out


def _demote(c, tmp_path, kind):
    vid, payloads = _fill_volume(c, "warmme")
    _seal(c, vid)
    holder = next(vs for vs in c.servers if vs.store.find_volume(vid))
    kept = tmp_path / f"{kind}-kept"
    kept.mkdir()
    shutil.copyfile(holder.store.find_volume(vid).dat_path,
                    kept / f"{vid}.dat")
    c.master.tierer.age_s = 0.0       # sealed counts at once
    c.master.tierer.rate_mbps = 0.0   # unpaced: the paced case is below
    before = _tier_series(c) if kind == "port" else None
    out = _tiering(c, scan=True)
    assert out["volumes"][str(vid)]["state"] == "warm", out
    assert wait_until(lambda: not any(vs.store.find_volume(vid)
                                      for vs in c.servers), timeout=10)
    reads = {fid: c.op.read_file(c.master.url, fid) for fid in payloads}
    return {"vid": vid, "payloads": payloads, "reads": reads, "out": out,
            "kept": str(kept / str(vid)), "before": before}


def test_tiering_demotes_sealed_volume_like_jax(tmp_path, fixed_clock):
    from seaweedfs_tpu.ec.constants import TOTAL_SHARDS, to_ext
    from seaweedfs_tpu.ec.encoder import write_ec_files
    from seaweedfs_tpu.ops.codec import NumpyCodec
    got = {}
    for kind in ("ref", "port"):
        c = Cluster(kind, tmp_path, n=2)
        try:
            got[kind] = _demote(c, tmp_path, kind)
            if kind == "port":
                port = got[kind]
                vid = port["vid"]
                assert str(vid) in c.ec_volumes()
                shards = {}
                for vs in c.servers:
                    ev = vs.store.find_ec_volume(vid)
                    for sid in (ev.shard_ids() if ev else []):
                        with open(ev.base_name + to_ext(sid), "rb") as f:
                            shards[sid] = f.read()
                port["shards"] = shards
                port["after"] = _tier_series(c)
        finally:
            c.stop()
    ref, port = got["ref"], got["port"]
    assert port["vid"] == ref["vid"] and port["payloads"] == ref["payloads"]
    assert _shape(port["out"]) == _shape(ref["out"])
    st = port["out"]["volumes"][str(port["vid"])]
    assert st["hot_bytes"] > 0 and st["demote_mbps"] >= 0
    assert len(st["trace_id"]) == 32
    assert port["out"]["demotions_ok"] == 1
    assert port["reads"] == port["payloads"]

    # the demoted shards are the JAX package's encode of the kept .dat
    with open(ref["kept"] + ".dat", "rb") as a, \
            open(port["kept"] + ".dat", "rb") as b:
        assert a.read() == b.read()
    write_ec_files(ref["kept"], codec=NumpyCodec(10, 4))
    assert sorted(port["shards"]) == list(range(TOTAL_SHARDS))
    for sid, blob in port["shards"].items():
        with open(ref["kept"] + to_ext(sid), "rb") as f:
            assert blob == f.read(), sid

    delta = {k: v - port["before"].get(k, 0)
             for k, v in port["after"].items()}
    ok = ("SeaweedFS_master_tier_demotions_total", (("result", "ok"),))
    assert delta[ok] == 1
    assert delta[("SeaweedFS_master_tier_demoted_bytes_total", ())] == \
        st["hot_bytes"]
    assert port["after"][("SeaweedFS_master_tier_volumes",
                          (("state", "warm"),))] == 1
    assert port["after"][("SeaweedFS_master_tier_mbps", ())] == \
        st["demote_mbps"]


def test_tiering_skips_young_and_writable(tmp_path, fixed_clock):
    got = {}
    for kind in ("ref", "port"):
        c = Cluster(kind, tmp_path, n=2)
        try:
            vid, _ = _fill_volume(c, "hotstuff", n=3, seed=4)
            steps = []
            # writable: never a candidate, even at age 0
            c.master.tierer.age_s = 0.0
            c.master.tierer.rate_mbps = 0.0
            steps.append(_shape(_tiering(c, scan=True)))
            # sealed but just written: the age gate holds it back
            _seal(c, vid)
            c.master.tierer.age_s = 3600.0
            steps.append(_shape(_tiering(c, scan=True)))
            # old enough: demoted on the next pass
            c.master.tierer.age_s = 0.0
            steps.append(_shape(_tiering(c, scan=True)))
            got[kind] = (vid, steps)
        finally:
            c.stop()
    assert got["port"] == got["ref"]
    vid, steps = got["port"]
    assert steps[0]["volumes"] == steps[1]["volumes"] == {}
    assert steps[2]["volumes"][str(vid)][1] == "warm"
    assert [s["scans"] for s in steps] == [1, 2, 3]


def test_tiering_reads_served_during_demotion(tmp_path, torch_one_thread):
    """No drain window: the reader never fails or sees a wrong byte, the
    writer never fails and never lands in the sealed volume."""
    c = Cluster("port", tmp_path, n=2)
    try:
        vid, payloads = _fill_volume(c, "livetier", n=12, seed=6)
        _seal(c, vid)
        c.master.tierer.age_s = 0.0
        c.master.tierer.rate_mbps = 4.0   # paced: reads overlap the move
        fids = list(payloads)
        stop = threading.Event()
        failures, reads, writes = [], [0], []

        def hammer():
            i = 0
            while not stop.is_set():
                fid = fids[i % len(fids)]
                try:
                    if c.op.read_file(c.master.url, fid) != payloads[fid]:
                        failures.append((fid, "mismatch"))
                except Exception as e:  # noqa: BLE001 - the assertion
                    failures.append((fid, repr(e)))
                reads[0] += 1
                i += 1

        def writer():
            rng = np.random.default_rng(7)
            while not stop.is_set():
                try:
                    writes.append(c.op.upload_data(
                        c.master.url, rng.bytes(2048), filename="w",
                        collection="other"))
                except Exception as e:  # noqa: BLE001 - the assertion
                    failures.append(("write", repr(e)))

        threads = [threading.Thread(target=fn, daemon=True)
                   for fn in (hammer, writer)]
        for t in threads:
            t.start()
        try:
            t0 = time.perf_counter()
            out = _tiering(c, scan=True)
            wall = time.perf_counter() - t0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        st = out["volumes"][str(vid)]
        assert st["state"] == "warm", st
        assert not failures, failures[:5]
        assert reads[0] > 0 and writes
        assert all(int(fid.split(",")[0]) != vid for fid in writes)
        # the cap paced it: 14 one-MiB shards at 4 MB/s
        assert wall >= 14 * (1 << 20) / 4e6 * 0.9
        assert st["demote_mbps"] < 4.0
        for fid in fids[:3]:
            assert c.op.read_file(c.master.url, fid) == payloads[fid]
    finally:
        c.stop()


def test_tiering_endpoint_shape():
    from seaweedfs_tpu.server.http_util import get_json as ref_get
    from seaweedfs_tpu.server.master import MasterServer as RefMaster
    from seaweedfs_tpu_torch.server import tiering
    from seaweedfs_tpu_torch.server.http_util import get_json
    from seaweedfs_tpu_torch.server.master import MasterServer
    ref = RefMaster(port=0, pulse_seconds=1, vacuum_interval=0).start()
    port = MasterServer(port=0, pulse_seconds=1, repair_interval=0).start()
    try:
        want = ref_get(f"http://{ref.url}/cluster/tiering")
        got = get_json(f"http://{port.url}/cluster/tiering")
        assert got == want
        assert got["enabled"] is False and got["volumes"] == {}
        assert got["knobs"] == {
            "interval_s": tiering.TIER_INTERVAL_S,
            "age_s": tiering.TIER_AGE_S,
            "concurrency": tiering.TIER_CONCURRENCY,
            "rate_mbps": tiering.TIER_RATE_MBPS,
            "full_frac": tiering.TIER_FULL_FRAC}
        # a scan of an empty cluster touches nothing but the counter
        assert get_json(f"http://{port.url}/cluster/tiering?scan=1") == \
            ref_get(f"http://{ref.url}/cluster/tiering?scan=1")
        assert port.tierer._thread is None
    finally:
        port.stop()
        ref.stop()


def test_tiering_knobs_from_the_command_line(monkeypatch):
    """The master's -tier* flags reach MasterServer's keywords."""
    from types import SimpleNamespace

    import seaweedfs_tpu_torch.server.master as master_mod
    made = []

    class Recorder:
        def __init__(self, **kw):
            made.append(kw)
            self.url = "127.0.0.1:0"

        def start(self):
            return self

        def stop(self):
            made.append("stopped")
    done = threading.Event()
    done.set()
    monkeypatch.setattr(master_mod, "MasterServer", Recorder)
    monkeypatch.setattr(master_mod, "threading",
                        SimpleNamespace(Event=lambda: done))
    monkeypatch.setattr(master_mod.signal, "signal", lambda *a: None)
    assert master_mod.main(["-port", "0", "-tierEnable", "-tierInterval",
                            "30", "-tierAge", "5", "-tierConcurrency", "2",
                            "-tierRateMBps", "12.5",
                            "-tierFullFrac", "0.5"]) == 0
    kw = made[0]
    assert {k: kw[k] for k in kw if k.startswith("tier_")} == {
        "tier_enable": True, "tier_interval": 30.0, "tier_age": 5.0,
        "tier_concurrency": 2, "tier_rate_mbps": 12.5,
        "tier_full_frac": 0.5}
    assert made[-1] == "stopped"
    made.clear()
    assert master_mod.main(["-port", "0"]) == 0
    from seaweedfs_tpu_torch.server import tiering
    assert made[0]["tier_enable"] is False
    assert made[0]["tier_rate_mbps"] == tiering.TIER_RATE_MBPS


def test_tier_loop_runs_on_the_leader_and_ends_with_the_master():
    from seaweedfs_tpu_torch.server.master import MasterServer
    m = MasterServer(port=0, pulse_seconds=1, repair_interval=0,
                     tier_enable=True, tier_interval=0.05).start()
    try:
        thread = m.tierer._thread
        assert thread is not None and thread.name == "master-tierer"
        assert wait_until(lambda: m.tierer.scans >= 2, timeout=10)
    finally:
        m.stop()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_follower_forwards_tiering_to_its_leader(tmp_path):
    from test_torch_raft import _group, http_leader
    from seaweedfs_tpu_torch.server.http_util import get_json
    masters = _group("port", tmp_path)
    try:
        leader = http_leader(masters)
        leader.tierer.age_s = 12.0
        follower = next(m for m in masters if m is not leader)
        before = follower.forwarded
        got = get_json(f"http://{follower.url}/cluster/tiering?scan=1")
        assert got["knobs"]["age_s"] == 12.0 and got["scans"] == 1
        assert leader.tierer.scans == 1 and follower.tierer.scans == 0
        assert follower.forwarded == before + 1
    finally:
        for m in masters:
            m.stop()
