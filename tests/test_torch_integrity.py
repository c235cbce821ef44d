"""The port's integrity plane against the JAX package's.

- ``stats/repair_queue``: one scripted sequence of reports, duplicates,
  drains, failed attempts (back-off), resolutions and snapshots through
  both packages' ``RepairQueue`` with their clocks fixed; every return
  and snapshot equal field by field.
- The master's ``_repair_scan`` over the same shard maps in both
  packages (a stripe filled shard by shard as an encode registers it,
  whole, with holes, remounted, gone): the queue's snapshots equal (the
  JAX health fold is empty; its ``source`` is each master's own url).
- ``/cluster/scrub_report`` and ``/cluster/repairs`` replies of both
  masters on the same findings.
- A 3-server cluster of each package (the port's servers on the CPU,
  the JAX ones on their numpy codec), the flow of the JAX
  ``tests/test_scrub.py::test_cluster_scrub_detect_repair_end_to_end``:
  the same seeded needles into collection "sc", ``ec.encode`` of the
  fullest volume, a clean scrub on every server, one byte flipped in the
  lowest shard of the first holder, that holder's scrub finding, the
  master's corruption incident drained into ``/admin/ec/scrub_repair``,
  a clean re-scrub, the highest shard deleted everywhere and the
  lost-shard incident drained into a rebuild. Equal between the two: the
  placements, findings, incidents (times out), the ``scrub_status``
  fields (host and device dispatches as a sum: the split is each
  codec's), every repaired shard's bytes (= the original's), the reads,
  and the shell's ``volume.ec.scrub``, ``volume.ec.degraded`` and
  ``cluster.repairs`` lines (servers by index, times and the dispatch
  split out). On the port side, K1's dispatches (``ops/device_stats``)
  equal the scrubs' device dispatches.
- The shell's ``volume.ec.scrub``, ``volume.ec.degraded``,
  ``cluster.repairs`` and ``cluster.devices`` lines of both packages on
  the same replies: equal character for character.
- Naive degraded reads (``degraded_mode="naive"``) byte-identical to the
  batch engine's, to the JAX server's ``_reconstruct_shard_range_naive``
  and to the lost shard.
- The heartbeat: a master that holds one heartbeat post open does not
  hold up ``/admin/assign_volume``, and the late answer does not roll
  back that route's newer ack.

Tolerances: none; bytes and fields are equal. No test waits across a
pulse: each polls."""

import hashlib
import io
import json
import os
import re
import shutil
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from conftest import wait_until
from test_torch_cluster import _ordered_ports, seed_jax

SEED = 5
TOTAL = 14
REPAIR_S = 0.3
NT = 1_700_000_000  # the needles' clock, fixed for both packages


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def time(self):
        return self.t


# -- the repair queue ----------------------------------------------------------

def _queue_script(q, clock):
    """A scripted sequence; returns every observable result."""
    out = []
    a = q.report("corruption", volume=3, shard=2, source="s1",
                 detail={"slabs": [0], "columns": 1})
    out.append(a.to_dict())
    clock.t += 1
    b = q.report("lost_shard", volume=3, shard=9, source="m")
    out.append(b.to_dict())
    clock.t += 1
    out.append(q.report("corruption", volume=3, shard=2, source="s2",
                        detail={"slabs": [0, 1]}).to_dict())   # duplicate
    out.append(q.report("corruption", volume=4, shard=-1,
                        source="s1").to_dict())               # unattributed
    out.append(q.report("at_risk_holder", holder="h:1",
                        detail={"score": 0.1}).to_dict())
    out.append(q.report("lost_shard", volume=5, shard=0,
                        detected_at=500.0).to_dict())
    with pytest.raises(ValueError):
        q.report("flood", volume=1)
    out.append(q.snapshot())
    nxt = q.next_incident()                  # corruption first
    out.append(nxt.to_dict())
    q.attempt_failed(nxt, "holder down " * 40)
    out.append(q.snapshot())
    out.append(q.next_incident().to_dict())  # backed off: the oldest loss
    out.append(q.next_incident().to_dict())  # again, attempts 2
    clock.t += 31
    out.append(q.next_incident().to_dict())  # back-off over: corruption
    out.append([i.to_dict() for i in q.open_for_volume(3)])
    out.append([i.to_dict() for i in q.open_for_volume(3, "lost_shard")])
    clock.t += 2.5
    out.append(q.resolve("corruption", volume=3, shard=2,
                         via="scrub_repair").to_dict())
    out.append(q.resolve("corruption", volume=3, shard=2))  # None
    clock.t += 4
    out.append(q.resolve("lost_shard", volume=3, shard=9,
                         via="rebuild").to_dict())
    out.append(q.resolve("lost_shard", volume=5, shard=0,
                         via="remounted").to_dict())
    out.append(q.ttr_stats())
    out.append(q.depth_by_kind())
    out.append(q.snapshot())
    out.append(q.summary())
    return out


def test_repair_queue_matches_jax(monkeypatch):
    from seaweedfs_tpu.stats import repair_queue as ref
    from seaweedfs_tpu_torch.stats import repair_queue as port
    results = []
    for mod in (ref, port):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        results.append(_queue_script(mod.RepairQueue(), clock))
    assert results[0] == results[1]
    assert port.PRIORITIES == ref.PRIORITIES
    assert port.RETRY_BACKOFF_S == ref.RETRY_BACKOFF_S


# -- the master's scan and replies -------------------------------------------

class _Node:
    def __init__(self, url):
        self.url = url


def _masters(monkeypatch):
    from seaweedfs_tpu.server.master import MasterServer as RefMaster
    from seaweedfs_tpu_torch.server.master import MasterServer
    monkeypatch.setenv("SW_REPAIR_INTERVAL_S", "0")
    ref = RefMaster(port=0, pulse_seconds=60, vacuum_interval=0).start()
    port = MasterServer(port=0, pulse_seconds=60, seed=SEED,
                        repair_interval=0).start()
    return ref, port


def _clocks(monkeypatch):
    from seaweedfs_tpu.stats import repair_queue as ref
    from seaweedfs_tpu_torch.stats import repair_queue as port
    clock = FakeClock()
    monkeypatch.setattr(ref, "time", clock)
    monkeypatch.setattr(port, "time", clock)
    return clock


def _own_url_out(snap, url):
    """A snapshot with the master's own url as ``M``."""
    return json.loads(json.dumps(snap).replace(url, "M"))


def test_repair_scan_matches_jax(monkeypatch):
    clock = _clocks(monkeypatch)
    ref, port = _masters(monkeypatch)
    holders = [_Node(f"10.0.0.{i}:80") for i in range(3)]
    try:
        def apply(maps):
            got = []
            for m in (ref, port):
                with m.topology.lock:
                    m.topology.ec_shard_map = {
                        vid: [[holders[h] for h in hs] for hs in per]
                        for vid, per in maps.items()}
                m._repair_scan()
                got.append((_own_url_out(m.repair_queue.snapshot(), m.url),
                            sorted(m._repair_seen_complete)))
            assert got[0] == got[1]
            clock.t += 1
            return got[1]

        def stripe(present, holes=()):
            return [[s % 3] if s < present and s not in holes else []
                    for s in range(TOTAL)]

        # an encode registering its shards one by one: holes, no loss
        for present in (1, 5, 13):
            snap, seen = apply({7: stripe(present)})
            assert snap["open"] == [] and seen == []
        snap, seen = apply({7: stripe(14), 8: stripe(9)})
        assert seen == [7] and snap["open"] == []
        # holes in the whole stripe are losses; the half-built one is not
        snap, _ = apply({7: stripe(14, holes=(3, 11)), 8: stripe(9)})
        assert [(i["kind"], i["shard"]) for i in snap["open"]] == \
            [("lost_shard", 3), ("lost_shard", 11)]
        snap, _ = apply({7: stripe(14, holes=(11,)), 8: stripe(9)})
        assert snap["resolved_recent"][-1]["via"] == "remounted"
        # a volume gone from every holder, then from the map
        snap, seen = apply({7: [[] for _ in range(TOTAL)], 8: stripe(9)})
        assert len(snap["open"]) == 1
        snap, seen = apply({8: stripe(9)})
        assert snap["open"] == [] and seen == []
        assert snap["resolved_recent"][-1]["via"] == "volume_removed"
    finally:
        ref.stop()
        port.stop()


def test_scrub_report_and_repairs_replies_match_jax(monkeypatch):
    from seaweedfs_tpu_torch.server.http_util import get_json, post_json
    clock = _clocks(monkeypatch)
    ref, port = _masters(monkeypatch)
    try:
        findings = [
            {"volume": 3, "collection": "sc", "shards": [2, 5],
             "slabs": [0], "columns": 2, "source": "v1:80",
             "detected_at": 900.5},
            {"volume": 3, "collection": "sc", "shards": [2], "slabs": [1],
             "columns": 1, "source": "v2:80"},
            {"volume": 4, "shards": [], "slabs": [3], "columns": 9,
             "source": "v1:80"},
        ]
        for finding in findings:
            got = [post_json(f"http://{m.url}/cluster/scrub_report",
                             finding) for m in (ref, port)]
            assert got[0] == got[1]
            clock.t += 1
        for path in ("/cluster/repairs", "/cluster/repairs?refresh=1"):
            got = [get_json(f"http://{m.url}{path}") for m in (ref, port)]
            assert got[0] == got[1]
        assert [i["status"] for i in got[1]["open"]] == \
            ["open", "open", "unattributed"]
    finally:
        ref.stop()
        port.stop()


# -- the shell's lines on the same replies ------------------------------------

class _CannedEnv:
    """Every node and master answer from ``replies`` by path."""

    def __init__(self, env_cls, replies):
        self.env = env_cls("m:1", out=io.StringIO())
        self.env.master_get = lambda path: replies[path]
        self.env.node_get = lambda url, path: replies[(url, path)]
        self.env.node_post = lambda url, path, *a, **k: {}


def test_shell_lines_match_jax_on_the_same_replies():
    from seaweedfs_tpu.shell import command_cluster as ref_cluster
    from seaweedfs_tpu.shell import command_ec as ref_ec
    from seaweedfs_tpu.shell.command_env import CommandEnv as RefEnv
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.shell import command_cluster, command_ec
    nodes = {"nodes": [{"url": "a:1"}, {"url": "b:2"}]}
    scrub = {"passes": 3, "volumes_scrubbed": 2, "slabs": 28,
             "bytes_verified": 29 << 20, "last_pass_mbps": 812.34,
             "corrupt_slabs": 1, "corrupt_columns": 4, "findings": 1,
             "host_dispatches": 2, "device_dispatches": 26,
             "skipped_not_owner": 1, "skipped_missing": 0, "errors": 0}
    degraded = {"reads": 40, "batches": 9, "batched_requests": 31,
                "max_batch_requests": 7, "cache_hit_ratio": 0.4,
                "cache_bytes": 5 << 20, "cache_entries": 40,
                "survivor_bytes": 11 << 20, "remote_bytes": 3 << 20,
                "host_dispatches": 1, "device_dispatches": 8,
                "p99_ms": 41.25, "errors": 0}
    repairs = {
        "open": [{"kind": "lost_shard", "volume": 3, "shard": 9,
                  "attempts": 2, "detected_at": 1700000000.4,
                  "last_error": "rebuild of 3 restored nothing"},
                 {"kind": "at_risk_holder", "volume": None, "shard": None,
                  "holder": "h:9", "attempts": 0, "detected_at": 17.0}],
        "resolved_recent": [
            {"kind": "corruption", "volume": 3, "shard": 2,
             "via": "scrub_repair", "time_to_re_protection_s": 1.26}],
        "counters": {"resolved": 1},
        "time_to_re_protection": {"p50_s": 1.26, "p99_s": 1.26,
                                  "count": 1}}
    devices = {
        "stats": {"compiles": {"gf_plan.make_plan": 3, "nvcc:x": 1},
                  "recompiles": {"gf_plan.make_plan": 1},
                  "sentinel": True,
                  "offenders": ["gf_plan.make_plan:((4, 14), 'ab')"],
                  "const_cache_occupancy": {"entries": 2,
                                            "bytes": 5312}},
        "inventory": {"platform": "gpu",
                      "device_kinds": {"NVIDIA H100 80GB HBM3": 1}}}
    replies = {"/cluster/status": nodes,
               "/cluster/repairs?refresh=1": repairs,
               "/cluster/repairs": repairs,
               ("a:1", "/admin/ec/scrub_status"): scrub,
               ("b:2", "/admin/ec/scrub_status"): {},
               ("a:1", "/status"): {"ec_degraded": degraded},
               ("b:2", "/status"): {},
               ("a:1", "/admin/devices"): devices,
               ("b:2", "/admin/devices"): {}}
    lines = []
    for env_cls, ec_mod, cl_mod in ((RefEnv, ref_ec, ref_cluster),
                                    (CommandEnv, command_ec,
                                     command_cluster)):
        got = []
        for fn, args in ((ec_mod.volume_ec_scrub, ["-trigger"]),
                         (ec_mod.volume_ec_degraded, []),
                         (cl_mod.cluster_repairs, []),
                         (cl_mod.cluster_repairs, ["-refresh", "false"]),
                         (cl_mod.cluster_devices, [])):
            c = _CannedEnv(env_cls, replies)
            fn(c.env, args)
            got.append(c.env.out.getvalue())
        lines.append(got)
    assert lines[0] == lines[1]
    assert "SENTINEL" in lines[1][4] and "devices=NVIDIA H100" in \
        lines[1][4]


# -- a cluster of each package, end to end --------------------------------------

def _server(kind, d, master_url, port):
    if kind == "ref":
        from seaweedfs_tpu.server.volume_server import VolumeServer
        return VolumeServer(port=port, directories=[d],
                            master_url=master_url, pulse_seconds=1,
                            max_volume_counts=[30], ec_backend="numpy",
                            fast_port=-1).start()
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(port=port, directories=[d], master_url=master_url,
                        pulse_seconds=1, max_volume_counts=[30],
                        device="cpu", scrub_idle_s=0,
                        scrub_rate_mbps=0).start()


_TIMING = ("last_pass_s", "last_pass_mbps", "last_pass_at", "volumes",
           "host_dispatches", "device_dispatches")


def _scrub_fields(snap):
    out = {k: v for k, v in snap.items() if k not in _TIMING}
    out["dispatches"] = snap["host_dispatches"] + snap["device_dispatches"]
    return out


def _incident(inc, names):
    out = {k: v for k, v in inc.items() if k not in (
        "detected_at", "resolved_at", "time_to_re_protection_s", "id")}
    out["source"] = names.get(out["source"], out["source"])
    return out


def _shell_lines(text, names):
    for url, name in names.items():
        text = text.replace(url, name)
    text = re.sub(r"dispatch\(host/dev\)=\d+/\d+", "dispatch=D", text)
    text = re.sub(r"@\d+\.\d+MB/s", "@R", text)
    text = re.sub(r"(ttr|p50|p99)=\d+\.\d+s", r"\1=T", text)
    text = re.sub(r"since=\d+", "since=T", text)
    return re.sub(r"\d+\.\d+(e-?\d+)?", "T", text).splitlines()


def _sha_file(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def integrity_flow(kind, root, monkeypatch):
    """The JAX end-to-end scrub test's flow on one package's cluster;
    returns what the two clusters must agree on."""
    from seaweedfs_tpu_torch.server.http_util import (HttpError, get_json,
                                                      http_call, post_json)
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.shell.command_env import CommandEnv, run_command
        monkeypatch.setenv("SW_REPAIR_INTERVAL_S", str(REPAIR_S))
        monkeypatch.setenv("SW_EC_SCRUB_RATE_MBPS", "0")
        # no score is below 0: neither master's at-risk half opens an
        # advisory, however slow a loaded host makes its holders look
        # (the port master takes the same floor as ``at_risk_score``)
        monkeypatch.setenv("SW_REPAIR_AT_RISK_SCORE", "0")
        master = MasterServer(port=0, pulse_seconds=1,
                              vacuum_interval=0).start()
    else:
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K1
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
        master = MasterServer(port=0, pulse_seconds=1, seed=SEED,
                              repair_interval=REPAIR_S,
                              at_risk_score=0).start()
    servers = [_server(kind, str(root / f"{kind}-v{i}"), master.url, p)
               for i, p in enumerate(_ordered_ports(3))]
    names = {vs.url: f"S{i}" for i, vs in enumerate(servers)}
    names[master.url] = "M"
    rec = {}

    def shell(line):
        out = io.StringIO()
        run_command(CommandEnv(master.url, out=out), line)
        return _shell_lines(out.getvalue(), names)

    def repairs(refresh=False):
        return get_json(f"http://{master.url}/cluster/repairs"
                        + ("?refresh=1" if refresh else ""))

    try:
        rng = np.random.default_rng(29)
        payloads = {}
        with monkeypatch.context() as m:
            m.setattr(time, "time", lambda: float(NT))
            m.setattr(time, "time_ns", lambda: NT * 10**9)
            for i in range(10):
                data = rng.integers(0, 256, 120_000).astype(
                    np.uint8).tobytes()
                fid = op.upload_data(master.url, data, filename=f"s{i}",
                                     collection="sc")
                payloads[fid] = data
        rec["fids"] = sorted(payloads)
        by_vid = {}
        for f in payloads:
            by_vid.setdefault(int(f.split(",")[0]), []).append(f)
        vid = max(sorted(by_vid), key=lambda v: len(by_vid[v]))
        rec["encode"] = shell(f"ec.encode -volumeId {vid}")

        def shard_map():
            try:
                out = get_json(f"http://{master.url}/cluster/ec_lookup"
                               f"?volumeId={vid}")
            except HttpError as e:
                if e.status == 404:  # no shard registered yet
                    return None
                raise
            got = {int(s): urls for s, urls in out["shards"].items()}
            return got if set(got) == set(range(TOTAL)) else None

        placed = wait_until(shard_map, timeout=30)
        rec["placed"] = {s: [names[u] for u in urls]
                         for s, urls in placed.items()}
        held = {s: os.path.join(
            servers[int(names[urls[0]][1:])].store.locations[0].directory,
            f"sc_{vid}.ec{s:02d}") for s, urls in placed.items()}
        shas = {s: _sha_file(p) for s, p in held.items()}
        rec["shas"] = shas

        # a clean scrub on every server: no finding, no incident
        k1 = DEVICE_STATS.snapshot()["dispatches"].get(K1, 0) \
            if kind == "port" else 0
        rec["clean"] = []
        for vs in servers:
            res = post_json(f"http://{vs.url}/admin/ec/scrub")
            snap = get_json(f"http://{vs.url}/admin/ec/scrub_status")
            assert snap["findings"] == 0 and snap["corrupt_slabs"] == 0
            rec["clean"].append((res["volumes"], res["findings"],
                                 _scrub_fields(snap)))
        if kind == "port":
            assert DEVICE_STATS.snapshot()["dispatches"][K1] - k1 == sum(
                vs.scrub.snapshot()["device_dispatches"] for vs in servers)
        assert not repairs()["open"]

        # one byte flipped in the first holder's lowest shard
        victim = next(i for i, vs in enumerate(servers)
                      if vs.store.find_ec_volume(vid) is not None)
        vs = servers[victim]
        ev = vs.store.find_ec_volume(vid)
        sid = sorted(ev.shards)[0]
        path = ev.base_name + f".ec{sid:02d}"
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0x80]))
        res = post_json(f"http://{vs.url}/admin/ec/scrub?volume={vid}")
        assert not res["clean"] and res["corrupt_shards"] == [sid]
        rec["finding"] = (victim, sid, {k: v for k, v in res.items() if k
                                        not in ("seconds", "phases",
                                                "path")})

        def resolved(kind_, shard):
            # the repair loop's own scan opens the lost-shard incident: a
            # scan here could see the remount before the drain resolves
            for inc in repairs()["resolved_recent"]:
                if inc["kind"] == kind_ and inc["volume"] == vid and \
                        inc["shard"] == shard:
                    return inc
            return None

        inc = wait_until(lambda: resolved("corruption", sid), timeout=60)
        assert inc and inc["via"] == "scrub_repair"
        assert 0 < inc["time_to_re_protection_s"] < 120
        rec["corruption"] = _incident(inc, names)
        assert _sha_file(path) == shas[sid]
        out = post_json(f"http://{vs.url}/admin/ec/scrub?volume={vid}")
        assert out["clean"]
        for f, want in payloads.items():
            if int(f.split(",")[0]) == vid:
                assert http_call("GET", f"http://{servers[0].url}/{f}",
                                 timeout=30) == want

        # the highest shard deleted everywhere: rebuilt by the drain
        lose = max(placed)
        for holder in placed[lose]:
            post_json(f"http://{holder}/admin/ec/unmount?volume={vid}"
                      f"&shards={lose}")
            post_json(f"http://{holder}/admin/ec/delete_shards"
                      f"?volume={vid}&collection=sc&shards={lose}")
        inc = wait_until(lambda: resolved("lost_shard", lose), timeout=60)
        assert inc and inc["time_to_re_protection_s"] > 0
        rec["lost"] = _incident(inc, names)
        now = wait_until(shard_map, timeout=30)
        (rebuilt_on,) = now[lose]
        rec["rebuilt_on"] = names[rebuilt_on]
        d = servers[int(names[rebuilt_on][1:])].store.locations[0].directory
        assert _sha_file(os.path.join(d, f"sc_{vid}.ec{lose:02d}")) == \
            shas[lose]
        # one line a server, in the master's order of its servers
        rec["scrub_lines"] = sorted(shell("volume.ec.scrub"))
        rec["degraded_lines"] = sorted(shell("volume.ec.degraded"))
        rec["repairs_lines"] = shell("cluster.repairs")
        rec["devices_lines"] = shell("cluster.devices")
    finally:
        master.stop()
        for vs in servers:
            vs.stop()
    return rec


@pytest.fixture
def torch_one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cluster_scrub_detect_repair_matches_jax(tmp_path, monkeypatch,
                                                 torch_one_thread):
    seed_jax(monkeypatch, SEED)
    ref = integrity_flow("ref", tmp_path, monkeypatch)
    port = integrity_flow("port", tmp_path, monkeypatch)
    devices = port.pop("devices_lines")
    ref.pop("devices_lines")
    for key in ref:
        assert port[key] == ref[key], key
    assert devices[0] == "cluster.devices: 3 nodes"
    assert all(re.match(r"  S\d  platform=cpu  devices=cpux1  compiles=\d+ "
                        r"recompiles=0  const_cache=\d+/\d+B$", ln)
               for ln in devices[1:])


# -- naive degraded reads ------------------------------------------------------

def _ec_volume_dir(root):
    """A directory with an EC volume 1 (collection "") of seeded needles,
    encoded by a port server on the CPU; returns (dir, {fid: data})."""
    from seaweedfs_tpu_torch.server.http_util import post_json
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.client.operation import upload
    d = str(root / "ec")
    os.makedirs(d)
    vs = VolumeServer(port=0, directories=[d], device="cpu").start()
    rng = np.random.default_rng(3)
    payloads = {}
    try:
        post_json(f"http://{vs.url}/admin/assign_volume?volume=1")
        for i in range(12):
            data = rng.integers(0, 256, int(rng.integers(2000, 90_000)),
                                dtype=np.uint8).tobytes()
            fid = f"1,{i + 1:x}{0x1234abcd + i:08x}"
            upload(vs.url, fid, data, f"n{i}")
            payloads[fid] = data
        post_json(f"http://{vs.url}/admin/volume/readonly?volume=1")
        post_json(f"http://{vs.url}/admin/ec/generate?volume=1")
        post_json(f"http://{vs.url}/admin/delete_volume?volume=1")
    finally:
        vs.stop()
    return d, payloads


def test_naive_degraded_reads_match_batch_and_jax(tmp_path,
                                                  torch_one_thread):
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
    from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K1
    from seaweedfs_tpu_torch.server.http_util import http_call
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    src, payloads = _ec_volume_dir(tmp_path)
    lost = 0
    with open(os.path.join(src, f"1.ec{lost:02d}"), "rb") as f:
        truth = f.read()
    os.remove(os.path.join(src, f"1.ec{lost:02d}"))
    dirs = {}
    for name in ("naive", "batch", "ref"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(src, dirs[name])
    naive = VolumeServer(port=0, directories=[dirs["naive"]], device="cpu",
                         degraded_mode="naive").start()
    batch = VolumeServer(port=0, directories=[dirs["batch"]],
                         device="cpu").start()
    ref = RefVS(port=0, directories=[dirs["ref"]],
                master_url="127.0.0.1:1", ec_backend="numpy",
                fast_port=-1).start()
    try:
        ranges = [(0, 1), (100, 4093), (len(truth) - 700, 700),
                  (65_536, 131_072), (len(truth) - 10, 30)]
        for off, size in ranges:
            want = truth[off:off + size].ljust(size, b"\0")
            before = DEVICE_STATS.snapshot()["dispatches"].get(K1, 0)
            got = naive._reconstruct_shard_range(1, lost, off, size)
            # one (1,k) call
            assert DEVICE_STATS.snapshot()["dispatches"][K1] == before + 1
            assert got == want
            assert ref._reconstruct_shard_range_naive(1, lost, off, size) \
                == want
            assert batch._reconstruct_shard_range(1, lost, off, size) == \
                want
        # needles through the lost shard, over HTTP
        for fid, data in payloads.items():
            assert http_call("GET", f"http://{naive.url}/{fid}") == data
        assert naive.degraded.snapshot()["reads"] == 0  # never the engine
        with pytest.raises(ValueError):
            VolumeServer(port=0, directories=[dirs["naive"]], device="cpu",
                         degraded_mode="fast")
    finally:
        for vs in (naive, batch, ref):
            vs.stop()


# -- the heartbeat ----------------------------------------------------------------

class _StallingMaster:
    """A master whose heartbeat answers are held on request: posts are
    numbered from 1, and each number in ``hold`` waits until released.
    Every answer is the port master's ``{"volume_size_limit", "leader"}``,
    or, with ``forward``, the answer of that master to the same post
    (sent once the hold is released), its leader hint this stub."""

    def __init__(self, hold, forward=None):
        from seaweedfs_tpu_torch.server.http_util import post_json
        self.hold = {n: threading.Event() for n in hold}
        self.posts = []
        self.answered = []
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])) or b"{}")
                master.posts.append(body)
                n = len(master.posts)
                if n in master.hold:
                    master.hold[n].wait(30)
                if forward:
                    reply = post_json(f"http://{forward}{self.path}", body,
                                      timeout=10)
                    if "leader" in reply:   # the server stays behind us
                        reply["leader"] = master.url
                else:
                    reply = {"volume_size_limit": 1 << 30,
                             "leader": master.url}
                out = json.dumps(reply).encode()
                master.answered.append(n)   # before the client can see it
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        for ev in self.hold.values():
            ev.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def test_heartbeat_post_never_blocks_admin_routes(tmp_path):
    from seaweedfs_tpu_torch.server.http_util import post_json
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    # post 1: start(); 2: a loop pulse, held; 3: the route's; 4+: held
    master = _StallingMaster(hold=[2] + list(range(4, 40)))
    vs = VolumeServer(port=0, directories=[str(tmp_path)], device="cpu",
                      master_url=master.url, pulse_seconds=3600)
    try:
        vs.start()
        assert master.answered == [1]
        vs._hb_wake.set()    # the loop collects and posts: held
        assert wait_until(lambda: len(master.posts) == 2)
        t0 = time.monotonic()
        assert post_json(f"http://{vs.url}/admin/assign_volume?volume=9",
                         timeout=10) == {"volume": 9}
        assert time.monotonic() - t0 < 5
        assert master.answered == [1, 3]   # the loop's post still open
        assert 9 in vs._hb_acked_volumes and vs._hb_acked_seq == 3
        master.hold[2].set()               # the late answer of collect 2
        # the loop goes on to its next collect (post 4, held) only after
        # it has handled post 2's answer
        assert wait_until(lambda: len(master.posts) >= 4)
        assert 2 in master.answered
        assert 9 in vs._hb_acked_volumes and vs._hb_acked_seq == 3
        # collect 2, when its post went out, was a delta without volume 9
        assert master.posts[1].get("delta") and not master.posts[1][
            "new_volumes"]
        assert [v["id"] for v in master.posts[2]["new_volumes"]] == [9]
    finally:
        master.stop()
        vs._stop.set()
        vs._hb_wake.set()
        vs.server.stop()
        vs.store.close()


def test_late_heartbeat_leaves_no_ghost_volume(tmp_path):
    """A route's collect that reaches the master after a later collect
    is dropped there: else its volume, deleted since, would come back
    and no later delta (against the newer ack) would delete it again."""
    from seaweedfs_tpu_torch.server.http_util import post_json
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    real = MasterServer(port=0, repair_interval=0).start()
    # post 1: start(); 2: assign_volume's, held; 3: delete_volume's
    proxy = _StallingMaster(hold=[2], forward=real.url)
    vs = VolumeServer(port=0, directories=[str(tmp_path)], device="cpu",
                      master_url=proxy.url, pulse_seconds=3600)
    assigned = {}
    try:
        vs.start()
        vs.store.on_change = lambda: None   # only the routes heartbeat
        assert proxy.answered == [1]
        t = threading.Thread(target=lambda: assigned.update(post_json(
            f"http://{vs.url}/admin/assign_volume?volume=9", timeout=20)))
        t.start()
        assert wait_until(lambda: len(proxy.posts) == 2)
        assert [v["id"] for v in proxy.posts[1]["new_volumes"]] == [9]
        assert post_json(f"http://{vs.url}/admin/delete_volume?volume=9",
                         timeout=10) == {"deleted": 9}
        assert proxy.answered == [1, 3]
        assert vs._hb_acked_seq == 3 and 9 not in vs._hb_acked_volumes
        proxy.hold[2].set()                  # collect 2 arrives late
        t.join(20)
        assert assigned == {"volume": 9} and proxy.answered == [1, 3, 2]
        assert real.topology.lookup("", 9) is None
        assert vs._hb_acked_seq == 3
        vs.heartbeat_once()                  # a delta against ack 3
        assert proxy.posts[3]["delta"] and not proxy.posts[3][
            "deleted_volumes"]
        assert real.topology.lookup("", 9) is None
        assert [n.url for n in real.topology.all_nodes()] == [vs.url]
    finally:
        proxy.stop()
        vs._stop.set()
        vs._hb_wake.set()
        vs.server.stop()
        vs.store.close()
        real.stop()
