"""The port's fleet plane (``stats/aggregate``, the health fold, the
master's at-risk scan, the shell's ``cluster.health``, ``cluster.profile``
and ``trace.export``) against the JAX package's, and a port cluster's
traces and metrics end to end.

- Both packages' ``ClusterMetricsAggregator``s, fed one set of canned
  node texts through ``fetch=`` (one node's scrape failing): equal merged
  renders and equal ``holder_health`` folds.
- A JAX and a port master given one canned health fold after another
  open and resolve the same ``at_risk_holder`` incidents (the 0.1
  hysteresis included); the queue snapshots equal, clocks fixed.
- ``cluster.health`` lines of both shells on the same replies.
- A port cluster (master and three servers on the CPU, the
  ``test_torch_cluster.Cluster`` helpers): ``ec.encode`` and
  ``ec.rebuild`` through the port shell. The rebuild is one trace: its
  id (the rebuilder's ``/admin/ec/rebuild`` answer) names spans of the
  shell, the master, the rebuilder and a peer, and ``trace.export``
  merges them with no negative time. ``/admin/ec/generate``,
  ``/admin/ec/rebuild`` and ``/admin/ec/scrub_repair`` answer a
  ``trace_id``; ``/cluster/metrics?refresh=1`` carries per-node sums of
  the K1 dispatch series and ``/cluster/health?refresh=1`` every server
  fresh; ``POST /admin/profile?seconds=bogus`` answers 400 and a second
  profile while one runs 409; ``cluster.profile`` gathers stacks from
  every node it names.
- The observability routes of a JAX and a port master and volume server
  (no volumes): equal statuses and JSON (the health fold, the merged
  exposition, a trace's spans and export, the profile's refusals), the
  same reply shapes (the ring, memory, disk) and the same families on
  both ``/metrics``.

No test waits across a pulse: each polls. Tolerances: none."""

import io
import json
import threading

import pytest

from conftest import wait_until
from test_torch_cluster import Cluster, torch_one_thread  # noqa: F401
from test_torch_integrity import (FakeClock, _CannedEnv, _masters,
                                  _own_url_out)


def _node_text(m, node, scale):
    """One node's exposition from a fresh registry of ``m``."""
    reg = m.Registry()
    c = reg.counter("SeaweedFS_volumeServer_request_total", "Requests.",
                    labels=("type",))
    c.inc("GET data", amount=3 * scale)
    c.inc("POST /admin/ec/rebuild", amount=scale)
    h = reg.histogram("SeaweedFS_volumeServer_request_seconds", "Seconds.",
                      labels=("type",), buckets=(0.01, 0.1, 1.0))
    h.observe(0.05 * scale, "GET data", trace_id=f"{scale:032x}")
    h.observe(0.005, "GET data")
    g = reg.gauge("SeaweedFS_volumeServer_ec_gather_mbps", "MB/s.")
    g.set(100.5 * scale)
    hh = reg.gauge("SeaweedFS_volumeServer_ec_holder_health", "Score.",
                   labels=("holder",))
    hl = reg.gauge("SeaweedFS_volumeServer_ec_holder_latency_ewma_ms",
                   "EWMA.", labels=("holder", "kind"))
    he = reg.counter("SeaweedFS_volumeServer_ec_holder_events_total",
                     "Events.", labels=("holder", "event"))
    for holder, score in (("h:1", 0.9 / scale), ("h:2", 0.35 * scale)):
        hh.set(score, holder)
        hl.set(20.0 * scale, holder, "shard_read")
        he.set_total(7 * scale, holder, "reads")
    he.set_total(scale, "h:1", "errors")
    return reg.render()


def test_aggregators_merge_like_jax(monkeypatch):
    import time
    import seaweedfs_tpu.stats.aggregate as ref
    import seaweedfs_tpu_torch.stats.aggregate as port
    from seaweedfs_tpu_torch.stats import metrics
    # the exemplars' stamps
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    texts = {"a:1": _node_text(metrics, "a:1", 1),
             "b:2": _node_text(metrics, "b:2", 2)}

    def fetch(url):
        if url not in texts:
            raise ConnectionError(f"{url} refused")
        return texts[url]

    nodes = ["a:1", "b:2", "c:3"]
    views = []
    for mod in (ref, port):
        agg = mod.ClusterMetricsAggregator(lambda: nodes, interval_s=60,
                                           fetch=fetch)
        assert agg.scrape_once() == 2
        views.append((agg.render(), agg.holder_health(),
                      agg.node_status()))
    assert views[0] == views[1]
    render, health, status = views[1]
    assert 'cluster_node_up{node="c:3"} 0' in render
    assert 'SeaweedFS_volumeServer_request_total{type="GET data"} 9' \
        in render
    assert health["holders"]["h:1"]["score"] == 0.45
    assert health["holders"]["h:2"]["events"] == {"reads": 21.0}
    assert status[2]["last_error"] == "ConnectionError: c:3 refused"
    assert port.CLUSTER_SCRAPE_S == ref.DEFAULT_SCRAPE_S == 15.0


FOLDS = [
    {"h:1": 0.2, "h:2": 0.9},
    {"h:1": 0.45, "h:2": 0.35},      # inside the hysteresis band: open
    {"h:1": 0.55, "h:2": 0.3},       # h:1 recovered
    {"h:2": 0.41},
    {"h:2": 0.51, "h:3": 0.05},
]


def test_at_risk_incidents_match_jax(monkeypatch):
    from seaweedfs_tpu.stats import repair_queue as ref_q
    from seaweedfs_tpu_torch.stats import repair_queue as port_q
    clock = FakeClock()
    monkeypatch.setattr(ref_q, "time", clock)
    monkeypatch.setattr(port_q, "time", clock)
    ref, port = _masters(monkeypatch)
    try:
        for fold in FOLDS:
            got = []
            for m in (ref, port):
                m.cluster_agg.holder_health = lambda fold=fold: {
                    "holders": {h: {"score": s} for h, s in fold.items()},
                    "nodes": []}
                m._repair_scan()
                got.append(_own_url_out(m.repair_queue.snapshot(), m.url))
            assert got[0] == got[1]
            clock.t += 1
        snap = got[1]
        assert sorted(i["holder"] for i in snap["open"]) == ["h:3"]
        assert [(i["holder"], i["via"]) for i in snap["resolved_recent"]] \
            == [("h:1", "recovered"), ("h:2", "recovered")]
        assert port.at_risk_score == ref.at_risk_score == 0.4
    finally:
        ref.stop()
        port.stop()


def test_cluster_health_lines_match_jax():
    from seaweedfs_tpu.shell import command_cluster as ref_cluster
    from seaweedfs_tpu.shell.command_env import CommandEnv as RefEnv
    from seaweedfs_tpu_torch.shell import CommandEnv, command_cluster
    view = {"holders": {
        "h:1": {"score": 0.8123, "observers": {"a:1": 0.8123},
                "latency_ewma_ms": {"shard_read": 12.25,
                                    "degraded_read": 3.0},
                "events": {"reads": 40.0, "errors": 1.0}},
        "h:2": {"score": 0.31, "observers": {},
                "latency_ewma_ms": {}, "events": {"hedges_lost": 2.0}}},
        "nodes": [{"node": "a:1", "stale": False, "last_error": ""},
                  {"node": "b:2", "stale": True,
                   "last_error": "HttpError: refused"},
                  {"node": "c:3", "stale": True, "last_error": ""}],
        "repairs": {"open": 0}}
    replies = {"/cluster/health?refresh=1": view, "/cluster/health": view}
    lines = []
    for env_cls, mod in ((RefEnv, ref_cluster), (CommandEnv,
                                                 command_cluster)):
        got = []
        for args in ([], ["-refresh", "false"]):
            canned = _CannedEnv(env_cls, replies)
            mod.cluster_health(canned.env, args)
            got.append(canned.env.out.getvalue())
        lines.append(got)
    assert lines[0] == lines[1]
    assert lines[1][0].splitlines()[:2] == [
        "cluster.health: 2 holders scored by 1/3 fresh nodes",
        "  node b:2  STALE (HttpError: refused)"]


class _Recording:
    """A port ``CommandEnv`` whose node_post answers are kept."""

    def __init__(self, c):
        self.env = c.CommandEnv(c.master.url, out=io.StringIO())
        self.replies = []
        post = self.env.node_post

        def node_post(node, path, *a, **k):
            out = post(node, path, *a, **k)
            self.replies.append((node, path.split("?")[0], out))
            return out
        self.env.node_post = node_post

    def run(self, line):
        self.env.out = io.StringIO()
        from seaweedfs_tpu_torch.shell import run_command
        run_command(self.env, line)
        return self.env.out.getvalue()

    def answer(self, path):
        return [out for _, p, out in self.replies if p == path]


def _k1_series(text):
    from seaweedfs_tpu_torch.stats.metrics import parse_prometheus_text
    for fam in parse_prometheus_text(text):
        if fam["name"] == "SeaweedFS_volumeServer_ec_xla_dispatches_total":
            for _, labels, value in fam["samples"]:
                if dict(labels).get("entry") == "rs_hopper.gf_matmul":
                    return value
    return 0.0


def test_port_cluster_traces_and_metrics(tmp_path, torch_one_thread):
    import numpy as np
    from seaweedfs_tpu_torch.server.http_util import (HttpError, get_json,
                                                      http_call, post_json)
    from seaweedfs_tpu_torch.util import tracing
    c = Cluster("port", tmp_path)
    try:
        murl = c.master.url
        rng = np.random.default_rng(11)
        fids = [c.op.upload_data(murl, rng.bytes(9_000 + 300 * i),
                                 filename=f"o{i}", collection="obs")
                for i in range(10)]
        by_vid = {}
        for fid in fids:
            by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
        vid = max(sorted(by_vid), key=lambda v: len(by_vid[v]))
        shell = _Recording(c)
        assert "ec encoded" in shell.run(f"ec.encode -volumeId {vid}")
        (gen,) = shell.answer("/admin/ec/generate")
        assert tracing.parse_traceparent(f"00-{gen['trace_id']}-"
                                         f"{'1' * 16}-01")

        # two shards lost on the first server, rebuilt through the shell
        victim = c.servers[0]
        lost = victim.store.find_ec_volume(vid).shard_ids()[:2]
        post_json(f"http://{victim.url}/admin/ec/delete_shards?volume="
                  f"{vid}&collection=obs&shards="
                  f"{','.join(map(str, lost))}")
        assert wait_until(lambda: all(
            str(s) not in c.ec_volumes()[str(vid)]["shards"]
            for s in lost))
        out = shell.run("ec.rebuild")
        assert f"rebuilt shards {sorted(lost)}" in out
        (node, _, reb) = next(r for r in shell.replies
                              if r[1] == "/admin/ec/rebuild")
        tid = reb["trace_id"]
        spans = tracing.RING.get(tid)
        by_node = {}
        for s in spans:
            by_node.setdefault(s["tags"].get("node"), []).append(s["name"])
        roots = [s for s in spans if not s["parent_id"]]
        assert [s["name"] for s in roots] == ["ec.rebuild"]
        assert "POST /admin/ec/rebuild" in by_node[node]
        assert any(n.startswith("* /cluster/") for n in by_node[murl])
        peers = [u for u in by_node if u not in (None, murl, node)]
        assert peers and all(
            any("/admin/ec/shard_" in n for n in by_node[p]) for p in peers)
        names = {s["name"] for s in spans}
        assert {"dispatch", "gather.stripe", "ec.rebuild.stream"} <= names

        # the merged export: every node's part under the one id
        dest = str(tmp_path / "trace.json")
        out = shell.run(f"trace.export -trace {tid} -o {dest}")
        assert out.startswith(f"trace.export: {len(spans)} spans from ")
        with open(dest) as f:
            merged = json.load(f)
        assert set(merged["metadata"]["nodes"]) >= \
            {"client", murl, node, peers[0]}
        events = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
        assert len(events) == len(spans)
        assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in events)

        # a scrub repair answers its trace too
        sid = c.servers[1].store.find_ec_volume(vid).shard_ids()[0]
        rep = post_json(f"http://{c.servers[1].url}/admin/ec/scrub_repair"
                        f"?volume={vid}&shard={sid}&collection=obs", {})
        assert rep["rebuilt"] == [sid] and len(rep["trace_id"]) == 32
        assert tracing.RING.get(rep["trace_id"])

        # the fleet scrape: the merged K1 series is the per-node sum
        per_node = [_k1_series(http_call("GET", f"http://{vs.url}/metrics")
                               .decode()) for vs in c.servers]
        assert per_node[0] > 0
        merged_text = http_call(
            "GET", f"http://{murl}/cluster/metrics?refresh=1").decode()
        assert _k1_series(merged_text) == sum(per_node)
        health = get_json(f"http://{murl}/cluster/health?refresh=1")
        assert sorted(n["node"] for n in health["nodes"]
                      if not n["stale"]) == sorted(vs.url
                                                   for vs in c.servers)
        assert health["repairs"]["open"] == 0
        assert get_json(f"http://{murl}/stats/health") == \
            {"ok": True, "leader": True}
        assert "SeaweedFS_master_request_total" in http_call(
            "GET", f"http://{murl}/metrics").decode()

        # profiles: a bad window, then one while another runs
        with pytest.raises(HttpError) as e:
            http_call("POST", f"http://{c.servers[0].url}/admin/profile"
                              f"?seconds=bogus")
        assert e.value.status == 400
        first = {}
        t = threading.Thread(target=lambda: first.setdefault(
            "out", http_call("POST", f"http://{c.servers[0].url}"
                                     f"/admin/profile?seconds=1.0")))
        t.start()
        try:
            # one process, one profile at a time: once the first sampler
            # runs, a second server of the process answers 409
            assert wait_until(lambda: any(
                th.name == "sampling-profiler"
                for th in threading.enumerate()))
            with pytest.raises(HttpError) as e:
                http_call("POST", f"http://{c.servers[1].url}"
                                  f"/admin/profile?seconds=0.1")
            assert e.value.status == 409
        finally:
            t.join()
        stacks = first["out"].decode().splitlines()
        assert stacks and all(ln.rsplit(" ", 1)[1].isdigit()
                              for ln in stacks)
        dest = str(tmp_path / "prof.folded")
        out = shell.run(f"cluster.profile -seconds 0.05 -o {dest}")
        assert out.strip().endswith(f"from 4/4 nodes over 0.05s -> {dest}")
    finally:
        c.stop()


def _families(text):
    """(name, kind) of each family of an exposition but the ones the port
    leaves out (which series a family holds depends on what ran in the
    process before)."""
    from seaweedfs_tpu_torch.stats.metrics import parse_prometheus_text
    from test_torch_metrics import LEFT_OUT
    return sorted((fam["name"], fam["kind"])
                  for fam in parse_prometheus_text(text)
                  if not fam["name"].startswith(LEFT_OUT))


def test_observability_routes_answer_like_jax(tmp_path, monkeypatch):
    """The same requests to a JAX and a port master and volume server
    (no volumes, the servers' master a closed port): equal statuses and
    JSON, and the expositions the same families."""
    import http.client
    from seaweedfs_tpu.server.master import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import \
        VolumeServer as RefVolumeServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    monkeypatch.setenv("SW_REPAIR_INTERVAL_S", "0")
    dirs = (str(tmp_path / "ref"), str(tmp_path / "port"))
    servers = [
        (RefMaster(port=0, pulse_seconds=60, vacuum_interval=0).start(),
         RefVolumeServer(port=0, directories=[dirs[0]],
                         master_url="127.0.0.1:1", ec_backend="numpy",
                         fast_port=-1).start()),
        (MasterServer(port=0, pulse_seconds=60, seed=1,
                      repair_interval=0).start(),
         VolumeServer(port=0, directories=[dirs[1]], device="cpu",
                      master_url="127.0.0.1:1", fast_port=-1).start())]

    def call(url, method, path):
        host, p = url.split(":")
        conn = http.client.HTTPConnection(host, int(p), timeout=60)
        try:
            conn.request(method, path)
            resp = conn.getresponse()
            data = resp.read()
            ctype = resp.getheader("Content-Type")
        finally:
            conn.close()
        if ctype == "application/json":
            data = json.loads(data)
        return resp.status, ctype, data

    try:
        for route in ("GET /cluster/health?refresh=1", "GET /stats/health",
                      "GET /cluster/metrics?refresh=1",
                      f"GET /admin/traces?trace={'ab' * 16}",
                      f"GET /admin/traces/export?trace={'ab' * 16}",
                      "GET /admin/traces/export",
                      "POST /admin/profile?seconds=bogus",
                      "POST /admin/profile?seconds=0"):
            method, path = route.split(" ")
            got = [call(m.url, method, path) for m, _ in servers]
            assert got[0] == got[1], route
        for i, path in enumerate(("/admin/traces?n=3", "/stats/memory",
                                  "/stats/disk")):
            got = [call(vs.url, "GET", path) for _, vs in servers]
            assert got[0][:2] == got[1][:2] == (200, "application/json")
            if i == 2:
                assert [d["dir"] for d in got[1][2]["DiskStatuses"]] == \
                    [dirs[1]]
                assert got[0][2]["DiskStatuses"][0].keys() == \
                    got[1][2]["DiskStatuses"][0].keys()
            else:
                assert got[0][2].keys() == got[1][2].keys()
        for pick in (0, 1):
            texts = [call(pair[pick].url, "GET", "/metrics")
                     for pair in servers]
            assert texts[0][:2] == texts[1][:2] == \
                (200, "text/plain; version=0.0.4")
            assert _families(texts[0][2].decode()) == \
                _families(texts[1][2].decode())
        prof = [call(vs.url, "POST", "/admin/profile?seconds=0.05")
                for _, vs in servers]
        assert [p[:2] for p in prof] == [(200, "text/plain; charset=utf-8")
                                         ] * 2
    finally:
        for m, vs in servers:
            vs.stop()
            m.stop()
