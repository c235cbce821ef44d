"""The port's raft, its sequencer and its HA master against the JAX
package's.

* Replay: a seeded script of ``request_vote`` / ``append_entries`` /
  ``install_snapshot`` payloads (leaders of rising terms, forked logs,
  stale terms, windows past the end, snapshots, a commit index that
  moves) is fed to a JAX ``RaftNode`` and a port one, neither started,
  both compacting past 5 entries. After every message their replies,
  terms, votes, logs, commit and apply points, applied commands and the
  persisted ``raft-<id>.json`` bytes must be equal.
* ``RaftSequencer``: both packages' under one seeded run of local grants,
  foreign ceilings, a foreign ceiling committed ahead of a local
  proposal, and heartbeat maxima; every key, proposal and ceiling equal.
* A mixed group: two JAX nodes and a port node on the JAX tests'
  in-process ``Net``, the leader cut off by a seeded schedule; every
  acknowledged entry applied once, in order, on all three, and the three
  applied logs equal once healed.
* The port alone: failover with log continuity, persistence across a
  restart, compaction with a lagging follower caught up by
  InstallSnapshot.
* An HA port cluster over HTTP: three port masters (write JWTs, the
  whitelist, the vacuum, repair and maintenance loops every 0.2 s) and
  two port volume servers given the leader as the first seed. Assign,
  ``/submit``, the ``GET /<fid>`` redirect and a 001 write go through a
  follower; the leader is stopped; file keys and volume ids issued after
  are above all issued before; a vid map polling a follower recovers,
  the servers' own maps (bound to the dead first seed) answer None and a
  001 write still lands on both replicas; every loop acted only while
  its master led.
* Follower replies against a JAX master in the same role: a follower's
  heartbeat answer, 301, forwarded answers and errors, the forwarding
  loop's 503 and ``/cluster/status`` (urls named by role), a leaderless
  master's 503s, and an assign that loses the leadership or times out.

No test assumes that an election ends within a fixed time: each polls
for one leader with a deadline of 20 s, looking again on every poll.
Tolerances: none (equal)."""

import http.client
import json
import os
import socket
import time

import numpy as np
import pytest

from conftest import wait_until
from test_raft import Net
from seaweedfs_tpu.topology import raft as ref_raft
from seaweedfs_tpu.topology.topology import RaftSequencer as RefSequencer
from seaweedfs_tpu_torch.topology import raft as port_raft
from seaweedfs_tpu_torch.topology.topology import \
    RaftSequencer as PortSequencer

ELECTION_S = 20.0   # the bound on every wait for a leader


def _no_transport(*_):
    raise OSError("no network in a replay")


# -- replay ------------------------------------------------------------------

def replay_script(seed, steps=160):
    """RPC payloads from a seeded history of leaders, as a generator that
    is sent each reply (the JAX node's): each term's leader ships its log
    from the follower's next index (stepping back on a refusal, with a
    wrong index or term now and then), forks the uncommitted tail when a
    new term starts, ships a snapshot of its committed prefix, and
    candidates ask for votes with logs ahead or behind."""
    rng = np.random.default_rng(seed)
    truth = []       # the current leader's log
    term, value, commit, nxt = 1, 0, 0, 1
    for _ in range(steps):
        r = rng.random()
        if r < 0.08:
            term += int(rng.integers(1, 3))
            if len(truth) > commit and rng.random() < 0.5:
                truth = truth[:int(rng.integers(commit, len(truth) + 1))]
            nxt = len(truth) + 1
        if r < 0.4 or not truth:
            for _ in range(int(rng.integers(1, 4))):
                value += 1
                truth.append({"term": term, "command": {
                    "type": "max_volume_id", "value": value}})
        kind = ("append",) * 9 + ("vote",) * 2 + ("snap",)
        kind = kind[int(rng.integers(0, len(kind)))]
        if kind == "append":
            prev = min(nxt - 1, len(truth))
            if rng.random() < 0.08:
                prev = len(truth) + int(rng.integers(1, 3))
            prev_term = truth[prev - 1]["term"] if 0 < prev <= len(truth) \
                else 0
            if rng.random() < 0.05:
                prev_term += 1
            entries = [json.loads(json.dumps(e))
                       for e in truth[prev:prev + int(rng.integers(0, 4))]]
            msg_term = term - int(rng.random() < 0.05)
            commit = min(len(truth), max(commit, int(rng.integers(
                0, prev + len(entries) + 1))))
            reply = yield ("append_entries", {
                "term": msg_term, "leader_id": f"leader-{msg_term}",
                "prev_log_index": prev, "prev_log_term": prev_term,
                "entries": entries, "leader_commit": commit})
            if isinstance(reply, dict) and reply.get("success"):
                nxt = prev + len(entries) + 1
            else:
                nxt = max(1, nxt - 1)
        elif kind == "vote":
            vterm = term + int(rng.integers(-1, 2))
            li = int(rng.integers(max(0, len(truth) - 3), len(truth) + 2))
            lt = truth[li - 1]["term"] if 0 < li <= len(truth) \
                else int(rng.integers(0, term + 1))
            yield ("request_vote", {
                "term": vterm, "candidate_id": f"cand-{rng.integers(0, 3)}",
                "last_log_index": li, "last_log_term": lt})
            term = max(term, vterm)
        elif commit:
            si = int(rng.integers(1, commit + 1))
            st = truth[si - 1]["term"] + int(rng.random() < 0.15)
            yield ("install_snapshot", {
                "term": term, "leader_id": f"leader-{term}",
                "snap_index": si, "snap_term": st,
                "state": {"max": max(e["command"]["value"]
                                     for e in truth[:si])}})


class _Machine:
    """The state machine both nodes drive: a max and the applied list."""

    def __init__(self):
        self.applied = []
        self.max = 0

    def apply(self, cmd):
        self.applied.append(cmd)
        self.max = max(self.max, cmd["value"])

    def snapshot(self):
        return {"max": self.max}

    def restore(self, st):
        self.max = max(self.max, st.get("max", 0))


def _node_state(node):
    return {"term": node.current_term, "voted_for": node.voted_for,
            "state": node.state, "leader": node.leader_id,
            "log": node.log, "snap_index": node.snap_index,
            "snap_term": node.snap_term, "snap_state": node.snap_state,
            "commit_index": node.commit_index,
            "last_applied": node.last_applied}


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_replay_matches_jax(tmp_path, seed):
    nodes, machines, dirs = [], [], []
    for mod, name in ((ref_raft, "ref"), (port_raft, "port")):
        m = _Machine()
        d = str(tmp_path / name)
        nodes.append(mod.RaftNode(
            "n0", ["n0", "n1", "n2"], m.apply, state_dir=d,
            transport=_no_transport, snapshot_state_fn=m.snapshot,
            restore_fn=m.restore, max_log_entries=5))
        machines.append(m)
        dirs.append(d)
    seen = {"reject": 0, "grant": 0, "snap": 0}
    script = replay_script(seed)
    reply = None
    while True:
        try:
            rpc, payload = script.send(reply)
        except StopIteration:
            break
        replies = []
        for node in nodes:
            try:
                replies.append(getattr(node, f"handle_{rpc}")(
                    json.loads(json.dumps(payload))))
            except Exception as e:  # noqa: BLE001 - compared, not hidden
                replies.append(repr(e))
        assert replies[1] == replies[0], (rpc, payload)
        assert _node_state(nodes[1]) == _node_state(nodes[0]), rpc
        assert machines[1].applied == machines[0].applied
        files = [open(os.path.join(d, "raft-n0.json"), "rb").read()
                 for d in dirs]
        assert files[1] == files[0]
        reply = replies[0]
        got = reply if isinstance(reply, dict) else {}
        seen["reject"] += got.get("success") is False
        seen["grant"] += bool(got.get("vote_granted"))
    seen["snap"] = nodes[1].snap_index
    # the script reached every branch worth comparing
    assert seen["reject"] and seen["grant"] and seen["snap"], seen
    assert len(machines[1].applied) >= 10


# -- the sequencer ------------------------------------------------------------

def sequencer_script(seed, n=80):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            ops.append(("next", int(rng.integers(1, 40))))
        elif r < 0.7:
            ops.append(("foreign", int(rng.integers(0, 200))))
        elif r < 0.88:
            ops.append(("race", int(rng.integers(1, 40)),
                        int(rng.integers(1, 200))))
        else:
            ops.append(("set_max", int(rng.integers(0, 100))))
    return ops


def _run_sequencer(cls, script):
    """Every key, every proposal's value and the ceiling after each op."""
    pending = []
    proposals = []

    def propose(cmd):
        proposals.append(cmd["value"])
        # a foreign ceiling committed ahead of this proposal applies first
        while pending:
            seq.apply_ceiling(seq.ceiling() + pending.pop())
        seq.apply_ceiling(cmd["value"], cmd.get("nonce"))

    seq = cls(propose, block=64)
    trace = []
    for op in script:
        if op[0] == "next":
            got = seq.next_file_id(op[1])
        elif op[0] == "foreign":
            seq.apply_ceiling(seq.ceiling() + op[1])
            got = None
        elif op[0] == "race":
            pending.append(op[2])
            got = seq.next_file_id(op[1])
        else:
            seq.set_max(seq.ceiling() + op[1])
            got = None
        trace.append((got, seq.ceiling(), list(proposals)))
    return trace


@pytest.mark.parametrize("seed", [7, 8])
def test_raft_sequencer_matches_jax(seed):
    script = sequencer_script(seed)
    ref = _run_sequencer(RefSequencer, script)
    port = _run_sequencer(PortSequencer, script)
    assert port == ref
    # every grant is its own: no key handed out twice
    issued = []
    for op, (got, _, _) in zip(script, port):
        if got is not None:
            issued += range(got, got + op[1])
    assert len(issued) == len(set(issued))


def test_raft_sequencer_grant_base_is_decided_at_apply_time():
    """A fresh leader's first proposal, with the dead leader's ceiling
    committed ahead of it: the grant is computed against that ceiling."""
    calls = []

    def propose(cmd):
        calls.append(cmd["value"])
        if len(calls) == 1:
            seq.apply_ceiling(10000)
        seq.apply_ceiling(cmd["value"], cmd.get("nonce"))

    seq = PortSequencer(propose, block=10000)
    assert seq.next_file_id() == 10001
    assert calls == [10000, 20000]


# -- a mixed JAX / port group -------------------------------------------------

def single_leader(net, timeout=ELECTION_S):
    """The one leader among the nodes not cut off, looked for again on
    every poll; AssertionError past ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [n for i, n in net.nodes.items()
                   if n.state == ref_raft.LEADER and i not in net.down]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no single leader")


def _stop(net):
    for n in net.nodes.values():
        n.stop()


def propose_on_leader(net, command, timeout=3 * ELECTION_S):
    """Propose ``command`` on whichever node leads until one commits it;
    AssertionError past ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return single_leader(net).propose(command, timeout=5.0)
        except (ref_raft.NotLeaderError, port_raft.NotLeaderError,
                TimeoutError):
            if time.monotonic() > deadline:
                raise AssertionError(f"{command} never committed")


@pytest.mark.parametrize("seed", [21, 22])
def test_mixed_group_commits_one_log(seed):
    net = Net()
    ids = ["jax-0", "jax-1", "port-0"]
    applied = {i: [] for i in ids}
    for i in ids:
        mod = port_raft if i.startswith("port") else ref_raft
        net.nodes[i] = mod.RaftNode(i, ids, applied[i].append,
                                    transport=net.transport_for(i))
    for n in net.nodes.values():
        n.start()
    rng = np.random.default_rng(seed)
    acked, counter = [], 0
    try:
        for step in range(8):
            action = ("propose", "propose", "cut leader",
                      "heal")[int(rng.integers(0, 4))] if step else \
                "propose"
            if action == "cut leader":
                net.down = {single_leader(net).id}
                continue
            if action == "heal":
                net.down = set()
                continue
            counter += 1
            leader = single_leader(net)
            try:
                leader.propose({"value": counter}, timeout=3.0)
                acked.append(counter)
            except (ref_raft.NotLeaderError, port_raft.NotLeaderError,
                    TimeoutError):
                pass
        net.down = set()
        # a last entry of the final term commits everything before it
        propose_on_leader(net, {"value": 999})
        assert wait_until(lambda: all(
            log and log[-1]["value"] == 999 for log in applied.values()),
            timeout=ELECTION_S)
        logs = [[c["value"] for c in applied[i]] for i in ids]
        assert logs[0] == logs[1] == logs[2]
        assert [v for v in logs[0] if v in set(acked)] == acked
        assert len(set(logs[0])) == len(logs[0])
        assert acked
    finally:
        _stop(net)


# -- the port alone -----------------------------------------------------------

def _port_group(ids, state_dir=None, **kw):
    net = Net()
    applied = {i: [] for i in ids}
    for i in ids:
        net.nodes[i] = port_raft.RaftNode(
            i, ids, applied[i].append,
            state_dir=str(state_dir) if state_dir else None,
            transport=net.transport_for(i), **kw)
    return net, applied


def test_port_failover_log_continuity_and_restart(tmp_path):
    ids = ["p0", "p1", "p2"]
    net, applied = _port_group(ids, tmp_path)
    for n in net.nodes.values():
        n.start()
    try:
        propose_on_leader(net, {"value": 7})
        leader = single_leader(net)
        follower = next(n for n in net.nodes.values() if n is not leader)
        with pytest.raises(port_raft.NotLeaderError) as ei:
            follower.propose({"value": 0})
        assert ei.value.leader != follower.id
        net.down.add(leader.id)
        leader.stop()
        new = single_leader(net)
        assert new.id != leader.id
        propose_on_leader(net, {"value": 8})
        assert wait_until(lambda: all(
            [c["value"] for c in applied[i]] == [7, 8]
            for i in ids if i != leader.id), timeout=ELECTION_S)
        term = max(n.current_term for n in net.nodes.values())
    finally:
        _stop(net)
    # a node started again reloads its term and its log from disk
    again = port_raft.RaftNode(new.id, ids, lambda c: None,
                               state_dir=str(tmp_path),
                               transport=_no_transport)
    assert again.current_term >= term - 1
    assert [e["command"]["value"] for e in again.log] == [7, 8]


def test_port_compaction_and_snapshot_catch_up():
    ids = ["s0", "s1", "s2"]
    state = {i: {"max": 0} for i in ids}
    net = Net()
    for i in ids:
        net.nodes[i] = port_raft.RaftNode(
            i, ids,
            (lambda i=i: lambda cmd: state[i].__setitem__(
                "max", max(state[i]["max"], cmd["value"])))(),
            transport=net.transport_for(i),
            snapshot_state_fn=(lambda i=i: lambda: dict(state[i]))(),
            restore_fn=(lambda i=i: lambda st: state[i].__setitem__(
                "max", max(state[i]["max"], st.get("max", 0))))(),
            max_log_entries=10)
    for n in net.nodes.values():
        n.start()
    try:
        leader = single_leader(net)
        laggard = next(i for i in ids if i != leader.id)
        net.down.add(laggard)
        for v in range(1, 61):
            propose_on_leader(net, {"value": v})
        assert max(n.snap_index for n in net.nodes.values()) > 0
        assert all(len(n.log) <= 20 for i, n in net.nodes.items()
                   if i != laggard)
        net.down.discard(laggard)
        assert wait_until(lambda: state[laggard]["max"] == 60,
                          timeout=ELECTION_S)
        assert net.nodes[laggard].snap_index > 0
        propose_on_leader(net, {"value": 200})
        assert wait_until(lambda: all(s["max"] == 200
                                      for s in state.values()),
                          timeout=ELECTION_S)
    finally:
        _stop(net)


def test_same_node_and_reflected_heartbeat():
    assert port_raft.same_node("localhost:9333", "127.0.0.1:9333")
    assert not port_raft.same_node("localhost:9333", "127.0.0.1:9334")
    node = port_raft.RaftNode("localhost:9333",
                              ["127.0.0.1:9333", "127.0.0.1:9334"],
                              lambda c: None, transport=_no_transport)
    assert node.peers == ["127.0.0.1:9334"]
    node = port_raft.RaftNode("m0", [], lambda c: None,
                              transport=_no_transport)
    node.state, node.current_term = port_raft.LEADER, 3
    out = node.handle_append_entries(
        {"term": 3, "leader_id": "m0", "prev_log_index": 0,
         "prev_log_term": 0, "entries": [], "leader_commit": 0})
    assert out["success"] and node.state == port_raft.LEADER


# -- HA masters over HTTP -----------------------------------------------------

def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def http_leader(masters, timeout=ELECTION_S):
    """The one master of ``masters`` that leads, looked for again on every
    poll."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [m for m in masters if m.is_leader()]
        if len(leaders) == 1 and all(
                m.leader_url() == leaders[0].url for m in masters):
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no single HTTP leader")


def _call(url, method, path, body=None, headers=None):
    host, p = url.split(":")
    conn = http.client.HTTPConnection(host, int(p), timeout=30)
    try:
        h = dict(headers or {})
        if body is not None:
            h["Content-Type"] = "application/json"
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers=h)
        resp = conn.getresponse()
        data = resp.read()
        loc = resp.getheader("Location")
    finally:
        conn.close()
    return resp.status, (json.loads(data) if data else None), loc


KEY = "raft-test-key"


@pytest.fixture
def ha_port(tmp_path, monkeypatch):
    """Three port masters with JWTs, the whitelist and every loop at 0.2 s
    (each loop action recorded with whether its master led), then two
    port volume servers given the leader as their first seed."""
    from seaweedfs_tpu_torch import shell
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    acts = []
    ports = free_ports(3)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    masters = []
    for i, p in enumerate(ports):
        m = MasterServer(port=p, pulse_seconds=1, seed=i, peers=peers,
                         raft_dir=str(tmp_path / "raft"),
                         jwt_signing_key=KEY, whitelist=["127.0.0.1"],
                         repair_interval=0.2, vacuum_interval=0.2,
                         maintenance_scripts="collection.list",
                         maintenance_interval=0.2)
        for name in ("_run_vacuum_pass", "_repair_scan"):
            def wrapped(*a, m=m, fn=getattr(m, name), name=name, **kw):
                acts.append((m.url, name, m.is_leader()))
                return fn(*a, **kw)
            setattr(m, name, wrapped)
        masters.append(m)
    run_command = shell.run_command

    def recorded(env, line):
        by_url = {m.url: m for m in masters}
        acts.append((env.master_url, "maintenance",
                     by_url[env.master_url].is_leader()))
        return run_command(env, line)
    monkeypatch.setattr(shell, "run_command", recorded)
    for m in masters:
        m.start()
    leader = http_leader(masters)
    seeds = ",".join([leader.url] + [m.url for m in masters
                                     if m is not leader])
    servers = [VolumeServer(port=0, directories=[str(tmp_path / f"v{i}")],
                            master_url=seeds, pulse_seconds=1,
                            max_volume_counts=[10], device="cpu",
                            jwt_signing_key=KEY,
                            whitelist=["127.0.0.1"]).start()
               for i in range(2)]
    yield masters, leader, servers, acts
    for vs in servers:
        vs.stop()
    for m in masters:
        m.stop()


def _key(fid):
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    return parse_file_id(fid)[1]


def test_ha_port_cluster_failover(ha_port):
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.client.vid_map import VidMap
    from seaweedfs_tpu_torch.server.http_util import (HttpError, http_call,
                                                      post_json,
                                                      post_multipart)
    masters, leader, servers, acts = ha_port
    urls = {vs.url for vs in servers}
    assert wait_until(lambda: {n.url for n in leader.topology.all_nodes()}
                      == urls, timeout=ELECTION_S)
    follower = next(m for m in masters if m is not leader)
    # a 001 volume, a write through the follower's assign, and /submit
    assert post_json(f"http://{follower.url}/vol/grow?replication=001"
                     f"&count=1") == {"count": 1}
    fid = op.upload_data(follower.url, b"before", filename="b.bin",
                         replication="001")
    vid = int(fid.split(",")[0])
    for vs in servers:
        assert http_call("GET", f"http://{vs.url}/{fid}") == b"before"
    # follower 301 -> leader 301 -> a holder
    assert http_call("GET", f"http://{follower.url}/{fid}") == b"before"
    sub = post_multipart(f"http://{follower.url}/submit", "s.bin",
                         b"submitted")
    assert http_call("GET", f"http://{sub['fileUrl']}") == b"submitted"
    # a write without its token is refused
    a = op.assign(follower.url)
    with pytest.raises(HttpError) as e:
        post_multipart(f"http://{a['url']}/{a['fid']}", "x", b"x")
    assert e.value.status == 401
    keys = [_key(fid), _key(sub["fid"])] + \
        [_key(op.assign(follower.url)["fid"]) for _ in range(4)]
    vid_before = leader.topology.max_volume_id
    watcher = VidMap(follower.url).start()
    try:
        assert wait_until(lambda: watcher.lookup(vid) is not None,
                          timeout=ELECTION_S)
        survivors = [m for m in masters if m is not leader]
        leader.stop()
        new = http_leader(survivors)
        # a loop pass that began before the stop has recorded its act by
        # the time a new leader is elected
        stopped_acts = sum(u == leader.url for u, _, _ in acts)
        assert wait_until(lambda: {n.url for n in new.topology.all_nodes()}
                          == urls, timeout=ELECTION_S)
        # the servers' own maps follow the dead first seed: parked
        assert wait_until(lambda: all(vs._vid_map.lookup(vid) is None
                                      for vs in servers),
                          timeout=ELECTION_S)
        # a 001 write through the survivors lands on both replicas
        a = op.assign(follower.url, replication="001")
        op.upload(a["url"], a["fid"], b"after", jwt=a["auth"])
        for vs in servers:
            assert http_call("GET", f"http://{vs.url}/{a['fid']}") == \
                b"after"
        after = [_key(a["fid"])] + \
            [_key(op.assign(m.url)["fid"]) for m in survivors]
        assert min(after) > max(keys), (keys, after)
        grown = post_json(f"http://{follower.url}/vol/grow?count=1")
        assert grown == {"count": 1}
        assert wait_until(lambda: max(int(v) for v in json.loads(
            http_call("GET", f"http://{follower.url}/cluster/volumes"))[
            "volumes"]) > vid_before, timeout=ELECTION_S)
        # a vid map polling a follower recovers the route
        assert wait_until(lambda: sorted(watcher.lookup(vid) or []) ==
                          sorted(urls), timeout=ELECTION_S)
        assert op.read_file(follower.url, fid) == b"before"
    finally:
        watcher.stop()
    # every loop acted only while its master led: the new leader acts, the
    # stopped one no more
    assert wait_until(lambda: {name for u, name, _ in acts
                               if u == new.url} ==
                      {"_run_vacuum_pass", "_repair_scan", "maintenance"},
                      timeout=ELECTION_S)
    assert all(led for _, _, led in acts), [a for a in acts if not a[2]]
    assert sum(u == leader.url for u, _, _ in acts) == stopped_acts


def test_ha_delete_needs_its_token(ha_port):
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.security.jwt import GenJwt
    from seaweedfs_tpu_torch.server.http_util import HttpError
    masters, leader, servers, _ = ha_port
    assert wait_until(lambda: len(leader.topology.all_nodes()) == 2,
                      timeout=ELECTION_S)
    follower = next(m for m in masters if m is not leader)
    fid = op.upload_data(follower.url, b"to delete")
    assert not op.delete_file(follower.url, fid)
    assert op.read_file(follower.url, fid) == b"to delete"
    assert op.delete_file(follower.url, fid, jwt=GenJwt(KEY, fid))
    with pytest.raises(HttpError) as e:
        op.read_file(follower.url, fid)
    assert e.value.status == 404


# -- follower replies against a JAX master in the same role ----------------

def _group(kind, tmp_path):
    if kind == "ref":
        from seaweedfs_tpu.server.master import MasterServer
        kw = {}
    else:
        from seaweedfs_tpu_torch.server.master import MasterServer
        kw = {"seed": 1}
    ports = free_ports(3)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    return [MasterServer(port=p, pulse_seconds=1, peers=peers,
                         raft_dir=str(tmp_path / kind), vacuum_interval=0,
                         **kw).start() for p in ports]


def _follower_replies(masters, attempts=5):
    """The replies of ``_follower_replies_once``, taken again when the
    leadership moved while they were taken (roles would mix)."""
    for _ in range(attempts):
        leader = http_leader(masters)
        out = _follower_replies_once(masters, leader)
        if http_leader(masters) is leader:
            return out
    raise AssertionError("the leadership never held still")


def _follower_replies_once(masters, leader):
    followers = [m for m in masters if m is not leader]
    roles = {leader.url: "LEADER", followers[0].url: "F1",
             followers[1].url: "F2"}

    def norm(obj):
        text = json.dumps(obj, sort_keys=True)
        for url, role in roles.items():
            text = text.replace(url, role)
        return json.loads(text)

    f = followers[0].url
    hb = {"ip": "127.0.0.1", "port": 1, "public_url": "",
          "max_volume_count": 3, "volumes": []}
    out = {
        "heartbeat": _call(f, "POST", "/cluster/heartbeat", hb),
        "redirect": _call(f, "GET", "/3,0123456789?x=1"),
        "not a fid": _call(f, "GET", "/nope"),
        "status": _call(f, "GET", "/cluster/status"),
        "lookup": _call(f, "GET", "/dir/lookup?volumeId=5"),
        "ec lookup": _call(f, "GET", "/cluster/ec_lookup?volumeId=5"),
        "ec status": _call(f, "GET", "/cluster/ec_status"),
        "volumes": _call(f, "GET", "/cluster/volumes"),
        "assign": _call(f, "GET", "/dir/assign"),
        "loop": _call(f, "GET", "/dir/lookup?volumeId=5",
                      headers={"X-Raft-Forwarded": "1"}),
    }
    return norm(out)


def test_follower_replies_match_jax(tmp_path):
    got = {}
    for kind in ("ref", "port"):
        masters = _group(kind, tmp_path)
        try:
            got[kind] = _follower_replies(masters)
        finally:
            for m in masters:
                m.stop()
    assert got["port"] == got["ref"]
    assert got["port"]["redirect"][0] == 301
    assert got["port"]["redirect"][2] == "http://LEADER/3,0123456789?x=1"
    assert got["port"]["heartbeat"][1]["not_leader"] is True
    assert got["port"]["status"][1]["peers"] == ["F1", "F2"]
    assert got["port"]["loop"][0] == 503


def test_leaderless_master_replies_match_jax(tmp_path):
    """A master whose two peers never answer can win no election: it
    names no leader, and every route but its heartbeat answers 503."""
    got = {}
    for kind in ("ref", "port"):
        if kind == "ref":
            from seaweedfs_tpu.server.master import MasterServer
        else:
            from seaweedfs_tpu_torch.server.master import MasterServer
        own, *dead = free_ports(3)
        m = MasterServer(port=own, pulse_seconds=1,
                         peers=",".join(f"127.0.0.1:{p}"
                                        for p in [own] + dead),
                         raft_dir=str(tmp_path / kind),
                         vacuum_interval=0).start()
        try:
            assert wait_until(lambda: m.raft.current_term > 0,
                              timeout=ELECTION_S)
            got[kind] = [
                _call(m.url, "POST", "/cluster/heartbeat",
                      {"ip": "127.0.0.1", "port": 1, "volumes": []}),
                _call(m.url, "GET", "/dir/assign"),
                _call(m.url, "GET", "/3,0123456789"),
                _call(m.url, "GET", "/cluster/status")]
            assert not m.is_leader()
        finally:
            m.stop()
    assert got["port"] == got["ref"]
    assert [s for s, _, _ in got["port"]] == [200, 503, 503, 503]


@pytest.mark.parametrize("failure", ["not leader", "timeout"])
def test_assign_losing_the_leadership_matches_jax(failure):
    from seaweedfs_tpu.server.master import MasterServer as RefMaster
    from seaweedfs_tpu_torch.server.master import MasterServer as PortMaster
    got = []
    for cls, err in ((RefMaster, ref_raft.NotLeaderError),
                     (PortMaster, port_raft.NotLeaderError)):
        m = cls(port=0, pulse_seconds=1, vacuum_interval=0).start()
        exc = err("127.0.0.1:1") if failure == "not leader" \
            else TimeoutError("slow")

        def fail(req, exc=exc):
            raise exc
        m._dir_assign_local = fail
        try:
            got.append(_call(m.url, "GET", "/dir/assign"))
        finally:
            m.stop()
    assert got[1] == got[0]
    assert got[1][0] == 503


def _start_master(args, cwd):
    import subprocess
    import sys
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.server.master",
         "-pulseSeconds", "1", "-repairInterval", "0",
         "-vacuumIntervalSeconds", "0", *args],
        cwd=cwd, stdout=subprocess.PIPE, text=True)


def test_master_cli_raft_guard_and_etcd_flags(tmp_path):
    """Three ``python3 -m seaweedfs_tpu_torch.server.master`` processes
    with ``-peers``, ``-mdir``, ``-jwtKey`` and ``-whiteList`` elect one
    leader and hand out write tokens through any of them, which a volume
    server with the key demands; a fourth with ``-sequencer etcd`` takes
    its file keys from the (fake) etcd and keeps ``sequencer.dat`` in its
    ``-mdir``."""
    from test_filer import fake_etcd
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.server.http_util import (HttpError, get_json,
                                                      post_multipart)
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ports = free_ports(4)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports[:3])
    srv = fake_etcd()
    procs = [_start_master(["-port", str(p), "-peers", peers, "-mdir",
                            str(tmp_path / f"m{i}"), "-jwtKey", KEY,
                            "-whiteList", "127.0.0.1,10.0."], root)
             for i, p in enumerate(ports[:3])]
    procs.append(_start_master(
        ["-port", str(ports[3]), "-mdir", str(tmp_path / "etcd"),
         "-sequencer", "etcd", "-sequencerEtcd", f"127.0.0.1:{srv.port}",
         "-sequencerEtcdUser", srv.USER,
         "-sequencerEtcdPassword", srv.PASSWORD], root))
    vs = None
    try:
        for proc in procs:
            line = proc.stdout.readline()
            assert line.startswith("master listening on "), line

        def leader():
            try:
                views = [get_json(f"http://127.0.0.1:{p}/cluster/status")
                         for p in ports[:3]]
            except HttpError:
                return None
            leaders = {v["leader"] for v in views}
            return leaders.pop() if len(leaders) == 1 else None
        assert wait_until(leader, timeout=ELECTION_S)
        seeds = ",".join(f"127.0.0.1:{p}" for p in ports[:3])
        vs = VolumeServer(port=0, directories=[str(tmp_path / "v")],
                          master_url=seeds, pulse_seconds=1,
                          max_volume_counts=[10], device="cpu",
                          jwt_signing_key=KEY).start()
        follower = next(f"127.0.0.1:{p}" for p in ports[:3]
                        if f"127.0.0.1:{p}" != leader())
        assert wait_until(lambda: len(get_json(
            f"http://{follower}/cluster/status")["nodes"]) == 1,
            timeout=ELECTION_S)
        a = op.assign(follower)
        with pytest.raises(HttpError) as e:
            post_multipart(f"http://{a['url']}/{a['fid']}", "x", b"x")
        assert e.value.status == 401
        op.upload(a["url"], a["fid"], b"cli", jwt=a["auth"])
        assert op.read_file(follower, a["fid"]) == b"cli"
        # the etcd master's first key is the first of its etcd grant
        vs2 = VolumeServer(port=0, directories=[str(tmp_path / "v2")],
                           master_url=f"127.0.0.1:{ports[3]}",
                           pulse_seconds=1, max_volume_counts=[10],
                           device="cpu").start()
        try:
            fid = op.assign(f"127.0.0.1:{ports[3]}")["fid"]
        finally:
            vs2.stop()
        assert _key(fid) == 1
        assert int(srv.kv[b"/seaweedfs/master/sequence"]) == \
            int((tmp_path / "etcd" / "sequencer.dat").read_text()) > 1
    finally:
        if vs is not None:
            vs.stop()
        for proc in procs:
            proc.terminate()
            proc.wait(timeout=10)
            proc.stdout.close()
