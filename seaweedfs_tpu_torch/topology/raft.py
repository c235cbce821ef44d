"""Raft among the masters: leader election and a replicated log.

The JAX package's ``topology/raft.py``. The masters elect a leader and
replicate the little state that must survive a failover: the highest
volume id and the file-key sequence ceiling (``RaftSequencer``). The
RPCs are JSON bodies POSTed to ``/raft/<rpc>`` over the masters' own
HTTP; a failed POST (``HttpError``) counts as no answer.

What is kept of Raft: fixed membership (the ``peers`` list, no joint
consensus); election with randomized timeouts; log replication with the
commit rule of the current term; state persisted to ``raft-<id>.json``
in ``state_dir`` through a temp file and ``os.replace``; and log
compaction past ``max_log_entries`` into a snapshot of the state
machine (``snapshot_state_fn`` / ``restore_fn``), with InstallSnapshot
for a peer whose next entry was compacted away. The election deadline
draws from ``rng`` (the JAX node draws from the module-global
``random``).
"""

from __future__ import annotations

import json
import os
import random
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from ..server.http_util import HttpError, post_json

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

ELECTION_TIMEOUT_RANGE = (0.6, 1.2)  # seconds (scaled to HTTP RPCs)
RPC_TIMEOUT = 0.5    # well under the election timeout
TICK_S = 0.05        # the ticker's period: a leader heartbeats every tick


def _resolve_host(host: str) -> str:
    try:
        return socket.gethostbyname(host)
    except OSError:
        return host


def same_node(a: str, b: str) -> bool:
    """host:port equality that takes localhost, 127.0.0.1 and a host name
    as one: a node that failed to see itself in the peer list would count
    itself twice in a quorum and depose itself with its own heartbeat."""
    if a == b:
        return True
    try:
        ha, pa = a.rsplit(":", 1)
        hb, pb = b.rsplit(":", 1)
    except ValueError:
        return False
    return pa == pb and _resolve_host(ha) == _resolve_host(hb)


class NotLeaderError(Exception):
    """A write on a node that is not the leader; ``leader`` is the node
    it believes leads (None when it knows none)."""

    def __init__(self, leader: Optional[str]):
        super().__init__(f"not the raft leader; leader is {leader}")
        self.leader = leader


class RaftNode:
    def __init__(self, node_id: str, peers: List[str],
                 apply_fn: Callable[[dict], None],
                 state_dir: Optional[str] = None,
                 transport: Optional[Callable] = None,
                 snapshot_state_fn: Optional[Callable[[], dict]] = None,
                 restore_fn: Optional[Callable[[dict], None]] = None,
                 max_log_entries: int = 1024,
                 rng: Optional[random.Random] = None):
        """``node_id`` and ``peers`` are master urls (host:port); the
        node drops itself from ``peers``. ``apply_fn`` gets each
        committed command once, in log order. ``transport(peer, rpc,
        payload)`` answers an RPC (by default a POST to
        ``http://<peer>/raft/<rpc>``). ``snapshot_state_fn()`` captures
        the applied state for compaction, ``restore_fn(state)`` installs
        one; without them the log is kept whole. ``rng`` draws the
        election deadlines."""
        self.id = node_id
        self.peers = [p for p in peers if not same_node(p, node_id)]
        self.apply_fn = apply_fn
        self.state_dir = state_dir
        self.transport = transport or self._http_transport
        self.snapshot_state_fn = snapshot_state_fn
        self.restore_fn = restore_fn
        self.max_log_entries = int(max_log_entries)
        self.rng = rng or random.Random()

        # persistent state
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: List[dict] = []        # {"term": t, "command": {...}}
        # the compaction base: entries 1..snap_index live only in
        # snap_state
        self.snap_index = 0
        self.snap_term = 0
        self.snap_state: Optional[dict] = None
        self._load_state()

        # volatile state
        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = self.snap_index  # 1-based; 0: nothing
        self.last_applied = self.snap_index
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}

        self.lock = threading.RLock()
        self._commit_cv = threading.Condition(self.lock)
        self._stop = threading.Event()
        self._election_deadline = self._new_deadline()
        self._inflight: Dict[str, bool] = {}   # one RPC a peer at a time
        self._ticker = threading.Thread(target=self._tick_loop,
                                        daemon=True, name="raft-ticker")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RaftNode":
        self._ticker.start()
        return self

    def stop(self):
        self._stop.set()

    @property
    def is_leader(self) -> bool:
        with self.lock:
            return self.state == LEADER

    def leader(self) -> Optional[str]:
        with self.lock:
            return self.id if self.state == LEADER else self.leader_id

    # -- log indexing over the snapshot base ---------------------------------
    def _last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _entry(self, index: int) -> dict:
        return self.log[index - self.snap_index - 1]

    def _term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index or index > self._last_index():
            return 0
        return self._entry(index)["term"]

    def _maybe_compact(self):
        """Collapse the applied prefix into a snapshot (the lock held).
        The cut is always ``last_applied``, the point the captured state
        stands for, so a restore plus the replay of the rest applies each
        command once. A leader keeps the entries a close peer still
        needs, until the log passes twice the limit; then it cuts and the
        peer catches up through InstallSnapshot."""
        if self.snapshot_state_fn is None:
            return
        if len(self.log) <= self.max_log_entries:
            return
        cut_to = self.last_applied
        if cut_to <= self.snap_index:
            return
        if self.state == LEADER and self.peers and \
                len(self.log) <= 2 * self.max_log_entries:
            floor = min(self.match_index.get(p, 0) for p in self.peers)
            if cut_to > floor and \
                    self._last_index() - floor <= self.max_log_entries:
                return  # a close peer: keep its entries, cut later
        self.snap_term = self._term_at(cut_to)
        self.snap_state = self.snapshot_state_fn()
        self.log = self.log[cut_to - self.snap_index:]
        self.snap_index = cut_to
        self._persist()

    # -- persistence ---------------------------------------------------------
    def _state_path(self) -> str:
        safe = self.id.replace(":", "_").replace("/", "_")
        return os.path.join(self.state_dir, f"raft-{safe}.json")

    def _load_state(self):
        if not self.state_dir:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        p = self._state_path()
        if os.path.exists(p):
            try:
                with open(p) as f:
                    st = json.load(f)
                self.current_term = st.get("term", 0)
                self.voted_for = st.get("voted_for")
                self.log = st.get("log", [])
                self.snap_index = st.get("snap_index", 0)
                self.snap_term = st.get("snap_term", 0)
                self.snap_state = st.get("snap_state")
                if self.snap_state is not None and \
                        self.restore_fn is not None:
                    self.restore_fn(self.snap_state)
            except (ValueError, OSError):
                pass

    def _persist(self):
        if not self.state_dir:
            return
        p = self._state_path()
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.current_term,
                       "voted_for": self.voted_for,
                       "log": self.log,
                       "snap_index": self.snap_index,
                       "snap_term": self.snap_term,
                       "snap_state": self.snap_state}, f)
        os.replace(tmp, p)

    # -- timers --------------------------------------------------------------
    def _new_deadline(self) -> float:
        return time.monotonic() + self.rng.uniform(*ELECTION_TIMEOUT_RANGE)

    def _tick_loop(self):
        while not self._stop.wait(TICK_S):
            with self.lock:
                state = self.state
                expired = time.monotonic() >= self._election_deadline
            if state == LEADER:
                self._broadcast_heartbeats()
            elif expired:
                self._run_election()

    # -- election ------------------------------------------------------------
    def _run_election(self):
        with self.lock:
            self.state = CANDIDATE
            self.current_term += 1
            self.voted_for = self.id
            self.leader_id = None
            self._persist()
            term = self.current_term
            last_index = self._last_index()
            last_term = self._term_at(last_index)
            self._election_deadline = self._new_deadline()
        # votes are asked in parallel: serial RPCs to a dead peer would
        # outlast the election timeout
        votes = [1]
        done = threading.Event()

        def ask(peer):
            reply = self._rpc(peer, "request_vote", {
                "term": term, "candidate_id": self.id,
                "last_log_index": last_index,
                "last_log_term": last_term})
            if reply is None:
                return
            with self.lock:
                if reply["term"] > self.current_term:
                    self._become_follower(reply["term"], None)
                    done.set()
                    return
                if self.state != CANDIDATE or self.current_term != term:
                    done.set()
                    return
                if reply.get("vote_granted"):
                    votes[0] += 1
                    if votes[0] * 2 > len(self.peers) + 1:
                        done.set()

        for peer in self.peers:
            threading.Thread(target=ask, args=(peer,), daemon=True,
                             name=f"raft-vote-{peer}").start()
        done.wait(RPC_TIMEOUT + 0.2)
        with self.lock:
            if self.state == CANDIDATE and self.current_term == term \
                    and votes[0] * 2 > len(self.peers) + 1:
                self.state = LEADER
                self.leader_id = self.id
                nxt = self._last_index() + 1
                self.next_index = {p: nxt for p in self.peers}
                self.match_index = {p: 0 for p in self.peers}
        if self.is_leader:
            self._broadcast_heartbeats()

    def _become_follower(self, term: int, leader: Optional[str]):
        self.state = FOLLOWER
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist()
        if leader:
            self.leader_id = leader
        self._election_deadline = self._new_deadline()

    # -- replication (the leader's side) -------------------------------------
    def _broadcast_heartbeats(self):
        """One replication RPC a peer, each on its own thread: a dead
        peer's timeout must not delay the live peers' heartbeats (their
        election timers would expire)."""
        for peer in self.peers:
            with self.lock:
                if self._inflight.get(peer):
                    continue
                self._inflight[peer] = True

            def run(p=peer):
                try:
                    self._replicate_to(p)
                    self._advance_commit()
                    # a compaction deferred for this peer can go once its
                    # ack lands
                    with self.lock:
                        self._maybe_compact()
                finally:
                    with self.lock:
                        self._inflight[p] = False
            threading.Thread(target=run, daemon=True,
                             name=f"raft-replicate-{peer}").start()

    def _replicate_to(self, peer: str):
        with self.lock:
            if self.state != LEADER:
                return
            term = self.current_term
            nxt = self.next_index.get(peer, self._last_index() + 1)
            if nxt <= self.snap_index:
                # the peer needs compacted entries: ship the snapshot
                snap = {"term": term, "leader_id": self.id,
                        "snap_index": self.snap_index,
                        "snap_term": self.snap_term,
                        "state": self.snap_state}
            else:
                snap = None
                prev_index = nxt - 1
                prev_term = self._term_at(prev_index)
                entries = self.log[nxt - self.snap_index - 1:]
                commit = self.commit_index
        if snap is not None:
            reply = self._rpc(peer, "install_snapshot", snap)
            if reply is None:
                return
            with self.lock:
                if reply["term"] > self.current_term:
                    self._become_follower(reply["term"], None)
                    return
                if self.state != LEADER or self.current_term != term:
                    return
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0), snap["snap_index"])
                self.next_index[peer] = self.match_index[peer] + 1
            return
        reply = self._rpc(peer, "append_entries", {
            "term": term, "leader_id": self.id,
            "prev_log_index": prev_index, "prev_log_term": prev_term,
            "entries": entries, "leader_commit": commit})
        if reply is None:
            return
        with self.lock:
            if reply["term"] > self.current_term:
                self._become_follower(reply["term"], None)
                return
            if self.state != LEADER or self.current_term != term:
                return
            if reply.get("success"):
                self.match_index[peer] = prev_index + len(entries)
                self.next_index[peer] = self.match_index[peer] + 1
            else:
                self.next_index[peer] = max(1, nxt - 1)

    def _advance_commit(self):
        with self.lock:
            if self.state != LEADER:
                return
            for n in range(self._last_index(), self.commit_index, -1):
                if self._term_at(n) != self.current_term:
                    break
                replicas = 1 + sum(1 for p in self.peers
                                   if self.match_index.get(p, 0) >= n)
                if replicas * 2 > len(self.peers) + 1:
                    self.commit_index = n
                    self._apply_committed()
                    self._commit_cv.notify_all()
                    break

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            self.apply_fn(self._entry(self.last_applied)["command"])
        self._maybe_compact()

    # -- the write path ------------------------------------------------------
    def propose(self, command: dict, timeout: float = 5.0) -> int:
        """Append ``command``, replicate it to a majority and apply it;
        its log index. NotLeaderError on a node that is not the leader
        (or stops being it before the commit), TimeoutError past
        ``timeout``."""
        with self.lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader())
            self.log.append({"term": self.current_term,
                             "command": command})
            self._persist()
            index = self._last_index()
        if not self.peers:                  # a group of one
            with self.lock:
                self.commit_index = index
                self._apply_committed()
            return index
        self._broadcast_heartbeats()
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            while self.commit_index < index:
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set():
                    raise TimeoutError(
                        f"raft commit of index {index} timed out")
                if self.state != LEADER:
                    raise NotLeaderError(self.leader())
                self._commit_cv.wait(min(left, 0.1))
        return index

    # -- RPC handlers (the follower's side) ----------------------------------
    def handle_request_vote(self, req: dict) -> dict:
        with self.lock:
            term = req["term"]
            if term > self.current_term:
                self._become_follower(term, None)
            granted = False
            if term == self.current_term and \
                    self.voted_for in (None, req["candidate_id"]):
                my_last = self._last_index()
                my_last_term = self._term_at(my_last)
                up_to_date = (
                    req["last_log_term"] > my_last_term or
                    (req["last_log_term"] == my_last_term and
                     req["last_log_index"] >= my_last))
                if up_to_date:
                    granted = True
                    self.voted_for = req["candidate_id"]
                    self._persist()
                    self._election_deadline = self._new_deadline()
            return {"term": self.current_term, "vote_granted": granted}

    def handle_append_entries(self, req: dict) -> dict:
        with self.lock:
            term = req["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if same_node(req["leader_id"], self.id):
                # our own heartbeat come back (a peer list naming us
                # twice): stepping down to it would depose us for good
                return {"term": self.current_term, "success": True}
            self._become_follower(term, req["leader_id"])
            prev = req["prev_log_index"]
            entries = req["entries"]
            clamped = False
            if prev < self.snap_index:
                # the window starts inside our compacted prefix, which is
                # committed here: skip it. The leader's prev_log_term is
                # of its own prev index, not of our boundary, so no term
                # check applies after the clamp
                skip = self.snap_index - prev
                entries = entries[skip:] if skip < len(entries) else []
                prev = self.snap_index
                clamped = True
            if prev > self._last_index() or (
                    not clamped and prev > 0 and
                    self._term_at(prev) != req.get("prev_log_term", 0)):
                return {"term": self.current_term, "success": False}
            if entries:
                # truncate only from the first index whose term differs
                # (Raft 5.3): a late, overlapping window must not wipe
                # entries already acknowledged
                changed = False
                for i, e in enumerate(entries):
                    pos = prev + i - self.snap_index  # 0-based log slot
                    if pos < len(self.log):
                        if self.log[pos]["term"] != e["term"]:
                            self.log = self.log[:pos] + entries[i:]
                            changed = True
                            break
                    else:
                        self.log = self.log + entries[i:]
                        changed = True
                        break
                if changed:
                    self._persist()
            if req["leader_commit"] > self.commit_index:
                self.commit_index = min(req["leader_commit"],
                                        self._last_index())
                self._apply_committed()
            return {"term": self.current_term, "success": True}

    def handle_install_snapshot(self, req: dict) -> dict:
        """Install a leader's snapshot (Raft 7, in one message: the state
        machine is two counters)."""
        with self.lock:
            term = req["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            self._become_follower(term, req["leader_id"])
            snap_index = int(req["snap_index"])
            snap_term = int(req["snap_term"])
            if snap_index <= self.snap_index:
                return {"term": self.current_term, "success": True}
            if snap_index < self._last_index() and \
                    self._term_at(snap_index) == snap_term:
                # our suffix continues the snapshot's branch: keep it
                self.log = self.log[snap_index - self.snap_index:]
            else:
                # a conflicting or absent suffix: the whole log goes
                self.log = []
            self.snap_index = snap_index
            self.snap_term = snap_term
            self.snap_state = req.get("state")
            if self.snap_state is not None and self.restore_fn is not None:
                self.restore_fn(self.snap_state)
            self.commit_index = max(self.commit_index, snap_index)
            self.last_applied = max(self.last_applied, snap_index)
            self._persist()
            return {"term": self.current_term, "success": True}

    # -- transport -----------------------------------------------------------
    def _http_transport(self, peer: str, rpc: str, payload: dict):
        return post_json(f"http://{peer}/raft/{rpc}", payload,
                         timeout=RPC_TIMEOUT)

    def _rpc(self, peer: str, rpc: str, payload: dict) -> Optional[dict]:
        try:
            return self.transport(peer, rpc, payload)
        except (HttpError, OSError):
            return None

    def status(self) -> dict:
        with self.lock:
            return {"id": self.id, "state": self.state,
                    "term": self.current_term,
                    "leader": self.leader(),
                    "log_length": len(self.log),
                    "snap_index": self.snap_index,
                    "commit_index": self.commit_index,
                    "peers": self.peers}
