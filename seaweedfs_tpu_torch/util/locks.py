"""Lock factory with an optional lock-order recorder.

The JAX package's ``util/locks.py``. With ``SW_LOCK_DEBUG`` on
(util/config; the test session turns it on for every process it
starts), ``make_lock``/``make_rlock`` hand out instrumented wrappers
that record the cross-thread lock-acquisition graph: an edge ``A -> B``
means some thread acquired ``B`` while holding ``A``. A cycle in that
graph is a potential ABBA deadlock even if the run never deadlocked.
With it off, the factories return plain ``threading`` locks.

Nodes are lock *names* (lockdep-style classes), not instances: every
volume's ``torch.volume.lock`` is one node, so an ABBA between two
volumes is still caught. Every name starts with ``NAME_PREFIX``
(``torch.``, before the JAX package's name for the same lock where it
has one), so no merge by name can join the port's graph to the JAX
package's. Deliberately ordered nesting goes into ``ALLOWED``, each edge
with its justification.

A recording process dumps its graph at exit under
``$SW_LOCK_GRAPH_DIR/torch/`` (``GRAPH_SUBDIR``): the JAX package's
session check merges only the ``*.json`` files at the top of that
directory, so the port's edges never reach it. ``load_graph_dir`` of the
subdirectory reads them back.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from . import config


#: Every port lock name starts with this.
NAME_PREFIX = "torch."
#: The subdirectory of SW_LOCK_GRAPH_DIR that the port's dumps go to.
GRAPH_SUBDIR = "torch"
#: Edges (holder, acquired) that ``cycles`` may drop, each justified in a
#: comment beside it. Empty: the port nests no lock classes on purpose.
ALLOWED: set = set()


def debug_enabled() -> bool:
    return config.env_bool("SW_LOCK_DEBUG")


def _checked(name: str) -> str:
    if not name.startswith(NAME_PREFIX):
        raise ValueError(f"lock name {name!r} must start with "
                         f"{NAME_PREFIX!r}")
    return name


class LockGraphRecorder:
    """Cross-thread lock-acquisition graph for one process.

    Thread-local held stacks, a global edge map keyed
    ``(holder_name, acquired_name)`` with an example location so a
    reported cycle points somewhere actionable."""

    def __init__(self):
        self._mu = threading.Lock()  # guards edges only
        self._tls = threading.local()
        # (holder, acquired) -> {"count": n, "thread": name}
        self.edges: Dict[Tuple[str, str], dict] = {}

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def on_acquire(self, lock: "_DebugLockBase"):
        held = self._held()
        if held and not lock.reentrant_held():
            top = held[-1]
            if top is not lock:
                edge = (top.name, lock.name)
                with self._mu:
                    e = self.edges.get(edge)
                    if e is None:
                        # the first thread to take this edge names it
                        e = self.edges[edge] = {
                            "count": 0,
                            "thread": threading.current_thread().name}
                    e["count"] += 1
        held.append(lock)

    def on_release(self, lock: "_DebugLockBase"):
        held = self._held()
        # remove the most recent occurrence; out-of-order releases are
        # legal (if rare), so scan instead of assuming LIFO
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def edge_list(self) -> List[dict]:
        with self._mu:
            return [{"from": a, "to": b, **info}
                    for (a, b), info in sorted(self.edges.items())]

    def clear(self):
        with self._mu:
            self.edges.clear()

    def cycles(self, extra_edges: Optional[List[dict]] = None,
               allowed: Optional[set] = None) -> List[List[str]]:
        """Elementary cycles in the (merged) name graph, each rotated to
        its lexicographically smallest node and deduplicated.  ``allowed``
        drops individual edges (``ALLOWED``) before the search, so a
        justified ordered nesting can't mask a real cycle elsewhere."""
        graph: Dict[str, set] = {}
        merged = self.edge_list() + list(extra_edges or [])
        for e in merged:
            a, b = e["from"], e["to"]
            if allowed and (a, b) in allowed:
                continue
            graph.setdefault(a, set()).add(b)
        out, seen = [], set()
        # DFS from every node; the graphs here are tiny (tens of names)
        for start in sorted(graph):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(graph.get(node, ())):
                    if nxt == start:
                        cyc = path[:]
                        low = cyc.index(min(cyc))
                        key = tuple(cyc[low:] + cyc[:low])
                        if key not in seen:
                            seen.add(key)
                            out.append(list(key))
                    elif nxt not in path and len(path) < 16:
                        stack.append((nxt, path + [nxt]))
        return out

    def dump(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"pid": os.getpid(), "edges": self.edge_list()}, f)


RECORDER = LockGraphRecorder()


class _DebugLockBase:
    """Common wrapper: acquire/release bookkeeping + the Condition
    protocol (_release_save/_acquire_restore/_is_owned) so a factory
    lock can back a threading.Condition without desyncing the held
    stack during wait()."""

    def __init__(self, name: str, inner, recorder: LockGraphRecorder):
        self.name = name
        self._inner = inner
        self._recorder = recorder

    def reentrant_held(self) -> bool:
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._recorder.on_acquire(self)
        return ok

    def release(self):
        self._recorder.on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition(lock) protocol
    def _release_save(self):
        self._recorder.on_release(self)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._recorder.on_acquire(self)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain-Lock heuristic, same as threading.Condition's fallback
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class DebugLock(_DebugLockBase):
    pass


class DebugRLock(_DebugLockBase):
    """Re-entrant variant: nested re-acquires by the owning thread are
    not new graph edges (a lock can't deadlock against itself in one
    thread), and only the outermost release pops the held stack."""

    def __init__(self, name: str, recorder: LockGraphRecorder):
        super().__init__(name, threading.RLock(), recorder)
        self._owner: Optional[int] = None
        self._depth = 0

    def reentrant_held(self) -> bool:
        return self._owner == threading.get_ident() and self._depth > 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._depth == 0 or \
                    self._owner != threading.get_ident():
                self._recorder.on_acquire(self)
            else:
                # re-entrant: keep stack balance without a new edge
                self._recorder._held().append(self)
            self._owner = threading.get_ident()
            self._depth += 1
        return ok

    def release(self):
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._recorder.on_release(self)
        self._inner.release()

    def _release_save(self):
        # Condition.wait on an RLock releases ALL recursion levels
        self._recorder.on_release(self)
        depth, self._depth = self._depth, 0
        self._owner = None
        state = self._inner._release_save()
        return (state, depth)

    def _acquire_restore(self, state):
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        self._owner = threading.get_ident()
        self._depth = depth
        self._recorder.on_acquire(self)

    def _is_owned(self):
        return self._inner._is_owned()


def make_lock(name: str, recorder: Optional[LockGraphRecorder] = None):
    """A ``threading.Lock`` — instrumented with ``name`` as its
    lock-class when recording is on.  ``recorder`` is for tests; the
    process-global RECORDER is the default."""
    _checked(name)
    if recorder is None and not debug_enabled():
        return threading.Lock()
    return DebugLock(name, threading.Lock(), recorder or RECORDER)


def make_rlock(name: str, recorder: Optional[LockGraphRecorder] = None):
    _checked(name)
    if recorder is None and not debug_enabled():
        return threading.RLock()
    return DebugRLock(name, recorder or RECORDER)


def load_graph_dir(path: str) -> List[dict]:
    """Merged edge list from every per-process dump in ``path``."""
    edges: List[dict] = []
    if not path or not os.path.isdir(path):
        return edges
    for name in sorted(os.listdir(path)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(path, name), encoding="utf-8") as f:
                edges.extend(json.load(f).get("edges", []))
        except (OSError, ValueError):
            continue
    return edges


def graph_dir() -> str:
    """Where this process's dump goes: GRAPH_SUBDIR under
    SW_LOCK_GRAPH_DIR ("" when that is unset)."""
    out_dir = config.env_str("SW_LOCK_GRAPH_DIR")
    return os.path.join(out_dir, GRAPH_SUBDIR) if out_dir else ""


def _dump_at_exit():
    out_dir = graph_dir()
    if not out_dir or not RECORDER.edges:
        return
    try:
        os.makedirs(out_dir, exist_ok=True)
        RECORDER.dump(os.path.join(out_dir, f"lockgraph-{os.getpid()}.json"))
    except OSError:
        pass  # diagnostics must never break process exit


# registered unconditionally: _dump_at_exit no-ops unless recording ran
# and SW_LOCK_GRAPH_DIR is set, and import order must not decide whether
# a late-enabled process dumps its graph
atexit.register(_dump_at_exit)
