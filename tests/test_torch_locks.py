"""The port's lock-order recorder (util/locks) against the JAX package's.

- The same acquisition scripts, each thread named, go through both
  packages' recorders (one ``LockGraphRecorder`` each): equal edge lists
  and equal ``cycles()``, an ABBA pair, a re-entrant lock, a
  ``threading.Condition`` over a ``DebugRLock`` and an out-of-order
  release included.
- A port stack in this process (master, volume server, filer, S3
  gateway) through a write, an ``ec.encode`` and a degraded read under
  the port's recorder: edges among the port's own lock names only, and
  no cycle outside ``ALLOWED``.
- A port process's dump lands under ``$SW_LOCK_GRAPH_DIR/torch/``, where
  the JAX session check's ``load_graph_dir`` never reads it.
- Every port lock is made by the factory, under a ``torch.`` name that
  no JAX lock has.

Tolerances: none.
"""

import ast
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from seaweedfs_tpu.util import locks as ref_locks
from seaweedfs_tpu_torch.util import locks

ROOT = Path(__file__).resolve().parents[1]

# (thread name, [(op, lock)]): op "a" acquires, "r" releases, "w" waits on
# the condition of lock "c" (released and taken back inside)
SCRIPTS = {
    "nested": [("t1", [("a", "A"), ("a", "B"), ("r", "B"), ("a", "C"),
                       ("r", "C"), ("r", "A")])],
    "abba": [("t1", [("a", "A"), ("a", "B"), ("r", "B"), ("r", "A")]),
             ("t2", [("a", "B"), ("a", "A"), ("r", "A"), ("r", "B")])],
    "cycle of three": [
        ("t1", [("a", "A"), ("a", "B"), ("r", "B"), ("r", "A")]),
        ("t2", [("a", "B"), ("a", "C"), ("r", "C"), ("r", "B")]),
        ("t3", [("a", "C"), ("a", "A"), ("r", "A"), ("r", "C")])],
    "reentrant": [("t1", [("a", "R"), ("a", "R"), ("a", "A"), ("r", "A"),
                          ("r", "R"), ("a", "B"), ("r", "B"), ("r", "R")])],
    "out of order": [("t1", [("a", "A"), ("a", "B"), ("r", "A"),
                             ("a", "C"), ("r", "C"), ("r", "B")])],
    "condition": [("t1", [("a", "c"), ("a", "A"), ("r", "A"), ("w", "c"),
                          ("a", "B"), ("r", "B"), ("r", "c")]),
                  ("t2", [("a", "A"), ("a", "c"), ("r", "c"), ("r", "A")])],
}


def _run(mod, script):
    """The script's threads, one after another, on ``mod``'s locks over a
    recorder of its own; returns the recorder."""
    rec = mod.LockGraphRecorder()
    names = {lock for _, ops in script for _, lock in ops}
    made = {name: (mod.make_rlock if name in "Rc" else mod.make_lock)(
        f"torch.{name}", recorder=rec) for name in names}
    cond = threading.Condition(made["c"]) if "c" in made else None

    def body(ops):
        for op, name in ops:
            if op == "a":
                made[name].acquire()
            elif op == "r":
                made[name].release()
            else:
                assert not cond.wait(timeout=0.01)
    for thread_name, ops in script:
        t = threading.Thread(target=body, args=(ops,), name=thread_name)
        t.start()
        t.join()
    return rec


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_recorders_agree(script):
    ref, port = _run(ref_locks, SCRIPTS[script]), \
        _run(locks, SCRIPTS[script])
    assert port.edge_list() == ref.edge_list()
    assert port.cycles() == ref.cycles()
    allowed = {("torch.B", "torch.A")}
    assert port.cycles(allowed=allowed) == ref.cycles(allowed=allowed)
    want = {"abba": [["torch.A", "torch.B"]],
            "cycle of three": [["torch.A", "torch.B", "torch.C"]],
            "condition": [["torch.A", "torch.c"]]}
    assert port.cycles() == want.get(script, [])
    extra = [{"from": "torch.C", "to": "torch.A"}]
    assert port.cycles(extra_edges=extra) == ref.cycles(extra_edges=extra)


def test_clear_then_record_again():
    """After ``clear()`` a thread that saw an edge records it afresh. The
    JAX recorder keeps a per-thread set of seen edges across the clear
    and raises KeyError there, with the inner lock left held."""
    for mod in (locks, ref_locks):
        rec = mod.LockGraphRecorder()
        a = mod.make_lock("torch.a", recorder=rec)
        b = mod.make_lock("torch.b", recorder=rec)
        with a:
            with b:
                pass
        rec.clear()
        a.acquire()
        try:
            if mod is ref_locks:
                with pytest.raises(KeyError):
                    b.acquire()
                assert b.locked()
                b._inner.release()
                continue
            with b:
                pass
        finally:
            a.release()
        assert [(e["from"], e["to"], e["count"])
                for e in rec.edge_list()] == [("torch.a", "torch.b", 1)]


def test_rlock_under_condition():
    """A DebugRLock backs a Condition: wait releases every level and the
    held stack, notify wakes the waiter, and the stack balances after."""
    rec = locks.LockGraphRecorder()
    lock = locks.DebugRLock("torch.cv", rec)
    other = locks.make_lock("torch.other", recorder=rec)
    cond = threading.Condition(lock)
    woke, ready = [], threading.Event()

    def waiter():
        with cond:
            with cond:
                ready.set()
                woke.append(cond.wait(timeout=10))
                with other:
                    pass
    t = threading.Thread(target=waiter)
    t.start()
    ready.wait(10)
    with cond:  # taken only once the waiter waits
        cond.notify_all()
    t.join(10)
    assert woke == [True]
    assert [(e["from"], e["to"]) for e in rec.edge_list()] == \
        [("torch.cv", "torch.other")]
    assert rec._held() == [] and not lock._is_owned()


def test_factories_follow_the_switch(monkeypatch):
    import _thread
    monkeypatch.setenv("SW_LOCK_DEBUG", "0")
    assert isinstance(locks.make_lock("torch.x"), _thread.LockType)
    assert type(locks.make_rlock("torch.x")) is type(threading.RLock())
    monkeypatch.setenv("SW_LOCK_DEBUG", "1")
    assert isinstance(locks.make_lock("torch.x"), locks.DebugLock)
    assert isinstance(locks.make_rlock("torch.x"), locks.DebugRLock)
    with pytest.raises(ValueError, match="must start with 'torch.'"):
        locks.make_lock("volume.lock")


def test_port_stack_records_no_cycle(tmp_path, monkeypatch):
    """A write, an ec.encode and a GET through a lost shard on a port
    stack: the recorder saw nested port locks, only port names, and no
    cycle outside ALLOWED."""
    import random
    from test_torch_s3 import Stack, _lose_a_shard, _s3
    monkeypatch.setenv("SW_LOCK_DEBUG", "1")
    locks.RECORDER.clear()
    stack = Stack("port", tmp_path, chunk=1 << 20)
    try:
        objs = [(f"o{i}.bin", random.Random(i).randbytes(300 << 10))
                for i in range(8)]
        _s3(stack, "PUT", "/deg")
        for k, d in objs:
            assert _s3(stack, "PUT", f"/deg/{k}", d)[0] == 200
        _lose_a_shard(stack, objs)
        for k, d in objs:
            assert _s3(stack, "GET", f"/deg/{k}")[2] == d
    finally:
        stack.stop()
    edges = locks.RECORDER.edge_list()
    nodes = {n for e in edges for n in (e["from"], e["to"])}
    assert edges and {"torch.volume.lock", "torch.filer._lock"} & nodes
    assert all(n.startswith(locks.NAME_PREFIX) for n in nodes), nodes
    assert locks.RECORDER.cycles(allowed=locks.ALLOWED) == []


def test_process_dump_stays_out_of_the_jax_merge(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from seaweedfs_tpu_torch.util.locks import make_lock\n"
            "a, b = make_lock('torch.a'), make_lock('torch.b')\n"
            "with a:\n    with b:\n        pass\n") % str(ROOT)
    env = dict(os.environ, SW_LOCK_DEBUG="1", SW_LOCK_GRAPH_DIR=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    (dump,) = (tmp_path / locks.GRAPH_SUBDIR).glob("lockgraph-*.json")
    assert json.loads(dump.read_text())["edges"][0]["from"] == "torch.a"
    assert not list(tmp_path.glob("*.json"))
    assert ref_locks.load_graph_dir(str(tmp_path)) == []
    assert [(e["from"], e["to"]) for e in locks.load_graph_dir(
        str(tmp_path / locks.GRAPH_SUBDIR))] == [("torch.a", "torch.b")]


def _lock_calls(path):
    """(factory, first argument) of every lock made in ``path``, and the
    plain threading.Lock/RLock calls."""
    made, plain = [], []
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = getattr(fn, "attr", getattr(fn, "id", ""))
        if name in ("make_lock", "make_rlock") and node.args:
            made.append((name, node.args[0]))
        elif name in ("Lock", "RLock") and \
                getattr(getattr(fn, "value", None), "id", "") == "threading":
            plain.append(node.lineno)
    return made, plain


def test_every_port_lock_is_named_apart_from_jax():
    jax_names = set()
    for p in (ROOT / "seaweedfs_tpu").rglob("*.py"):
        for _, arg in _lock_calls(p)[0]:
            if isinstance(arg, ast.Constant):
                jax_names.add(arg.value)
    port_names = []
    for p in (ROOT / "seaweedfs_tpu_torch").rglob("*.py"):
        if "build" in p.relative_to(ROOT).parts or p.name == "locks.py":
            continue
        made, plain = _lock_calls(p)
        assert plain == [], f"{p}: plain locks at lines {plain}"
        for _, arg in made:
            assert isinstance(arg, ast.Constant), p
            port_names.append(arg.value)
    assert len(port_names) >= 63
    assert all(n.startswith("torch.") for n in port_names)
    assert not set(port_names) & jax_names
    # named for the JAX counterpart where there is one
    assert len({"torch." + n for n in jax_names} & set(port_names)) >= 52
