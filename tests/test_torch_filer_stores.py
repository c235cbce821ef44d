"""The port's network filer stores (filer/{redis,mysql,postgres,
cassandra}_store and etcd_store's ``EtcdStore``) against the JAX
package's.

- ``TestStores``' script (``tests/test_filer.py``: a round trip with
  chunks and extended attributes, a miss, paged listings inclusive and
  not, a recursive child delete, ``_`` and ``%`` in paths) runs on each
  package's store of each kind, each against a fresh fake of its own
  (``FakeRedis``, ``FakeMysql``, ``FakePostgres``, ``FakeCassandra``,
  ``FakeEtcd``: the real wire protocols): every reply is equal, and the
  two fakes end in equal state.
- ``filer -store redis`` and ``filer -store postgres`` start through the
  port CLI's parser over a fake, and an entry created through the filer
  lands in it.

Tolerances: none (entries compared by their encoded bytes).
"""

import types

import pytest

from test_filer import (FakeCassandra, FakeEtcd, FakeMysql, FakePostgres,
                        FakeRedis)

FAKES = {"redis": FakeRedis, "mysql": FakeMysql, "postgres": FakePostgres,
         "cassandra": FakeCassandra, "etcd": FakeEtcd}


def _state(kind, fake):
    """What a fake holds: the keys and sorted sets, or the rows."""
    with fake.lock:
        if kind == "redis":
            return dict(fake.kv), {k: sorted(v.items()) if isinstance(
                v, dict) else sorted(v) for k, v in fake.zsets.items()}
        if kind == "etcd":
            return dict(fake.kv)
        return dict(fake.rows)


def _stop(fake):
    if isinstance(fake, FakeEtcd):
        fake.httpd.shutdown()
        fake.httpd.server_close()
    else:
        fake.stop()


def _store(pkg, kind, fake):
    from importlib import import_module
    filer = import_module(f"{pkg}.filer.filerstore")
    import_module(f"{pkg}.filer")  # the JAX stores register on import
    opts = {"addr": f"127.0.0.1:{fake.port}"}
    if kind != "redis":
        opts.update(user=fake.USER, password=fake.PASSWORD)
    return filer.make_store(kind, **opts)


def _script(store, entry_mod):
    """TestStores' four tests in one run; returns every reply."""
    Entry, Attr, FileChunk = entry_mod.Entry, entry_mod.Attr, \
        entry_mod.FileChunk
    out = []

    def found(path):
        e = store.find_entry(path)
        out.append(("find", path, None if e is None else
                    (e.full_path, e.encode())))

    def listed(*args):
        out.append(("list", args, [(e.full_path, e.encode()) for e in
                                   store.list_directory_entries(*args)]))
    e = Entry(full_path="/home/file.txt",
              attr=Attr(mtime=123.0, mime="text/plain"),
              chunks=[FileChunk(fid="3,01ab", offset=0, size=10, mtime=5)],
              extended={"user.k": b"\x01\x02"})
    store.insert_entry(e)
    found("/home/file.txt")
    found("/nope")
    for name in "abcd":
        store.insert_entry(Entry(full_path=f"/dir/{name}"))
    listed("/dir", "", False, 2)
    listed("/dir", "b", False, 10)
    listed("/dir", "b", True, 10)
    e.attr.mime = "application/octet-stream"
    store.update_entry(e)
    found("/home/file.txt")
    for p in ("/x/a", "/x/sub/b", "/y/c"):
        store.insert_entry(Entry(full_path=p))
    store.delete_folder_children("/x")
    for p in ("/x/a", "/x/sub/b", "/y/c"):
        found(p)
    store.insert_entry(Entry(full_path="/a_b/keepme-not"))
    store.insert_entry(Entry(full_path="/axb/keep"))
    store.delete_folder_children("/a_b")
    found("/a_b/keepme-not")
    found("/axb/keep")
    store.delete_entry("/dir/c")
    listed("/dir", "", True, 0)
    listed("/", "", False, 100)
    return out


@pytest.mark.parametrize("kind", sorted(FAKES))
def test_store_script_matches_jax(kind, monkeypatch):
    from seaweedfs_tpu.filer import entry as ref_entry
    from seaweedfs_tpu_torch.filer import entry as port_entry
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.0)
    replies, states = {}, {}
    for pkg, entry_mod in (("seaweedfs_tpu", ref_entry),
                           ("seaweedfs_tpu_torch", port_entry)):
        # directory markers take their times from the clock
        monkeypatch.setattr(entry_mod, "time", clock)
        fake = FAKES[kind]()
        store = _store(pkg, kind, fake)
        try:
            replies[pkg] = _script(store, entry_mod)
            states[pkg] = _state(kind, fake)
        finally:
            store.close()
            _stop(fake)
    assert type(store).__module__ == f"seaweedfs_tpu_torch.filer.{kind}_store"
    assert replies["seaweedfs_tpu_torch"] == replies["seaweedfs_tpu"]
    assert states["seaweedfs_tpu_torch"] == states["seaweedfs_tpu"]
    assert states["seaweedfs_tpu"]  # the script left entries behind


@pytest.mark.parametrize("kind, flags", [
    ("redis", lambda fake: ["-redisAddr", f"127.0.0.1:{fake.port}"]),
    ("postgres", lambda fake: ["-postgresAddr", f"127.0.0.1:{fake.port}",
                               "-postgresUser", fake.USER,
                               "-postgresPassword", fake.PASSWORD])])
def test_filer_cli_on_a_network_store(kind, flags, monkeypatch):
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    from seaweedfs_tpu_torch.filer.filer_client import FilerClient
    fake = FAKES[kind]()
    started = []
    monkeypatch.setattr(cli, "_wait", lambda *servers: started.extend(
        servers))
    cli.main(["filer", "-store", kind, "-port", "0", "-master",
              "127.0.0.1:1"] + flags(fake))
    (f,) = started
    try:
        assert type(f.filer.store).__name__ == \
            {"redis": "RedisStore", "postgres": "PostgresStore"}[kind]
        client = FilerClient(f.url)
        client.create_entry(Entry(full_path="/docs/a.txt",
                                  attr=Attr(mtime=1.0, mime="text/plain")))
        got = client.find_entry("/docs/a.txt")
        assert got.attr.mime == "text/plain"
        assert [e.name for e in client.list_entries("/docs")] == ["a.txt"]
        assert "a.txt" in repr(_state(kind, fake))
    finally:
        f.stop()
        _stop(fake)
