"""The port's filer metadata layer against the JAX package's, on the CPU.

- A seeded script of creates (files with overlapping chunk lists,
  directories, nested paths), updates, renames of files and of
  subtrees, plain and recursive deletes, overwrites and bucket
  operations runs on both packages' ``Filer`` over each of the memory,
  sqlite and sharded stores, with one fixed clock for both. After every
  step the raised error (its class name and text), and at the end every
  listing (in pages), every entry's stored bytes and wire JSON, the
  events the ``on_update`` hooks saw (as ``event_notification`` builds
  them) and the deletion queue must be equal.
- ``non_overlapping_visible_intervals``, ``view_from_chunks``,
  ``compact_file_chunks``, ``minus_chunks``, ``total_size`` and
  ``etag`` agree on seeded overlapping chunk lists.
- A sqlite file and a sharded store directory written by one package
  open in the other with every entry equal, in both directions.
- Chunk blobs sealed (AES-256-GCM) or gzipped by one package open
  through the other's ``read_chunked``, in both directions; the LogBuffer
  hands out the same events.
- A network store whose server is not there raises at once; an unknown
  kind raises, naming it.

Tolerances: none (bytes and JSON compared exactly).
"""

import json
import posixpath
import random
import threading
import time

import pytest

SEED = 18
STORES = ("memory", "sqlite", "sharded")


def _pkgs():
    import seaweedfs_tpu.filer.entry as r_entry
    import seaweedfs_tpu.filer.filechunks as r_fc
    import seaweedfs_tpu.filer.filer as r_filer
    import seaweedfs_tpu.filer.filerstore as r_store
    import seaweedfs_tpu.filer.log_buffer as r_log
    import seaweedfs_tpu.filer.stream as r_stream
    import seaweedfs_tpu_torch.filer.entry as p_entry
    import seaweedfs_tpu_torch.filer.filechunks as p_fc
    import seaweedfs_tpu_torch.filer.filer as p_filer
    import seaweedfs_tpu_torch.filer.filerstore as p_store
    import seaweedfs_tpu_torch.filer.log_buffer as p_log
    import seaweedfs_tpu_torch.filer.stream as p_stream
    return {"ref": (r_entry, r_fc, r_filer, r_store, r_log, r_stream),
            "port": (p_entry, p_fc, p_filer, p_store, p_log, p_stream)}


@pytest.fixture
def fixed_clock(monkeypatch):
    """One clock for both packages: each call from the test's own thread
    moves it on by 1 ms; a call from any other thread (a server loop an
    earlier test left running in this process) reads it unmoved."""
    state = {"t": 1_760_000_000.0}
    owner = threading.get_ident()

    def now():
        if threading.get_ident() == owner:
            state["t"] += 0.001
        return state["t"]
    monkeypatch.setattr(time, "time", now)
    monkeypatch.setattr(time, "time_ns", lambda: int(now() * 1e9))
    return state


def _store_options(kind, root, name):
    if kind == "sqlite":
        return {"path": str(root / f"{name}.db")}
    if kind == "sharded":
        return {"path": str(root / name), "shards": 4}
    return {}


def _chunks(entry_mod, rng, n, base_mtime):
    out = []
    for i in range(n):
        off = rng.randrange(0, 4096)
        out.append(entry_mod.FileChunk(
            fid=f"{rng.randrange(1, 9)},{rng.getrandbits(40):x}",
            offset=off, size=rng.randrange(1, 2048),
            mtime=base_mtime + rng.randrange(0, 50),
            etag=f"{rng.getrandbits(64):016x}"))
    return out


def _script(seed, n_steps=140):
    """Operations as plain tuples, so both packages replay the same."""
    rng = random.Random(seed)
    dirs = ["/a", "/a/b", "/a/b/c", "/d", "/buckets/x", "/e/f"]
    names = ["f1", "f2", "g.txt", "h"]
    ops = []
    for step in range(n_steps):
        kind = rng.choice(["file", "file", "file", "dir", "update",
                           "rename", "delete", "delete_r", "bucket",
                           "overwrite"])
        d = rng.choice(dirs)
        path = posixpath.join(d, rng.choice(names))
        if kind == "file":
            ops.append(("file", path, rng.randrange(1 << 30),
                        rng.randrange(1, 5)))
        elif kind == "overwrite":
            ops.append(("file", path, rng.randrange(1 << 30), 1))
        elif kind == "dir":
            ops.append(("dir", posixpath.join(d, f"sub{step % 3}")))
        elif kind == "update":
            ops.append(("update", path, f"text/x-{step}"))
        elif kind == "rename":
            src = rng.choice([path, d])
            ops.append(("rename", src,
                        posixpath.join(rng.choice(dirs), f"mv{step}")))
        elif kind == "delete":
            ops.append(("delete", rng.choice([path, d]), False))
        elif kind == "delete_r":
            ops.append(("delete", d, True))
        else:
            ops.append(("bucket", rng.choice(["create", "delete"]),
                        f"bk{step % 2}"))
    return ops


def _replay(pkg, kind, root, ops):
    entry_mod, _, filer_mod, store_mod, log_mod, _ = pkg
    name = entry_mod.__name__.split(".")[0]
    store = store_mod.make_store(kind, **_store_options(kind, root, name))
    f = filer_mod.Filer(store)
    events = []
    buf = log_mod.LogBuffer()
    f.on_update(lambda o, n, dc: events.append(
        log_mod.event_notification(o, n, dc)))
    f.on_update(lambda o, n, dc: buf.append(
        log_mod.event_notification(o, n, dc)))
    errors = []
    for op in ops:
        try:
            if op[0] == "file":
                _, path, seed, n = op
                rng = random.Random(seed)
                now = time.time()
                attr = entry_mod.Attr(mtime=now, crtime=now,
                                      mime="application/octet-stream",
                                      md5=f"{seed:032x}")
                f.create_entry(entry_mod.Entry(
                    full_path=path, attr=attr,
                    chunks=_chunks(entry_mod, rng, n, seed)))
            elif op[0] == "dir":
                f.create_entry(entry_mod.new_dir_entry(op[1]))
            elif op[0] == "update":
                e = f.find_entry(op[1])
                e.attr.mime = op[2]
                f.update_entry(e)
            elif op[0] == "rename":
                f.rename_entry(op[1], op[2])
            elif op[0] == "delete":
                f.delete_entry(op[1], recursive=op[2])
            elif op[1] == "create":
                f.create_bucket(op[2])
            else:
                f.delete_bucket(op[2])
            errors.append(None)
        except Exception as e:  # noqa: BLE001 - compared across packages
            errors.append((type(e).__name__, str(e)))
    tree = _walk(f, entry_mod, "/")
    out = {"errors": errors, "tree": tree, "events": events,
           "log": [e for _, e in buf.read_since(0, limit=1 << 20)],
           "queue": f.drain_deletion_queue(),
           "buckets": [b.full_path for b in f.list_buckets()]}
    store.close()
    return out


def _walk(f, entry_mod, path, page=3):
    """Every entry under ``path``: its stored bytes and its wire JSON,
    listed in pages of ``page`` (the store's pagination exercised)."""
    out = []
    start = ""
    while True:
        batch = f.list_entries(path, start, False, page)
        for e in batch:
            out.append((e.full_path, e.encode(),
                        json.dumps(entry_mod.entry_to_wire(e))))
            if e.is_directory:
                out.extend(_walk(f, entry_mod, e.full_path, page))
        if len(batch) < page:
            return out
        start = batch[-1].name


def _check_script(tmp_path, fixed_clock, kind):
    ops = _script(SEED + STORES.index(kind))
    got = {}
    for name, pkg in _pkgs().items():
        fixed_clock["t"] = 1_760_000_000.0
        got[name] = _replay(pkg, kind, tmp_path, ops)
    ref, port = got["ref"], got["port"]
    assert sum(e is None for e in ref["errors"]) > len(ops) // 2
    assert any(e is not None for e in ref["errors"])
    for key in ("errors", "tree", "events", "log", "queue", "buckets"):
        assert port[key] == ref[key], key
    assert len(ref["tree"]) > 10 and ref["queue"]


@pytest.mark.parametrize("kind", STORES)
def test_filer_script_matches_jax(tmp_path, fixed_clock, kind):
    _check_script(tmp_path, fixed_clock, kind)


@pytest.mark.parametrize("kind", STORES)
def test_filer_script_ignores_foreign_clock_reads(tmp_path, fixed_clock,
                                                  kind):
    """A thread of someone else's (a server loop an earlier test left
    running) that reads the clock during the replay moves nothing."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            time.time()
            time.time_ns()
    spinner = threading.Thread(target=spin, daemon=True)
    spinner.start()
    try:
        _check_script(tmp_path, fixed_clock, kind)
    finally:
        stop.set()
        spinner.join(5)
    assert not spinner.is_alive()


def test_wire_json_byte_equal():
    pk = _pkgs()
    r_entry, p_entry = pk["ref"][0], pk["port"][0]
    rng = random.Random(SEED)
    for i in range(20):
        kw = dict(mtime=rng.random() * 1e9, crtime=rng.random() * 1e9,
                  mode=rng.choice([0o660, 0o40777, 0o104755]),
                  uid=i, gid=2 * i, mime="text/plain", replication="001",
                  collection="c", ttl_sec=60 * i, user_name="u",
                  md5=f"{i:032x}", symlink_target="/t" if i % 3 else "")
        chunks = [dict(fid=f"3,{j:x}", offset=100 * j, size=100,
                       mtime=j, etag="e", cipher_key=bytes([j]) * 32
                       if i % 2 else b"", is_compressed=bool(i % 4))
                  for j in range(i % 4)]
        ext = {"k": b"v" * i} if i % 5 else {}
        entries = [
            m.Entry(full_path=f"/x/y{i}", attr=m.Attr(**kw),
                    chunks=[m.FileChunk(**c) for c in chunks],
                    extended=dict(ext))
            for m in (r_entry, p_entry)]
        wires = [json.dumps(m.entry_to_wire(e))
                 for m, e in zip((r_entry, p_entry), entries)]
        assert wires[0] == wires[1]
        assert entries[0].encode() == entries[1].encode()
        back = p_entry.entry_from_wire(json.loads(wires[0]))
        assert back.encode() == r_entry.entry_from_wire(
            json.loads(wires[0])).encode()
        assert p_entry.Entry.decode("/x", entries[0].encode()).encode() \
            == entries[1].encode().replace(b'/x/y%d"' % i, b'/x"')
    d = [m.new_dir_entry("/q/r", now=5.0) for m in (r_entry, p_entry)]
    assert d[0].encode() == d[1].encode()


def test_filechunks_match_jax():
    pk = _pkgs()
    (r_entry, r_fc), (p_entry, p_fc) = pk["ref"][:2], pk["port"][:2]
    rng = random.Random(SEED)
    for case in range(60):
        n = rng.randrange(1, 9)
        # offsets and sizes on a coarse grid, so chunk edges coincide
        spec = [(f"{rng.randrange(1, 4)},{k:x}",
                 rng.randrange(0, 12) * 50,
                 rng.randrange(1, 7) * 50 + rng.choice([0, 7]),
                 rng.randrange(0, 5),
                 f"e{k}", bytes([k]) * 32 if k % 3 == 0 else b"",
                 k % 4 == 1)
                for k in range(n)]
        ref = [r_entry.FileChunk(*s) for s in spec]
        port = [p_entry.FileChunk(*s) for s in spec]

        def fields(xs):
            return [tuple(vars(x).values()) for x in xs]
        assert fields(p_fc.non_overlapping_visible_intervals(port)) == \
            fields(r_fc.non_overlapping_visible_intervals(ref))
        off = rng.randrange(0, 700)
        size = rng.choice([-1, rng.randrange(0, 500)])
        assert fields(p_fc.view_from_chunks(port, off, size)) == \
            fields(r_fc.view_from_chunks(ref, off, size))
        pc, pg = p_fc.compact_file_chunks(port)
        rc, rg = r_fc.compact_file_chunks(ref)
        assert (fields(pc), fields(pg)) == (fields(rc), fields(rg))
        assert fields(p_fc.minus_chunks(port, pc)) == \
            fields(r_fc.minus_chunks(ref, rc))
        # the same fid and offset at another size is another chunk
        resized = [(f, o, sz + 1, *rest) for f, o, sz, *rest in spec[:2]]
        assert fields(p_fc.minus_chunks(
            port, [p_entry.FileChunk(*r) for r in resized])) == \
            fields(r_fc.minus_chunks(
                ref, [r_entry.FileChunk(*r) for r in resized]))
        assert p_fc.total_size(port) == r_fc.total_size(ref)
        assert p_fc.etag(port) == r_fc.etag(ref)


def _fill(pkg, kind, path, n=40):
    entry_mod, _, filer_mod, store_mod = pkg[:4]
    store = store_mod.make_store(kind, **(
        {"path": path} if kind == "sqlite" else {"path": path,
                                                 "shards": 5}))
    f = filer_mod.Filer(store)
    rng = random.Random(SEED)
    for i in range(n):
        d = f"/t/{rng.choice('abc')}/{rng.choice('xy')}"
        f.create_entry(entry_mod.Entry(
            full_path=f"{d}/n{i}",
            attr=entry_mod.Attr(mtime=i, crtime=i, md5=f"{i:032x}"),
            chunks=_chunks(entry_mod, rng, 2, i)))
    f.create_bucket("carried")
    tree = _walk(f, entry_mod, "/")
    store.close()
    return tree


def _open_tree(pkg, kind, path):
    entry_mod, _, filer_mod, store_mod = pkg[:4]
    store = store_mod.make_store(kind, **(
        {"path": path} if kind == "sqlite" else {"path": path}))
    tree = _walk(filer_mod.Filer(store), entry_mod, "/")
    store.close()
    return tree


@pytest.mark.parametrize("kind", ("sqlite", "sharded"))
@pytest.mark.parametrize("writer", ("ref", "port"))
def test_store_files_carry_across(tmp_path, kind, writer):
    """A store one package wrote opens in the other, every entry equal
    (the sharded store's shard count comes from its SHARDS marker)."""
    pk = _pkgs()
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / ("meta.db" if kind == "sqlite" else "meta"))
    written = _fill(pk[writer], kind, path)
    assert len(written) > 40
    assert _open_tree(pk[reader], kind, path) == written
    if kind == "sharded":
        assert (tmp_path / "meta" / "SHARDS").read_text() == "5"


@pytest.mark.parametrize("sealer", ("ref", "port"))
def test_sealed_and_gzipped_chunks_carry_across(sealer):
    """Blobs sealed or gzipped by one package read back through the
    other's ``read_chunked`` (a whole-blob fetch, then the view's
    slice), and the raw blobs open both ways."""
    from seaweedfs_tpu.util import cipher as r_cipher
    from seaweedfs_tpu.util import compression as r_gz
    from seaweedfs_tpu_torch.util import cipher as p_cipher
    from seaweedfs_tpu_torch.util import compression as p_gz
    seal = {"ref": (r_cipher, r_gz), "port": (p_cipher, p_gz)}
    opener = "port" if sealer == "ref" else "ref"
    cipher, gz = seal[sealer]
    rng = random.Random(SEED)
    plain = [bytes(rng.getrandbits(8) for _ in range(3000)),
             b"the quick brown fox " * 200,
             b"sealed and gzipped " * 150]
    blobs, specs = {}, []
    off = 0
    for i, p in enumerate(plain):
        blob, key, zipped = p, b"", False
        if i >= 1:
            blob, zipped = gz.gzip_data(p), True
        if i != 1:
            blob, key = cipher.encrypt(blob)
        blobs[f"1,{i:x}"] = blob
        specs.append((f"1,{i:x}", off, len(p), i, "", key, zipped))
        off += len(p)
    o_cipher, o_gz = seal[opener]
    assert o_cipher.decrypt(blobs["1,0"], specs[0][5]) == plain[0]
    assert o_gz.gunzip_data(blobs["1,1"]) == plain[1]
    assert gz.gzip_data(plain[1]) == o_gz.gzip_data(plain[1])
    assert o_gz.is_compressible("a.txt") and \
        not o_gz.is_compressible("a.jpg", "text/plain")

    def fetch(fid, offset, size):
        b = blobs[fid]
        return b if size < 0 else b[offset:offset + size]
    pk = _pkgs()[opener]
    chunks = [pk[0].FileChunk(*s) for s in specs]
    whole = b"".join(plain)
    assert pk[5].read_chunked(chunks, 0, -1, fetch) == whole
    assert pk[5].read_chunked(chunks, 2900, 4000, fetch) == \
        whole[2900:6900]
    wrong = pk[0].FileChunk(*(specs[0][:5] + (bytes(32), False)))
    with pytest.raises(Exception, match="decryption failed"):
        pk[5].read_chunked([wrong], 0, -1, fetch)


def test_log_buffer_matches_jax():
    pk = _pkgs()
    bufs = [pk[k][4].LogBuffer() for k in ("ref", "port")]
    for i in range(30):
        for b in bufs:
            b.append({"i": i}, ts=float(i // 3))
    for ts, limit in ((-1, 1024), (2.0, 4), (5.0, 1), (9.0, 10)):
        assert bufs[1].read_since(ts, limit) == bufs[0].read_since(ts, limit)
    assert bufs[1].wait_since(100.0, timeout=0.01) == []
    for b in bufs:
        b.close()
    ev = [pk[k][4].encode_event_line({"a": [1, 2], "b": None})
          for k in ("ref", "port")]
    assert ev[0] == ev[1]


@pytest.mark.parametrize("kind", ("redis", "mysql", "postgres", "cassandra",
                                  "etcd"))
def test_unported_store_raises(kind):
    """A network store is registered and fails fast when its server is
    not there, as the JAX one does; a kind neither package has raises,
    naming it."""
    import socket
    from seaweedfs_tpu_torch.filer.etcd_store import EtcdError
    from seaweedfs_tpu_torch.filer.filerstore import STORES, make_store
    with pytest.raises(ValueError, match="unknown filer store 'leveldb'"):
        make_store("leveldb")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises((OSError, EtcdError)):
        make_store(kind, addr=f"127.0.0.1:{port}")
    assert STORES[kind].name == kind


def test_cipher_without_libcrypto_raises(monkeypatch):
    """One path: no libcrypto, no sealing (never plaintext in its place)."""
    import ctypes.util
    from seaweedfs_tpu_torch.util import cipher
    monkeypatch.setattr(cipher, "_lib", None)
    monkeypatch.setattr(ctypes.util, "find_library",
                        lambda name: "libcrypto-missing.so.0")
    with pytest.raises(cipher.CipherError, match="libcrypto not found"):
        cipher.encrypt(b"secret")
    with pytest.raises(cipher.CipherError, match="libcrypto not found"):
        cipher.decrypt(bytes(64), bytes(32))
