"""The port's replication against the JAX package's, on the CPU.

- One seeded script of filer operations (uploads of 0–5 KiB in 1 KiB
  chunks, an overwrite, renames within, out of and into the watched
  prefix, a directory, deletes, a recursive delete, writes outside the
  prefix) runs on a JAX stack and on a port stack (master, volume server,
  filer). Each package's ``EventSubscriber`` (``poll_once(advance=False)``,
  then ``commit`` once the batch is applied) feeds its ``Replicator``,
  which writes into a ``filer`` sink (another stack's filer) and an
  ``s3`` sink (that stack's S3 gateway). The replicator's actions,
  ``format_event`` of every event, and both sink trees (every path, kind,
  mime and byte) must be equal.
- The subscriber moves its cursor only on ``commit``, alike.
- ``azure_shared_key_signature`` on seeded inputs, and the requests an
  ``AzureSink`` sends (captured at ``urllib.request.urlopen`` under a
  fixed clock), must be equal; ``make_sink`` must build and refuse alike.
- ``format_event`` on every kind of event, ``FilerSource.matches`` and
  ``relative`` agree.

Tolerances: none (bytes and text compared exactly).
"""

import base64
import random
import time
import urllib.request

import pytest

import seaweedfs_tpu.replication as ref_rep
import seaweedfs_tpu.replication.sub as ref_sub
import seaweedfs_tpu_torch.replication as port_rep
import seaweedfs_tpu_torch.replication.sub as port_sub
from test_torch_filer_server import _stack, _stop
from test_torch_s3 import AK, SK, Stack

SEED = 20
PKGS = {"ref": (ref_rep, ref_sub), "port": (port_rep, port_sub)}


def _client(kind):
    if kind == "ref":
        from seaweedfs_tpu.filer.filer_client import FilerClient
        from seaweedfs_tpu.server import http_util
    else:
        from seaweedfs_tpu_torch.filer.filer_client import FilerClient
        from seaweedfs_tpu_torch.server import http_util
    return FilerClient, http_util


def _script(seed):
    rng = random.Random(seed)
    ops = []
    for i in range(6):
        ops.append(("put", f"/data/a/f{i}.bin", rng.randrange(0, 5000),
                    rng.choice(["application/octet-stream", "text/plain"])))
    ops += [("put", "/other/x.bin", 700, "text/plain"),
            ("put", "/data/a/f0.bin", 2600, "text/plain"),
            ("mv", "/data/a/f1.bin", "/data/b/g1.bin"),
            ("mv", "/data/a/f2.bin", "/other/out.bin"),
            ("mv", "/other/x.bin", "/data/in.bin"),
            ("mkdir", "/data/emptydir"),
            ("rm", "/data/a/f3.bin", False),
            ("put", "/data/c/d/deep.bin", 1500, "text/plain"),
            ("rm", "/data/c", True),
            ("put", "/data/a/f4.bin", 0, "application/octet-stream")]
    return ops


def _apply(kind, filer_url, i, op, seed):
    FilerClient, hu = _client(kind)
    fc = FilerClient(filer_url)
    if op[0] == "put":
        data = random.Random(seed * 1000 + i).randbytes(op[2])
        hu.post_multipart(f"http://{filer_url}{op[1]}",
                          op[1].rsplit("/", 1)[1], data, content_type=op[3])
    elif op[0] == "mv":
        fc.rename_entry(op[1], op[2])
    elif op[0] == "mkdir":
        fc.mkdir(op[1])
    else:
        fc.delete_entry(op[1], recursive=op[2],
                        ignore_recursive_error=op[2])


def _tree(kind, filer_url, path):
    """(path, is_dir, mime, bytes) of everything under ``path``."""
    FilerClient, hu = _client(kind)
    fc = FilerClient(filer_url)
    out = []
    for e in fc.list_entries(path, limit=10000):
        if e.is_directory:
            out.append((e.full_path, True, "", b""))
            out += _tree(kind, filer_url, e.full_path)
        else:
            out.append((e.full_path, False, e.attr.mime,
                        hu.http_call("GET", f"http://{filer_url}"
                                     f"{e.full_path}")))
    return out


def _drain(sub, reps, events):
    actions = []
    while True:
        batch = sub.poll_once(advance=False)
        if not batch:
            return actions
        for e in batch:
            events.append(e["event"])
            actions.append([r.replicate(e["event"]) for r in reps])
        sub.commit(batch)


@pytest.fixture
def stacks(tmp_path):
    made = {}
    try:
        for kind in ("ref", "port"):
            (tmp_path / kind).mkdir()
            made[kind] = (_stack(kind, tmp_path / kind / "src"),
                          Stack(kind, tmp_path / kind))
        yield made
    finally:
        for src, dst in made.values():
            dst.stop()
            _stop(src)


def test_replication_script_matches_jax(stacks):
    ops = _script(SEED)
    got = {}
    for kind, (rep, sub_mod) in PKGS.items():
        src, dst = stacks[kind]
        master, _, filer = src
        dst.filer.filer.create_bucket("rep")
        source = rep.FilerSource(filer.url, master.url, path_prefix="/data")
        sinks = [rep.make_sink({"type": "filer", "filer_url": dst.filer.url,
                                "target_dir": "/mirror"}),
                 rep.make_sink({"type": "s3", "endpoint":
                                f"http://{dst.s3.url}", "bucket": "rep",
                                "access_key": AK, "secret_key": SK,
                                "directory": "backup"})]
        reps = [rep.Replicator(source, s) for s in sinks]
        sub = rep.EventSubscriber(filer.url, poll_timeout=0.3,
                                  path_prefix="/data")
        events, actions = [], []
        for i, op in enumerate(ops):
            # a live replicator: each change is applied before the next
            # one can delete the chunks it reads
            _apply(kind, filer.url, i, op, SEED)
            actions += _drain(sub, reps, events)
        got[kind] = {
            "actions": actions,
            "lines": [sub_mod.format_event(float(i), e)
                      for i, e in enumerate(events)],
            "filer_sink": _tree(kind, dst.filer.url, "/mirror"),
            "s3_sink": [(p, d, b) for p, d, _, b in
                        _tree(kind, dst.filer.url, "/buckets/rep")],
            "source": _tree(kind, filer.url, "/data"),
        }
    assert got["port"] == got["ref"]
    ref = got["ref"]
    assert {"create", "update", "delete"} <= {a for a, _ in ref["actions"]}
    # the sinks hold what the source holds under /data
    src_files = {p[len("/data"):]: b for p, d, _, b in ref["source"]
                 if not d}
    assert {p[len("/mirror"):]: b for p, d, _, b in ref["filer_sink"]
            if not d} == src_files
    assert {p[len("/buckets/rep/backup"):]: b for p, d, b in ref["s3_sink"]
            if not d} == src_files
    assert len(src_files) >= 5


def test_subscriber_commits_only_after_apply_like_jax(stacks):
    got = {}
    for kind, (rep, _) in PKGS.items():
        _, _, filer = stacks[kind][0]
        _, hu = _client(kind)
        sub = rep.EventSubscriber(filer.url, poll_timeout=0.3)
        hu.post_multipart(f"http://{filer.url}/c/f.txt", "f.txt", b"x")
        batch = sub.poll_once(advance=False)
        again = sub.poll_once(advance=False)
        held = sub.since
        sub.commit(batch)
        after = sub.poll_once()
        got[kind] = (len(batch), held, [e["ts"] for e in again] ==
                     [e["ts"] for e in batch],
                     sub.since == max(e["ts"] for e in batch), after)
    assert got["port"] == got["ref"] == (2, 0.0, True, True, [])


def test_azure_signature_and_sink_requests_match_jax(monkeypatch):
    rng = random.Random(SEED)
    for _ in range(40):
        key = base64.b64encode(rng.randbytes(32)).decode()
        headers = {"x-ms-date": f"Sun, 18 Oct 2026 0{rng.randrange(10)}:00:00 GMT",
                   "x-ms-version": "2020-10-02"}
        if rng.random() < 0.5:
            headers["content-length"] = rng.choice(["0", "17", 0])
        if rng.random() < 0.5:
            headers["content-type"] = "text/plain"
        if rng.random() < 0.3:
            headers["x-ms-blob-type"] = "BlockBlob"
        query = {"comp": "block", "blockid": "QUJD"} \
            if rng.random() < 0.3 else {}
        args = ("acct", key, rng.choice(["PUT", "delete", "GET"]),
                f"/c/dir/b{rng.randrange(99)}.bin", headers, query)
        assert port_rep.sink.azure_shared_key_signature(*args) == \
            ref_rep.sink.azure_shared_key_signature(*args)

    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)
    seen = []

    def urlopen(req, *a, **kw):
        data = req.data.read() if hasattr(req.data, "read") else req.data
        seen.append((req.get_method(), req.full_url,
                     sorted((k.lower(), v) for k, v in req.header_items()),
                     data))
        raise OSError("no azure here")
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    got = {}
    for kind, (rep, _) in PKGS.items():
        seen.clear()
        errs = []
        for endpoint in ("http://127.0.0.1:1", "http://127.0.0.1:1/acct"):
            sink = rep.make_sink({
                "type": "azure", "account": "acct",
                "account_key": base64.b64encode(b"topsecret").decode(),
                "container": "backup", "directory": "mirror",
                "endpoint": endpoint})
            for call in (lambda: sink.create_entry(
                    "/docs/a b.bin", {"Mime": "text/plain"}, b"azure"),
                    lambda: sink.create_entry("/d", {"IsDirectory": True},
                                              b""),
                    lambda: sink.delete_entry("/docs/a b.bin", False)):
                try:
                    call()
                    errs.append("ok")
                except Exception as e:  # noqa: BLE001 - compared
                    errs.append((type(e).__name__, str(e),
                                 getattr(e, "status", None)))
        got[kind] = (list(seen), errs)
    assert got["port"] == got["ref"]
    assert len(got["ref"][0]) == 4


SINK_CONFIGS = [
    {"type": "ftp"},
    {"type": "azure"},
    {"type": "s3", "endpoint": "http://127.0.0.1:1", "bucket": "b",
     "directory": "/x/"},
    {"type": "s3"},
    {"type": "gcs", "bucket": "g"},
    {"type": "b2", "bucket": "b", "region": "eu-central-003"},
    {"type": "filer", "filer_url": "127.0.0.1:1", "target_dir": "m/"},
    {"type": "filer", "filer_url": "127.0.0.1:1", "bogus": 1},
    {},
]


@pytest.mark.parametrize("i", range(len(SINK_CONFIGS)))
def test_make_sink_matches_jax(i):
    got = []
    for rep in (ref_rep, port_rep):
        try:
            s = rep.make_sink(dict(SINK_CONFIGS[i]))
            d = {k: v for k, v in vars(s).items()
                 if isinstance(v, (str, int))}
            inner = getattr(s, "s3", None)
            if inner is not None:
                d.update({f"s3.{k}": v for k, v in vars(inner).items()
                          if isinstance(v, (str, int))})
            got.append((s.kind, type(s).__name__, d))
        except rep.SinkError as e:
            got.append(("SinkError", str(e), e.status))
    assert got[0] == got[1]


def test_format_event_and_source_paths_match_jax():
    events = [({"newEntry": {"FullPath": "/a/b"}, "oldEntry": None}, 12.5),
              ({"oldEntry": {"FullPath": "/a/b"}}, 1.0),
              ({"oldEntry": {"FullPath": "/a/b"},
                "newEntry": {"FullPath": "/a/b"}}, 1_760_000_000.123456),
              ({"oldEntry": {"FullPath": "/a/b"},
                "newEntry": {"FullPath": "/c/d"}}, 3.0),
              ({}, 0.0), ({"newEntry": {}}, 2.0)]
    for ev, ts in events:
        assert port_sub.format_event(ts, ev) == ref_sub.format_event(ts, ev)
    for prefix in ("/", "/data", "/data/"):
        srcs = [rep.FilerSource("127.0.0.1:1", "127.0.0.1:1", prefix)
                for rep in (ref_rep, port_rep)]
        for path in ("/data", "/data/x", "/datax", "/other/y", "/"):
            assert srcs[1].matches(path) == srcs[0].matches(path)
            assert srcs[1].relative(path) == srcs[0].relative(path)
    assert port_rep.source.SPOOL_MAX_BYTES == ref_rep.source.SPOOL_MAX_BYTES
