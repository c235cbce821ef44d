"""The port's message broker and its shell's fs.* and bucket.* commands
against the JAX package's, on the CPU.

- Broker: one request script over HTTP on both packages' ``MsgBrokerServer``
  (status, publishes with ``X-Queue-*`` headers and an empty body, topics,
  subscribes from 0, from a position, drained with a short timeout, a
  missing topic, a publish without a topic, deletes, the topic cap),
  with the broker module's clock stepping 1 ms a call in both; and the
  same ``QueueClient`` script. Statuses and bodies must be equal.
- Shell: each package runs a master, a volume server and a filer (1 KiB
  chunks) holding the same files, and one shell script (``fs.pwd``,
  ``fs.ls`` with ``-l``, ``fs.cd``, ``fs.cat`` of text and of binary,
  ``fs.du``, ``fs.tree``, ``fs.mkdir``, ``fs.mv``, ``fs.rm`` with and
  without ``-r``, ``fs.meta.cat``, ``fs.meta.save``, ``fs.meta.load``,
  ``fs.meta.notify``, ``bucket.list``, ``bucket.create``,
  ``bucket.delete``, their usage lines and errors, and a shell with no
  filer). The output must be equal once file ids, times and the stack's
  urls are normalized, and so must the saved metadata files.

Tolerances: none.
"""

import http.client
import io
import re
import types

import pytest

from test_torch_filer_server import _stack, _stop


def _broker_mod(kind):
    if kind == "ref":
        import seaweedfs_tpu.server.msg_broker as mb
    else:
        import seaweedfs_tpu_torch.server.msg_broker as mb
    return mb


@pytest.fixture
def broker_clock(monkeypatch):
    state = {"t": 1_760_000_000.0}

    def now():
        state["t"] += 0.001
        return state["t"]
    fake = types.SimpleNamespace(time=now)
    for kind in ("ref", "port"):
        monkeypatch.setattr(_broker_mod(kind), "time", fake)
    return state


def _req(url, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(url, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def test_broker_script_matches_jax(broker_clock):
    got = {}
    for kind in ("ref", "port"):
        broker_clock["t"] = 1_760_000_000.0
        b = _broker_mod(kind).MsgBrokerServer(port=0, max_topics=2).start()
        out = []
        try:
            def r(*a, **kw):
                out.append(_req(b.url, *a, **kw))
            r("GET", "/queue/status")
            r("POST", "/queue/publish?topic=t1", b"one",
              {"X-Queue-Source": "test", "X-Queue-Kind": "a",
               "X-Other": "no"})
            r("POST", "/queue/publish?topic=t1", b"")
            r("POST", "/queue/publish?topic=t1", bytes(range(256)))
            r("GET", "/queue/topics")
            r("GET", "/queue/subscribe?topic=t1&since=0")
            r("GET", "/queue/subscribe?topic=t1&since=1760000000.001")
            r("GET", "/queue/subscribe?topic=t1&since=1760000000.003"
                     "&timeout=0.1")
            r("GET", "/queue/subscribe?topic=none")
            r("GET", "/queue/subscribe")
            r("POST", "/queue/publish", b"x")
            r("POST", "/queue/publish?topic=t2", b"two")
            r("POST", "/queue/publish?topic=t3", b"three")
            r("GET", "/queue/status")
            r("POST", "/queue/delete?topic=t1")
            r("POST", "/queue/delete?topic=t1")
            r("GET", "/queue/subscribe?topic=t1")
            r("GET", "/queue/topics")
            mb = _broker_mod(kind)
            c = mb.QueueClient(b.url)
            c.publish("q", b"msg-one", source="test")
            c.publish("q", b"msg-two")
            out.append(c.poll("q"))
            out.append(c.poll("q", timeout=0.1))
            c.publish("q", b"msg-three")
            out.append(c.poll("q"))
            out.append(dict(c.cursors))
        finally:
            b.stop()
        got[kind] = out
    assert got["port"] == got["ref"]
    assert got["ref"][-2] == [(b"msg-three", {})]


FILES = {"/docs/a.txt": b"alpha-content",
         "/docs/sub/b.txt": b"bb" * 1000,
         "/docs/bin.dat": bytes(range(256)) * 5,
         "/other/c.txt": b"c"}


def _shell(kind):
    if kind == "ref":
        import seaweedfs_tpu.shell  # noqa: F401  (registers the commands)
        from seaweedfs_tpu.server.http_util import post_multipart
        from seaweedfs_tpu.shell.command_env import CommandEnv, run_command
    else:
        from seaweedfs_tpu_torch.server.http_util import post_multipart
        from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    return CommandEnv, run_command, post_multipart


def _norm(text, stack):
    m, vs, f = stack
    for url, name in ((f.url, "FILER"), (m.url, "MASTER"), (vs.url, "VS")):
        text = text.replace(url, name)
    text = re.sub(r"\b\d+,[0-9a-f]{9,}\b", "FID", text)
    text = re.sub(r'"(mtime|crtime|Mtime|Crtime)": ?[0-9.e+]+',
                  r'"\1": T', text)
    return re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d", "DATE", text)


def test_fs_and_bucket_shell_match_jax(tmp_path):
    got = {}
    for kind in ("ref", "port"):
        stack = _stack(kind, tmp_path / kind)
        CommandEnv, run_command, post_multipart = _shell(kind)
        m, _, f = stack
        saved = tmp_path / f"{kind}-meta.jsonl"
        try:
            for path, data in FILES.items():
                post_multipart(f"http://{f.url}{path}",
                               path.rsplit("/", 1)[1], data)
            out = io.StringIO()
            bare = CommandEnv(m.url, out=out)
            for line in ("fs.ls /", "bucket.list"):
                out.write(f"$ {line}\n")
                run_command(bare, line)
            env = CommandEnv(m.url, out=out, filer_url=f.url)
            script = [
                "fs.pwd", "fs.ls /", "fs.ls -l /docs", "fs.cd docs",
                "fs.pwd", "fs.ls", "fs.ls -l sub", "fs.cat a.txt",
                "fs.cat /docs/bin.dat", "fs.cat", "fs.cd /docs/a.txt",
                "fs.cd /nonexistent", "fs.du /", "fs.du", "fs.du /nope",
                "fs.tree /", "fs.cd /", "fs.mkdir /newdir", "fs.mkdir",
                "fs.mv /docs/a.txt /newdir/a2.txt", "fs.mv /x",
                "fs.ls /newdir", "fs.rm /docs/sub", "fs.rm",
                "fs.meta.cat /newdir/a2.txt", "fs.meta.cat /nope",
                "fs.meta.cat", f"fs.meta.save -o {saved} /",
                "fs.rm -r /docs/sub", "fs.tree /",
                f"fs.meta.load -i {saved}", "fs.meta.load",
                "fs.tree /", "fs.meta.notify /newdir",
                "bucket.list", "bucket.create -name b1",
                "bucket.create -name b2 -collection c", "bucket.create",
                "bucket.list", "bucket.delete -name b1", "bucket.delete",
                "bucket.list", "fs.ls /buckets", "fs.du /docs"]
            for line in script:
                out.write(f"$ {line}\n")
                run_command(env, line)
            text = out.getvalue().replace(str(saved), "SAVED")
            got[kind] = (_norm(text, stack).splitlines(),
                         _norm(saved.read_text(), stack).splitlines())
        finally:
            _stop(stack)
    ref_lines, port_lines = got["ref"][0], got["port"][0]
    for i, (a, b) in enumerate(zip(ref_lines, port_lines)):
        assert b == a, (i, ref_lines[max(0, i - 3):i + 1])
    assert len(port_lines) == len(ref_lines)
    assert got["port"][1] == got["ref"][1]
    text = "\n".join(ref_lines)
    assert "alpha-content" in text and "<1280 binary bytes>" in text
    assert "no filer configured" in text and "created bucket b2" in text
