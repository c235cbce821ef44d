"""The port's status pages against the JAX package's: the master's ``/``
and ``/ui``, a volume server's ``/ui`` and the filer's HTML listing of a
directory render the same section titles, headers and rows once each
server's host:port, the data directory, the clock and the package's name
in the footer are normalized (the trace rows carry random ids: only
their section and headers are compared). Names are escaped (the JAX
filer test's ``<i>.txt``), and API clients keep the JSON listing.

Both clusters (a master, a volume server holding volume 5 with one
needle, a filer) run in this process, the JAX one on NumPy, the port's
on the CPU.

Tolerances: none.
"""

import re

import pytest

from seaweedfs_tpu_torch.server import status_ui

FID = "5,01637037d6"


def _cluster(kind, tmp):
    if kind == "ref":
        from seaweedfs_tpu.client import operation as op
        from seaweedfs_tpu.server.filer_server import FilerServer
        from seaweedfs_tpu.server.http_util import http_call, post_multipart
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        m = MasterServer(port=0, pulse_seconds=1).start()
        vkw = {"ec_backend": "numpy"}
    else:
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.http_util import (http_call,
                                                          post_multipart)
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        m = MasterServer(port=0, pulse_seconds=1, repair_interval=0).start()
        vkw = {"device": "cpu"}
    vs = VolumeServer(port=0, directories=[str(tmp / kind)],
                      master_url=m.url, pulse_seconds=1,
                      max_volume_counts=[10], fast_port=-1, **vkw).start()
    http_call("POST", f"http://{vs.url}/admin/assign_volume?volume=5")
    op.upload(vs.url, FID, b"ui-bytes" * 10, filename="u.bin")
    vs.heartbeat_once()
    return {"m": m, "vs": vs, "call": http_call, "post": post_multipart,
            "Filer": FilerServer, "dir": str(tmp / kind)}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ui")
    out = {}
    try:
        for kind in ("ref", "port"):
            out[kind] = _cluster(kind, tmp)
        yield out
    finally:
        for c in out.values():
            c["vs"].stop()
            c["m"].stop()


def _normalize(page: bytes, c) -> str:
    text = page.decode()
    for url, name in ((c["m"].url, "MASTER"), (c["vs"].url, "VOLUME")):
        text = text.replace(url, name)
    text = text.replace(c["dir"], "DIR")
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "TIME", text)
    text = re.sub(r"\d+s ago", "ago", text)
    return text.replace("seaweedfs_tpu_torch &middot;",
                        "seaweedfs_tpu &middot;")


def _sections(text: str):
    """[(heading, [header...], [[cell...]...])] of a page; the trace
    section's rows dropped."""
    out = []
    for heading, table in re.findall(r"<h2>(.*?)</h2><table>(.*?)</table>",
                                     text):
        rows = re.findall(r"<tr>(.*?)</tr>", table)
        head = re.findall(r"<th>(.*?)</th>", rows[0])
        cells = [re.findall(r"<td>(.*?)</td>", r) for r in rows[1:]]
        out.append((heading, head, [] if "traces" in heading else cells))
    return out


@pytest.mark.parametrize("path", ["/", "/ui"])
def test_master_page_matches_jax(clusters, path):
    pages = {}
    for kind, c in clusters.items():
        page = c["call"]("GET", f"http://{c['m'].url}{path}")
        pages[kind] = _normalize(page, c)
    assert _sections(pages["port"]) == _sections(pages["ref"])
    secs = dict((h, rows) for h, _, rows in _sections(pages["port"]))
    assert secs["Volume servers"] == [["VOLUME", "DefaultRack", "1", "0",
                                       "10", "ago"]]
    assert secs["Volumes"] == [["5", "-", "VOLUME", "0.0 MB", "1", "0"]]
    # outside the trace table the pages are one text
    strip = re.compile(r"<h2>Recent traces.*?</table>", re.S)
    assert strip.sub("", pages["port"]) == strip.sub("", pages["ref"])
    assert "<h1>Master MASTER</h1>" in pages["port"]


def test_volume_page_matches_jax(clusters):
    pages = {}
    for kind, c in clusters.items():
        page = c["call"]("GET", f"http://{c['vs'].url}/ui")
        pages[kind] = _normalize(page, c)
    assert _sections(pages["port"]) == _sections(pages["ref"])
    secs = dict((h, rows) for h, _, rows in _sections(pages["port"]))
    assert secs["Volumes"] == [["5", "-", "DIR", "0.0 MB", "1", "0", "rw",
                                "memory", "4"]]
    assert secs["Server"] == [["VOLUME", "MASTER", "-", "-"]]
    assert secs["EC volumes"] == []


def test_filer_listing_page_matches_jax(clusters):
    pages = {}
    for kind, c in clusters.items():
        f = c["Filer"](port=0, master_url=c["m"].url).start()
        try:
            for name, body in (("a.txt", b"alpha"), ("<i>.txt", b"x"),
                               ("b&c.bin", b"bee" * 100),
                               ("sub/deep.bin", b"d")):
                c["post"](f"http://{f.url}/docs/{name}",
                          name.split("/")[-1], body)
            got = []
            for q in ("", "?limit=2", "?limit=2&lastFileName=b%26c.bin"):
                page = c["call"]("GET", f"http://{f.url}/docs/{q}",
                                 headers={"Accept": "text/html"})
                got.append(_normalize(page, c).replace(f.url, "FILER"))
            js = c["call"]("GET", f"http://{f.url}/docs/",
                           headers={"Accept": "application/json"})
            pretty = c["call"]("GET", f"http://{f.url}/docs/?pretty=y",
                               headers={"Accept": "text/html"})
            assert js.startswith(b"{") and pretty.startswith(b"{")
            pages[kind] = got
        finally:
            f.stop()
    assert pages["port"] == pages["ref"]
    full, first, rest = pages["port"]
    assert "<h1>Filer /docs</h1>" in full
    assert "&lt;i&gt;.txt" in full and "<i>.txt" not in full  # XSS
    assert '<a href="/docs/%3Ci%3E.txt">&lt;i&gt;.txt</a>' in full
    assert '<a href="/docs/b%26c.bin">b&amp;c.bin</a>' in full
    assert "next page" in first and "next page" not in full
    assert _sections(rest)[0][2] == [
        ['<a href="/docs/sub">sub</a>', "dir", "-"]]


def test_render_page_escapes_but_raw_cells():
    from seaweedfs_tpu.server import status_ui as ref_ui
    sections = [("h<2>", ["a&b", "<th>"],
                 [("<script>x</script>", 3), ("ok", "\"q'")])]
    pages = []
    for ui in (ref_ui, status_ui):
        pages.append(re.sub(
            r"<p class=\"muted\">.*?</p>", "",
            ui.render_page("t<1>", sections + [
                ("raw", ["link"], [(ui.Raw('<a href="/x">x</a>'),)])],
                footer_html="<p>f</p>").decode()))
    assert pages[1] == pages[0]
    assert "<script>" not in pages[1] and "&lt;script&gt;" in pages[1]
    assert '<td><a href="/x">x</a></td>' in pages[1]
    assert "<title>t&lt;1&gt;</title>" in pages[1]
