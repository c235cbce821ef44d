"""The HTML status pages (reference weed/server/master_ui/ and
volume_server_ui/ templates), as the JAX package's ``server/status_ui``
renders them: the master's ``/`` and ``/ui`` (``master_status_page``),
a volume server's ``/ui`` (``volume_status_page``), and the filer's
listing of a directory for a browser (``render_page``). Every cell is
escaped but one marked ``Raw`` (trusted markup the caller built from
escaped parts: the filer's links)."""

from __future__ import annotations

import html
import time

_PAGE = """<!doctype html><html><head><title>{title}</title><style>
body{{font-family:sans-serif;margin:2em;color:#222}}
table{{border-collapse:collapse;margin:1em 0}}
td,th{{border:1px solid #ccc;padding:4px 10px;text-align:left}}
th{{background:#f4f4f4}} h1{{font-size:1.3em}} .muted{{color:#888}}
</style></head><body><h1>{title}</h1>{body}
<p class="muted">seaweedfs_tpu_torch &middot; {now}</p></body></html>"""


class Raw(str):
    """One cell of trusted, already escaped markup."""


def _table(headers, rows) -> str:
    head = "".join(f"<th>{html.escape(str(h))}</th>" for h in headers)

    def cell(c):
        return str(c) if isinstance(c, Raw) else html.escape(str(c))

    body = "".join(
        "<tr>" + "".join(f"<td>{cell(c)}</td>" for c in row)
        + "</tr>" for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def render_page(title: str, sections, footer_html: str = "") -> bytes:
    """A page of ``sections``, each (heading, headers, rows);
    ``footer_html`` is trusted markup after them."""
    body = ""
    for heading, headers, rows in sections:
        body += f"<h2>{html.escape(heading)}</h2>"
        body += _table(headers, rows)
    body += footer_html
    return _PAGE.format(title=html.escape(title), body=body,
                        now=time.strftime("%Y-%m-%d %H:%M:%S")).encode()


def traces_section(n: int = 8):
    """(heading, headers, rows) of the newest traces in this process's
    ring: id, root span, span count, the EC phases' seconds and the
    longest span."""
    from ..util import tracing
    rows = []
    for t in tracing.RING.recent(n):
        phases = {}
        for s in t["spans"]:
            name = s.get("name")
            if name in tracing.PHASES:
                phases[name] = phases.get(name, 0.0) \
                    + (s.get("duration_s") or 0.0)
        breakdown = " ".join(f"{p}={phases[p]*1000:.0f}ms"
                             for p in tracing.PHASES if p in phases) or "-"
        rows.append((t["trace_id"][:16], t.get("root") or "-",
                     t["span_count"], breakdown,
                     f"{t['max_span_s']*1000:.1f}ms"))
    return ("Recent traces (/admin/traces)",
            ["trace", "root span", "spans", "ec phases", "longest span"],
            rows)


def master_status_page(master) -> bytes:
    topo = master.topology
    nodes, vols = [], []
    with topo.lock:
        for n in topo.all_nodes():
            nodes.append((n.url, n.rack.id if n.rack else "",
                          len(n.volumes), len(n.ec_shards),
                          n.max_volume_count,
                          f"{time.time() - n.last_seen:.0f}s ago"))
        for node in topo.all_nodes():
            for vid, vi in sorted(node.volumes.items()):
                vols.append((vid, vi.collection or "-", node.url,
                             f"{vi.size / 1e6:.1f} MB",
                             vi.file_count, vi.delete_count))
    sections = [
        ("Cluster", ["leader", "peers", "volume size limit"],
         [(master.leader_url() or master.url,
           ", ".join(master.raft.peers) if master.raft else "-",
           f"{topo.volume_size_limit >> 20} MB")]),
        ("Volume servers", ["url", "rack", "volumes", "ec shards",
                            "max", "last heartbeat"], nodes),
        ("Volumes", ["id", "collection", "server", "size", "files",
                     "deleted"], vols[:200]),
        traces_section(),
    ]
    return render_page(f"Master {master.url}", sections)


def volume_status_page(vs) -> bytes:
    vols, ecs = [], []
    for loc in vs.store.locations:
        with loc.lock:  # mounts and deletes change these maps
            for vid, v in sorted(loc.volumes.items()):
                vols.append((vid, v.collection or "-", loc.directory,
                             f"{v.size() / 1e6:.1f} MB", v.file_count(),
                             v.deleted_count(),
                             "ro" if v.readonly else "rw",
                             v.index_kind, v.offset_width))
            for vid, ev in sorted(loc.ec_volumes.items()):
                ecs.append((vid, ev.collection or "-",
                            ",".join(map(str, ev.shard_ids()))))
    sections = [
        ("Server", ["url", "master", "data center", "rack"],
         [(vs.url, vs.master_url, vs.store.data_center or "-",
           vs.store.rack or "-")]),
        ("Volumes", ["id", "collection", "dir", "size", "files",
                     "deleted", "mode", "index", "offw"], vols),
        ("EC volumes", ["id", "collection", "shards"], ecs),
        traces_section(),
    ]
    return render_page(f"Volume server {vs.url}", sections)
