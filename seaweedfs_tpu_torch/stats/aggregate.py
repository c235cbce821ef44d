"""Cluster metrics aggregation (fleet health plane, half one).

The master already knows every live node from heartbeats; this module
closes the loop by scraping each node's `/metrics` on an interval
(``CLUSTER_SCRAPE_S``, the JAX SW_CLUSTER_SCRAPE_S default of 15 s, or
the ``interval_s`` argument), parsing the Prometheus text back
into samples (stats.metrics.parse_prometheus_text — round-trip tested
against the renderer), and serving one merged exposition at
`GET /cluster/metrics`:

  * counters and histogram series are summed per label-set (histogram
    buckets carry their `le` label, so bucket-wise merging falls out of
    the same rule);
  * gauges (and untyped families) are kept per-node under an added
    `node=` label — a per-node bandwidth gauge averaged across the
    fleet would be meaningless;
  * nodes whose scrapes stop succeeding are marked stale (a synthetic
    `cluster_node_up` gauge leads the merged view) and aged out of the
    merge entirely after `age_out_s`.

`GET /cluster/health` is served from the same snapshots: the
`ec_holder_*` families each node exports are folded into one per-holder
view (worst observer score wins — a holder slow for anyone is slow).

The JAX package's ``stats/aggregate.py``. ``fetch=`` (url -> exposition
text) replaces the HTTP scrape, so tests can feed canned texts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..util.locks import make_lock
from .metrics import (CLUSTER_NODE_UP_GAUGE, CLUSTER_NODES_GAUGE,
                      CLUSTER_SCRAPE_COUNTER, CLUSTER_SCRAPE_SECONDS,
                      parse_prometheus_text, render_families)

#: Seconds between scrape sweeps (SW_CLUSTER_SCRAPE_S).
CLUSTER_SCRAPE_S = 15.0

_HEALTH_SUFFIX = "_ec_holder_health"
_HEALTH_LAT_SUFFIX = "_ec_holder_latency_ewma_ms"
_HEALTH_EVENTS_SUFFIX = "_ec_holder_events_total"


class _NodeSnapshot:
    __slots__ = ("url", "families", "last_success", "last_attempt",
                 "last_error")

    def __init__(self, url: str):
        self.url = url
        self.families: List[Dict] = []
        self.last_success = 0.0
        self.last_attempt = 0.0
        self.last_error = ""


class ClusterMetricsAggregator:
    """Master-side scraper + merger over the heartbeating node set."""

    def __init__(self, list_nodes: Callable[[], Sequence[str]],
                 interval_s: Optional[float] = None,
                 fetch: Optional[Callable[[str], str]] = None):
        self.list_nodes = list_nodes
        self.interval_s = (CLUSTER_SCRAPE_S if interval_s is None
                           else float(interval_s))
        # one missed sweep is jitter; two means the node is gone
        self.stale_after_s = max(2.5 * self.interval_s, 1.0)
        self.age_out_s = 4 * self.stale_after_s
        self._fetch = fetch or self._http_fetch
        self._lock = make_lock("torch.aggregate._lock")
        self._nodes: Dict[str, _NodeSnapshot] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _http_fetch(url: str) -> str:
        from ..server.http_util import http_call
        return http_call("GET", f"http://{url}/metrics",
                         timeout=10.0).decode("utf-8", "replace")

    # -- scrape loop ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cluster-metrics-scraper")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - a scrape sweep must
                # never kill the loop; per-node errors are already
                # caught, this guards list_nodes itself
                pass

    def scrape_once(self) -> int:
        """One synchronous sweep over the current node set; returns how
        many nodes scraped clean.  Also the test/`?refresh=1` path."""
        t0 = time.monotonic()
        ok = 0
        for url in list(self.list_nodes()):
            snap = self._snap(url)
            snap.last_attempt = t0
            try:
                text = self._fetch(url)
                families = parse_prometheus_text(text)
            except Exception as e:  # noqa: BLE001 - any transport or
                # parse failure marks the node, never aborts the sweep
                snap.last_error = f"{type(e).__name__}: {e}"
                CLUSTER_SCRAPE_COUNTER.inc("error")
                continue
            with self._lock:
                snap.families = families
                snap.last_success = time.monotonic()
                snap.last_error = ""
            CLUSTER_SCRAPE_COUNTER.inc("ok")
            ok += 1
        self._age_out()
        self._export_node_gauges()
        CLUSTER_SCRAPE_SECONDS.observe(time.monotonic() - t0)
        return ok

    def _snap(self, url: str) -> _NodeSnapshot:
        with self._lock:
            snap = self._nodes.get(url)
            if snap is None:
                snap = self._nodes[url] = _NodeSnapshot(url)
            return snap

    def _age_out(self):
        now = time.monotonic()
        with self._lock:
            dead = [u for u, s in self._nodes.items()
                    if now - (s.last_success or s.last_attempt)
                    > self.age_out_s]
            for u in dead:
                del self._nodes[u]

    def _is_stale(self, snap: _NodeSnapshot) -> bool:
        if not snap.last_success:
            return True
        return time.monotonic() - snap.last_success > self.stale_after_s

    def _export_node_gauges(self):
        with self._lock:
            snaps = list(self._nodes.values())
        fresh = stale = 0
        for s in snaps:
            is_stale = self._is_stale(s)
            CLUSTER_NODE_UP_GAUGE.set(0.0 if is_stale else 1.0, s.url)
            if is_stale:
                stale += 1
            else:
                fresh += 1
        CLUSTER_NODES_GAUGE.set(fresh, "fresh")
        CLUSTER_NODES_GAUGE.set(stale, "stale")

    # -- merged views --------------------------------------------------------

    def node_status(self) -> List[Dict]:
        with self._lock:
            snaps = sorted(self._nodes.values(), key=lambda s: s.url)
        return [{"node": s.url, "stale": self._is_stale(s),
                 "last_error": s.last_error} for s in snaps]

    def merged_families(self) -> List[Dict]:
        """Merge every non-aged-out node's parsed families."""
        with self._lock:
            per_node = [(s.url, s.families, self._is_stale(s))
                        for s in sorted(self._nodes.values(),
                                        key=lambda s: s.url)]
        up = {"name": "cluster_node_up", "kind": "gauge",
              "help": "1 if the node's last scrape is fresh, 0 if "
                      "stale (aged-out nodes are dropped).",
              "samples": [("cluster_node_up", (("node", url),),
                           0.0 if stale else 1.0)
                          for url, _, stale in per_node]}
        merged: List[Dict] = [up]
        by_name: Dict[str, Dict] = {}
        # summed series accumulate here: family name -> (sample_name,
        # labels) -> value
        sums: Dict[str, Dict[tuple, float]] = {}
        for url, families, _stale in per_node:
            for fam in families:
                out = by_name.get(fam["name"])
                if out is None:
                    out = {"name": fam["name"], "kind": fam["kind"],
                           "help": fam["help"], "samples": []}
                    by_name[fam["name"]] = out
                    merged.append(out)
                if fam["kind"] in ("counter", "histogram"):
                    acc = sums.setdefault(fam["name"], {})
                    for sample_name, labels, value in fam["samples"]:
                        key = (sample_name, labels)
                        acc[key] = acc.get(key, 0.0) + value
                    # newest exemplar per merged series wins — a fresh
                    # trace id beats a stale one from another node
                    for key, ex in (fam.get("exemplars") or {}).items():
                        held = out.setdefault("exemplars", {}).get(key)
                        if held is None or ex[2] >= held[2]:
                            out["exemplars"][key] = ex
                else:   # gauge / untyped: keep per-node
                    for sample_name, labels, value in fam["samples"]:
                        out["samples"].append(
                            (sample_name, labels + (("node", url),),
                             value))
        for name, acc in sums.items():
            by_name[name]["samples"] = [
                (sample_name, labels, value)
                for (sample_name, labels), value in acc.items()]
        return merged

    def render(self) -> str:
        return render_families(self.merged_families())

    def holder_health(self) -> Dict:
        """Fold each node's `ec_holder_*` families into one per-holder
        cluster view.  Worst observer score wins; latency EWMAs take the
        worst observer per kind; event counters sum."""
        with self._lock:
            per_node = [(s.url, s.families)
                        for s in sorted(self._nodes.values(),
                                        key=lambda s: s.url)
                        if not self._is_stale(s)]
        holders: Dict[str, Dict] = {}

        def ensure(holder: str) -> Dict:
            return holders.setdefault(holder, {
                "score": 1.0, "observers": {},
                "latency_ewma_ms": {}, "events": {}})

        for url, families in per_node:
            for fam in families:
                name = fam["name"]
                if name.endswith(_HEALTH_SUFFIX):
                    for _sn, labels, value in fam["samples"]:
                        ld = dict(labels)
                        h = ensure(ld.get("holder", "?"))
                        h["observers"][url] = value
                        h["score"] = min(h["score"], value)
                elif name.endswith(_HEALTH_LAT_SUFFIX):
                    for _sn, labels, value in fam["samples"]:
                        ld = dict(labels)
                        h = ensure(ld.get("holder", "?"))
                        kind = ld.get("kind", "?")
                        h["latency_ewma_ms"][kind] = max(
                            h["latency_ewma_ms"].get(kind, 0.0), value)
                elif name.endswith(_HEALTH_EVENTS_SUFFIX):
                    for _sn, labels, value in fam["samples"]:
                        ld = dict(labels)
                        h = ensure(ld.get("holder", "?"))
                        ev = ld.get("event", "?")
                        h["events"][ev] = h["events"].get(ev, 0) + value
        return {"holders": holders, "nodes": self.node_status()}
