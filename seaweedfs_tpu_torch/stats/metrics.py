"""Prometheus-compatible metrics (reference weed/stats/metrics.go).

The JAX package's ``stats/metrics.py``: the exposition core (escaping,
exemplars, ``parse_prometheus_text`` / ``render_families``, counters,
gauges, histograms, registries), the master and volume-server
gatherers with their families, the ``observe_*`` mirrors, the
small-dispatch tuner and the push loop. Family and label names are the
JAX package's letter for letter: they are the scrape's public interface,
and the master's aggregator folds by name. The ``ec_xla_*`` families
carry the port's device accounting (``ops/device_stats``): builds are
nvcc and tile-plan builds, device samples are CUDA-event timings, and
``ec_xla_jit_cache_*`` gets no series (the port has no jit factories).

The native plane's families (``fast_plane_request_total``,
``plane_*``) mirror ``server/native_plane``'s counters, latency and fsync
buckets (``PLANE_LAT_BUCKETS_S`` are the C++ plane's ``kLatBoundsUs``) on
each scrape. The filer's gatherer (``FILER_GATHER``) holds its request
counter and histogram.

Two differences, on purpose, both in the small-dispatch tuner:

* it learns from the ``width`` tag of a ``reconstruct`` span (survivor
  bytes per row), the unit ``ops/codec.dispatch_threshold`` is compared
  in. The JAX package feeds it the span's ``bytes`` (k x width) and
  installs a crossover k times too wide; the span's ``bytes`` tag keeps
  the JAX value;
* a fit whose device line lies below the host line at every width (a
  non-positive intercept under a shallower slope) suggests the low
  clamp: the card wins everywhere. The JAX package returns the high
  clamp there, which sends every width below 8 MiB to the host.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..util.locks import make_lock

_DEFAULT_BUCKETS = (0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1,
                    0.3, 1.0, 3.0, 10.0)


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double quote,
    and line feed must be escaped inside the quoted label value."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text) -> str:
    """HELP lines escape only backslash and line feed (the value is not
    quoted, so double quotes pass through verbatim)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _unescape_help(text: str) -> str:
    out = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _unescape_label_value(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ('"', "\\"):
                out.append(nxt)
            else:           # unknown escape: keep verbatim
                out.append(c)
                out.append(nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_value(v) -> str:
    """Render a sample value so that parse(render(v)) == v exactly.

    Integral values print without a decimal point (matching the plain
    int rendering of histogram bucket counts); everything else uses
    repr(), Python's shortest round-trip float representation.  The
    %g formatting this replaces silently truncated to 6 significant
    digits, which broke the render->parse->render fixed point for
    large counters."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _parse_value(text: str) -> float:
    t = text.strip()
    if t in ("+Inf", "Inf"):
        return float("inf")
    if t == "-Inf":
        return float("-inf")
    if t == "NaN":
        return float("nan")
    return float(t)


def _fmt_exemplar(labels, value, ts) -> str:
    """OpenMetrics-style exemplar suffix for a sample line:
    `` # {trace_id="..."} <observed value> <unix ts>``. Appended to
    ``_bucket`` series so a tail-latency bucket carries the trace id of
    the request that landed in it."""
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return f" # {{{body}}} {_fmt_value(value)} {_fmt_value(ts)}"


def _label_block_end(line: str, start: int) -> int:
    """Index just past the ``}`` closing the label block whose ``{`` is
    at ``start``, honoring quoted and escaped label values."""
    i = start + 1
    n = len(line)
    in_q = False
    while i < n:
        c = line[i]
        if in_q:
            if c == "\\":
                i += 1
            elif c == '"':
                in_q = False
        elif c == '"':
            in_q = True
        elif c == "}":
            return i + 1
        i += 1
    return -1


def _split_exemplar(line: str):
    """Split a sample line into (sample part, exemplar or None).

    The exemplar tail is `` # {labels} value ts``. The marker search
    starts AFTER the sample's own label block, so a label VALUE
    containing " # {" never mis-splits."""
    i = 0
    n = len(line)
    while i < n and line[i] not in "{ ":
        i += 1
    if i < n and line[i] == "{":
        i = _label_block_end(line, i)
        if i < 0:
            raise ValueError(f"unterminated label block in {line!r}")
    idx = line.find(" # {", i)
    if idx < 0:
        return line, None
    open_b = idx + 3
    close = _label_block_end(line, open_b)
    if close < 0:
        raise ValueError(f"malformed exemplar in {line!r}")
    labels = _parse_labels(line[open_b + 1:close - 1])
    rest = line[close:].split()
    if len(rest) != 2:
        raise ValueError(f"malformed exemplar in {line!r}")
    return line[:idx], (labels, _parse_value(rest[0]),
                        _parse_value(rest[1]))


def _parse_labels(body: str) -> Tuple[Tuple[str, str], ...]:
    """Parse the inside of a {...} label block, honoring escapes."""
    pairs = []
    i = 0
    n = len(body)
    while i < n:
        while i < n and body[i] in ", ":
            i += 1
        if i >= n:
            break
        eq = body.index("=", i)
        name = body[i:eq].strip()
        i = eq + 1
        if i >= n or body[i] != '"':
            raise ValueError(f"unquoted label value in {body!r}")
        i += 1
        raw = []
        while i < n:
            c = body[i]
            if c == "\\" and i + 1 < n:
                raw.append(body[i:i + 2])
                i += 2
                continue
            if c == '"':
                break
            raw.append(c)
            i += 1
        if i >= n:
            raise ValueError(f"unterminated label value in {body!r}")
        i += 1  # closing quote
        pairs.append((name, _unescape_label_value("".join(raw))))
    return tuple(pairs)


def parse_prometheus_text(text: str) -> List[Dict]:
    """Parse a Prometheus text exposition back into sample families.

    Returns an ordered list of dicts:
        {"name": family name, "kind": counter|gauge|histogram|untyped,
         "help": help text,
         "samples": [(sample_name, ((label, value), ...), float), ...]}

    Histogram child series (`_bucket`/`_sum`/`_count`) are grouped under
    their family.  Exemplar tails (`` # {trace_id="..."} v ts``) are
    kept out-of-band — samples stay 3-tuples for every existing
    consumer — in the family's ``"exemplars"`` dict, keyed by
    ``(sample_name, labels)``.  Designed as the exact inverse of
    Registry.render(): render -> parse -> render_families is a fixed
    point, so the cluster aggregator can merge scraped text without
    dropping samples (or their exemplars)."""
    families: List[Dict] = []
    by_name: Dict[str, Dict] = {}

    def family_for_sample(sample_name: str) -> Dict:
        # histogram children carry suffixes; try the longest prefix
        for cand in (sample_name, sample_name.rsplit("_bucket", 1)[0],
                     sample_name.rsplit("_sum", 1)[0],
                     sample_name.rsplit("_count", 1)[0]):
            fam = by_name.get(cand)
            if fam is not None:
                return fam
        fam = {"name": sample_name, "kind": "untyped", "help": "",
               "samples": []}
        families.append(fam)
        by_name[sample_name] = fam
        return fam

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            help_text = _unescape_help(help_text)
            fam = by_name.get(name)
            if fam is None:
                fam = {"name": name, "kind": "untyped", "help": help_text,
                       "samples": []}
                families.append(fam)
                by_name[name] = fam
            else:
                fam["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) >= 2:
                name, kind = parts[0], parts[1]
                fam = by_name.get(name)
                if fam is None:
                    fam = {"name": name, "kind": kind, "help": "",
                           "samples": []}
                    families.append(fam)
                    by_name[name] = fam
                else:
                    fam["kind"] = kind
            continue
        if line.startswith("#"):
            continue
        # sample line: name[{labels}] value [# {exemplar} v ts]
        line, exemplar = _split_exemplar(line)
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ValueError(f"malformed sample line: {line!r}")
            sample_name = line[:brace]
            labels = _parse_labels(line[brace + 1:close])
            value = _parse_value(line[close + 1:])
        else:
            sample_name, _, value_text = line.partition(" ")
            labels = ()
            value = _parse_value(value_text)
        fam = family_for_sample(sample_name)
        fam["samples"].append((sample_name, labels, value))
        if exemplar is not None:
            fam.setdefault("exemplars", {})[(sample_name, labels)] = \
                exemplar
    return families


def render_families(families: List[Dict]) -> str:
    """Render parsed families back to exposition text — the inverse of
    parse_prometheus_text, and line-identical to Registry.render() for
    text that originated there."""
    lines: List[str] = []
    for fam in families:
        lines.append(f"# HELP {fam['name']} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {fam['name']} {fam['kind']}")
        exemplars = fam.get("exemplars") or {}
        for sample_name, labels, value in fam["samples"]:
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label_value(v)}"' for k, v in labels)
                line = f"{sample_name}{{{body}}} {_fmt_value(value)}"
            else:
                line = f"{sample_name} {_fmt_value(value)}"
            ex = exemplars.get((sample_name, labels))
            if ex is not None:
                line += _fmt_exemplar(*ex)
            lines.append(line)
    return "\n".join(lines) + "\n"


def _fmt_labels(label_names, label_values) -> str:
    if not label_names:
        return ""
    pairs = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in
                     zip(label_names, label_values))
    return "{" + pairs + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(labels)
        self._lock = make_lock("torch.metrics.Metric._lock")

    def header(self) -> List[str]:
        return [f"# HELP {self.name} {_escape_help(self.help)}",
                f"# TYPE {self.name} {self.kind}"]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text="", labels=()):
        super().__init__(name, help_text, labels)
        self._values: Dict[tuple, float] = {}

    def inc(self, *label_values, amount: float = 1.0):
        with self._lock:
            self._values[label_values] = \
                self._values.get(label_values, 0.0) + amount

    def set_total(self, value: float, *label_values):
        """Snapshot-mirror a monotonic count maintained elsewhere (the
        device accounting and the engines keep their own); semantically
        still a counter: the source only ever increases within a
        process."""
        with self._lock:
            self._values[label_values] = value

    def value(self, *label_values) -> float:
        with self._lock:
            return self._values.get(label_values, 0.0)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for lv, v in sorted(self._values.items()):
                out.append(
                    f"{self.name}"
                    f"{_fmt_labels(self.label_names, lv)} {_fmt_value(v)}")
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text="", labels=()):
        super().__init__(name, help_text, labels)
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, *label_values):
        with self._lock:
            self._values[label_values] = value

    def value(self, *label_values) -> float:
        with self._lock:
            return self._values.get(label_values, 0.0)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for lv, v in sorted(self._values.items()):
                out.append(
                    f"{self.name}"
                    f"{_fmt_labels(self.label_names, lv)} {_fmt_value(v)}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text="", labels=(),
                 buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._totals: Dict[tuple, int] = {}
        # label_values -> bucket index -> (labels, value, ts); index
        # len(self.buckets) is the +Inf bucket. Newest observation wins.
        self._exemplars: Dict[tuple, Dict[int, tuple]] = {}

    def observe(self, value: float, *label_values,
                trace_id: Optional[str] = None):
        with self._lock:
            counts = self._counts.setdefault(
                label_values, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):
                counts[i] += 1
            self._sums[label_values] = \
                self._sums.get(label_values, 0.0) + value
            self._totals[label_values] = \
                self._totals.get(label_values, 0) + 1
            if trace_id:
                # one exemplar per bucket, newest wins: a p99 outlier
                # lands in a top bucket and stays referable until a
                # slower request replaces it
                self._exemplars.setdefault(label_values, {})[i] = (
                    (("trace_id", str(trace_id)),), float(value),
                    time.time())

    def set_buckets(self, counts, total: int, sum_value: float,
                    *label_values):
        """Snapshot-mirror a histogram maintained elsewhere: ``counts`` are
        NON-cumulative per-bucket counts aligned with ``self.buckets``
        (any overflow beyond the last bound is implied by ``total``),
        plus the observation count and value sum."""
        with self._lock:
            store = [0] * len(self.buckets)
            for i, c in enumerate(counts[:len(store)]):
                store[i] = int(c)
            self._counts[label_values] = store
            self._totals[label_values] = int(total)
            self._sums[label_values] = float(sum_value)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for lv in sorted(self._counts):
                ex_map = self._exemplars.get(lv, {})
                cumulative = 0
                for i, (bound, c) in enumerate(
                        zip(self.buckets, self._counts[lv])):
                    cumulative += c
                    labels = _fmt_labels(
                        self.label_names + ("le",),
                        lv + (f"{bound:g}",))
                    line = f"{self.name}_bucket{labels} {cumulative}"
                    ex = ex_map.get(i)
                    if ex is not None:
                        line += _fmt_exemplar(*ex)
                    out.append(line)
                labels = _fmt_labels(self.label_names + ("le",),
                                     lv + ("+Inf",))
                line = f"{self.name}_bucket{labels} {self._totals[lv]}"
                ex = ex_map.get(len(self.buckets))
                if ex is not None:
                    line += _fmt_exemplar(*ex)
                out.append(line)
                base = _fmt_labels(self.label_names, lv)
                out.append(f"{self.name}_sum{base} "
                           f"{_fmt_value(self._sums[lv])}")
                out.append(f"{self.name}_count{base} "
                           f"{self._totals[lv]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []
        self._lock = make_lock("torch.metrics.Registry._lock")

    def register(self, metric: _Metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def counter(self, name, help_text="", labels=()) -> Counter:
        return self.register(Counter(name, help_text, labels))

    def gauge(self, name, help_text="", labels=()) -> Gauge:
        return self.register(Gauge(name, help_text, labels))

    def histogram(self, name, help_text="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, labels, buckets))

    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# -- per-role gatherers (reference metrics.go:14-107) -----------------------

MASTER_GATHER = Registry()
VOLUME_SERVER_GATHER = Registry()
FILER_GATHER = Registry()

VOLUME_REQUEST_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_request_total",
    "Counter of volume server requests.", labels=("type",))
VOLUME_REQUEST_HISTOGRAM = VOLUME_SERVER_GATHER.histogram(
    "SeaweedFS_volumeServer_request_seconds",
    "Bucketed histogram of volume server request processing time.",
    labels=("type",))
VOLUME_COUNT_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_volumes",
    "Number of volumes or EC shards.",
    labels=("collection", "type"))
VOLUME_DISK_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_total_disk_size",
    "Actual disk size used by volumes.",
    labels=("collection", "type"))
FAST_PLANE_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_fast_plane_request_total",
    "Requests handled by the native C++ read plane.",
    labels=("outcome",))
FILER_REQUEST_COUNTER = FILER_GATHER.counter(
    "SeaweedFS_filer_request_total",
    "Counter of filer requests.", labels=("type",))
FILER_REQUEST_HISTOGRAM = FILER_GATHER.histogram(
    "SeaweedFS_filer_request_seconds",
    "Bucketed histogram of filer request processing time.",
    labels=("type",))

MASTER_REQUEST_COUNTER = MASTER_GATHER.counter(
    "SeaweedFS_master_request_total",
    "Counter of master requests.", labels=("type",))
MASTER_REQUEST_HISTOGRAM = MASTER_GATHER.histogram(
    "SeaweedFS_master_request_seconds",
    "Bucketed histogram of master request processing time.",
    labels=("type",))

# -- fleet health plane: cluster scrape (stats/aggregate.py) -----------------

CLUSTER_SCRAPE_COUNTER = MASTER_GATHER.counter(
    "SeaweedFS_master_cluster_scrape_total",
    "Cluster /metrics scrape attempts by outcome (ok, error).",
    labels=("outcome",))
CLUSTER_SCRAPE_SECONDS = MASTER_GATHER.histogram(
    "SeaweedFS_master_cluster_scrape_seconds",
    "Bucketed duration of one full cluster scrape sweep.")
CLUSTER_NODE_UP_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_cluster_node_up",
    "1 if the node's last /metrics scrape succeeded, 0 if it is stale.",
    labels=("node",))
CLUSTER_NODES_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_cluster_scraped_nodes",
    "Nodes currently held by the cluster aggregator, by freshness "
    "(fresh, stale).",
    labels=("state",))

# -- hot→warm tiering (server/tiering.py) ------------------------------------

MASTER_TIER_DEMOTIONS = MASTER_GATHER.counter(
    "SeaweedFS_master_tier_demotions_total",
    "Volume demotions finished by the background tierer, by result "
    "(ok, failed).",
    labels=("result",))
MASTER_TIER_SECONDS = MASTER_GATHER.counter(
    "SeaweedFS_master_tier_demotion_seconds_total",
    "Cumulative wall seconds spent demoting volumes to EC warm "
    "storage.")
MASTER_TIER_BYTES = MASTER_GATHER.counter(
    "SeaweedFS_master_tier_demoted_bytes_total",
    "Hot .dat bytes converted to EC warm storage by the tierer.")
MASTER_TIER_MBPS_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_tier_mbps",
    "Effective demotion bandwidth of the last completed demotion "
    "(hot bytes / wall seconds — the rate cap should show here).")
MASTER_TIER_VOLUMES_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_tier_volumes",
    "Volumes currently tracked by the tierer, by lifecycle state "
    "(candidate, demoting, warm, failed).",
    labels=("state",))

# -- EC phase spans (fed by util/tracing via observe_span) -------------------

EC_PHASE_NAMES = ("gather", "plan", "dispatch", "drain", "write")

VOLUME_EC_PHASE_HISTOGRAM = VOLUME_SERVER_GATHER.histogram(
    "SeaweedFS_volumeServer_ec_phase_seconds",
    "Bucketed histogram of per-phase EC span durations.",
    labels=("phase",))
VOLUME_EC_PHASE_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_phase_seconds_total",
    "Cumulative seconds spent in each EC phase.",
    labels=("phase",))
DEVICE_TELEMETRY_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_device_telemetry_total",
    "Process-global device codec telemetry (ops/telemetry.STATS).",
    labels=("kind",))
SMALL_DISPATCH_SUGGESTED_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_small_dispatch_suggested_bytes",
    "Suggested host/device crossover width (ops/codec "
    "SMALL_DISPATCH_BYTES) fitted from the first reconstruct spans "
    "(0 until enough samples).")

# -- streaming gather (ec/gather.py via observe_gather) ----------------------

VOLUME_EC_GATHER_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_gather_total",
    "Streaming-rebuild gather events by kind (bytes, fetches, stripes, "
    "retries, hedges_fired, hedges_won, hedges_lost).",
    labels=("kind",))
VOLUME_EC_GATHER_SECONDS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_gather_seconds_total",
    "Cumulative gather busy time (union of in-flight fetch intervals) "
    "across streaming rebuilds.")
VOLUME_EC_GATHER_MBPS_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_gather_mbps",
    "Effective gather bandwidth of the last streaming rebuild "
    "(fetched bytes / busy seconds).")
VOLUME_EC_OVERLAP_FRAC_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_overlap_frac",
    "Gather/compute overlap of the last streaming rebuild: "
    "(serialized_estimate - wall) / serialized_estimate, 0..1.")
HTTP_POOL_CHURN_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_http_pool_churn_total",
    "Keep-alive connection pool events (created, reused, "
    "evicted_stale, evicted_idle, evicted_overflow).",
    labels=("event",))


def observe_gather(stats: Dict):
    """Export one streaming rebuild's gather stats (the dict filled by
    ec.encoder.rebuild_ec_files_streaming) onto the volume registry."""
    if not stats:
        return
    for kind, key in (("bytes", "gather_bytes"),
                      ("fetches", "gather_fetches"),
                      ("stripes", "gather_stripes"),
                      ("retries", "gather_retries"),
                      ("hedges_fired", "hedges_fired"),
                      ("hedges_won", "hedges_won"),
                      ("hedges_lost", "hedges_lost")):
        n = stats.get(key)
        if n:
            VOLUME_EC_GATHER_COUNTER.inc(kind, amount=n)
    busy = stats.get("gather_busy_s")
    if busy:
        VOLUME_EC_GATHER_SECONDS.inc(amount=busy)
    if "gather_mbps" in stats:
        VOLUME_EC_GATHER_MBPS_GAUGE.set(stats["gather_mbps"])
    if "overlap_frac" in stats:
        VOLUME_EC_OVERLAP_FRAC_GAUGE.set(stats["overlap_frac"])


# -- mesh-sharded dispatch (ops/telemetry deltas via observe_mesh) -----------

VOLUME_EC_MESH_DISPATCH_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_mesh_dispatches_total",
    "Mesh-sharded device dispatches: one call whose payload width "
    "axis spans the mesh positions (single-device crossover dispatches "
    "are counted under ec_device_telemetry_total only).")
VOLUME_EC_MESH_WIDTH_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_mesh_dispatch_width_devices",
    "Devices the last mesh EC operation's dispatches landed bytes on "
    "(1 = silent fall-back to width-1 dispatch, the regression this "
    "gauge exists to catch).")
VOLUME_EC_MESH_DEVICE_BYTES = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_mesh_device_bytes_total",
    "Payload bytes landed on each mesh device by sharded dispatches.",
    labels=("device",))
VOLUME_EC_MESH_BUSY_FRAC_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_mesh_device_busy_frac",
    "Per-device byte share of the last mesh EC operation relative to "
    "the busiest device (1.0 everywhere = even shard split).",
    labels=("device",))


def observe_mesh(stats: Dict):
    """Export one EC operation's mesh-dispatch telemetry (the
    ops/telemetry.delta keys inside the stats dict filled by the
    encode/rebuild paths) onto the volume registry."""
    if not stats:
        return
    n = stats.get("mesh_dispatches")
    if n:
        VOLUME_EC_MESH_DISPATCH_COUNTER.inc(amount=n)
    for dev, nbytes in (stats.get("mesh_device_bytes") or {}).items():
        if nbytes:
            VOLUME_EC_MESH_DEVICE_BYTES.inc(str(dev), amount=nbytes)
    width = stats.get("dispatch_width_devices")
    if width:
        VOLUME_EC_MESH_WIDTH_GAUGE.set(width)
    for dev, frac in (stats.get("device_busy_frac") or {}).items():
        VOLUME_EC_MESH_BUSY_FRAC_GAUGE.set(frac, str(dev))


# -- device-runtime plane (ops/device_stats via observe_device_stats) --------

VOLUME_EC_XLA_COMPILES = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_compiles_total",
    "Builds per entry: the nvcc build of a kernel library "
    "(nvcc:<library>) and the tile plans of gf_plan.make_plan.",
    labels=("entry",))
VOLUME_EC_XLA_COMPILE_SECONDS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_compile_seconds_total",
    "Wall seconds spent in nvcc and plan builds per entry.",
    labels=("entry",))
VOLUME_EC_XLA_RECOMPILES = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_recompiles_total",
    "Builds beyond the first of one plan by one owner, or of one "
    "library: the one-plan-per-matrix rule broken. Steady state is 0.",
    labels=("entry",))
VOLUME_EC_XLA_RECOMPILE_SENTINEL = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_xla_recompile_sentinel",
    "Latches to 1 the first time a plan or library is built twice in "
    "this process; never resets.")
VOLUME_EC_XLA_DISPATCHES = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_dispatches_total",
    "Kernel calls per entry (rs_hopper.gf_matmul is K1), on any "
    "device; on the card each is one launch.",
    labels=("entry",))
VOLUME_EC_XLA_DEVICE_SAMPLES = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_device_samples_total",
    "Calls timed by CUDA events (the CPU clock off the card) while "
    "device timing is on (every sample_every'th).",
    labels=("entry",))
VOLUME_EC_XLA_DEVICE_SECONDS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_device_seconds_total",
    "Summed sampled device seconds per entry point; multiply the "
    "per-sample mean by ec_xla_dispatches_total for the estimated "
    "total.",
    labels=("entry",))
VOLUME_EC_XLA_JIT_CACHE = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_xla_jit_cache_total",
    "jit-factory cache events; the port has no jit factories, so "
    "this family has no series.",
    labels=("factory", "event"))
VOLUME_EC_XLA_JIT_CACHE_ENTRIES = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_xla_jit_cache_entries",
    "Live entries per jit factory; no series in the port.",
    labels=("factory",))
VOLUME_EC_XLA_DEVICE_MEMORY = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_xla_device_memory_bytes",
    "torch.cuda.memory_stats() gauges per card (the .all.current and "
    ".all.peak keys), once CUDA is initialized.",
    labels=("device", "kind"))
VOLUME_EC_CONST_CACHE_EVENTS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_const_cache_events_total",
    "_ConstCache device-constant events (hits, misses, evictions); a "
    "miss is one tile plan built and uploaded, an eviction forces a "
    "re-upload on next use.",
    labels=("event",))
VOLUME_EC_CONST_CACHE_ENTRIES = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_const_cache_entries",
    "Device-resident coefficient constants held across all live "
    "_ConstCache instances.")
VOLUME_EC_CONST_CACHE_BYTES = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_const_cache_bytes",
    "Device bytes pinned by cached coefficient constants across all "
    "live _ConstCache instances.")


def observe_device_stats(snap: Dict, factories: Dict = None,
                         inventory: Dict = None):
    """Mirror an ops/device_stats snapshot (plus optional jit-factory
    cache_info and device inventory) onto the volume registry. Uses
    set_total: the plane's counters are process-global monotonic, so
    each scrape overwrites rather than accumulates."""
    if not snap:
        return
    for entry, n in snap.get("compiles", {}).items():
        VOLUME_EC_XLA_COMPILES.set_total(n, entry)
    for entry, s in snap.get("compile_seconds", {}).items():
        VOLUME_EC_XLA_COMPILE_SECONDS.set_total(s, entry)
    for entry, n in snap.get("recompiles", {}).items():
        VOLUME_EC_XLA_RECOMPILES.set_total(n, entry)
    VOLUME_EC_XLA_RECOMPILE_SENTINEL.set(
        1 if snap.get("sentinel") else 0)
    for entry, n in snap.get("dispatches", {}).items():
        VOLUME_EC_XLA_DISPATCHES.set_total(n, entry)
    for entry, n in snap.get("device_samples", {}).items():
        VOLUME_EC_XLA_DEVICE_SAMPLES.set_total(n, entry)
    for entry, s in snap.get("device_seconds", {}).items():
        VOLUME_EC_XLA_DEVICE_SECONDS.set_total(s, entry)
    for event, n in snap.get("const_cache", {}).items():
        VOLUME_EC_CONST_CACHE_EVENTS.set_total(n, event)
    occ = snap.get("const_cache_occupancy") or {}
    VOLUME_EC_CONST_CACHE_ENTRIES.set(occ.get("entries", 0))
    VOLUME_EC_CONST_CACHE_BYTES.set(occ.get("bytes", 0))
    for factory, info in (factories or {}).items():
        for event in ("hits", "misses", "evictions"):
            VOLUME_EC_XLA_JIT_CACHE.set_total(
                info.get(event, 0), factory, event)
        VOLUME_EC_XLA_JIT_CACHE_ENTRIES.set(
            info.get("currsize", 0), factory)
    for dev in (inventory or {}).get("devices", []):
        name = f"{(inventory or {}).get('platform')}:{dev.get('id')}"
        for kind, val in (dev.get("memory_stats") or {}).items():
            if isinstance(val, (int, float)):
                VOLUME_EC_XLA_DEVICE_MEMORY.set(val, name, str(kind))


# -- trace repair (ec/decoder.rebuild_ec_file_repair via observe_repair) -----

VOLUME_EC_REPAIR_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_repair_total",
    "Single-shard repair events by kind (trace_rebuilds, "
    "full_rebuilds, fallbacks, symbol_bytes, baseline_bytes).",
    labels=("kind",))
VOLUME_EC_REPAIR_SECONDS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_repair_seconds_total",
    "Cumulative symbol-gather busy time across trace repairs.")
VOLUME_EC_REPAIR_BYTES_FRAC_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_repair_bytes_frac",
    "Repair traffic of the last trace repair as a fraction of the "
    "k*shard baseline the full gather would move (lower is better; "
    "1.0 means no gain).")
VOLUME_EC_REPAIR_SYMBOL_BITS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_repair_symbol_bits_total",
    "Per-survivor repair symbol widths: how many survivors shipped "
    "each bits-per-byte projection width across trace repairs.",
    labels=("bits",))


# -- piggyback plane repair (ec/decoder.rebuild_ec_file_piggyback) -----------

VOLUME_EC_PIGGYBACK_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_piggyback_total",
    "Piggyback-layout plane repair events by kind (plane_rebuilds, "
    "plane_bytes, baseline_bytes).",
    labels=("kind",))
VOLUME_EC_PIGGYBACK_BYTES_FRAC_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_piggyback_bytes_frac",
    "Repair traffic of the last piggyback plane repair as a fraction "
    "of the k*shard baseline the full gather would move (the coupled "
    "layout's floor is (k+1)/(2k); lower is better).")


def observe_repair(stats: Dict):
    """Export one rebuild's repair-mode stats (the dict filled by
    ec.decoder.rebuild_ec_file_repair / rebuild_ec_file_piggyback, or
    the fallback markers left by storage/store) onto the volume
    registry."""
    if not stats or "repair_mode" not in stats:
        return
    if stats.get("repair_fallback"):
        VOLUME_EC_REPAIR_COUNTER.inc("fallbacks")
    mode = stats["repair_mode"]
    if mode == "piggyback":
        VOLUME_EC_PIGGYBACK_COUNTER.inc("plane_rebuilds")
        for kind, key in (("plane_bytes", "repair_bytes"),
                          ("baseline_bytes", "repair_baseline_bytes")):
            n = stats.get(key)
            if n:
                VOLUME_EC_PIGGYBACK_COUNTER.inc(kind, amount=n)
        busy = stats.get("gather_busy_s")
        if busy:
            VOLUME_EC_REPAIR_SECONDS.inc(amount=busy)
        if "repair_bytes_frac" in stats:
            VOLUME_EC_PIGGYBACK_BYTES_FRAC_GAUGE.set(
                stats["repair_bytes_frac"])
        return
    if mode != "trace":
        VOLUME_EC_REPAIR_COUNTER.inc("full_rebuilds")
        return
    VOLUME_EC_REPAIR_COUNTER.inc("trace_rebuilds")
    for kind, key in (("symbol_bytes", "repair_bytes"),
                      ("baseline_bytes", "repair_baseline_bytes")):
        n = stats.get(key)
        if n:
            VOLUME_EC_REPAIR_COUNTER.inc(kind, amount=n)
    busy = stats.get("gather_busy_s")
    if busy:
        VOLUME_EC_REPAIR_SECONDS.inc(amount=busy)
    if "repair_bytes_frac" in stats:
        VOLUME_EC_REPAIR_BYTES_FRAC_GAUGE.set(stats["repair_bytes_frac"])
    for bits in (stats.get("repair_bits") or {}).values():
        VOLUME_EC_REPAIR_SYMBOL_BITS.inc(str(bits), amount=bits)


# -- EC plan caches (ops/codec plan_cache_stats via observe_plan_cache) ------

VOLUME_EC_PLAN_CACHE_EVENTS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_plan_cache_events_total",
    "Cumulative LRU events across the repair/piggyback plan caches "
    "(hits, misses, evictions). ops/codec.PLAN_CACHE_SIZE bounds each "
    "cache.",
    labels=("event",))
VOLUME_EC_PLAN_CACHE_ENTRIES = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_plan_cache_entries",
    "Current entry count per plan cache (repair, piggyback, "
    "piggyback_repair, piggyback_decode).",
    labels=("cache",))


def observe_plan_cache(snap: Dict = None):
    """Mirror the codec plan-cache snapshot onto the volume registry
    (process-global monotonic events -> set_total, entry counts ->
    gauge). Called on scrape; pass a snapshot to override (tests)."""
    if snap is None:
        from ..ops.codec import plan_cache_stats
        snap = plan_cache_stats()
    for event, total in (snap.get("events") or {}).items():
        VOLUME_EC_PLAN_CACHE_EVENTS.set_total(total, event)
    for cache, n in (snap.get("entries") or {}).items():
        VOLUME_EC_PLAN_CACHE_ENTRIES.set(n, cache)


# -- streaming spread (ec/spread.py via observe_spread) ----------------------

VOLUME_EC_SPREAD_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_spread_total",
    "Streaming-encode spread events by kind (bytes, sends, stripes, "
    "retries, failovers).",
    labels=("kind",))
VOLUME_EC_SPREAD_SECONDS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_spread_seconds_total",
    "Cumulative spread busy time (union of in-flight send intervals) "
    "across streaming encodes.")
VOLUME_EC_SPREAD_MBPS_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_spread_mbps",
    "Effective shard placement bandwidth of the last streaming encode "
    "(pushed bytes / busy seconds).")
VOLUME_EC_ENCODE_OVERLAP_FRAC_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_encode_overlap_frac",
    "Encode/spread overlap of the last streaming encode: "
    "(serialized_estimate - wall) / serialized_estimate, 0..1.")


def observe_spread(stats: Dict):
    """Export one streaming encode's spread stats (the dict filled by
    ec.encoder.write_ec_files_spread) onto the volume registry."""
    if not stats:
        return
    for kind, key in (("bytes", "spread_bytes"),
                      ("sends", "spread_sends"),
                      ("stripes", "spread_stripes"),
                      ("retries", "spread_retries"),
                      ("failovers", "spread_failovers")):
        n = stats.get(key)
        if n:
            VOLUME_EC_SPREAD_COUNTER.inc(kind, amount=n)
    busy = stats.get("spread_busy_s")
    if busy:
        VOLUME_EC_SPREAD_SECONDS.inc(amount=busy)
    if "spread_mbps" in stats:
        VOLUME_EC_SPREAD_MBPS_GAUGE.set(stats["spread_mbps"])
    if "overlap_frac" in stats:
        VOLUME_EC_ENCODE_OVERLAP_FRAC_GAUGE.set(stats["overlap_frac"])


# -- unified stripe transport (ec/transport.py via observe_transport) --------

VOLUME_EC_TRANSPORT_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_transport_total",
    "Shared stripe-transport events by role (pull, push) and kind "
    "(bytes, transfers, stripes, retries, failovers, hedges_fired, "
    "hedges_won, hedges_lost) — one family across gather, spread, "
    "repair and tier demotion.",
    labels=("role", "kind"))
VOLUME_EC_TRANSPORT_SECONDS = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_transport_seconds_total",
    "Cumulative transport busy time (union of in-flight transfer "
    "intervals) by role.",
    labels=("role",))
VOLUME_EC_TRANSPORT_WINDOW_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_transport_window_stripes",
    "Configured in-flight stripe window of the last transport run, "
    "by role.",
    labels=("role",))
VOLUME_EC_TRANSPORT_PEAK_BUFFER_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_transport_peak_buffer_bytes",
    "Peak in-flight buffered bytes of the last transport run, by role "
    "(window occupancy ceiling: must stay O(window * shards * slab)).",
    labels=("role",))


def observe_transport(role: str, stats, window: int = 0):
    """Export one transport run (a ``TransportStats`` from either side
    of ec/transport.py) onto the volume registry under the unified
    ``ec_transport_*`` family. ``role`` is "pull" or "push"."""
    if stats is None:
        return
    for kind, n in (("bytes", stats.bytes),
                    ("transfers", stats.fetches + stats.sends),
                    ("stripes", stats.stripes),
                    ("retries", stats.retries),
                    ("failovers", stats.failovers),
                    ("hedges_fired", stats.hedges_fired),
                    ("hedges_won", stats.hedges_won),
                    ("hedges_lost", stats.hedges_lost)):
        if n:
            VOLUME_EC_TRANSPORT_COUNTER.inc(role, kind, amount=n)
    busy = stats.busy_s()
    if busy:
        VOLUME_EC_TRANSPORT_SECONDS.inc(role, amount=busy)
    if window:
        VOLUME_EC_TRANSPORT_WINDOW_GAUGE.set(window, role)
    VOLUME_EC_TRANSPORT_PEAK_BUFFER_GAUGE.set(stats.peak_buffered, role)


# -- per-holder health scoreboard (stats/health.py) --------------------------

HOLDER_HEALTH_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_holder_health",
    "0..1 health score per shard holder as seen by this node's reader "
    "stack (1.0 = healthy / no data; latency, error and hedge-loss "
    "EWMAs folded in).",
    labels=("holder",))
HOLDER_LATENCY_EWMA_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_holder_latency_ewma_ms",
    "EWMA of per-fetch latency against each holder, by read kind "
    "(shard_read, repair_read, degraded_read).",
    labels=("holder", "kind"))
HOLDER_EVENT_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_holder_events_total",
    "Per-holder reader-stack events (reads, errors, hedges_lost, "
    "hedges_won_against).",
    labels=("holder", "event"))


def observe_health(snapshot: Dict):
    """Mirror one HolderHealthBoard snapshot (stats/health.py) onto the
    volume registry; called on every /metrics scrape so the master-side
    aggregator sees fresh per-holder scores."""
    if not snapshot:
        return
    for holder, h in snapshot.items():
        HOLDER_HEALTH_GAUGE.set(h["score"], holder)
        for kind, ewma_ms in h.get("latency_ewma_ms", {}).items():
            HOLDER_LATENCY_EWMA_GAUGE.set(ewma_ms, holder, kind)
        for event, n in h.get("events", {}).items():
            HOLDER_EVENT_COUNTER.set_total(n, holder, event)


# -- degraded reads (ec/degraded.py via observe_degraded) --------------------

VOLUME_EC_DEGRADED_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_degraded_total",
    "Degraded-read engine events by kind (reads, batches, "
    "batched_requests, cache_hits, cache_misses, survivor_bytes, "
    "remote_bytes, host_dispatches, device_dispatches, errors).",
    labels=("kind",))
DEGRADED_READ_HISTOGRAM = VOLUME_SERVER_GATHER.histogram(
    "SeaweedFS_volumeServer_ec_degraded_read_seconds",
    "Bucketed latency of reconstruct-on-read requests (the degraded "
    "p99 lives here).")
VOLUME_EC_DEGRADED_BATCH_WIDTH_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_degraded_batch_width",
    "Concurrent reconstruct requests coalesced into the most recent "
    "fused degraded-read dispatch.")
VOLUME_EC_DEGRADED_HIT_RATIO_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_degraded_cache_hit_ratio",
    "Reconstructed-slab LRU hit ratio since process start, 0..1.")
VOLUME_EC_DEGRADED_READAHEAD_RATIO_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_degraded_readahead_hit_ratio",
    "Fraction of readahead-reconstructed slabs later served from the "
    "LRU, 0..1 (SW_EC_DEGRADED_READAHEAD_SLABS).")


def observe_degraded(snap: Dict):
    """Mirror one DegradedReadEngine snapshot onto the volume registry
    (engine counters are process-monotonic, so set_total like the
    telemetry/pool-churn mirrors)."""
    if not snap:
        return
    for kind in ("reads", "batches", "batched_requests", "cache_hits",
                 "cache_misses", "survivor_bytes", "remote_bytes",
                 "host_dispatches", "device_dispatches", "errors",
                 "readahead_slabs", "readahead_hits"):
        VOLUME_EC_DEGRADED_COUNTER.set_total(snap.get(kind, 0), kind)
    VOLUME_EC_DEGRADED_BATCH_WIDTH_GAUGE.set(
        snap.get("last_batch_requests", 0))
    VOLUME_EC_DEGRADED_HIT_RATIO_GAUGE.set(
        snap.get("cache_hit_ratio", 0.0))
    VOLUME_EC_DEGRADED_READAHEAD_RATIO_GAUGE.set(
        snap.get("readahead_hit_ratio", 0.0))


# -- EC integrity scrub (ec/scrub.py via observe_scrub) ----------------------

VOLUME_EC_SCRUB_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_ec_scrub_total",
    "Syndrome-scrub engine events by kind (passes, volumes_scrubbed, "
    "slabs, bytes_verified, corrupt_slabs, corrupt_columns, findings, "
    "host_dispatches, device_dispatches, errors).",
    labels=("kind",))
VOLUME_EC_SCRUB_MBPS_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_scrub_mbps",
    "Gather bandwidth of the most recent scrub pass, MB/s (paced by "
    "SW_EC_SCRUB_RATE_MBPS).")
VOLUME_EC_SCRUB_LAST_PASS_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_ec_scrub_last_pass_unixtime",
    "Wall-clock time the last scrub pass finished; staleness alarm "
    "feed.")


def observe_scrub(snap: Dict):
    """Mirror one ScrubEngine snapshot onto the volume registry."""
    if not snap:
        return
    for kind in ("passes", "volumes_scrubbed", "slabs", "bytes_verified",
                 "remote_bytes", "corrupt_slabs", "corrupt_columns",
                 "findings", "report_failures", "skipped_missing",
                 "skipped_not_owner", "host_dispatches",
                 "device_dispatches", "errors"):
        VOLUME_EC_SCRUB_COUNTER.set_total(snap.get(kind, 0), kind)
    VOLUME_EC_SCRUB_MBPS_GAUGE.set(snap.get("last_pass_mbps", 0.0))
    VOLUME_EC_SCRUB_LAST_PASS_GAUGE.set(snap.get("last_pass_at", 0.0))


# -- the native plane (server/native_plane.py via observe_plane*) ------------

# kLatBoundsUs of csrc/http_plane.cc, in seconds (the tests hold the two
# equal through swhp_lat_bounds)
PLANE_LAT_BUCKETS_S = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                       0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0, 5.0)

PLANE_REQUEST_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_request_total",
    "Native-plane requests by status class (1xx..5xx).",
    labels=("class",))
PLANE_BYTES_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_bytes_total",
    "Bytes written to sockets by the native plane (headers + bodies).")
PLANE_EVENT_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_events_total",
    "Native-plane off-fast-path events by kind (redirects to the "
    "Python server, index misses).",
    labels=("kind",))
PLANE_REQUEST_HISTOGRAM = VOLUME_SERVER_GATHER.histogram(
    "SeaweedFS_volumeServer_plane_request_seconds",
    "Bucketed latency of native-plane requests, measured request-parse "
    "to response-written inside the C++ plane.",
    buckets=PLANE_LAT_BUCKETS_S)
PLANE_SLOW_RING_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_plane_slow_ring_depth",
    "Entries currently held in the native slow-request ring "
    "(GET /admin/plane/slow; threshold SW_PLANE_SLOW_US).")
PLANE_BUILD_FAILED_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_plane_build_failed",
    "1 if the one-time g++ build of the native plane failed and reads "
    "fell back to the Python path (stderr logged at warning).")


def observe_plane(snap: Optional[Dict], slow_depth: int = 0,
                  build_failed: bool = False):
    """Mirror one ``NativeReadPlane.stats()`` snapshot: the counters by
    ``set_total`` (they only grow), the native buckets in place of the
    histogram's."""
    PLANE_BUILD_FAILED_GAUGE.set(1 if build_failed else 0)
    if not snap:
        return
    for cls in ("1xx", "2xx", "3xx", "4xx", "5xx"):
        PLANE_REQUEST_COUNTER.set_total(snap.get(f"status_{cls}", 0), cls)
    PLANE_BYTES_COUNTER.set_total(snap.get("bytes_sent", 0))
    PLANE_EVENT_COUNTER.set_total(snap.get("redirects", 0), "redirect")
    PLANE_EVENT_COUNTER.set_total(snap.get("index_misses", 0), "index_miss")
    buckets = snap.get("buckets") or ()
    PLANE_REQUEST_HISTOGRAM.set_buckets(
        [c for _bound, c in buckets[:len(PLANE_LAT_BUCKETS_S)]],
        snap.get("lat_count", 0), snap.get("lat_sum_us", 0) / 1e6)
    PLANE_SLOW_RING_GAUGE.set(slow_depth)


PLANE_DEGRADED_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_degraded_total",
    "Native-plane EC read outcomes by result: served (lost-shard bytes "
    "filled from the slab cache, zero redirects), redirected (slabs "
    "absent or stale — Python reconstructs), local (all shards local).",
    labels=("result",))
PLANE_CACHE_EVENT_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_cache_events_total",
    "Reconstructed-slab cache flow by event (puts, hits, misses, "
    "evictions, invalidated).",
    labels=("event",))
PLANE_CACHE_BYTES_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_cache_put_bytes_total",
    "Slab bytes published into the native plane's cache.")
PLANE_CACHE_ENTRIES_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_plane_cache_entries",
    "Slabs currently resident in the native plane's cache.")
PLANE_CACHE_BYTES_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_plane_cache_bytes",
    "Bytes currently resident in the native plane's cache (bounded by "
    "SW_PLANE_CACHE_BYTES).")
PLANE_CACHE_MAX_BYTES_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_plane_cache_max_bytes",
    "Configured byte budget of the native plane's slab cache "
    "(SW_PLANE_CACHE_BYTES; 0 = in-plane degraded path disabled).")


def observe_plane_cache(snap: Optional[Dict]):
    """Mirror one ``NativeReadPlane.cache_stats()`` snapshot."""
    if not snap:
        return
    PLANE_DEGRADED_COUNTER.set_total(snap.get("degraded_served", 0),
                                     "served")
    PLANE_DEGRADED_COUNTER.set_total(snap.get("degraded_redirected", 0),
                                     "redirected")
    PLANE_DEGRADED_COUNTER.set_total(snap.get("ec_local_served", 0), "local")
    for event in ("puts", "hits", "misses", "evictions", "invalidated"):
        PLANE_CACHE_EVENT_COUNTER.set_total(snap.get(event, 0), event)
    PLANE_CACHE_BYTES_COUNTER.set_total(snap.get("put_bytes", 0))
    PLANE_CACHE_ENTRIES_GAUGE.set(snap.get("entries", 0))
    PLANE_CACHE_BYTES_GAUGE.set(snap.get("bytes", 0))
    PLANE_CACHE_MAX_BYTES_GAUGE.set(snap.get("max_bytes", 0))


PLANE_FSYNC_BATCH_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_fsync_batches_total",
    "Group commits issued by the native plane: one fdatasync pair "
    "(.dat + .idx) covering every rider in the batch; 'always' mode "
    "counts each per-append fsync as a batch of one.")
PLANE_FSYNC_RIDER_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_fsync_riders_total",
    "Appends whose ack was covered by a group commit; riders/batches "
    "is the fsync amortization ratio (1.0 = no batching win).")
PLANE_FSYNC_FAILURE_COUNTER = VOLUME_SERVER_GATHER.counter(
    "SeaweedFS_volumeServer_plane_fsync_failures_total",
    "fdatasync errors: the batch poisoned (-5 to every waiting append, "
    "nothing acked) and the writer fail-stopped — Python demoted the "
    "volume to its own append path.")
PLANE_FSYNC_HISTOGRAM = VOLUME_SERVER_GATHER.histogram(
    "SeaweedFS_volumeServer_plane_fsync_seconds",
    "Bucketed duration of the committer's covering fdatasync pair "
    "(populated only while SW_PLANE_STATS is on — stats off keeps the "
    "committer clock-free).",
    buckets=PLANE_LAT_BUCKETS_S)
PLANE_FSYNC_PENDING_GAUGE = VOLUME_SERVER_GATHER.gauge(
    "SeaweedFS_volumeServer_plane_fsync_pending",
    "Appends currently parked awaiting their covering group commit "
    "(bounded by SW_PLANE_FSYNC_MAX_PENDING per batch).")


def observe_plane_sync(snap: Optional[Dict]):
    """Mirror one ``NativeReadPlane.sync_stats()`` snapshot."""
    if not snap:
        return
    PLANE_FSYNC_BATCH_COUNTER.set_total(snap.get("batches", 0))
    PLANE_FSYNC_RIDER_COUNTER.set_total(snap.get("riders", 0))
    PLANE_FSYNC_FAILURE_COUNTER.set_total(snap.get("failures", 0))
    buckets = snap.get("buckets") or ()
    PLANE_FSYNC_HISTOGRAM.set_buckets(
        [c for _bound, c in buckets[:len(PLANE_LAT_BUCKETS_S)]],
        sum(c for _bound, c in buckets), snap.get("fsync_us_sum", 0) / 1e6)
    PLANE_FSYNC_PENDING_GAUGE.set(snap.get("pending", 0))


# -- repair queue (stats/repair_queue.py via observe_repair_queue) -----------

MASTER_REPAIR_QUEUE_COUNTER = MASTER_GATHER.counter(
    "SeaweedFS_master_repair_queue_incidents_total",
    "Repair-queue incident flow by kind and event (reported, resolved, "
    "attempts, attempt_failures, duplicates).",
    labels=("kind", "event"))
MASTER_REPAIR_QUEUE_OPEN_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_repair_queue_open",
    "Open incidents by kind (corruption, lost_shard, at_risk_holder).",
    labels=("kind",))
MASTER_REPAIR_QUEUE_TTR_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_repair_queue_ttr_seconds",
    "Time-to-re-protection over recent resolved incidents (quantile "
    "label: p50, p99, max).",
    labels=("quantile",))
MASTER_REPAIR_QUEUE_UNATTRIBUTED_GAUGE = MASTER_GATHER.gauge(
    "SeaweedFS_master_repair_queue_unattributed",
    "Open scrub findings with no attributable shard (shard=-1): "
    "visible at /cluster/repairs, excluded from the drain loop until "
    "an operator or a later scrub attributes them.")


def observe_repair_queue(snap: Dict):
    """Mirror one RepairQueue snapshot onto the master registry."""
    if not snap:
        return
    counters = snap.get("counters", {})
    for event in ("reported", "resolved", "attempts",
                  "attempt_failures", "duplicates"):
        MASTER_REPAIR_QUEUE_COUNTER.set_total(
            counters.get(event, 0), "all", event)
    for kind, depth in snap.get("depth", {}).items():
        MASTER_REPAIR_QUEUE_OPEN_GAUGE.set(depth, kind)
    MASTER_REPAIR_QUEUE_UNATTRIBUTED_GAUGE.set(
        snap.get("unattributed", 0))
    ttr = snap.get("time_to_re_protection", {})
    MASTER_REPAIR_QUEUE_TTR_GAUGE.set(ttr.get("p50_s", 0.0), "p50")
    MASTER_REPAIR_QUEUE_TTR_GAUGE.set(ttr.get("p99_s", 0.0), "p99")
    MASTER_REPAIR_QUEUE_TTR_GAUGE.set(ttr.get("max_s", 0.0), "max")


class SmallDispatchTuner:
    """Fits the host/device crossover from the first-N reconstruct
    spans: device dispatch time is modeled as a + b*bytes (fixed
    dispatch+transfer latency plus per-byte cost), the host path as a
    flat rate, and the suggested threshold is the width where the
    device line dips below the host line.  Published as a gauge, and
    installed as the live crossover when ops/codec.SMALL_DISPATCH_AUTO
    is on."""

    MIN_SAMPLES = 4          # per path, before suggesting anything
    MAX_SAMPLES = 64         # "first few calls" — stop learning after
    CLAMP = (64 << 10, 8 << 20)

    def __init__(self):
        self._lock = make_lock("torch.metrics.SmallDispatchTuner._lock")
        self._host: List[Tuple[float, float]] = []    # (bytes, seconds)
        self._device: List[Tuple[float, float]] = []

    def add(self, path: str, nbytes: float, seconds: float):
        if nbytes <= 0 or seconds <= 0:
            return None
        with self._lock:
            samples = self._host if path == "host" else self._device
            if len(samples) >= self.MAX_SAMPLES:
                return None
            samples.append((float(nbytes), float(seconds)))
        return self.suggest()

    def suggest(self) -> Optional[int]:
        with self._lock:
            host = list(self._host)
            device = list(self._device)
        if len(host) < self.MIN_SAMPLES or len(device) < self.MIN_SAMPLES:
            return None
        host_rate = sum(b for b, _ in host) / sum(s for _, s in host)
        # least-squares fit t = a + b*x over the device samples
        n = len(device)
        mx = sum(b for b, _ in device) / n
        my = sum(s for _, s in device) / n
        sxx = sum((b - mx) ** 2 for b, _ in device)
        if sxx <= 0:            # all widths identical — can't fit slope
            return None
        b_fit = sum((x - mx) * (y - my) for x, y in device) / sxx
        a_fit = my - b_fit * mx
        denom = 1.0 / host_rate - b_fit
        if denom <= 0:
            # the device line is no shallower than the host's: past the
            # sampled range the host wins, or the fit is degenerate
            return self.CLAMP[1]
        if a_fit <= 0:
            # a shallower device line that starts at or below zero lies
            # under the host line at every width: the card always wins
            return self.CLAMP[0]
        cross = a_fit / denom
        return int(min(max(cross, self.CLAMP[0]), self.CLAMP[1]))


SMALL_DISPATCH_TUNER = SmallDispatchTuner()


def observe_span(span_dict: Dict):
    """Export hook called by util/tracing for every finished span."""
    name = span_dict.get("name")
    dur = span_dict.get("duration_s")
    if dur is None:
        return
    if name in EC_PHASE_NAMES:
        VOLUME_EC_PHASE_HISTOGRAM.observe(dur, name)
        VOLUME_EC_PHASE_COUNTER.inc(name, amount=dur)
    elif name == "reconstruct":
        tags = span_dict.get("tags") or {}
        path = tags.get("path")
        # the crossover is a width (bytes a survivor row), so the tuner
        # learns widths; the JAX package feeds it ``bytes`` (k rows)
        width = tags.get("width")
        if path in ("host", "device") and width:
            suggestion = SMALL_DISPATCH_TUNER.add(path, width, dur)
            if suggestion:
                SMALL_DISPATCH_SUGGESTED_GAUGE.set(suggestion)
                # opt-in auto-apply: feed the fitted crossover back
                # into the live hybrid threshold instead of only
                # publishing it
                from ..ops.codec import maybe_auto_apply_small_dispatch
                maybe_auto_apply_small_dispatch(suggestion)


def start_push_loop(registry: Registry, gateway_url: str,
                    job: str, interval_s: float = 15.0,
                    stop_event: Optional[threading.Event] = None
                    ) -> threading.Thread:
    """Push-gateway parity (reference LoopPushingMetric,
    metrics.go:109-137): POST the text exposition on an interval."""
    from ..server.http_util import http_call
    stop = stop_event or threading.Event()

    def loop():
        while not stop.wait(interval_s):
            try:
                http_call(
                    "POST",
                    f"{gateway_url.rstrip('/')}/metrics/job/{job}",
                    registry.render().encode(),
                    {"Content-Type": "text/plain"})
            except Exception:  # noqa: BLE001 - a flaky gateway (bad
                # status line, reset, DNS) must never kill the loop:
                # nothing would ever restart it
                pass

    t = threading.Thread(target=loop, daemon=True, name="metrics-push")
    t.stop_event = stop
    t.start()
    return t
