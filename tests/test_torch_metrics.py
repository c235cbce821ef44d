"""The port's metrics (``stats/metrics``) and the small-dispatch tuner
against the JAX package's.

- The same observations into fresh ``Registry``s of both packages
  (counters, gauges, histograms, label values that need escaping,
  exemplars with fixed trace ids and a fixed clock) render
  byte-identical; ``parse_prometheus_text`` gives equal families on
  both renders and ``render_families`` of them is the render again (the
  JAX fixed point), exemplars included; a malformed line raises in both.
- The gatherers: every family the port registers is the JAX package's
  (name, kind, label names), and the JAX families the port lacks are
  only the filer's and the native plane's.
- The ``observe_*`` mirrors render the same series for the same
  snapshots (both packages' gatherers swapped for fresh registries).
- ``SmallDispatchTuner``: the same (path, bytes, seconds) samples give
  the same suggestions and clamps; ``dispatch_threshold`` is equal under
  the same override. The clamp fault of the JAX tuner, not copied: a fit
  whose device line starts at or below zero under a shallower slope
  (the card wins at every width) gives the JAX package's high clamp and
  the port's low one; a device line no shallower than the host's gives
  the high clamp in both.
- The tuner's unit: on the same host and device reconstruct calls, fed
  through each package's ``observe_span`` with the same durations and
  auto-apply on, the JAX package installs k times the port's crossover
  (it learns from the span's ``bytes``, k x width, and compares the
  override with a width); a width between the two takes the device path
  in the port and the host path in JAX.

Tolerances: none, but that the k x relation holds up to the int()
truncation of each fit (less than k bytes)."""

import pytest


def _fill(m):
    """One set of observations into a fresh registry of module ``m``."""
    reg = m.Registry()
    c = reg.counter("x_requests_total", 'Requests "by" op\\n and\nmore',
                    labels=("op",))
    c.inc("GET /a")
    c.inc("GET /a")
    c.inc('we"ird\\label\nx', amount=2.5)
    c.set_total(12345678901.0, "mirrored")
    g = reg.gauge("x_bandwidth_mbps", "Last MB/s.", labels=("node", "kind"))
    g.set(812.3456789, "n:1", "read")
    g.set(float("inf"), "n:2", "write")
    g.set(-3, "n:3", "a,b")
    h = reg.histogram("x_latency_seconds", "Latency.", labels=("op",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v, tid in ((0.0004, "a" * 32), (0.004, None), (0.05, "b" * 32),
                   (0.05, "c" * 32), (3.0, "d" * 32), (0.5, None)):
        h.observe(v, "GET /a", trace_id=tid)
    h.observe(0.02, "POST /b")
    h.set_buckets([1, 2, 0, 1], 5, 7.25, "mirrored")
    reg.counter("x_empty_total", "No series.")
    reg.gauge("x_plain", "No labels.").set(0.1 + 0.2)
    return reg


def test_registries_render_byte_identical(monkeypatch):
    import seaweedfs_tpu.stats.metrics as ref
    import seaweedfs_tpu_torch.stats.metrics as port
    for m in (ref, port):
        monkeypatch.setattr(m.time, "time", lambda: 1700000000.125)
    mine, theirs = _fill(port).render(), _fill(ref).render()
    assert mine == theirs
    assert ' # {trace_id="' + "d" * 32 + '"} 3 1700000000.125' in mine
    fams = port.parse_prometheus_text(mine)
    assert fams == ref.parse_prometheus_text(theirs)
    assert port.render_families(fams) == mine
    assert ref.render_families(fams) == mine
    assert [f["name"] for f in fams] == [
        "x_requests_total", "x_bandwidth_mbps", "x_latency_seconds",
        "x_empty_total", "x_plain"]
    lat = fams[2]
    # one exemplar a bucket, the newest: c replaced b in le="0.1"
    assert lat["kind"] == "histogram" and len(lat["exemplars"]) == 3


@pytest.mark.parametrize("text", [
    'x_total{op=unquoted} 1\n',
    'x_total{op="unterminated} 1\n',
    'x_total{op="a"} 1 # {trace_id="t"} 1\n',
])
def test_malformed_exposition_raises_in_both(text):
    import seaweedfs_tpu.stats.metrics as ref
    import seaweedfs_tpu_torch.stats.metrics as port
    for m in (ref, port):
        with pytest.raises(ValueError):
            m.parse_prometheus_text(text)


LEFT_OUT = ("SeaweedFS_volumeServer_plane_",
            "SeaweedFS_volumeServer_fast_plane_", "SeaweedFS_filer_")


@pytest.mark.parametrize("gather", ["MASTER_GATHER", "VOLUME_SERVER_GATHER"])
def test_gatherers_carry_the_jax_families(gather):
    import seaweedfs_tpu.stats.metrics as ref
    import seaweedfs_tpu_torch.stats.metrics as port

    def families(m):
        return {f.name: (f.kind, f.label_names,
                         getattr(f, "buckets", None))
                for f in getattr(m, gather)._metrics}
    mine, theirs = families(port), families(ref)
    assert all(theirs[name] == shape for name, shape in mine.items())
    assert sorted(n for n in theirs if n not in mine) == sorted(
        n for n in theirs if n.startswith(LEFT_OUT))
    assert not any(n.startswith(LEFT_OUT) for n in mine)
    assert port.EC_PHASE_NAMES == ref.EC_PHASE_NAMES


class _TStats:
    """A ``TransportStats`` stand-in for ``observe_transport``."""
    bytes, fetches, sends, stripes, retries = 4096, 7, 0, 2, 1
    failovers, hedges_fired, hedges_won, hedges_lost = 0, 2, 1, 1
    peak_buffered = 8192

    def busy_s(self):
        return 0.375


SNAPS = {
    "observe_gather": {"gather_bytes": 1 << 20, "gather_fetches": 14,
                       "gather_stripes": 2, "gather_retries": 1,
                       "hedges_fired": 0, "gather_busy_s": 0.25,
                       "gather_mbps": 4194.3, "overlap_frac": 0.31},
    "observe_repair": {"repair_mode": "trace", "repair_bytes": 720,
                       "repair_baseline_bytes": 1024,
                       "gather_busy_s": 0.5, "repair_bytes_frac": 0.6875,
                       "repair_bits": {"1": 4, "2": 8}},
    "observe_spread": {"spread_bytes": 12 << 20, "spread_sends": 24,
                       "spread_stripes": 2, "spread_busy_s": 0.75,
                       "spread_mbps": 16.8, "overlap_frac": 0.5},
    "observe_mesh": {"mesh_dispatches": 3,
                     "mesh_device_bytes": {"cuda:0/0": 100,
                                           "cuda:0/1": 50},
                     "dispatch_width_devices": 2,
                     "device_busy_frac": {"cuda:0/0": 1.0,
                                          "cuda:0/1": 0.5}},
    "observe_device_stats": {
        "compiles": {"gf_plan.make_plan": 3}, "compile_seconds":
        {"gf_plan.make_plan": 0.0125}, "recompiles": {}, "sentinel": False,
        "dispatches": {"rs_hopper.gf_matmul": 41}, "device_samples": {},
        "device_seconds": {}, "const_cache": {"hits": 9, "misses": 3,
                                              "evictions": 0},
        "const_cache_occupancy": {"entries": 3, "bytes": 4096}},
    "observe_plan_cache": {"events": {"hits": 4, "misses": 2,
                                      "evictions": 0},
                           "entries": {"repair": 1, "piggyback": 1}},
    "observe_degraded": {"reads": 40, "batches": 9, "survivor_bytes": 77,
                         "host_dispatches": 1, "device_dispatches": 8,
                         "last_batch_requests": 3, "cache_hit_ratio": 0.25},
    "observe_scrub": {"passes": 2, "slabs": 28, "findings": 1,
                      "last_pass_mbps": 900.5, "last_pass_at": 17.0},
    "observe_health": {"h:1": {"score": 0.3125,
                               "latency_ewma_ms": {"shard_read": 110.0},
                               "events": {"reads": 9, "errors": 2}}},
    "observe_repair_queue": {"counters": {"reported": 3, "resolved": 2},
                             "depth": {"lost_shard": 1},
                             "unattributed": 0,
                             "time_to_re_protection": {"p50_s": 1.5,
                                                       "p99_s": 2.5,
                                                       "max_s": 2.5}},
}


def _mirror_render(m, monkeypatch):
    """Every mirror once into fresh copies of ``m``'s gatherers."""
    import copy
    import threading
    for reg in ("MASTER_GATHER", "VOLUME_SERVER_GATHER"):
        fresh = m.Registry()
        for metric in getattr(m, reg)._metrics:
            clone = copy.copy(metric)
            for attr in ("_values", "_counts", "_sums", "_totals",
                         "_exemplars"):
                if hasattr(clone, attr):
                    setattr(clone, attr, {})
            clone._lock = threading.Lock()
            fresh.register(clone)
            for name, value in vars(m).items():
                if value is metric:
                    monkeypatch.setattr(m, name, clone)
        monkeypatch.setattr(m, reg, fresh)
    inventory = {"platform": "gpu", "devices": [
        {"id": 0, "memory_stats": {"allocated_bytes.all.current": 2048}}]}
    for fn, snap in SNAPS.items():
        if fn == "observe_device_stats":
            m.observe_device_stats(snap, None, inventory)
        else:
            getattr(m, fn)(snap)
    m.observe_transport("pull", _TStats(), window=4)
    return m.VOLUME_SERVER_GATHER.render() + m.MASTER_GATHER.render()


def test_mirrors_render_the_same_series(monkeypatch):
    import seaweedfs_tpu.stats.metrics as ref
    import seaweedfs_tpu_torch.stats.metrics as port
    mine = _mirror_render(port, monkeypatch)
    theirs = _mirror_render(ref, monkeypatch)
    keep = [ln for ln in theirs.splitlines()
            if not ln.startswith("# HELP") and not any(
                f" {p}" in ln or ln.startswith(p) for p in LEFT_OUT)]
    mine_lines = [ln for ln in mine.splitlines()
                  if not ln.startswith("# HELP")]
    assert mine_lines == keep
    assert 'SeaweedFS_volumeServer_ec_xla_dispatches_total{entry=' \
           '"rs_hopper.gf_matmul"} 41' in mine
    assert 'SeaweedFS_volumeServer_ec_transport_total{role="pull",' \
           'kind="hedges_lost"} 1' in mine


TUNER_CASES = {
    # device line a + b*w against a flat host rate: crosses inside
    "crosses": ([("host", w, w / 1e9) for w in (4e4, 8e4, 1.2e5, 1.6e5)]
                + [("device", w, 1e-4 + w / 1e10)
                   for w in (2.5e5, 5e5, 1e6, 2e6)]),
    # the device always wins: the low clamp
    "low clamp": ([("host", w, w / 1e7) for w in (4e4, 8e4, 1.2e5, 1.6e5)]
                  + [("device", w, 1e-6 + w / 1e10)
                     for w in (2.5e5, 5e5, 1e6, 2e6)]),
    # the device never wins: the high clamp
    "high clamp": ([("host", w, w / 1e11) for w in (4e4, 8e4, 1.2e5, 2e5)]
                   + [("device", w, 1e-3 + w / 1e10)
                      for w in (2.5e5, 5e5, 1e6, 2e6)]),
    # one width on the device: no slope, no answer
    "flat": ([("host", w, w / 1e9) for w in (4e4, 8e4, 1.2e5, 1.6e5)]
             + [("device", 5e5, 1e-4 + 5e5 / 1e10)] * 4),
    # too few samples, bad samples dropped
    "few": [("host", 4e4, 4e-5), ("device", 0, 1.0), ("device", 1e6, 0),
            ("host", 8e4, 8e-5)],
}


@pytest.mark.parametrize("case", sorted(TUNER_CASES))
def test_tuner_suggestions_match_jax(case):
    import seaweedfs_tpu.stats.metrics as ref
    import seaweedfs_tpu_torch.stats.metrics as port
    tuners = [ref.SmallDispatchTuner(), port.SmallDispatchTuner()]
    for path, nbytes, secs in TUNER_CASES[case]:
        got = [t.add(path, nbytes, secs) for t in tuners]
        assert got[0] == got[1]
    final = [t.suggest() for t in tuners]
    assert final[0] == final[1]
    expect = {"crosses": 111111, "low clamp": 64 << 10,
              "high clamp": 8 << 20, "flat": None, "few": None}[case]
    assert final[1] == expect
    assert port.SmallDispatchTuner.CLAMP == ref.SmallDispatchTuner.CLAMP
    assert port.SmallDispatchTuner.MAX_SAMPLES == \
        ref.SmallDispatchTuner.MAX_SAMPLES


NEGATIVE_INTERCEPT = {
    # host 10 MB/s; the device 1 GB/s from -0.1 ms: below the host line
    # at every width, so the card always wins
    "shallower": ([("host", w, w / 1e7) for w in (4e4, 8e4, 1.2e5, 1.6e5)]
                  + [("device", w, -1e-4 + w / 1e9)
                     for w in (2e6, 4e6, 6e6, 8e6)]),
    # the device line no shallower than the host's: the host wins past
    # the sampled range, whatever the intercept
    "steeper": ([("host", w, w / 1e10) for w in (4e4, 8e4, 1.2e5, 1.6e5)]
                + [("device", w, -1e-4 + w / 1e9)
                   for w in (2e6, 4e6, 6e6, 8e6)]),
}


@pytest.mark.parametrize("case", sorted(NEGATIVE_INTERCEPT))
def test_negative_intercept_clamp_differs_from_jax(case):
    """The clamp fault of the JAX tuner, not copied into the port."""
    import seaweedfs_tpu.stats.metrics as ref
    import seaweedfs_tpu_torch.stats.metrics as port
    tuners = [ref.SmallDispatchTuner(), port.SmallDispatchTuner()]
    for path, nbytes, secs in NEGATIVE_INTERCEPT[case]:
        assert secs > 0
        for t in tuners:
            t.add(path, nbytes, secs)
    got = [t.suggest() for t in tuners]
    if case == "shallower":
        assert got == [8 << 20, 64 << 10]
        assert got[1] == port.SmallDispatchTuner.CLAMP[0]
    else:
        assert got == [8 << 20, 8 << 20]


@pytest.mark.parametrize("override", [None, 96 << 10, 3 << 20])
def test_dispatch_threshold_matches_jax(monkeypatch, override):
    from seaweedfs_tpu.ops import codec as ref_codec
    from seaweedfs_tpu_torch.ops import codec as ops_codec
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
    monkeypatch.setattr(ref_codec, "_SMALL_DISPATCH_OVERRIDE", None)
    monkeypatch.setattr(ops_codec, "_SMALL_DISPATCH_OVERRIDE", None)
    ref_codec.set_small_dispatch_override(override)
    ops_codec.set_small_dispatch_override(override)
    assert ops_codec.small_dispatch_override() == \
        ref_codec.small_dispatch_override() == override
    for thr in (0, 256 << 10):
        ref_c = ref_codec.NumpyCodec(10, 4)
        ref_c.small_dispatch_bytes = thr
        port_c = TorchCodec(10, 4, device="cpu", small_dispatch_bytes=thr)
        assert ops_codec.dispatch_threshold(port_c) == \
            ref_codec.dispatch_threshold(ref_c)
        assert ops_codec.dispatch_threshold(port_c) == \
            (0 if not thr else (override or thr))


def _reconstruct_spans(tracing, codec, widths, rng):
    """Each width's reconstruct with shards 0 and 11 lost, through
    ``codec``; the ``reconstruct`` span each left."""
    import numpy as np
    seen = []
    tracing.add_finish_hook(seen.append)
    try:
        for w in widths:
            data = rng.integers(0, 256, (codec.k, w), dtype=np.uint8)
            shards = list(np.concatenate([data, codec.encode(data)]))
            shards[0] = shards[11] = None
            out = codec.reconstruct(shards)
            assert np.array_equal(out[0], data[0])
    finally:
        tracing.remove_finish_hook(seen.append)
    return [s for s in seen if s["name"] == "reconstruct"]


def test_auto_applied_crossover_is_k_times_wider_in_jax(monkeypatch):
    """The unit fault of the JAX tuner, not copied: the same samples,
    the same durations, auto-apply on in both packages."""
    import numpy as np
    import seaweedfs_tpu.stats.metrics as ref_metrics
    import seaweedfs_tpu_torch.stats.metrics as port_metrics
    from seaweedfs_tpu.ops import codec as ref_codec
    from seaweedfs_tpu.util import tracing as ref_tracing
    from seaweedfs_tpu_torch.ops import codec as ops_codec
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
    from seaweedfs_tpu_torch.util import tracing
    monkeypatch.setenv("SW_EC_SMALL_DISPATCH_AUTO", "0")
    monkeypatch.setattr(ops_codec, "SMALL_DISPATCH_AUTO", False)
    for mod in (ref_codec, ops_codec):
        monkeypatch.setattr(mod, "_SMALL_DISPATCH_OVERRIDE", None)
    for mod in (ref_metrics, port_metrics):
        # the calls below feed the live tuner their measured durations
        monkeypatch.setattr(mod, "SMALL_DISPATCH_TUNER",
                            mod.SmallDispatchTuner())
    k, thr = 10, 256 << 10
    # the JAX reconstruct's path is its threshold's alone, so its oracle
    # codec with a threshold leaves the spans a device codec would
    ref_c = ref_codec.NumpyCodec(k, 4)
    ref_c.small_dispatch_bytes = thr
    port_c = TorchCodec(k, 4, device="cpu", small_dispatch_bytes=thr)
    widths = [40_000, 80_000, 120_000, 160_000,
              262_144, 300_000, 400_000, 500_000]
    ref_spans = _reconstruct_spans(ref_tracing, ref_c, widths,
                                   np.random.default_rng(1))
    port_spans = _reconstruct_spans(tracing, port_c, widths,
                                    np.random.default_rng(1))
    assert [(s["tags"]["bytes"], s["tags"]["path"]) for s in ref_spans] \
        == [(s["tags"]["bytes"], s["tags"]["path"]) for s in port_spans] \
        == [(k * w, "host" if w < thr else "device") for w in widths]
    assert [s["tags"]["width"] for s in port_spans] == widths
    # one clock for both: 1 GB/s of width on the host, 0.1 ms + 10 GB/s
    # on the device (neither answer clamped), into fresh tuners
    monkeypatch.setenv("SW_EC_SMALL_DISPATCH_AUTO", "1")
    monkeypatch.setattr(ops_codec, "SMALL_DISPATCH_AUTO", True)
    for mod in (ref_metrics, port_metrics):
        monkeypatch.setattr(mod, "SMALL_DISPATCH_TUNER",
                            mod.SmallDispatchTuner())
    for ref_s, port_s, w in zip(ref_spans, port_spans, widths):
        secs = w / 1e9 if w < thr else 1e-4 + w / 1e10
        ref_metrics.observe_span(dict(ref_s, duration_s=secs))
        port_metrics.observe_span(dict(port_s, duration_s=secs))
    port_thr = ops_codec.small_dispatch_override()
    ref_thr = ref_codec.small_dispatch_override()
    assert port_thr == 111111          # 1e-4 / (1e-9 - 1e-10), a width
    assert abs(ref_thr - k * 1e-4 / (1e-9 - 1e-10)) < 1
    assert abs(ref_thr - k * port_thr) < k
    assert ops_codec.dispatch_threshold(port_c) == port_thr
    assert ref_codec.dispatch_threshold(ref_c) == ref_thr
    # a width between the two: the device in the port, the host in JAX
    mid = [600_000]
    assert port_thr < mid[0] < ref_thr
    monkeypatch.setattr(ops_codec, "SMALL_DISPATCH_AUTO", False)
    monkeypatch.setenv("SW_EC_SMALL_DISPATCH_AUTO", "0")
    (ref_s,) = _reconstruct_spans(ref_tracing, ref_c, mid,
                                  np.random.default_rng(2))
    (port_s,) = _reconstruct_spans(tracing, port_c, mid,
                                   np.random.default_rng(2))
    assert (port_s["tags"]["path"], ref_s["tags"]["path"]) == \
        ("device", "host")
