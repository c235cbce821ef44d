"""Device-runtime accounting: kernel launches, builds and constants.

The JAX package's ``ops/device_stats.py`` with its snapshot's keys, where
their meaning carries to hand-written kernels:

- **dispatches** — calls of each kernel entry, on any device, as JAX
  counts a jit dispatch on any backend: ``rs_hopper.gf_matmul`` (K1),
  ``rs_bitplane.bitplane_matmul`` (K6a) and
  ``rs_bitplane.bitplane_matmul_batched`` (K6b); on the CPU a call of
  the plain version. The multi-device programs count one dispatch a
  call under the JAX package's names (``mesh_codec._fn``,
  ``sharded_ec.encode_fn``, ``sharded_ec.rebuild_fn``); their K1
  launches, one a mesh position, count under K1.
- **launches** — the same entries' kernel launches on the card, counted
  once a launch has returned without error (a call on the CPU, or a
  launch that raised, moves ``dispatches`` only). This is the port's one
  launch counter: a run holds the card to its work by it.
- **compiles / compile_seconds** — the port's builds: the nvcc build of a
  kernel library (``rs_hopper.build_library``, entry ``nvcc:<library>``)
  and the tile plans of ``gf_plan.make_plan`` (entry
  ``gf_plan.make_plan``).
- **recompiles / sentinel / offenders** — a plan built a second time for
  the same coefficient bytes by one owner (a codec's constant cache), or
  a library built twice: the one-plan-per-matrix rule broken. The first
  latches ``sentinel``; the offenders list is bounded.
- **const_cache / const_cache_occupancy** — hits, misses and evictions of
  ``ops/codec._ConstCache`` (the device-resident plans), and the entries
  and bytes the live caches hold.
- **sampled device time** — with ``timing`` on, every ``sample_every``th
  call of an entry is timed: by CUDA events on the card, by
  ``perf_counter`` on the CPU. With it off (the default) the hot path
  takes one lock per counter it bumps and reads no clock, makes no
  synchronization (tests prove it by monkeypatching ``_perf_counter``).

``device_inventory`` reads ``torch.cuda`` (platform, device kind x count,
``memory_stats()``) and initializes no CUDA unless forced;
``admin_snapshot`` (``GET /admin/devices``) forces it. ``delta`` is the
movement since a snapshot, the per-leg report. The JAX knobs
SW_EC_DEVICE_TIMING and SW_EC_DEVICE_TIMING_SAMPLE are ``configure``'s
arguments here (defaults off and 1); the port reads no environment.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from time import perf_counter as _perf_counter
from typing import Any, Callable, Dict, List

#: Entry names of the three kernels.
K1 = "rs_hopper.gf_matmul"
K6A = "rs_bitplane.bitplane_matmul"
K6B = "rs_bitplane.bitplane_matmul_batched"
PLAN_ENTRY = "gf_plan.make_plan"
#: Entry names of the multi-device programs (parallel/), which launch K1
#: at every mesh position.
MESH_FN = "mesh_codec._fn"
SHARDED_ENCODE = "sharded_ec.encode_fn"
SHARDED_REBUILD = "sharded_ec.rebuild_fn"

#: Offenders latched by the sentinel are capped here; past that the
#: counters still move.
MAX_OFFENDERS = 8

TIMING = False       # SW_EC_DEVICE_TIMING
SAMPLE_EVERY = 1     # SW_EC_DEVICE_TIMING_SAMPLE

_TIMED_FIELDS = ("compiles", "compile_seconds", "recompiles", "dispatches",
                 "launches", "device_samples", "device_seconds")


def coeff_key(coeffs) -> tuple:
    """A coefficient matrix's identity for the recompile sentinel: its
    shape and a digest of its bytes."""
    return (tuple(coeffs.shape),
            hashlib.sha1(coeffs.tobytes()).hexdigest()[:16])


class DeviceStats:
    """Per-entry launch, build and timing accounting (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles: Dict[str, int] = {}
        self.compile_seconds: Dict[str, float] = {}
        self.recompiles: Dict[str, int] = {}
        self.dispatches: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.device_samples: Dict[str, int] = {}
        self.device_seconds: Dict[str, float] = {}
        # (entry, key) -> builds; a second one latches the sentinel
        self._built: Dict[tuple, int] = {}
        self.sentinel = False
        self.offenders: List[str] = []
        self.const_cache: Dict[str, int] = {
            "hits": 0, "misses": 0, "evictions": 0}
        self._const_caches: "weakref.WeakSet" = weakref.WeakSet()
        self.configure()

    def configure(self, timing: bool = TIMING,
                  sample_every: int = SAMPLE_EVERY):
        """Sampled device timing on or off, and its period."""
        self.timing_enabled = bool(timing)
        self.sample_every = max(1, int(sample_every))

    # -- hot path ------------------------------------------------------

    def tick(self, entry: str) -> bool:
        """Count one call of ``entry``; True when this one is to be
        timed. With timing off: one lock, one increment, no clock."""
        with self._lock:
            n = self.dispatches.get(entry, 0) + 1
            self.dispatches[entry] = n
        if not self.timing_enabled:
            return False
        return n % self.sample_every == 0

    def note_launch(self, entry: str):
        """One kernel launch of ``entry`` on the card that returned
        without error."""
        with self._lock:
            self.launches[entry] = self.launches.get(entry, 0) + 1

    def launch_count(self, entry: str) -> int:
        """``entry``'s kernel launches on the card."""
        with self._lock:
            return self.launches.get(entry, 0)

    def reset_counts(self):
        """Every entry's dispatches and launches back to 0 (a run's
        counts start here)."""
        with self._lock:
            self.dispatches = {}
            self.launches = {}

    # -- slow-path events ----------------------------------------------

    def note_compile(self, entry: str, key: Any, seconds: float,
                     owner: Any = None):
        """One build of ``entry``. A second build of the same ``key`` by
        the same ``owner`` is a recompile; builds with no owner (a plan
        made by hand) never are."""
        with self._lock:
            self.compiles[entry] = self.compiles.get(entry, 0) + 1
            self.compile_seconds[entry] = \
                self.compile_seconds.get(entry, 0.0) + seconds
            if owner is None:
                return
            k = (entry, owner, key)
            seen = self._built.get(k, 0) + 1
            self._built[k] = seen
            if seen > 1:
                self.recompiles[entry] = self.recompiles.get(entry, 0) + 1
                self.sentinel = True
                if len(self.offenders) < MAX_OFFENDERS:
                    self.offenders.append(f"{entry}:{key!r}")

    def note_device_time(self, entry: str, seconds: float):
        with self._lock:
            self.device_samples[entry] = \
                self.device_samples.get(entry, 0) + 1
            self.device_seconds[entry] = \
                self.device_seconds.get(entry, 0.0) + seconds

    def note_const_cache(self, event: str, n: int = 1):
        with self._lock:
            self.const_cache[event] = self.const_cache.get(event, 0) + n

    def register_const_cache(self, cache):
        self._const_caches.add(cache)

    # -- reads ---------------------------------------------------------

    def const_cache_occupancy(self) -> Dict[str, int]:
        entries = nbytes = 0
        for cache in list(self._const_caches):
            occ = cache.occupancy()
            entries += occ["entries"]
            nbytes += occ["bytes"]
        return {"entries": entries, "bytes": nbytes}

    def snapshot(self) -> dict:
        with self._lock:
            snap = {field: dict(getattr(self, field))
                    for field in _TIMED_FIELDS}
            snap.update(sentinel=self.sentinel,
                        offenders=list(self.offenders),
                        const_cache=dict(self.const_cache),
                        timing_enabled=self.timing_enabled,
                        sample_every=self.sample_every)
        snap["const_cache_occupancy"] = self.const_cache_occupancy()
        return snap


DEVICE_STATS = DeviceStats()


def delta(before: dict, after: dict = None) -> dict:
    """Movement since a ``snapshot()`` (to ``after``, by default now):
    each field's non-zero moves and their ``_total``, the sentinel and
    the new offenders."""
    now = DEVICE_STATS.snapshot() if after is None else after
    out = {}
    for field in _TIMED_FIELDS:
        prev = before.get(field, {})
        moved = {k: v - prev.get(k, 0) for k, v in now[field].items()
                 if v - prev.get(k, 0)}
        out[field] = moved
        out[field + "_total"] = sum(moved.values())
    out["sentinel"] = now["sentinel"]
    out["offenders"] = [o for o in now["offenders"]
                        if o not in before.get("offenders", [])]
    return out


def dispatch(entry: str, device, launch: Callable[[], Any]):
    """Run ``launch`` (one kernel launch on the card, which raises if it
    fails, or the plain version on the CPU) as one call of ``entry``,
    timed when sampled: by CUDA events on the current stream on the
    card, by ``_perf_counter`` on the CPU. A launch on the card counts
    in ``launches`` once it has returned."""
    on_card = device.type == "cuda"
    if not DEVICE_STATS.tick(entry):
        out = launch()
    elif on_card:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch()
        end.record()
        end.synchronize()
        DEVICE_STATS.note_device_time(entry, start.elapsed_time(end) / 1e3)
    else:
        t0 = _perf_counter()
        out = launch()
        DEVICE_STATS.note_device_time(entry, _perf_counter() - t0)
    if on_card:
        DEVICE_STATS.note_launch(entry)
    return out


def program(entry: str, devices, run: Callable[[], Any]):
    """Run ``run`` (a multi-device program: K1 launched at each of its
    positions, each launch counted under K1) as one dispatch of
    ``entry``. A sampled call is timed on the host clock to the end of
    its work on every card of ``devices``."""
    if not DEVICE_STATS.tick(entry):
        return run()
    t0 = _perf_counter()
    out = run()
    import torch
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    DEVICE_STATS.note_device_time(entry, _perf_counter() - t0)
    return out


def timed_build(entry: str, key: Any, build: Callable[[], Any],
                owner: Any = None):
    """``build()`` counted as one compile of ``entry`` with its seconds
    (a build is a slow path: it always reads the clock)."""
    t0 = _perf_counter()
    out = build()
    DEVICE_STATS.note_compile(entry, key, _perf_counter() - t0, owner)
    return out


def jit_factory_snapshot() -> Dict[str, dict]:
    """The host plan caches of ``ops/codec`` (repair, piggyback, their
    decode and repair plans), in the shape of the JAX package's jit
    factory report: an evicted plan is built again."""
    from . import codec
    return codec.plan_cache_info()


def device_inventory(force: bool = False) -> dict:
    """Platform, device kind x count, and ``memory_stats()`` per card.
    Without ``force`` a process whose CUDA is not initialized reports
    ``initialized: False`` and touches nothing."""
    import torch
    if not force and not torch.cuda.is_initialized():
        return {"initialized": False, "platform": None,
                "device_kinds": {}, "devices": []}
    if not torch.cuda.is_available():
        return {"initialized": True, "platform": "cpu",
                "device_kinds": {"cpu": 1},
                "devices": [{"id": 0, "kind": "cpu", "memory_stats": {}}]}
    kinds: Dict[str, int] = {}
    per_device = []
    for i in range(torch.cuda.device_count()):
        kind = torch.cuda.get_device_name(i)
        kinds[kind] = kinds.get(kind, 0) + 1
        try:
            mem = {k: v for k, v in torch.cuda.memory_stats(i).items()
                   if k.endswith(".all.current") or k.endswith(".all.peak")}
        except RuntimeError:
            mem = {}
        per_device.append({"id": i, "kind": kind, "memory_stats": mem})
    return {"initialized": True, "platform": "gpu",
            "device_kinds": kinds, "devices": per_device}


def admin_snapshot() -> dict:
    """The ``GET /admin/devices`` answer: the stats, the plan caches and
    the inventory (CUDA initialized if it was not)."""
    return {"stats": DEVICE_STATS.snapshot(),
            "jit_factories": jit_factory_snapshot(),
            "inventory": device_inventory(force=True)}
