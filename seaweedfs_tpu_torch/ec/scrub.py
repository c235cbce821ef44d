"""EC integrity scrub: verify H·x = 0 over whole shard slabs.

The syndrome check is the encode product with the coefficients swapped:
``codec.syndrome_plan()`` gives the (m, k+m) parity-check rows
H = [P | I_m], and one (m, k+m) x (k+m, w) dispatch per slab — through
the same ``PipelinedMatmul`` encode and rebuild ride, so K1 on the card —
proves every byte column of the slab consistent, or pins the corrupt
shard down to the byte. A piggyback volume is checked in sub-chunk space
with ``PiggybackPlan.syndrome_rows()``, (m·α, (k+m)·α) = (128, 448) for
RS(10,4), over window-split slabs.

Paced by ``rate_mbps`` so a background pass cannot starve foreground
reads, idling ``idle_s`` between passes. The scrubber of a volume is the
holder of its lowest-numbered shard, a convention every holder can
evaluate from the shard map. Scrub state (last scrubbed, bytes verified,
syndrome failures per local shard) persists in a ``.scrub`` sidecar
next to the ``.ecx``, and findings go to the ``on_finding`` callback.

The stripe's local shards are read off disk, the rest from the holders
the location map lists (never ``self_url``) by ``RemoteShardReader``s,
rotated by slab index.

This is the JAX package's ``ec/scrub.py`` engine, with every decision it
makes held: the counters, findings and sidecars of the two agree on the
same shard files and holders. Each volume's pass is an ``ec.scrub``
span with its ``gather`` and ``dispatch`` seconds as spans under it, as
in JAX; the same seconds go into a ``StageTimer``, reported as
``phases`` in each volume's result.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..ops import codec as ops_codec
from ..ops import gf256
from ..ops.pipeline import PipelinedMatmul
from ..storage.types import entry_size
from ..util import tracing
from ..util.locks import make_lock
from ..util.profiling import StageTimer
from .layout import volume_layout
from .transport import GatherStats, LocalShardReader, RemoteShardReader

log = logging.getLogger(__name__)

#: Defaults, each the JAX package's default of the knob named beside it.
RATE_MBPS = 8.0             # SW_EC_SCRUB_RATE_MBPS; 0 disables pacing
IDLE_S = 300.0              # SW_EC_SCRUB_IDLE_S; <= 0 disables the loop
SLAB_BYTES = 1 << 20        # SW_EC_SCRUB_SLAB_BYTES

# Locating the corrupt shard from a syndrome column is O(total * m) per
# column; a handful of columns is plenty to attribute a slab.
_LOCATE_SAMPLE = 64


def locate_corrupt_shard(h: np.ndarray, syndrome: np.ndarray) -> int:
    """Attribute one syndrome column to a shard, or -1 if ambiguous.

    A single corrupt shard c with error byte e produces
    s_i = H[i][c] * e for every parity-check row i, so each candidate
    column of H either explains the whole syndrome (solve e from the
    first nonzero row, verify the rest) or none of it.  Multi-shard
    corruption in one byte column generally matches nothing — the slab
    is still flagged, just unattributed.
    """
    m, total = h.shape
    match = -1
    for c in range(total):
        p = -1
        for i in range(m):
            if h[i][c]:
                p = i
                break
        if p < 0 or not syndrome[p]:
            continue
        e = gf256.gf_div(int(syndrome[p]), int(h[p][c]))
        if all(int(syndrome[i]) == gf256.MUL_TABLE[int(h[i][c])][e]
               for i in range(m)):
            if match >= 0:
                return -1  # two columns explain it: ambiguous
            match = c
    return match


class ScrubEngine:
    """Paced background syndrome verification of every local EC volume."""

    def __init__(self, store, locations: Callable[[int], Dict[int, list]],
                 codec: Callable[[], object],
                 self_url: Callable[[], str],
                 on_finding: Optional[Callable[[dict], bool]] = None,
                 rate_mbps: Optional[float] = None,
                 idle_s: Optional[float] = None,
                 slab: Optional[int] = None):
        self.store = store
        self.locations = locations
        self.codec = codec
        self.self_url = self_url
        self.on_finding = on_finding
        self.rate_mbps = RATE_MBPS if rate_mbps is None else rate_mbps
        self.idle_s = IDLE_S if idle_s is None else idle_s
        self.slab = int(slab) if slab else SLAB_BYTES
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pass_lock = make_lock("torch.scrub._pass_lock")   # one pass at a time
        self._lock = make_lock("torch.scrub._lock")        # counters
        self._c = {
            "passes": 0, "volumes_scrubbed": 0, "slabs": 0,
            "bytes_verified": 0, "remote_bytes": 0,
            "corrupt_slabs": 0, "corrupt_columns": 0, "findings": 0,
            "report_failures": 0, "skipped_missing": 0,
            "skipped_not_owner": 0, "errors": 0,
            "host_dispatches": 0, "device_dispatches": 0,
        }
        self._last_pass_s = 0.0
        self._last_pass_mbps = 0.0
        self._last_pass_at = 0.0
        # vid -> {"last_scrubbed":, "clean":, "corrupt_shards": [...]}
        self._volume_state: Dict[int, dict] = {}

    # -- lifecycle ---------------------------------------------------

    def start(self):
        if self.idle_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="ec-scrub", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.idle_s):
            try:
                self.run_pass()
            except Exception as e:  # noqa: BLE001 - keep scrubbing
                log.warning("ec scrub pass failed: %s", e)

    # -- pass / volume -----------------------------------------------

    def run_pass(self, force: bool = False) -> dict:
        """Scrub every local EC volume this server owns (or all local
        volumes when forced).  Returns a per-pass summary."""
        with self._pass_lock:
            t0 = time.perf_counter()
            with self._lock:
                bytes0 = self._c["bytes_verified"]
            vids = self._volume_ids()
            scrubbed, findings = 0, 0
            for vid in vids:
                if self._stop.is_set():
                    break
                try:
                    res = self.scrub_volume(vid, force=force)
                except Exception as e:  # noqa: BLE001 - one volume only
                    with self._lock:
                        self._c["errors"] += 1
                    log.warning("ec scrub of volume %s failed: %s", vid, e)
                    continue
                if res.get("skipped"):
                    continue
                scrubbed += 1
                findings += len(res.get("corrupt_shards", ()))
            dt = time.perf_counter() - t0
            with self._lock:
                self._c["passes"] += 1
                self._last_pass_s = dt
                self._last_pass_at = time.time()
                if dt > 0:
                    self._last_pass_mbps = \
                        (self._c["bytes_verified"] - bytes0) / dt / 1e6
            return {"volumes": scrubbed, "findings": findings,
                    "seconds": dt}

    def _volume_ids(self) -> List[int]:
        vids: List[int] = []
        for loc in self.store.locations:
            vids.extend(loc.ec_volumes.keys())
        return sorted(set(vids))

    def _is_owner(self, vid: int, local_sids: List[int]) -> bool:
        """One scrubber per volume: the holder of the lowest shard id
        anyone (locally or per the shard map) knows about."""
        known = set(local_sids)
        try:
            known.update(int(s) for s in (self.locations(vid) or {}))
        except Exception:  # noqa: BLE001 - location map is advisory
            pass
        return bool(known) and min(known) in local_sids

    def scrub_volume(self, vid: int, force: bool = False) -> dict:
        """Verify one volume's full codeword, slab by slab."""
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return {"volume": vid, "skipped": "not_local"}
        local = dict(ev.shards)
        if not local:
            return {"volume": vid, "skipped": "not_local"}
        local_sids = sorted(local)
        if not force and not self._is_owner(vid, local_sids):
            with self._lock:
                self._c["skipped_not_owner"] += 1
            self._set_volume_state(vid, skipped="not_owner")
            return {"volume": vid, "skipped": "not_owner"}

        codec = self.codec()
        # the volume's layout picks the parity-check rows: flat volumes
        # verify H·x=0 over raw shard bytes, piggyback volumes over the
        # sub-chunk rows ([E|I] from the coupled plan) of window-split
        # slabs — same fused dispatch, different basis
        li = self._layout(ev)
        alpha = wnd = None
        slab_eff = self.slab
        if li.piggyback:
            pplan = ops_codec.piggyback_plan(
                codec.k, codec.m,
                matrix_kind=getattr(codec, "matrix_kind", "vandermonde"),
                matrix=getattr(codec, "matrix", None),
                pairs=li.pairs)
            h = pplan.syndrome_rows()
            total = codec.total
            alpha, wnd = li.alpha, li.window
            slab_eff = max(wnd, self.slab - self.slab % wnd)
        else:
            h = codec.syndrome_plan()
            total = h.shape[1]
        gstats = GatherStats()
        readers, missing = self._readers(vid, local, total, gstats)
        if missing:
            with self._lock:
                self._c["skipped_missing"] += 1
            self._set_volume_state(vid, skipped="missing_shards",
                                   missing=missing)
            return {"volume": vid, "skipped": "missing_shards",
                    "missing": missing}

        shard_size = max(s.size for s in local.values())
        if li.piggyback and shard_size % wnd:
            # sidecar geometry disagrees with the shard bytes: a split
            # would misattribute every column, so surface it instead
            self._set_volume_state(vid, skipped="bad_geometry",
                                   window=wnd, shard_size=shard_size)
            return {"volume": vid, "skipped": "bad_geometry",
                    "window": wnd, "shard_size": shard_size}
        n_slabs = (shard_size + slab_eff - 1) // slab_eff
        corrupt_slabs: List[int] = []
        corrupt_shards: set = set()
        corrupt_columns = 0
        pass_bytes = 0
        t0 = time.perf_counter()
        timer = StageTimer()

        thr = ops_codec.dispatch_threshold(codec)
        use_device = bool(thr) and slab_eff >= thr

        def slabs():
            nonlocal pass_bytes
            with ThreadPoolExecutor(max_workers=min(total, 14)) as pool:
                for idx in range(n_slabs):
                    if self._stop.is_set():
                        return
                    off = idx * slab_eff
                    w = min(slab_eff, shard_size - off)
                    g0 = time.perf_counter()
                    futs = [pool.submit(readers[s].read, off, w, idx)
                            for s in range(total)]
                    rows = [np.frombuffer(f.result(), dtype=np.uint8)
                            for f in futs]
                    timer.add("gather", time.perf_counter() - g0)
                    block = np.stack(rows, axis=0)
                    pass_bytes += block.nbytes
                    self._pace(t0, pass_bytes)
                    if li.piggyback:
                        block = ops_codec.pb_split(block, alpha, wnd)
                    yield (idx, off, w), np.ascontiguousarray(block)

        def check(meta, out):
            nonlocal corrupt_columns
            idx, off, w = meta
            bad = np.flatnonzero(out.any(axis=0))
            with self._lock:
                self._c["slabs"] += 1
                self._c["bytes_verified"] += w * total
            if not bad.size:
                return
            corrupt_slabs.append(idx)
            corrupt_columns += int(bad.size)
            with self._lock:
                self._c["corrupt_slabs"] += 1
                self._c["corrupt_columns"] += int(bad.size)
            for col in bad[:_LOCATE_SAMPLE]:
                c = locate_corrupt_shard(h, out[:, col])
                # piggyback columns live in sub-chunk space: alpha
                # consecutive columns per shard
                corrupt_shards.add(
                    c // alpha if li.piggyback and c >= 0 else c)

        path = "device" if use_device else "host"
        with tracing.span("ec.scrub", volume=vid, shards=len(local_sids),
                          slab=slab_eff, layout=li.layout,
                          path=path) as root:
            if use_device:
                pm = PipelinedMatmul(h, codec=codec,
                                     max_width=max(slab_eff, 1 << 20),
                                     timer=timer)
                for meta, _data, out in pm.stream(slabs()):
                    with timer.stage("dispatch"):
                        check(meta, np.asarray(out))
                    with self._lock:
                        self._c["device_dispatches"] += 1
            else:
                for meta, block in slabs():
                    with timer.stage("dispatch"):
                        check(meta, ops_codec.host_matmul(h, block))
                    with self._lock:
                        self._c["host_dispatches"] += 1
            tracing.record_span("gather", timer.totals.get("gather", 0.0),
                                parent=root, op="ec.scrub",
                                bytes=pass_bytes)
            tracing.record_span("dispatch",
                                timer.totals.get("dispatch", 0.0),
                                parent=root, op="ec.scrub", path=path)

        dt = time.perf_counter() - t0
        with self._lock:
            self._c["volumes_scrubbed"] += 1
            self._c["remote_bytes"] += gstats.remote_bytes
            self._last_pass_s = dt
            self._last_pass_at = time.time()
            if dt > 0:
                self._last_pass_mbps = pass_bytes / dt / 1e6
        now = time.time()
        self._persist_state(ev, local_sids, now, shard_size,
                            len(corrupt_slabs))
        clean = not corrupt_slabs
        self._set_volume_state(
            vid, last_scrubbed=now, clean=clean,
            slabs=n_slabs, corrupt_slabs=len(corrupt_slabs),
            corrupt_shards=sorted(corrupt_shards))
        res = {"volume": vid, "collection": ev.collection,
               "slabs": n_slabs, "bytes": pass_bytes,
               "seconds": dt, "clean": clean,
               "corrupt_slabs": corrupt_slabs,
               "corrupt_columns": corrupt_columns,
               "corrupt_shards": sorted(corrupt_shards),
               "path": "device" if use_device else "host",
               "phases": {name: round(secs, 6)
                          for name, secs in timer.totals.items()}}
        if not clean:
            self._report({
                "volume": vid, "collection": ev.collection,
                "shards": sorted(s for s in corrupt_shards if s >= 0),
                "slabs": corrupt_slabs, "columns": corrupt_columns,
                "source": self.self_url(), "detected_at": now})
        return res

    def _layout(self, ev):
        """The volume's on-disk layout, resolved from its local
        sidecars (ec/layout.volume_layout)."""
        width = getattr(ev, "offset_width", None) or 4
        return volume_layout(ev.base_name, self.codec().k,
                             record_size=entry_size(width))

    def _readers(self, vid: int, local: Dict[int, object], total: int,
                 gstats: GatherStats) -> Tuple[list, List[int]]:
        """One reader per shard id: local shards off disk, the rest of
        the stripe from their holders. Second return lists shard ids
        nobody can serve (lost shards are the master scan's incident,
        not a scrub finding)."""
        holders = {}
        try:
            holders = {int(s): list(u)
                       for s, u in (self.locations(vid) or {}).items()}
        except Exception:  # noqa: BLE001 - degrade to local-only view
            pass
        me = self.self_url()
        readers: list = [None] * total
        missing: List[int] = []
        for sid in range(total):
            if sid in local:
                readers[sid] = LocalShardReader(local[sid].path, gstats)
                continue
            remote = [u for u in holders.get(sid, ()) if u != me]
            if not remote:
                missing.append(sid)
                continue
            readers[sid] = RemoteShardReader(vid, sid, remote, gstats)
        return readers, missing

    def _pace(self, t0: float, nbytes: int):
        """Sleep enough that the pass's gather bandwidth stays under
        the configured ceiling — this is the knob that bounds scrub's
        tax on foreground p99."""
        rate = self.rate_mbps
        if rate <= 0:
            return
        ahead = nbytes / (rate * 1e6) - (time.perf_counter() - t0)
        while ahead > 0 and not self._stop.is_set():
            step = min(ahead, 0.05)
            time.sleep(step)
            ahead -= step

    # -- findings / state --------------------------------------------

    def _report(self, finding: dict):
        with self._lock:
            self._c["findings"] += 1
        cb = self.on_finding
        ok = False
        if cb is not None:
            try:
                ok = bool(cb(finding))
            except Exception as e:  # noqa: BLE001 - master may be down
                log.warning("scrub finding report failed: %s", e)
        if not ok:
            with self._lock:
                self._c["report_failures"] += 1

    def _persist_state(self, ev, local_sids: List[int], now: float,
                       shard_size: int, corrupt_slabs: int):
        """Durable per-shard scrub state next to the shard sidecars."""
        path = ev.base_name + ".scrub"
        state = {"shards": {}, "passes": 0}
        try:
            with open(path, "r", encoding="utf-8") as f:
                prev = json.load(f)
            if isinstance(prev, dict):
                state["shards"] = dict(prev.get("shards") or {})
                state["passes"] = int(prev.get("passes") or 0)
        except (OSError, ValueError):
            pass
        state["passes"] += 1
        for sid in local_sids:
            rec = dict(state["shards"].get(str(sid)) or {})
            rec["last_scrubbed"] = now
            rec["bytes_verified"] = \
                int(rec.get("bytes_verified") or 0) + shard_size
            rec["syndrome_failures"] = \
                int(rec.get("syndrome_failures") or 0) + corrupt_slabs
            state["shards"][str(sid)] = rec
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("scrub state write failed for %s: %s", path, e)

    def _set_volume_state(self, vid: int, **kw):
        with self._lock:
            self._volume_state[vid] = dict(kw)
            # drop state for volumes no longer local
            if len(self._volume_state) > 4096:
                self._volume_state.pop(next(iter(self._volume_state)))

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["last_pass_s"] = round(self._last_pass_s, 6)
            out["last_pass_mbps"] = round(self._last_pass_mbps, 3)
            out["last_pass_at"] = self._last_pass_at
            out["rate_mbps"] = self.rate_mbps
            out["idle_s"] = self.idle_s
            out["slab_bytes"] = self.slab
            out["volumes"] = {str(v): dict(s)
                              for v, s in self._volume_state.items()}
        return out
