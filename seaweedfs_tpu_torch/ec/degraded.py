"""Batched degraded reads: reconstruct-on-read of a lost shard's bytes.

When a shard holder dies, needle reads that land on the lost shard fall
through to reconstruction (``EcVolume.read_needle_blob(nid,
reconstruct_fetch=engine.read)``). ``DegradedReadEngine`` serves them:

* **Coalescing** — concurrent reads of the same ``(vid, lost_sid)``
  funnel through a per-shard leader/follower batcher. The first request
  in becomes the leader, waits ``batch_ms`` for followers, and runs ONE
  gather + ONE decode dispatch for the union of their slab-aligned
  ranges; everyone else waits on a future.
* **Exactly-k gather** — the batch reads the decode plan's k survivor
  column ranges, never the other ``TOTAL_SHARDS-1`` siblings.
* **One-row decode** — ``codec.lost_row_coeffs`` gives the lost shard's
  single coefficient row, so the product is (1, k) on flat volumes; a
  piggyback volume takes the lost shard's alpha rows of the coupled
  decode plan, (32, 320) for RS(10,4), over window-split survivors.
* **Host/device crossover** — a batch narrower than
  ``codec.dispatch_threshold`` runs ``host_matmul``; a wider one streams
  through ``PipelinedMatmul`` as one device dispatch (K1 on the card).
* **Slab LRU** — reconstructed slabs park in a bounded LRU keyed
  ``(vid, sid, slab)``; ``invalidate`` drops a volume's slabs when its
  shards are mounted again.

* **Remote survivors** — a survivor this server does not hold is read
  from the holders the location map lists (never ``self_url``) by a
  ``RemoteShardReader``: rotation by slab index and failover (hedging
  at the transport's default, off); when no survivor is local the shard
  is sized by a suffix probe, once per shard (``ShardSizeCache``). A
  gather that fails drops the volume's cached locations and raises
  ``EcShardNotFound``.

This is the JAX package's ``ec/degraded.py`` engine, with every decision
it makes held: the counters of the two agree on the same shard files and
holders. Each batch is an ``ec.degraded`` span with the JAX engine's
``plan``, ``gather`` and ``dispatch`` spans under it (``path`` host or
device); the same phases go into a ``StageTimer`` whose totals
``snapshot()`` reports as ``phases``. ``on_read(seconds)`` sees every
read's latency (the server's histogram), and ``on_slabs(vid, sid,
slabs)`` every fresh reconstruction's slabs (the server publishes them
into its native plane's slab cache).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import codec as ops_codec
from ..ops.pipeline import PipelinedMatmul
from ..storage.types import entry_size
from ..util import tracing
from ..util.locks import make_lock
from ..util.profiling import StageTimer
from .ec_volume import EcShardNotFound
from .gather import ShardSizeCache
from .layout import LayoutInfo, volume_layout
from .transport import GatherStats, LocalShardReader, RemoteShardReader

#: Defaults, each the JAX package's default of the knob named beside it.
CACHE_BYTES = 64 << 20      # SW_EC_DEGRADED_CACHE_BYTES
SLAB_BYTES = 128 << 10      # SW_EC_DEGRADED_SLAB_BYTES
BATCH_MS = 2.0              # SW_EC_DEGRADED_BATCH_MS
READ_TIMEOUT_S = 10.0       # SW_EC_DEGRADED_READ_TIMEOUT_S
READAHEAD_SLABS = 1         # SW_EC_DEGRADED_READAHEAD_SLABS
MODE = "batch"              # SW_EC_DEGRADED_MODE
MODES = ("batch", "naive")


def degraded_mode(mode: Optional[str] = None) -> str:
    """"batch" (the engine) or "naive" (a volume server's per-read
    exactly-k reconstruction, kept for A/B runs); ``None`` or empty is the
    default, anything else raises."""
    mode = (mode or MODE).strip().lower() or MODE
    if mode not in MODES:
        raise ValueError(f"degraded mode must be one of {MODES}, got "
                         f"{mode!r}")
    return mode


class SlabCache:
    """Bounded byte-budget LRU of reconstructed slabs keyed
    ``(vid, sid, slab_idx)``. ``max_bytes == 0`` disables caching."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = make_lock("torch.degraded.SlabCache._lock")
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple) -> Optional[bytes]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return hit

    def peek(self, key: tuple) -> Optional[bytes]:
        """Presence probe that counts as neither hit nor miss and does
        not touch LRU order — readahead planning must not distort the
        cache stats or promote entries it only inspects."""
        with self._lock:
            return self._entries.get(key)

    def put(self, key: tuple, data: bytes):
        if self.max_bytes <= 0 or len(data) > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[key] = data
            self._bytes += len(data)
            while self._bytes > self.max_bytes:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
                self.evictions += 1

    def invalidate(self, vid: int, shard_ids=None):
        sids = None if shard_ids is None else {int(s) for s in shard_ids}
        with self._lock:
            doomed = [k for k in self._entries
                      if k[0] == vid and (sids is None or k[1] in sids)]
            for k in doomed:
                self._bytes -= len(self._entries.pop(k))
        return len(doomed)

    def stats(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._entries), self._bytes


class _Batch:
    """Per-(vid, sid) coalescing state. The leader flag and the pending
    slab->future map share one lock so a follower can never register
    into a batch the leader has already taken."""

    def __init__(self):
        self.lock = make_lock("torch.degraded.Batch.lock")
        self.pending: Dict[int, "_SlabFuture"] = {}
        self.leading = False
        self.requests = 0


class _SlabFuture:
    def __init__(self):
        self._done = threading.Event()
        self._value: Optional[bytes] = None
        self._exc: Optional[BaseException] = None

    def set(self, value: bytes):
        self._value = value
        self._done.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> bytes:
        if not self._done.wait(timeout):
            raise TimeoutError("degraded slab reconstruction timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


class DegradedReadEngine:
    """Reconstructs ranges of lost shards with batching, an exactly-k
    survivor gather, a one-row (or alpha-row) decode and a slab LRU.

    ``store`` supplies ``find_ec_volume``; ``locations(vid)`` returns the
    ``{sid: [holders]}`` map; ``loc_cache`` (optional) is the
    ``EcShardLocationCache`` to invalidate when a survivor gather dies;
    ``self_url`` (str or callable) is this server's own address, which
    never counts as a remote holder; ``codec`` (callable) resolves the
    RS codec lazily.
    """

    def __init__(self, store, locations, codec,
                 loc_cache=None, self_url="",
                 cache_bytes: Optional[int] = None,
                 slab: Optional[int] = None,
                 batch_ms: Optional[float] = None,
                 readahead: Optional[int] = None,
                 on_read=None, on_slabs=None):
        self.store = store
        # on_read(seconds) after every read (the server's latency
        # histogram); its failure never fails the read
        self.on_read = on_read
        # on_slabs(vid, sid, {slab index: bytes}) after every fresh
        # reconstruction: the server publishes the slabs into the native
        # plane's cache, so the next read of these bytes never leaves
        # the plane. Whatever invalidates this engine's cache invalidates
        # the plane's copy too. Its failure never fails the read.
        self.on_slabs = on_slabs
        self._locations = locations
        self._codec = codec
        self._loc_cache = loc_cache
        self._self_url = self_url
        self.slab = int(slab) if slab else SLAB_BYTES
        self.batch_s = (BATCH_MS if batch_ms is None
                        else float(batch_ms)) / 1000.0
        self.readahead = (READAHEAD_SLABS if readahead is None
                          else max(0, int(readahead)))
        self.cache = SlabCache(CACHE_BYTES if cache_bytes is None
                               else cache_bytes)
        # readahead-produced cache keys, so hits on them are attributable
        self._ra_keys: set = set()
        self.size_cache = ShardSizeCache(timeout=READ_TIMEOUT_S)
        # plan / gather / dispatch of every batch, and the pipeline's own
        # stages inside dispatch on the device path
        self.timer = StageTimer()
        self._lock = make_lock("torch.degraded.Engine._lock")
        self._batches: Dict[Tuple[int, int], _Batch] = {}
        self._latencies: deque = deque(maxlen=512)
        self._c: Dict[str, int] = {
            "reads": 0, "errors": 0, "batches": 0,
            "batched_requests": 0, "last_batch_requests": 0,
            "max_batch_requests": 0, "batch_slabs": 0,
            "survivor_rows": 0, "survivor_fetches": 0,
            "survivor_bytes": 0, "remote_bytes": 0,
            "hedges_fired": 0, "hedges_won": 0, "retries": 0,
            "host_dispatches": 0, "device_dispatches": 0,
            "readahead_slabs": 0, "readahead_hits": 0,
        }
        # the gather pool is shared across batches: a batch needs at
        # most k concurrent range reads and batches for different lost
        # shards overlap under multi-failure
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="ec-degraded")

    # -- public API --------------------------------------------------------
    def read(self, vid: int, sid: int, offset: int, size: int) -> bytes:
        """Reconstructed bytes ``[offset, offset+size)`` of the lost
        shard, zero-padded past the shard tail like local reads."""
        t0 = time.perf_counter()
        try:
            return self._read(int(vid), int(sid), int(offset), int(size))
        except Exception:
            with self._lock:
                self._c["errors"] += 1
            raise
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._c["reads"] += 1
                self._latencies.append(dt)
            if self.on_read is not None:
                try:
                    self.on_read(dt)
                except Exception:  # noqa: BLE001 - metrics never fail reads
                    pass

    def invalidate(self, vid: int, shard_ids=None) -> int:
        """Drop cached slabs for a volume (optionally specific shards): a
        shard mounted again after a rebuild must be read from disk, not
        from the reconstruction cache."""
        return self.cache.invalidate(int(vid), shard_ids)

    def close(self):
        """Stop the gather pool's threads."""
        self._pool.shutdown(wait=True)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._c)
            lat = sorted(self._latencies)
        entries, nbytes = self.cache.stats()
        out["cache_hits"] = self.cache.hits
        out["cache_misses"] = self.cache.misses
        out["cache_evictions"] = self.cache.evictions
        out["cache_entries"] = entries
        out["cache_bytes"] = nbytes
        looked = out["cache_hits"] + out["cache_misses"]
        out["cache_hit_ratio"] = (out["cache_hits"] / looked) if looked \
            else 0.0
        out["readahead_hit_ratio"] = \
            (out["readahead_hits"] / out["readahead_slabs"]) \
            if out["readahead_slabs"] else 0.0
        if lat:
            out["p50_ms"] = lat[len(lat) // 2] * 1000.0
            out["p99_ms"] = lat[min(len(lat) - 1,
                                    int(len(lat) * 0.99))] * 1000.0
        else:
            out["p50_ms"] = out["p99_ms"] = 0.0
        out["phases"] = {name: round(secs, 6)
                         for name, secs in self.timer.totals.items()}
        return out

    # -- read path ---------------------------------------------------------
    def _read(self, vid: int, sid: int, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        slab = self.slab
        first = offset // slab
        last = (offset + size - 1) // slab
        parts: Dict[int, bytes] = {}
        want: List[int] = []
        for idx in range(first, last + 1):
            key = (vid, sid, idx)
            hit = self.cache.get(key)
            if hit is None:
                want.append(idx)
            else:
                parts[idx] = hit
                with self._lock:
                    if key in self._ra_keys:
                        self._ra_keys.discard(key)
                        self._c["readahead_hits"] += 1
        if want:
            # the batch is already paying a gather + fused dispatch, so
            # widen it by the readahead window: neighbor slabs land in
            # the LRU and the next sequential read never reaches here
            ra = self.readahead if self.cache.max_bytes > 0 else 0
            extra = [idx for idx in range(last + 1, last + 1 + ra)
                     if self.cache.peek((vid, sid, idx)) is None]
            got = self._batched(vid, sid, want + extra)
            parts.update({i: got[i] for i in want})
            with self._lock:
                for idx in extra:
                    if got.get(idx):
                        self._ra_keys.add((vid, sid, idx))
                        self._c["readahead_slabs"] += 1
                if len(self._ra_keys) > 8192:  # evicted keys pile up
                    self._ra_keys.clear()
        out = bytearray()
        for idx in range(first, last + 1):
            seg = parts[idx]
            lo = max(offset, idx * slab) - idx * slab
            hi = min(offset + size, (idx + 1) * slab) - idx * slab
            piece = seg[lo:hi]
            if len(piece) < hi - lo:  # shard tail: zero-pad like local reads
                piece = piece + b"\x00" * (hi - lo - len(piece))
            out += piece
        return bytes(out)

    def _batched(self, vid: int, sid: int,
                 idxs: List[int]) -> Dict[int, bytes]:
        key = (vid, sid)
        with self._lock:
            st = self._batches.get(key)
            if st is None:
                st = self._batches[key] = _Batch()
        with st.lock:
            futs = {}
            for idx in idxs:
                f = st.pending.get(idx)
                if f is None:
                    f = st.pending[idx] = _SlabFuture()
                futs[idx] = f
            st.requests += 1
            lead = not st.leading
            if lead:
                st.leading = True
        if lead:
            if self.batch_s > 0:
                time.sleep(self.batch_s)
            with st.lock:
                take, st.pending = st.pending, {}
                nreq, st.requests = st.requests, 0
                st.leading = False
            try:
                got = self._reconstruct_batch(vid, sid,
                                              sorted(take), nreq)
                for idx, f in take.items():
                    f.set(got[idx])
            except BaseException as e:  # noqa: BLE001 - fail every waiter
                for f in take.values():
                    f.set_exception(e)
        deadline = READ_TIMEOUT_S * 3 + 30.0
        return {idx: f.result(timeout=deadline)
                for idx, f in futs.items()}

    # -- batch execution ---------------------------------------------------
    def _reconstruct_batch(self, vid: int, sid: int, idxs: List[int],
                           nreq: int) -> Dict[int, bytes]:
        with tracing.span("ec.degraded", volume=vid, shard=sid,
                          slabs=len(idxs), requests=nreq) as root:
            return self._reconstruct_batch_in(vid, sid, idxs, nreq, root)

    def _reconstruct_batch_in(self, vid: int, sid: int, idxs: List[int],
                              nreq: int, root) -> Dict[int, bytes]:
        codec = self._codec()
        ev = self.store.find_ec_volume(vid)
        self_url = self._self_url() if callable(self._self_url) \
            else self._self_url
        locations = self._locations(vid) or {}

        present = []
        for i in range(codec.total):
            if i == sid:
                present.append(False)
            elif ev is not None and i in ev.shards:
                present.append(True)
            else:
                present.append(any(h != self_url
                                   for h in locations.get(i, [])))
        if sum(present) < codec.k:
            raise EcShardNotFound(
                f"cannot reconstruct {vid}.{sid}: only "
                f"{sum(present)} of {codec.k} survivors reachable")
        # the volume's layout picks the decode basis: flat volumes use
        # the single lost-row coefficients over raw bytes, piggyback
        # volumes the coupled plan's alpha sub-chunk rows over
        # window-split survivor slabs
        li = self._layout(ev, codec)
        with self.timer.stage("plan"), \
                tracing.span("plan", backend=codec.backend,
                             layout=li.layout):
            if li.piggyback:
                src, pmissing, coeffs = ops_codec.piggyback_decode_plan(
                    codec.k, codec.m, tuple(present),
                    matrix_kind=getattr(codec, "matrix_kind",
                                        "vandermonde"),
                    matrix=getattr(codec, "matrix", None),
                    pairs=li.pairs)
                pos = pmissing.index(sid)
                row = np.ascontiguousarray(
                    coeffs[pos * li.alpha:(pos + 1) * li.alpha])
            else:
                src, row = codec.lost_row_coeffs(tuple(present), sid)

        stats = GatherStats()
        readers = []
        for s in src:
            if ev is not None and s in ev.shards:
                readers.append(LocalShardReader(ev.shards[s].path, stats))
            else:
                holders = [h for h in locations.get(s, []) if h != self_url]
                r = RemoteShardReader(vid, s, holders, stats,
                                      timeout=READ_TIMEOUT_S)
                r.span = root
                readers.append(r)

        shard_size = self._shard_size(vid, ev, src, locations, self_url)
        runs = self._runs(idxs, shard_size)
        if li.piggyback:
            # the coupled transform is window-local: widen each run to
            # window boundaries (shard sizes are window-aligned by
            # construction, so the widened runs stay in range)
            runs = self._window_runs(runs, li.window, shard_size)
        try:
            blocks = self._gather(readers, runs, root)
        except Exception as e:
            # survivors we believed in are gone — drop the stale
            # location set so the next batch re-plans from fresh
            # holders rather than repeating the same dead fetch
            if self._loc_cache is not None:
                self._loc_cache.invalidate(vid)
            raise EcShardNotFound(
                f"survivor gather for {vid}.{sid} failed: {e}") from e

        with self.timer.stage("dispatch"):
            if li.piggyback:
                out = self._dispatch_piggyback(codec, row, blocks,
                                               li.alpha, li.window)
            else:
                out = self._dispatch(codec, row, blocks)
        slabs = self._split(runs, out, shard_size)
        for idx, data in slabs.items():
            self.cache.put((vid, sid, idx), data)
        if self.on_slabs is not None:
            try:
                self.on_slabs(vid, sid, slabs)
            except Exception:  # noqa: BLE001 - publishing is best-effort
                pass

        with self._lock:
            self._c["batches"] += 1
            self._c["batched_requests"] += nreq
            self._c["last_batch_requests"] = nreq
            if nreq > self._c["max_batch_requests"]:
                self._c["max_batch_requests"] = nreq
            self._c["batch_slabs"] += len(idxs)
            self._c["survivor_rows"] += len(readers)
            self._c["survivor_fetches"] += stats.fetches
            self._c["survivor_bytes"] += stats.bytes
            self._c["remote_bytes"] += stats.remote_bytes
            self._c["hedges_fired"] += stats.hedges_fired
            self._c["hedges_won"] += stats.hedges_won
            self._c["retries"] += stats.retries
        return slabs

    def _shard_size(self, vid, ev, src, locations, self_url) -> int:
        """Shard length bounds the gather: ranges are clamped to it and
        the beyond-tail remainder is zeros (every shard is equal-length,
        so any survivor's size is the lost shard's size). A mounted shard
        gives it; with none, a survivor's holder is probed, once per
        shard for the engine's life."""
        if ev is not None:
            for s in src:
                if s in ev.shards:
                    return ev.shards[s].size
            if ev.shards:
                return next(iter(ev.shards.values())).size
        for s in src:
            holders = [h for h in locations.get(s, []) if h != self_url]
            if holders:
                return self.size_cache.get(vid, s, holders)
        raise EcShardNotFound(f"no survivor holders to size volume {vid}")

    def _runs(self, idxs: List[int], shard_size: int
              ) -> List[Tuple[int, int, List[int]]]:
        """Merge sorted slab indices into contiguous byte ranges
        ``(off, w, member_idxs)``, clamped to the shard; a zero-width
        run marks slabs entirely past the tail (all zeros)."""
        runs: List[Tuple[int, int, List[int]]] = []
        slab = self.slab
        i = 0
        while i < len(idxs):
            j = i
            while j + 1 < len(idxs) and idxs[j + 1] == idxs[j] + 1:
                j += 1
            off = idxs[i] * slab
            end = min((idxs[j] + 1) * slab, shard_size)
            runs.append((off, max(0, end - off), idxs[i:j + 1]))
            i = j + 1
        return runs

    @staticmethod
    def _layout(ev, codec) -> LayoutInfo:
        """Resolve the volume's on-disk layout from its local sidecars;
        a server with no mounted index (ev is None) cannot be serving
        the needle lookup that led here, so flat is the safe default."""
        base = getattr(ev, "base_name", None)
        if base is None:
            return LayoutInfo()
        width = getattr(ev, "offset_width", None) or 4
        return volume_layout(base, codec.k, record_size=entry_size(width))

    @staticmethod
    def _window_runs(runs, window: int, shard_size: int):
        """Widen byte runs to sub-chunk window boundaries so the
        piggyback transform sees whole windows; zero-width (past-tail)
        runs stay empty."""
        out = []
        for off, w, members in runs:
            if w <= 0:
                out.append((off, w, members))
                continue
            aoff = off - off % window
            end = off + w
            aend = min(-(-end // window) * window, shard_size)
            out.append((aoff, aend - aoff, members))
        return out

    def _device(self, codec, coeffs: np.ndarray,
                data: np.ndarray) -> np.ndarray:
        """One device dispatch of coeffs @ data through PipelinedMatmul."""
        pm = PipelinedMatmul(coeffs, codec=codec,
                             max_width=max(data.shape[1], 1 << 20),
                             timer=self.timer)
        out = None
        for _meta, _d, o in pm.stream([(None, data)]):
            out = o
        with self._lock:
            self._c["device_dispatches"] += 1
        return out

    def _host(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        out = ops_codec.host_matmul(coeffs, data)
        with self._lock:
            self._c["host_dispatches"] += 1
        return out

    def _dispatch_piggyback(self, codec, rows: np.ndarray,
                            blocks: List[np.ndarray], alpha: int,
                            window: int) -> np.ndarray:
        """ONE coupled decode dispatch for the whole batch: window-split
        the concatenated survivor slab, multiply by the lost shard's
        alpha sub-chunk coefficient rows, and interleave the result back
        into shard bytes. Same host/device crossover as the flat path,
        measured on the sub-chunk width."""
        data = blocks[0] if len(blocks) == 1 else \
            np.concatenate(blocks, axis=1)
        if data.shape[1] == 0:
            return np.zeros(0, dtype=np.uint8)
        sub = ops_codec.pb_split(data, alpha, window)
        thr = ops_codec.dispatch_threshold(codec)
        host = (not thr) or sub.shape[1] < thr
        with tracing.span("dispatch", backend=codec.backend,
                          bytes=int(data.nbytes), layout="piggyback",
                          path="host" if host else "device"):
            out = self._host(rows, sub) if host else \
                self._device(codec, rows, sub)
        merged = ops_codec.pb_merge(np.asarray(out, dtype=np.uint8), alpha,
                                    window)
        return np.ascontiguousarray(merged[0])

    def _gather(self, readers, runs, root=None) -> List[np.ndarray]:
        """Fetch every (survivor row x run) range concurrently; returns
        one (k, w) block per run. Exactly k rows — never more."""
        t0 = time.perf_counter()
        futs = {}
        for ri, (off, w, _m) in enumerate(runs):
            if w <= 0:
                continue
            stripe = off // self.slab
            for r, reader in enumerate(readers):
                futs[(ri, r)] = self._pool.submit(reader.read, off, w,
                                                  stripe)
        blocks = []
        err = None
        for ri, (off, w, _m) in enumerate(runs):
            if w <= 0:
                blocks.append(np.zeros((len(readers), 0), dtype=np.uint8))
                continue
            rows = []
            for r in range(len(readers)):
                f = futs[(ri, r)]
                if err is not None:
                    f.cancel()
                    continue
                try:
                    rows.append(np.frombuffer(f.result(), dtype=np.uint8))
                except Exception as e:  # noqa: BLE001 - drain then raise
                    err = e
            if err is None:
                blocks.append(np.stack(rows, axis=0))
        dt = time.perf_counter() - t0
        nbytes = sum(b.nbytes for b in blocks)
        self.timer.add("gather", dt, nbytes)
        tracing.record_span("gather", dt, parent=root, op="ec.degraded",
                            bytes=nbytes)
        if err is not None:
            raise err
        return blocks

    def _dispatch(self, codec, row: np.ndarray,
                  blocks: List[np.ndarray]) -> np.ndarray:
        """ONE decode dispatch for the whole batch: concatenate the
        per-run blocks into a (k, W) slab and multiply by the lost
        shard's single coefficient row. Below the crossover the host LUT
        walk wins; at or above it the batch streams through the device
        kernel."""
        data = blocks[0] if len(blocks) == 1 else \
            np.concatenate(blocks, axis=1)
        width = data.shape[1]
        thr = ops_codec.dispatch_threshold(codec)
        host = (not thr) or width < thr or width == 0
        with tracing.span("dispatch", backend=codec.backend,
                          bytes=int(data.nbytes),
                          path="host" if host else "device"):
            out = self._host(row, data) if host else \
                self._device(codec, row, data)
        return np.ascontiguousarray(out[0])

    def _split(self, runs: List[Tuple[int, int, List[int]]],
               out: np.ndarray, shard_size: int) -> Dict[int, bytes]:
        """Carve the decoded (W,) row back into per-slab byte strings
        in the same run order the gather concatenated them. Slabs past
        the shard tail come back empty (assembly zero-pads)."""
        slabs: Dict[int, bytes] = {}
        slab = self.slab
        pos = 0
        for off, w, members in runs:
            run_out = out[pos:pos + w]
            pos += w
            for idx in members:
                rel = idx * slab - off
                n = min(slab, max(0, shard_size - idx * slab))
                slabs[idx] = run_out[rel:rel + n].tobytes() if n else b""
        return slabs
