"""Streaming striped survivor gather for EC rebuild and repair: the
*pull* role of ``ec/transport.py``.

Instead of reading every surviving shard whole before the first GF byte
is computed, the streaming rebuild fetches slab-aligned byte ranges of
each survivor and hands each arriving stripe to the pipelined decode
while the next stripes are still in flight. The window, pool and
ordering, rotation, failover and hedging come from
``transport.StripedPull`` and ``RemoteShardReader``; this module keeps
what is specific to pulling shards: shard-size probing, index-sidecar
fetching, the slab choice, and the readers and stream shapes of trace
repair (packed symbol planes) and piggyback plane repair (half-plane
sub-chunks). The projections (``project_slab``, ``pb_plane_slice``) run
on the host with numpy, on the holder for a remote reader and on the
rebuilder for a local one, as the JAX package runs them.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.codec import pb_plane_rows, pb_plane_slice, project_slab
from ..server.http_util import HttpError, http_call, http_get_with_headers
from .transport import (  # noqa: F401  - the shared transport, pull role
    DEFAULT_WINDOW, GatherStats, LocalShardReader, RemoteShardReader,
    StripedPull, TransportStats,
)

_CONTENT_RANGE_RE = re.compile(r"bytes\s+(\d+)-(\d+)/(\d+)")


def auto_slab(shard_size: int, default: int = 8 << 20,
              min_slab: int = 1 << 20, target_stripes: int = 4) -> int:
    """Slab size for a rebuild when the caller didn't pick one. A shard
    smaller than about one default slab would be a single stripe, with
    nothing for the gather to overlap with the decode: shrink the slab
    (never below ``min_slab``) so the stream has at least
    ``target_stripes`` stripes; tiny shards keep the default."""
    if shard_size <= 2 * min_slab:
        return default
    per = -(-shard_size // target_stripes)
    return max(min_slab, min(default, per))


def gather_window() -> int:
    return DEFAULT_WINDOW


def probe_shard_size(vid: int, sid: int, holders: Sequence[str],
                     timeout: float = 30.0) -> int:
    """Total shard size from a one-byte suffix-range read: the 206's
    ``Content-Range: bytes a-b/total`` carries it without moving the
    shard. A holder that refuses the suffix form with 416 is sized with
    1-byte ``offset=`` reads instead: double the offset until EOF, then
    binary-search the boundary (about 2·log2(size) tiny requests)."""

    def _size_by_tiny_reads(url: str) -> int:
        def has_byte(off: int) -> bool:
            return len(http_call("GET", url + f"&offset={off}&size=1",
                                 timeout=timeout)) > 0

        if not has_byte(0):
            return 0
        lo, hi = 0, 1
        while has_byte(hi):
            lo, hi = hi, hi * 2
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if has_byte(mid):
                lo = mid
            else:
                hi = mid
        return lo + 1

    last = None
    for holder in holders:
        url = (f"http://{holder}/admin/ec/shard_read?volume={vid}"
               f"&shard={sid}")
        try:
            _, hdrs = http_get_with_headers(
                url, timeout=timeout, headers={"Range": "bytes=-1"})
        except HttpError as e:
            if e.status == 416:
                try:
                    return _size_by_tiny_reads(url)
                except HttpError as e2:
                    last = e2
                    continue
            last = e
            continue
        cr = next((v for k, v in hdrs.items()
                   if k.lower() == "content-range"), "")
        m = _CONTENT_RANGE_RE.match(cr or "")
        if m:
            return int(m.group(3))
        last = HttpError(
            502, f"no Content-Range from {holder} for {vid}.{sid}")
    if last is not None:
        raise last
    raise ValueError(f"shard {vid}.{sid}: no holders to probe")


class ShardSizeCache:
    """Memo of ``probe_shard_size`` keyed by (vid, sid), one per rebuild
    (or per degraded engine): one wire probe per shard is enough.
    ``probes`` counts the probes that went on the wire."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self.probes = 0
        self._sizes: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()

    def get(self, vid: int, sid: int, holders: Sequence[str]) -> int:
        key = (int(vid), int(sid))
        with self._lock:
            if key in self._sizes:
                return self._sizes[key]
        size = probe_shard_size(vid, sid, holders, timeout=self.timeout)
        with self._lock:
            self.probes += 1
            self._sizes[key] = size
        return size


def fetch_index_files(base_name: str, holders: Sequence[str],
                      timeout: float = 300.0) -> List[str]:
    """Pull the small index sidecars onto the rebuilder over
    ``/admin/file``: the .ecx is required (the rebuilt .ecx's tombstone
    replay and the mount need it), the .vif and .ecj are best-effort.
    They are the only whole files a streaming rebuild copies. Returns
    the extensions fetched; a sidecar already present is kept."""
    name = os.path.basename(base_name)
    fetched: List[str] = []
    for ext, required in ((".ecx", True), (".vif", False), (".ecj", False)):
        if os.path.exists(base_name + ext):
            continue
        last = None
        data = None
        for holder in holders:
            try:
                data = http_call(
                    "GET", f"http://{holder}/admin/file?name={name}{ext}",
                    timeout=timeout)
                break
            except HttpError as e:
                last = e
                data = None
        if data is None:
            if required:
                raise last if last is not None else HttpError(
                    404, f"{name}{ext}: no holder serves it")
            continue
        with open(base_name + ext, "wb") as f:
            f.write(data)
        fetched.append(ext)
    return fetched


def _read_range(path: str, off: int, n: int) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(off)
        data = f.read(n)
    if len(data) != n:
        raise IOError(f"short read of {path} at {off}: {len(data)} < {n}")
    return np.frombuffer(data, dtype=np.uint8)


class RemoteRepairReader(RemoteShardReader):
    """Projected reads for trace repair: a POST to the holder's
    ``/admin/ec/shard_repair_read`` applies this survivor's trace masks
    there and ships only the packed symbol planes, ``len(masks) *
    ceil(n/8)`` bytes for an n-byte range."""

    _method = "POST"
    _health_kind = "repair_read"

    def __init__(self, vid: int, sid: int, holders: Sequence[str],
                 masks: Sequence[int],
                 stats: Optional[TransportStats] = None,
                 timeout: float = 300.0,
                 hedge_ms: Optional[float] = None,
                 routing: bool = False):
        super().__init__(vid, sid, holders, stats=stats, timeout=timeout,
                         hedge_ms=hedge_ms, routing=routing)
        if not masks:
            raise ValueError(f"shard {vid}.{sid}: no repair masks")
        self.masks = [int(x) for x in masks]

    def _url(self, holder: str, off: int, n: int) -> str:
        m = ",".join(str(x) for x in self.masks)
        return (f"http://{holder}/admin/ec/shard_repair_read"
                f"?volume={self.vid}&shard={self.sid}"
                f"&offset={off}&size={n}&masks={m}")

    def _expect_len(self, n: int) -> int:
        return len(self.masks) * ((n + 7) // 8)


class RemotePlaneReader(RemoteShardReader):
    """Half-plane reads for piggyback repair: a POST to the holder's
    ``/admin/ec/shard_plane_read`` slices the repair plane there
    (``ops/codec.pb_plane_slice``) and ships ``n/2`` bytes for an n-byte
    window-aligned range."""

    _method = "POST"
    _health_kind = "plane_read"

    def __init__(self, vid: int, sid: int, holders: Sequence[str],
                 alpha: int, window: int, plane_bit: int, plane_side: int,
                 stats: Optional[TransportStats] = None,
                 timeout: float = 300.0,
                 hedge_ms: Optional[float] = None,
                 routing: bool = False):
        super().__init__(vid, sid, holders, stats=stats, timeout=timeout,
                         hedge_ms=hedge_ms, routing=routing)
        self.alpha = int(alpha)
        self.window = int(window)
        self.plane_bit = int(plane_bit)
        self.plane_side = int(plane_side)

    def _url(self, holder: str, off: int, n: int) -> str:
        return (f"http://{holder}/admin/ec/shard_plane_read"
                f"?volume={self.vid}&shard={self.sid}"
                f"&offset={off}&size={n}&alpha={self.alpha}"
                f"&window={self.window}&bit={self.plane_bit}"
                f"&side={self.plane_side}")

    def _expect_len(self, n: int) -> int:
        return n // 2


class LocalRepairReader:
    """Trace projection of a survivor shard on the rebuilder's disk: read
    the range, project, and account only the symbol bytes (the range
    itself never crossed the network)."""

    remote = False

    def __init__(self, path: str, masks: Sequence[int],
                 stats: Optional[TransportStats] = None):
        if not masks:
            raise ValueError(f"{path}: no repair masks")
        self.path = path
        self.masks = [int(x) for x in masks]
        self.stats = stats or GatherStats()

    def read(self, off: int, n: int, stripe_idx: int = 0) -> bytes:
        t0 = time.perf_counter()
        planes = project_slab(_read_range(self.path, off, n), self.masks)
        self.stats.add_fetch(planes.nbytes, t0, time.perf_counter())
        return planes.tobytes()


class LocalPlaneReader:
    """Plane slice of a helper shard on the rebuilder's disk: read the
    window-aligned range, slice the repair plane, and account only the
    plane bytes."""

    remote = False

    def __init__(self, path: str, alpha: int, window: int,
                 plane_bit: int, plane_side: int,
                 stats: Optional[TransportStats] = None):
        self.path = path
        self.alpha = int(alpha)
        self.window = int(window)
        self.plane_bit = int(plane_bit)
        self.plane_side = int(plane_side)
        self.stats = stats or GatherStats()

    def read(self, off: int, n: int, stripe_idx: int = 0) -> bytes:
        t0 = time.perf_counter()
        plane = pb_plane_slice(_read_range(self.path, off, n), self.alpha,
                               self.window, self.plane_bit, self.plane_side)
        self.stats.add_fetch(plane.nbytes, t0, time.perf_counter())
        return plane.tobytes()


class StripedGatherSource(StripedPull):
    """The survivor stream: ``slabs()`` yields ``(meta, (k, w) uint8)``
    stripes in order, fetching up to ``window`` stripes ahead.
    ``readers`` are the survivors in decode plan order (the first k for
    the flat layout, piggyback_decode_plan's src for the coupled one),
    local files and remote holders mixed freely."""


class RepairGatherSource(StripedPull):
    """Trace-repair symbol stream: one projection reader per plan helper
    (``ops/codec.RepairPlan`` order). ``slabs()`` yields
    ``(meta, (total_bits, ceil(w/8)) uint8)`` blocks -- the concatenated
    planes in helper-then-mask order, ready for the fused combine
    matmul."""

    def __init__(self, readers: Sequence, shard_size: int, plan,
                 slab: int = 8 << 20, window: Optional[int] = None,
                 stats: Optional[TransportStats] = None,
                 parent_span=None):
        if len(readers) != len(plan.helpers):
            raise ValueError(
                f"need one reader per helper: {len(readers)} != "
                f"{len(plan.helpers)}")
        super().__init__(readers, shard_size, slab=slab, window=window,
                         stats=stats, parent_span=parent_span)
        self.plan = plan

    def _stripe_nbytes(self, w: int) -> int:
        return self.plan.total_bits * ((w + 7) // 8)

    def _assemble(self, bufs: List[bytes], w: int) -> np.ndarray:
        stride = (w + 7) // 8
        rows = [np.frombuffer(b, dtype=np.uint8).reshape(-1, stride)
                for b in bufs]
        return np.concatenate(rows, axis=0)


class PlaneGatherSource(StripedPull):
    """Piggyback-repair plane stream: one plane reader per plan helper
    (``ops/codec.PiggybackRepairPlan.helpers`` order: the k-1 data shards,
    then the 2 parities). ``slabs()`` yields
    ``(meta, ((k+1)*alpha/2, w/alpha) uint8)`` blocks -- the restacked
    plane rows in plan column order. Stripes are clamped to whole
    sub-chunk windows so every slice and restack is window-local."""

    def __init__(self, readers: Sequence, shard_size: int, plan,
                 window: int, slab: int = 8 << 20,
                 gather_window: Optional[int] = None,
                 stats: Optional[TransportStats] = None,
                 parent_span=None):
        if len(readers) != len(plan.helpers):
            raise ValueError(
                f"need one reader per helper: {len(readers)} != "
                f"{len(plan.helpers)}")
        if shard_size % window:
            raise ValueError(
                f"piggyback shard size {shard_size} not aligned to "
                f"window {window}")
        slab = max(window, slab - slab % window)
        super().__init__(readers, shard_size, slab=slab,
                         window=gather_window, stats=stats,
                         parent_span=parent_span)
        self.plan = plan
        self.pb_window = int(window)

    def _stripe_nbytes(self, w: int) -> int:
        return len(self.readers) * (w // 2)

    def _assemble(self, bufs: List[bytes], w: int) -> np.ndarray:
        rows = [pb_plane_rows(np.frombuffer(b, dtype=np.uint8),
                              self.plan.alpha, self.pb_window)
                for b in bufs]
        return np.concatenate(rows, axis=0)
