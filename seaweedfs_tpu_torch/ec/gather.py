"""Streaming striped survivor gather for EC rebuild and repair: the
*pull* role of ``ec/transport.py``, local half.

Instead of reading every surviving shard whole before the first GF byte
is computed, the streaming rebuild fetches slab-aligned byte ranges of
each survivor and hands each arriving stripe to the pipelined decode
while the next stripes are still in flight. The window, pool and
ordering come from ``transport.StripedPull``; this module keeps what is
specific to pulling shards: the slab choice, and the readers and stream
shapes of trace repair (packed symbol planes) and piggyback plane repair
(half-plane sub-chunks). The holder-side transforms (``project_slab``,
``pb_plane_slice``) run on the host with numpy, as the JAX package runs
them.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..ops.codec import pb_plane_rows, pb_plane_slice, project_slab
from .transport import (  # noqa: F401  - the shared transport, pull role
    DEFAULT_WINDOW, GatherStats, LocalShardReader, StripedPull,
    TransportStats,
)


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


def _read_range(path: str, off: int, n: int) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(off)
        data = f.read(n)
    if len(data) != n:
        raise IOError(f"short read of {path} at {off}: {len(data)} < {n}")
    return np.frombuffer(data, dtype=np.uint8)


class LocalRepairReader:
    """Trace projection of a survivor shard on the rebuilder's disk: read
    the range, project, and account only the symbol bytes (the range
    itself never crossed the network)."""

    def __init__(self, path: str, masks: Sequence[int],
                 stats: Optional[TransportStats] = None):
        if not masks:
            raise ValueError(f"{path}: no repair masks")
        self.path = path
        self.masks = [int(x) for x in masks]
        self.stats = stats or GatherStats()

    def read(self, off: int, n: int) -> bytes:
        t0 = time.perf_counter()
        planes = project_slab(_read_range(self.path, off, n), self.masks)
        self.stats.add_fetch(planes.nbytes, t0, time.perf_counter())
        return planes.tobytes()


class LocalPlaneReader:
    """Plane slice of a helper shard on the rebuilder's disk: read the
    window-aligned range, slice the repair plane, and account only the
    plane bytes."""

    def __init__(self, path: str, alpha: int, window: int,
                 plane_bit: int, plane_side: int,
                 stats: Optional[TransportStats] = None):
        self.path = path
        self.alpha = int(alpha)
        self.window = int(window)
        self.plane_bit = int(plane_bit)
        self.plane_side = int(plane_side)
        self.stats = stats or GatherStats()

    def read(self, off: int, n: int) -> bytes:
        t0 = time.perf_counter()
        plane = pb_plane_slice(_read_range(self.path, off, n), self.alpha,
                               self.window, self.plane_bit, self.plane_side)
        self.stats.add_fetch(plane.nbytes, t0, time.perf_counter())
        return plane.tobytes()


class StripedGatherSource(StripedPull):
    """The survivor stream: ``slabs()`` yields ``(meta, (k, w) uint8)``
    stripes in order, fetching up to ``window`` stripes ahead.
    ``readers`` are the survivors in decode plan order (the first k for
    the flat layout, piggyback_decode_plan's src for the coupled one)."""


class RepairGatherSource(StripedPull):
    """Trace-repair symbol stream: one projection reader per plan helper
    (``ops/codec.RepairPlan`` order). ``slabs()`` yields
    ``(meta, (total_bits, ceil(w/8)) uint8)`` blocks -- the concatenated
    planes in helper-then-mask order, ready for the fused combine
    matmul."""

    def __init__(self, readers: Sequence, shard_size: int, plan,
                 slab: int = 8 << 20, window: Optional[int] = None,
                 stats: Optional[TransportStats] = None):
        if len(readers) != len(plan.helpers):
            raise ValueError(
                f"need one reader per helper: {len(readers)} != "
                f"{len(plan.helpers)}")
        super().__init__(readers, shard_size, slab=slab, window=window,
                         stats=stats)
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
                 stats: Optional[TransportStats] = None):
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
                         window=gather_window, stats=stats)
        self.plan = plan
        self.pb_window = int(window)

    def _stripe_nbytes(self, w: int) -> int:
        return len(self.readers) * (w // 2)

    def _assemble(self, bufs: List[bytes], w: int) -> np.ndarray:
        rows = [pb_plane_rows(np.frombuffer(b, dtype=np.uint8),
                              self.plan.alpha, self.pb_window)
                for b in bufs]
        return np.concatenate(rows, axis=0)
