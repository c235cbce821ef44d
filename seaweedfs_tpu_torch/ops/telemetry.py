"""Device-dispatch counters for the EC hot paths.

Every device dispatch, coefficient-constant upload and host-path
small-read fallback increments a process-global counter, and
rebuild_ec_files / write_ec_files report the deltas so a regression to
per-slab uploads (or to no device dispatch at all) shows up as a count
instead of hiding inside wall time.

Mesh-sharded dispatches (parallel/mesh_codec) also record the payload
bytes each mesh position received (``mesh_dispatches`` and the
per-position byte map). A codec over a one-wide mesh, or a crossover
that sends every slab to the single-device path, runs and is exact; only
that map tells it from a dispatch spread over the mesh, so ``delta()``
derives ``dispatch_width_devices`` and ``device_busy_frac`` from it. The
map is keyed by position (``cuda:0/1``), not by device: positions may
share a card, and a map by device would read one wide.
"""

from __future__ import annotations

import threading
from typing import Dict


class DispatchStats:
    """Monotonic process-global counters (thread-safe)."""

    _FIELDS = ("dispatches", "bitmat_uploads", "host_fallbacks",
               "device_bytes", "mesh_dispatches")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)
        self._mesh_device_bytes: Dict[str, int] = {}

    def add(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def add_mesh_device_bytes(self, position: str, n: int):
        """Payload bytes a sharded put landed on one mesh position."""
        with self._lock:
            self._mesh_device_bytes[position] = \
                self._mesh_device_bytes.get(position, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            snap = {f: getattr(self, f) for f in self._FIELDS}
            snap["mesh_device_bytes"] = dict(self._mesh_device_bytes)
            return snap


STATS = DispatchStats()


def delta(before: dict) -> dict:
    """Counter movement since a snapshot() — the per-operation report.

    Besides the raw field deltas: ``mesh_device_bytes`` (the positions a
    sharded put landed bytes on in the window, and how many),
    ``dispatch_width_devices`` (how many positions those are; 1 when
    only single-device dispatches ran, 0 when none did) and
    ``device_busy_frac`` (each position's bytes over the busiest's: 1.0
    everywhere is an even split)."""
    now = STATS.snapshot()
    out = {f: now[f] - before.get(f, 0) for f in DispatchStats._FIELDS}
    before_pos = before.get("mesh_device_bytes", {})
    per_pos = {}
    for pos, n in now["mesh_device_bytes"].items():
        moved = n - before_pos.get(pos, 0)
        if moved > 0:
            per_pos[pos] = moved
    out["mesh_device_bytes"] = per_pos
    if per_pos:
        peak = max(per_pos.values())
        out["dispatch_width_devices"] = len(per_pos)
        out["device_busy_frac"] = {p: round(n / peak, 4)
                                   for p, n in sorted(per_pos.items())}
    else:
        out["dispatch_width_devices"] = 1 if out["dispatches"] > 0 else 0
        out["device_busy_frac"] = {}
    return out
