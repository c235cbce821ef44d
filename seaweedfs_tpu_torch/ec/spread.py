"""Streaming striped shard spread for EC encode: the *push* role of
``ec/transport.py``.

The streaming spread takes the stripe stream coming out of the encode
(each stripe is one slab-aligned ``[off, off+w)`` range of every shard)
and pushes each shard's ranges straight to its assigned holder through
the chunked ``/admin/ec/shard_write`` route while later slabs are still
encoding. Shards bound for remote holders never touch the source disk.

The transport (the bounded per-target window with peak-buffer and
blocked-time accounting, contiguous-run merging, retry and failover onto
spares, first-run hedging, the ``.part`` stage and atomic finalize) lives
in ``ec/transport.py``, shared with the gather's pull side. This module
keeps what is specific to pushing an encode: mapping a shard assignment
onto transport writers. It is the JAX package's ``ec/spread.py``; the
window defaults to ``transport.DEFAULT_WINDOW`` (the JAX
SW_EC_SPREAD_WINDOW default) and is read from no environment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .constants import to_ext
from .transport import (  # noqa: F401  - the shared transport, push role
    DEFAULT_WINDOW, LocalShardWriter, RemoteShardWriter, SpreadError,
    SpreadStats, StripedPush, TransportStats, merge_runs, push_window,
)


def spread_window() -> int:
    return push_window()


class StripedSpreadSink(StripedPush):
    """The placement stream: ``write_stripe`` routes each shard row of the
    arriving stripe to its holder's bounded send queue; per-target
    workers push the ranges while the encode produces the next stripes.
    ``assignment`` maps shard id -> holder url; shards mapped to
    ``local_url`` (or unmapped) take the local-writer fast path and are
    staged next to ``base_name``. Everything after writer construction is
    ``StripedPush``."""

    def __init__(self, vid: int, base_name: str,
                 assignment: Dict[int, str], total: int,
                 collection: str = "",
                 local_url: str = "",
                 spares: Optional[Sequence[str]] = None,
                 window: Optional[int] = None,
                 stats: Optional[TransportStats] = None,
                 rate_mbps: float = 0.0,
                 hedge_ms: Optional[float] = None,
                 routing: bool = False, parent_span=None):
        self.vid = vid
        self.base_name = base_name
        writers: List = []
        by_target: Dict[Optional[str], List[int]] = {}
        for sid in range(int(total)):
            url = assignment.get(sid) or ""
            if url == local_url:
                url = ""
            if url:
                w = RemoteShardWriter(vid, sid, collection)
            else:
                w = LocalShardWriter(base_name + to_ext(sid))
            writers.append(w)
            by_target.setdefault(url or None, []).append(sid)
        super().__init__(writers, by_target, spares=spares, window=window,
                         stats=stats, hedge_ms=hedge_ms,
                         rate_mbps=rate_mbps, routing=routing,
                         parent_span=parent_span)
