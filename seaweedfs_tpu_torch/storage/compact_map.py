"""The needle-map factory and the live-set snapshot compaction walks.

The JAX package's ``storage/compact_map.py`` for ``kind="memory"``:
``load_needle_map`` and ``snapshot_live_items``. The ``compact``
(sorted arrays), ``sortedfile`` (mmap'd .sdx) and ``disk`` (sqlite)
index kinds are not ported.
"""

from __future__ import annotations

from typing import List, Tuple

from .needle_map import NeedleMap, NeedleValue
from .types import OFFSET_SIZE

def snapshot_live_items(nm: NeedleMap, by_offset: bool = False
                        ) -> List[Tuple[int, NeedleValue]]:
    """A copy of the live set (the caller holds the volume lock), in .dat
    offset order when ``by_offset``."""
    items = list(nm.items())
    if by_offset:
        items.sort(key=lambda kv: kv[1].offset)
    return items


def load_needle_map(idx_path: str,
                    offset_width: int = OFFSET_SIZE) -> NeedleMap:
    """The memory needle map, replayed from the .idx."""
    return NeedleMap.load(idx_path, offset_width)
