"""EC on-disk layout versioning: flat vs piggybacked sub-chunk parity.

Two layouts coexist in one cluster:

* ``flat`` — plain systematic RS; parity row j is ``a[j] @ data`` over
  whole shard bytes. Every volume written before the piggyback layout
  existed is flat, and flat stays the default.
* ``piggyback`` — data shards are byte-identical to flat, but parity
  shards couple paired data sub-chunks (``ops/codec.piggyback_plan``)
  so a single coupled data shard repairs from half-planes:
  ``(k+1)/(2k)`` of the k*shard full-gather download.

The layout is recorded twice, redundantly:

* the ``.vif`` JSON sidecar carries the authoritative record —
  ``ec_layout`` plus the sub-chunk geometry (``ec_window``,
  ``ec_pairs``) the repair/decode paths must agree on;
* the ``.ecx`` index gets ONE trailing version byte past the last
  sorted record (``ECX_TAG_PIGGYBACK``). Readers floor-divide the file
  size by the record width, so the tag is invisible to the binary
  search, ``walk_index_file`` and tombstone replay — but it survives
  paths that copy the .ecx without the .vif, so a rebuilder can still
  refuse to misread piggyback parity as flat.

``volume_layout`` resolves the two (``.vif`` wins) and is the single
routing predicate for rebuild (and, as they are ported, scrub and
degraded reads). The sidecar bytes match the JAX package's
``seaweedfs_tpu/ec/layout.py`` exactly, so either side reads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..ops.codec import PIGGYBACK_MAX_PAIRS
from .constants import SMALL_BLOCK_SIZE

LAYOUT_FLAT = "flat"
LAYOUT_PIGGYBACK = "piggyback"

# trailing .ecx version byte; flat volumes carry NO tag (byte-identical
# to every pre-layout volume ever written)
ECX_TAG_PIGGYBACK = 0x01
_ECX_TAGS = {ECX_TAG_PIGGYBACK: LAYOUT_PIGGYBACK}


class LayoutInfo:
    """Resolved layout of one EC volume."""

    __slots__ = ("layout", "window", "pairs")

    def __init__(self, layout: str = LAYOUT_FLAT,
                 window: Optional[int] = None,
                 pairs: Optional[int] = None):
        self.layout = layout
        self.window = window
        self.pairs = pairs

    @property
    def piggyback(self) -> bool:
        return self.layout == LAYOUT_PIGGYBACK

    @property
    def alpha(self) -> int:
        return 1 << (self.pairs or 0)

    def __repr__(self):
        return (f"LayoutInfo({self.layout!r}, window={self.window}, "
                f"pairs={self.pairs})")


def _default_geometry(k: int) -> "tuple[int, int]":
    """(window, pairs) a volume tagged piggyback but missing its .vif
    must have been written with: the encode path only accepts the
    defaults when it writes no explicit geometry."""
    return SMALL_BLOCK_SIZE, min(k // 2, PIGGYBACK_MAX_PAIRS)


def ecx_record_bytes(path: str, record_size: int) -> int:
    """Size of the record-aligned prefix of an index file — the bytes a
    copy/merge must take; anything past it is the layout tag."""
    size = os.path.getsize(path)
    return (size // record_size) * record_size


def read_ecx_tag(base_name: str, record_size: int = 16) -> Optional[str]:
    """Layout named by the trailing .ecx version byte, or None when the
    file is record-aligned (every flat/pre-layout volume)."""
    path = base_name + ".ecx"
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    extra = size % record_size
    if extra == 0:
        return None
    with open(path, "rb") as f:
        f.seek(size - 1)
        tag = f.read(1)
    return _ECX_TAGS.get(tag[0] if tag else -1)


def write_ecx_tag(base_name: str, layout: str, record_size: int = 16):
    """Append (or correct) the trailing layout byte. Flat volumes get
    NO tag — a flat .ecx must stay byte-identical to the pre-layout
    format, so marking flat means truncating back to whole records."""
    path = base_name + ".ecx"
    aligned = ecx_record_bytes(path, record_size)
    with open(path, "r+b") as f:
        f.truncate(aligned)
        if layout == LAYOUT_PIGGYBACK:
            f.seek(aligned)
            f.write(bytes([ECX_TAG_PIGGYBACK]))


def volume_layout(base_name: str, k: int,
                  record_size: int = 16) -> LayoutInfo:
    """Resolve a volume's layout from its sidecars. The .vif JSON wins;
    a bare .ecx tag falls back to the default sub-chunk geometry for
    ``k`` (the only geometry an untagged-vif encode can have written).
    No sidecar information at all means flat — exactly what every
    pre-layout volume is."""
    vif = base_name + ".vif"
    if os.path.exists(vif):
        try:
            with open(vif) as f:
                info = json.load(f)
        except (ValueError, OSError):
            info = {}
        layout = info.get("ec_layout")
        if layout == LAYOUT_PIGGYBACK:
            dw, dp = _default_geometry(k)
            return LayoutInfo(LAYOUT_PIGGYBACK,
                              int(info.get("ec_window") or dw),
                              int(info.get("ec_pairs") or dp))
        if layout:
            return LayoutInfo(LAYOUT_FLAT)
    if read_ecx_tag(base_name, record_size) == LAYOUT_PIGGYBACK:
        dw, dp = _default_geometry(k)
        return LayoutInfo(LAYOUT_PIGGYBACK, dw, dp)
    return LayoutInfo(LAYOUT_FLAT)


def write_layout_sidecars(base_name: str, layout: str,
                          window: Optional[int] = None,
                          pairs: Optional[int] = None,
                          record_size: int = 16, **vif_extra):
    """Record a volume's layout in both sidecars: merge the layout keys
    into the .vif JSON (creating it if absent) and set the .ecx tag.
    ``vif_extra`` carries the caller's other .vif fields (version,
    offset_width) so one call writes a complete sidecar."""
    vif = base_name + ".vif"
    info = {}
    if os.path.exists(vif):
        try:
            with open(vif) as f:
                info = json.load(f) or {}
        except (ValueError, OSError):
            info = {}
    info.update(vif_extra)
    info["ec_layout"] = layout
    if layout == LAYOUT_PIGGYBACK:
        info["ec_window"] = int(window)
        info["ec_pairs"] = int(pairs)
    else:
        info.pop("ec_window", None)
        info.pop("ec_pairs", None)
    with open(vif, "w") as f:
        json.dump(info, f)
    if os.path.exists(base_name + ".ecx"):
        write_ecx_tag(base_name, layout, record_size)
