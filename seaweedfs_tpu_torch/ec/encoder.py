"""Volume -> EC shard files (.dat -> .ec00..ec13), sorted index, rebuild.

Behavior-compatible with reference ec_encoder.go:
  * write_sorted_file_from_idx: .idx append log -> .ecx (same 16B entries,
    sorted by needle id)
  * write_ec_files: two-level striping — while MORE than one large row
    (k x 1GB) remains, emit a large row; tail as small rows (k x 1MB),
    zero-padded
  * rebuild_ec_files: regenerate missing .ecNN from >= k survivors

Both run the flat layout (plain RS parity) or the piggyback layout
(coupled sub-chunk parity, ops/codec.piggyback_plan): data shards are
identical under both, and piggyback parity is one (m*alpha, k*alpha)
GF matmul per window-split slab on the same kernel.

Geometry is taken from the codec (generic RS(k,m), default 10+4).

Each device call covers a whole slab (default k x 8MB), and with the
"cuda" codec the slabs flow through ops/pipeline.PipelinedMatmul, which
overlaps disk reads, h2d, the kernel, d2h and shard-file writes. Slab
reads are strided (block i of a row lives at start + i*block_size), the
reference's column layout, so shard bytes are identical across backends.

Per-phase wall time (gather / plan / dispatch / drain / write) is
returned in ``stats["phases"]``.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.codec import (ReedSolomonCodec, get_codec, pb_merge, pb_split,
                         pb_window, piggyback_decode_plan, piggyback_plan)
from ..ops.pipeline import PipelinedMatmul
from ..ops.telemetry import STATS, delta
from ..storage.needle_map import MemDb
from ..storage.super_block import (SUPER_BLOCK_SIZE, InvalidSuperBlock,
                                   SuperBlock)
from ..storage.types import OFFSET_SIZE
from ..util.profiling import StageTimer
from .constants import (DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS,
                        SMALL_BLOCK_SIZE, to_ext)

DEFAULT_SLAB = 8 << 20  # bytes per shard per device call


def write_sorted_file_from_idx(base_name: str):
    """Build the sorted EC index next to the volume files. Record width
    follows the volume's offset width (superblock flag; 5-byte-offset
    volumes have 17B .idx/.ecx records)."""
    width = OFFSET_SIZE
    try:
        with open(base_name + ".dat", "rb") as f:
            width = SuperBlock.from_bytes(
                f.read(SUPER_BLOCK_SIZE)).offset_width
    except (OSError, InvalidSuperBlock):  # no/short .dat: default width
        pass
    db = MemDb.load_from_idx(base_name + ".idx", width)
    db.save_to_idx(base_name + ".ecx")


def _row_slabs(f, k: int, start: int, block_size: int, slab: int,
               timer: StageTimer) -> Iterator[Tuple[None, np.ndarray]]:
    """Yield the slabs of one row of k blocks at [start, start+k*block)."""
    step = min(slab, block_size)
    for off in range(0, block_size, step):
        width = min(step, block_size - off)  # final chunk may be partial
        t0 = time.perf_counter()
        data = np.zeros((k, width), dtype=np.uint8)
        for i in range(k):
            f.seek(start + i * block_size + off)
            chunk = f.read(width)
            if chunk:
                data[i, :len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
        timer.add("disk_read", time.perf_counter() - t0, k * width)
        yield None, data


def _dat_slabs(dat_path: str, dat_size: int, k: int, large_block: int,
               small_block: int, slab: int, timer: StageTimer
               ) -> Iterator[Tuple[None, np.ndarray]]:
    """All slabs of a .dat in shard-file order (large rows, then small)."""
    with open(dat_path, "rb") as f:
        remaining = dat_size
        processed = 0
        large_row = large_block * k
        while remaining > large_row:
            yield from _row_slabs(f, k, processed, large_block, slab, timer)
            remaining -= large_row
            processed += large_row
        small_row = small_block * k
        while remaining > 0:
            yield from _row_slabs(f, k, processed, small_block, slab, timer)
            remaining -= small_row
            processed += small_row


def _coalesce_slabs(slabs: Iterator[Tuple[None, np.ndarray]],
                    target_width: int) -> Iterator[Tuple[None, np.ndarray]]:
    """Hstack consecutive row-slabs up to target_width per device call.

    GF coding is columnwise-independent, so concat-then-encode equals
    encode-then-concat; and consecutive slabs append contiguously to each
    shard file, so the batched rows are exactly the shard byte ranges.
    Without this, a volume of 1MB small rows would reach the device 10MB
    per call.
    """
    batch: List[np.ndarray] = []
    total = 0
    for _, data in slabs:
        w = data.shape[1]
        if batch and total + w > target_width:
            yield None, (batch[0] if len(batch) == 1
                         else np.concatenate(batch, axis=1))
            batch, total = [], 0
        batch.append(data)
        total += w
    if batch:
        yield None, (batch[0] if len(batch) == 1
                     else np.concatenate(batch, axis=1))


def _window_batches(slabs: Iterator[Tuple[None, np.ndarray]],
                    window: int) -> Iterator[Tuple[None, np.ndarray]]:
    """Re-chunk a slab stream onto sub-chunk window boundaries.

    The piggyback parity transform is window-local (ops/codec.pb_split
    interleaves alpha sub-chunks per window), so every batch fed to the
    encode matmul must be a whole number of windows. Shards append
    contiguously, so buffering the non-aligned remainder into the next
    batch preserves shard bytes exactly. The stream total is
    window-aligned by construction (both stripe blocks divide by the
    window), so the buffer always drains."""
    held: Optional[np.ndarray] = None
    for _, data in slabs:
        if held is not None:
            data = np.concatenate([held, data], axis=1)
            held = None
        cut = (data.shape[1] // window) * window
        if cut < data.shape[1]:
            held = np.ascontiguousarray(data[:, cut:])
            data = data[:, :cut]
        if data.shape[1]:
            yield None, np.ascontiguousarray(data)
    if held is not None and held.shape[1]:
        raise ValueError(
            f"stream tail of {held.shape[1]} bytes is not window-aligned "
            f"(window {window}); block sizes must divide by the window")


def piggyback_geometry(codec: ReedSolomonCodec, large_block: int,
                       small_block: int):
    """Resolve (plan, window) for a piggyback encode and check the
    stripe geometry supports sub-chunking: the window must divide both
    stripe blocks so every shard size is window-aligned."""
    pplan = piggyback_plan(codec.k, codec.m, matrix_kind=codec.matrix_kind,
                           matrix=codec.matrix)
    window = pb_window(small_block, pplan.alpha)
    if large_block % window:
        raise ValueError(
            f"piggyback layout: large block {large_block} not divisible "
            f"by the sub-chunk window {window}")
    return pplan, window


def _pb_slab(slab: int, window: int) -> int:
    """Clamp a slab size to whole windows (never below one window) so
    every stripe of a piggyback stream stays window-aligned."""
    return max(window, slab - slab % window)


def _pb_transforms(timer: StageTimer, alpha: int, window: int):
    """pb_split / pb_merge for one stream, each timed as its own stage
    (reported as stats["pb_host_s"]; they sit inside the gather or
    dispatch phase of whichever thread runs them)."""
    def split(rows):
        t0 = time.perf_counter()
        out = pb_split(rows, alpha, window)
        timer.add("pb_split", time.perf_counter() - t0, rows.nbytes)
        return out

    def merge(flat):
        t0 = time.perf_counter()
        out = pb_merge(np.asarray(flat, dtype=np.uint8), alpha, window)
        timer.add("pb_merge", time.perf_counter() - t0, out.nbytes)
        return out
    return split, merge


def _pb_encode_stream(codec, pplan, window, slabs, slab, pipelined, timer):
    """(None, data, parity) per window-aligned batch of a piggyback
    encode: split into sub-chunk rows, one emat product, merge back."""
    alpha = pplan.alpha
    batches = _window_batches(_coalesce_slabs(slabs, _pb_slab(slab, window)),
                              window)
    split, merge = _pb_transforms(timer, alpha, window)
    if pipelined:
        # the original data rides as meta; the split runs on the
        # pipeline's reader thread
        pm = PipelinedMatmul(pplan.emat, codec=codec,
                             max_width=max(slab // alpha, window // alpha),
                             timer=timer)
        for data, _, psub in pm.stream((data, split(data))
                                       for _, data in batches):
            yield None, data, merge(psub)
    else:
        for _, data in batches:
            yield None, data, merge(codec._matmul(pplan.emat, split(data)))


def _pb_host_s(timer: StageTimer) -> dict:
    return {n: round(timer.totals.get(f"pb_{n}", 0.0), 6)
            for n in ("split", "merge")}


def _phases(timer: StageTimer, pipelined: bool, stream_s: float) -> dict:
    """Map StageTimer stages onto the canonical EC phase names, from the
    consumer thread's perspective: in the pipelined path the waits
    (read_wait / h2d / drain_wait) plus the write stage tile the stream
    wall instead of double-counting overlapped worker-thread work. What
    no stage brackets (the host codec call on the sync path, pad copies
    and dispatch issue) is attributed to dispatch, so the phases sum to
    the operation wall."""
    t = timer.totals
    phases = {
        "gather": t.get("read_wait" if pipelined else "disk_read", 0.0),
        "plan": t.get("plan", 0.0),
        "dispatch": t.get("h2d", 0.0),
        "drain": t.get("drain_wait", 0.0),
        "write": t.get("shard_write", 0.0),
    }
    phases["dispatch"] += max(0.0, stream_s - sum(phases.values()))
    return {n: round(s, 6) for n, s in phases.items()}


def write_ec_files(base_name: str, codec: Optional[ReedSolomonCodec] = None,
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   slab: int = DEFAULT_SLAB,
                   pipelined: Optional[bool] = None,
                   stats: Optional[dict] = None,
                   layout: str = "flat"):
    """Encode base_name.dat into base_name.ec00 .. .ec{k+m-1}.

    pipelined: None = auto (pipeline when the codec is device-backed);
    True/False forces. Both paths produce byte-identical shard files.
    ``stats``, when given, is filled with the dispatch-counter deltas of
    this encode, stream_s, backend, layout and the per-phase wall times
    (piggyback adds pb_host_s, the split/merge seconds).

    ``layout``: "flat" (plain RS parity) or "piggyback" (coupled
    sub-chunk parity). Data shard bytes are identical under both. The
    caller records the layout in the volume's sidecars
    (ec/layout.write_layout_sidecars); this function only shapes bytes.
    """
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    k, m = codec.k, codec.m
    if layout not in ("flat", "piggyback"):
        raise ValueError(f"unknown EC layout {layout!r}")
    piggyback = layout == "piggyback"
    if piggyback:
        pplan, window = piggyback_geometry(codec, large_block, small_block)
    if pipelined is None:
        pipelined = codec.backend == "cuda"
    dat_path = base_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    timer = StageTimer()
    before = STATS.snapshot()
    t_stream = time.perf_counter()
    slabs = _dat_slabs(dat_path, dat_size, k, large_block, small_block, slab,
                       timer)
    outs = [open(base_name + to_ext(i), "wb") for i in range(k + m)]
    try:
        if piggyback:
            stream = _pb_encode_stream(codec, pplan, window, slabs, slab,
                                       pipelined, timer)
        elif pipelined:
            pm = PipelinedMatmul(codec.matrix[k:], codec=codec,
                                 max_width=slab, timer=timer)
            stream = pm.stream(_coalesce_slabs(slabs, slab))
        else:
            stream = ((meta, data, codec.encode(data))
                      for meta, data in slabs)
        for _, data, parity in stream:
            t0 = time.perf_counter()
            for i in range(k):
                outs[i].write(data[i].tobytes())
            for j in range(m):
                outs[k + j].write(parity[j].tobytes())
            timer.add("shard_write", time.perf_counter() - t0,
                      data.nbytes + parity.nbytes)
    finally:
        for o in outs:
            o.close()
    stream_s = time.perf_counter() - t_stream
    if stats is not None:
        stats.update(delta(before))
        stats["stream_s"] = round(stream_s, 6)
        stats["backend"] = codec.backend
        stats["layout"] = layout
        stats["phases"] = _phases(timer, pipelined, stream_s)
        if piggyback:
            stats["pb_host_s"] = _pb_host_s(timer)


def rebuild_ec_files(base_name: str,
                     codec: Optional[ReedSolomonCodec] = None,
                     slab: int = DEFAULT_SLAB,
                     pipelined: Optional[bool] = None,
                     stats: Optional[dict] = None,
                     layout=None) -> List[int]:
    """Regenerate missing shard files from survivors. Returns the list of
    rebuilt shard ids. Raises if fewer than k survive.

    The "cuda" codec streams survivor slabs through PipelinedMatmul with
    the fused decode plan: one device dispatch per slab regenerates
    every missing shard (data + parity rows stacked). ``stats``, when
    given, is filled with the dispatch-counter deltas of this rebuild
    (dispatches / bitmat_uploads / device_bytes / host_fallbacks),
    survivor_bytes, rebuilt_bytes, stream_s, backend and phases.

    ``layout``: an ec.layout.LayoutInfo (None means flat). A piggyback
    volume decodes through ops/codec.piggyback_decode_plan, one fused
    matmul per window-split slab (not pipelined)."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    k, total = codec.k, codec.total
    if pipelined is None:
        pipelined = codec.backend == "cuda"
    present = [os.path.exists(base_name + to_ext(i)) for i in range(total)]
    missing = [i for i, p in enumerate(present) if not p]
    if not missing:
        return []
    if sum(present) < k:
        raise ValueError(
            f"cannot rebuild: only {sum(present)} of {total} shards")
    shard_size = None
    for i, p in enumerate(present):
        if p:
            sz = os.path.getsize(base_name + to_ext(i))
            if shard_size is None:
                shard_size = sz
            elif shard_size != sz:
                raise ValueError("surviving shards differ in size")
    if layout is not None and layout.piggyback:
        return _rebuild_ec_files_piggyback(base_name, codec, layout, present,
                                           missing, shard_size, slab, stats)
    ins = [open(base_name + to_ext(i), "rb") if present[i] else None
           for i in range(total)]
    outs = {i: open(base_name + to_ext(i), "wb") for i in missing}
    # only the first k survivors feed the decode plan; reading more would
    # be dead I/O (their coefficient columns are zero by construction)
    src = [i for i, p in enumerate(present) if p][:k]

    def survivor_slabs():
        for off in range(0, shard_size, slab):
            n = min(slab, shard_size - off)
            rows = []
            for i in src:
                ins[i].seek(off)
                rows.append(np.frombuffer(ins[i].read(n), dtype=np.uint8))
            yield None, np.stack(rows, axis=0)

    before = STATS.snapshot()
    timer = StageTimer()
    t_stream = time.perf_counter()
    try:
        if pipelined:
            t0 = time.perf_counter()
            _, _, coeffs = codec.decode_plan(tuple(present))
            timer.add("plan", time.perf_counter() - t0)
            pm = PipelinedMatmul(coeffs, codec=codec, max_width=slab,
                                 timer=timer)
            for _, _, rebuilt in pm.stream(survivor_slabs()):
                t0 = time.perf_counter()
                for r, i in enumerate(missing):
                    outs[i].write(rebuilt[r].tobytes())
                timer.add("shard_write", time.perf_counter() - t0,
                          rebuilt.nbytes)
        else:
            for off in range(0, shard_size, slab):
                n = min(slab, shard_size - off)
                t0 = time.perf_counter()
                shards: List[Optional[np.ndarray]] = []
                for i in range(total):
                    if ins[i] is None:
                        shards.append(None)
                    else:
                        ins[i].seek(off)
                        shards.append(np.frombuffer(ins[i].read(n),
                                                    dtype=np.uint8))
                timer.add("disk_read", time.perf_counter() - t0)
                rebuilt = codec.reconstruct(shards)
                t0 = time.perf_counter()
                for i in missing:
                    outs[i].write(rebuilt[i].tobytes())
                timer.add("shard_write", time.perf_counter() - t0)
    finally:
        for h in ins:
            if h is not None:
                h.close()
        for h in outs.values():
            h.close()
    stream_s = time.perf_counter() - t_stream
    if stats is not None:
        stats.update(delta(before))
        stats["survivor_bytes"] = shard_size * k
        stats["rebuilt_bytes"] = shard_size * len(missing)
        stats["stream_s"] = round(stream_s, 6)
        stats["backend"] = codec.backend
        stats["phases"] = _phases(timer, pipelined, stream_s)
    return missing


def _rebuild_ec_files_piggyback(base_name, codec, layout, present,
                                missing, shard_size, slab, stats
                                ) -> List[int]:
    """Local piggyback rebuild: decode every missing shard (data AND
    parity) from the coupled decode plan's source set in one fused
    matmul per slab. Shard sizes are window-aligned by construction
    (both stripe blocks divide by the window), so slabs clamp to whole
    windows with no tail special-case."""
    alpha, window = layout.alpha, layout.window
    if shard_size % window:
        raise ValueError(
            f"piggyback shard size {shard_size} not window-aligned "
            f"({window}); sidecar geometry is wrong for these shards")
    before = STATS.snapshot()
    timer = StageTimer()
    split, merge = _pb_transforms(timer, alpha, window)
    t_stream = time.perf_counter()
    # the plan's missing rows are every absent shard, in order: `missing`
    src, _, coeffs = piggyback_decode_plan(
        codec.k, codec.m, tuple(bool(p) for p in present),
        matrix_kind=codec.matrix_kind, matrix=codec.matrix,
        pairs=layout.pairs)
    timer.add("plan", time.perf_counter() - t_stream)
    eff_slab = _pb_slab(slab, window)
    ins = {i: open(base_name + to_ext(i), "rb") for i in src}
    outs = {i: open(base_name + to_ext(i), "wb") for i in missing}
    try:
        for off in range(0, shard_size, eff_slab):
            n = min(eff_slab, shard_size - off)
            t0 = time.perf_counter()
            stack = []
            for i in src:
                ins[i].seek(off)
                stack.append(np.frombuffer(ins[i].read(n), dtype=np.uint8))
            block = np.stack(stack, axis=0)
            timer.add("disk_read", time.perf_counter() - t0, block.nbytes)
            merged = merge(codec._matmul(coeffs, split(block)))
            t0 = time.perf_counter()
            for r, i in enumerate(missing):
                outs[i].write(merged[r].tobytes())
            timer.add("shard_write", time.perf_counter() - t0,
                      n * len(missing))
    finally:
        for h in ins.values():
            h.close()
        for h in outs.values():
            h.close()
    stream_s = time.perf_counter() - t_stream
    if stats is not None:
        stats.update(delta(before))
        stats["survivor_bytes"] = shard_size * len(src)
        stats["rebuilt_bytes"] = shard_size * len(missing)
        stats["stream_s"] = round(stream_s, 6)
        stats["backend"] = codec.backend
        stats["layout"] = "piggyback"
        stats["phases"] = _phases(timer, False, stream_s)
        stats["pb_host_s"] = _pb_host_s(timer)
    return list(missing)
