"""Volume -> EC shard files (.dat -> .ec00..ec13), sorted index, rebuild.

Behavior-compatible with reference ec_encoder.go:
  * write_sorted_file_from_idx: .idx append log -> .ecx (same 16B entries,
    sorted by needle id)
  * write_ec_files: two-level striping — while MORE than one large row
    (k x 1GB) remains, emit a large row; tail as small rows (k x 1MB),
    zero-padded
  * rebuild_ec_files_streaming(_piggyback): regenerate missing .ecNN
    from >= k survivors whose stripes arrive from an ec.gather source
    (a windowed pull)
  * rebuild_ec_files: the same over the survivor files on local disk
  * write_ec_files_spread: the encode's stripe stream teed into an
    ec.spread sink, each shard's ranges pushed to its holder while later
    slabs still encode

Both run the flat layout (plain RS parity) or the piggyback layout
(coupled sub-chunk parity, ops/codec.piggyback_plan): data shards are
identical under both, and piggyback parity is one (m*alpha, k*alpha)
GF matmul per window-split slab on the same kernel.

Geometry is taken from the codec (generic RS(k,m), default 10+4).

Each device call covers a whole slab (default k x 8MB), and with the
"cuda" and "mesh" codecs the slabs flow through
ops/pipeline.PipelinedMatmul, which overlaps disk reads, h2d, the
kernel, d2h and shard-file writes. Slab reads are strided (block i of
a row lives at start + i*block_size), the reference's column layout, so
shard bytes are identical across backends.

Per-phase wall time (gather / plan / dispatch / drain / write) is
returned in ``stats["phases"]`` and recorded beside it as finished spans
of those names (``util/tracing``, the JAX package's ops and tags), under
the caller's current span.
"""

from __future__ import annotations

import contextlib
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
from ..util import tracing
from ..util.profiling import StageTimer
from .constants import (DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS,
                        SMALL_BLOCK_SIZE, to_ext)
from .gather import GatherStats, LocalShardReader, StripedGatherSource

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


def _sync_stream(slabs, fn, timer: StageTimer):
    """(meta, data, fn(data)) per slab: the sync counterpart of
    PipelinedMatmul.stream. Time spent waiting on the source counts as
    disk_read (the gather phase); fn's time falls to dispatch."""
    it = iter(slabs)
    while True:
        t0 = time.perf_counter()
        try:
            meta, data = next(it)
        except StopIteration:
            return
        timer.add("disk_read", time.perf_counter() - t0)
        yield meta, data, fn(data)


def _transport_stats(gs, stream_s: float, gather_s: float) -> dict:
    """Gather busy time (the union of fetch intervals), the compute left
    after the consumer's gather waits, and the share of their serialized
    sum that overlapped, for a rebuild fed by an ec.gather source."""
    gather_busy = gs.busy_s()
    compute_busy = max(stream_s - gather_s, 0.0)
    serialized = gather_busy + compute_busy
    overlap = 0.0
    if serialized > 0:
        overlap = max(0.0, min(1.0, (serialized - stream_s) / serialized))
    return {"gather_busy_s": round(gather_busy, 3),
            "compute_busy_s": round(compute_busy, 3),
            "overlap_frac": round(overlap, 4),
            "gather_mbps": round(gs.mbps(), 1),
            "gather_remote_shards": gs.remote_shards}


@contextlib.contextmanager
def _shard_outputs(base_name: str, sids):
    """The shard files a rebuild writes, all or nothing: on any failure
    they are closed and removed, so callers get complete shards or none
    (and can fall back with a clean slate)."""
    paths = {i: base_name + to_ext(i) for i in sids}
    outs = {i: open(path, "wb") for i, path in paths.items()}
    try:
        yield outs
    except BaseException:
        for h in outs.values():
            h.close()
        for path in paths.values():
            try:
                os.remove(path)
            except OSError:
                pass
        raise
    finally:
        for h in outs.values():
            h.close()


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


def _record_phase_spans(phases: dict, op: str, **tags):
    """Each phase that took time as a finished span of its name."""
    for name, secs in phases.items():
        if secs > 0:
            tracing.record_span(name, secs, op=op, **tags)


def write_ec_files(base_name: str, codec: Optional[ReedSolomonCodec] = None,
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   slab: int = DEFAULT_SLAB,
                   pipelined: Optional[bool] = None,
                   stats: Optional[dict] = None,
                   layout: str = "flat",
                   sink=None):
    """Encode base_name.dat into base_name.ec00 .. .ec{k+m-1}.

    pipelined: None = auto (pipeline when the codec is device-backed);
    True/False forces. Both paths produce byte-identical shard files.
    ``stats``, when given, is filled with the dispatch-counter deltas of
    this encode, stream_s, backend, layout and the per-phase wall times
    (piggyback adds pb_host_s, the split/merge seconds).

    ``sink``: when given (an ec.spread.StripedSpreadSink), the stripe
    stream is teed into ``sink.write_stripe(data, parity)`` instead of
    local shard files, and no shard file is opened here: each stripe is
    the next slab-aligned byte range of every shard, pushed to its
    holder while later slabs encode. The caller owns the sink
    (finish/abort).

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
        pipelined = codec.backend in ("cuda", "mesh")
    dat_path = base_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    timer = StageTimer()
    before = STATS.snapshot()
    t_stream = time.perf_counter()
    slabs = _dat_slabs(dat_path, dat_size, k, large_block, small_block, slab,
                       timer)
    outs = [] if sink is not None else \
        [open(base_name + to_ext(i), "wb") for i in range(k + m)]
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
            if sink is not None:
                sink.write_stripe(data, parity)
            else:
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
    phases = _phases(timer, pipelined, stream_s)
    _record_phase_spans(phases, "ec.encode")
    if stats is not None:
        stats.update(delta(before))
        stats["stream_s"] = round(stream_s, 6)
        stats["backend"] = codec.backend
        stats["layout"] = layout
        stats["phases"] = phases
        if piggyback:
            stats["pb_host_s"] = _pb_host_s(timer)


def write_ec_files_spread(base_name: str, sink,
                          codec: Optional[ReedSolomonCodec] = None,
                          large_block: int = LARGE_BLOCK_SIZE,
                          small_block: int = SMALL_BLOCK_SIZE,
                          slab: int = DEFAULT_SLAB,
                          pipelined: Optional[bool] = None,
                          stats: Optional[dict] = None,
                          layout: str = "flat"):
    """Streaming encode+spread: tee write_ec_files' stripe stream into
    ``sink`` (an ec.spread.StripedSpreadSink), so each shard's slab
    ranges reach its holder while later slabs are still encoding. Wall
    approaches max(encode, spread); shards bound for remote holders
    never touch the source disk.

    On ANY failure the sink is aborted (``.part`` cleanup on every
    holder) before the exception propagates: callers get a complete
    finalized shard set or nothing.

    ``stats``, when given, is filled with write_ec_files' stats (the
    dispatch-counter deltas, backend, layout, phases), the spread
    snapshot (``spread_*``, ``holder_fetches``, ...), ``shard_size``,
    ``stream_s`` (encode and finish), ``encode_busy_s`` (the stream
    wall less the time the producer was blocked on full send windows),
    ``spread_busy_s`` (the union of the send intervals),
    ``overlap_frac`` (the share of their serialized sum that
    overlapped), ``spread_mbps`` and ``spread_remote_shards``."""
    enc: dict = {}
    t_stream = time.perf_counter()
    try:
        write_ec_files(base_name, codec=codec, large_block=large_block,
                       small_block=small_block, slab=slab,
                       pipelined=pipelined, stats=enc, layout=layout,
                       sink=sink)
        sink.finish()
    except BaseException:
        sink.abort()
        raise
    stream_s = time.perf_counter() - t_stream
    if stats is not None:
        ss = sink.stats
        stats.update(enc)
        stats.update(ss.snapshot())
        stats["shard_size"] = sink.offset
        stats["stream_s"] = round(stream_s, 3)
        spread_busy = ss.busy_s()
        encode_busy = max(stream_s - sink.blocked_s, 0.0)
        serialized = encode_busy + spread_busy
        overlap = 0.0
        if serialized > 0:
            overlap = max(0.0, min(1.0,
                                   (serialized - stream_s) / serialized))
        stats["encode_busy_s"] = round(encode_busy, 3)
        stats["spread_busy_s"] = round(spread_busy, 3)
        stats["overlap_frac"] = round(overlap, 4)
        stats["spread_mbps"] = round(ss.mbps(), 1)
        stats["spread_remote_shards"] = ss.remote_shards


def rebuild_ec_files(base_name: str,
                     codec: Optional[ReedSolomonCodec] = None,
                     slab: int = DEFAULT_SLAB,
                     pipelined: Optional[bool] = None,
                     stats: Optional[dict] = None,
                     layout=None) -> List[int]:
    """Regenerate missing shard files from survivors on local disk.
    Returns the list of rebuilt shard ids. Raises if fewer than k
    survive.

    The local rebuild is the streaming rebuild over LocalShardReaders:
    the survivors the decode plan reads are pulled stripe by stripe
    through an ec.gather.StripedGatherSource, and the same all-or-nothing
    guarantee holds. With a device codec one device dispatch per slab
    regenerates every missing shard (data + parity rows stacked).
    ``stats``, when given, is filled as by rebuild_ec_files_streaming.

    ``layout``: an ec.layout.LayoutInfo (None means flat). A piggyback
    volume decodes through ops/codec.piggyback_decode_plan, one fused
    matmul per window-split slab (not pipelined)."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    k, total = codec.k, codec.total
    present = [os.path.exists(base_name + to_ext(i)) for i in range(total)]
    missing = [i for i, p in enumerate(present) if not p]
    if not missing:
        return []
    if sum(present) < k:
        raise ValueError(
            f"cannot rebuild: only {sum(present)} of {total} shards")
    sizes = {os.path.getsize(base_name + to_ext(i))
             for i, p in enumerate(present) if p}
    if len(sizes) != 1:
        raise ValueError("surviving shards differ in size")
    shard_size = sizes.pop()
    piggyback = layout is not None and layout.piggyback
    if piggyback:
        src = piggyback_decode_plan(
            k, codec.m, tuple(present), matrix_kind=codec.matrix_kind,
            matrix=codec.matrix, pairs=layout.pairs)[0]
        slab = _pb_slab(slab, layout.window)
    else:
        # only the first k survivors feed the decode plan; reading more
        # would be dead I/O (their coefficient columns are zero)
        src = [i for i, p in enumerate(present) if p][:k]
    gs = GatherStats()
    source = StripedGatherSource(
        [LocalShardReader(base_name + to_ext(i), gs) for i in src],
        shard_size, slab=slab, stats=gs)
    if piggyback:
        return _rebuild_piggyback_stream(base_name, present, missing,
                                         source, layout, codec, stats,
                                         streaming=False)
    # the sync local rebuild multiplies as the JAX package's
    # codec.reconstruct does: stripes below the crossover on the host
    return _rebuild_flat_stream(base_name, present, missing, source, codec,
                                slab, pipelined, stats, crossover=True)


def rebuild_ec_files_streaming(base_name: str,
                               present: List[bool],
                               missing: List[int],
                               source,
                               codec: Optional[ReedSolomonCodec] = None,
                               slab: int = DEFAULT_SLAB,
                               pipelined: Optional[bool] = None,
                               stats: Optional[dict] = None) -> List[int]:
    """Regenerate missing shards from a survivor stream: the survivor
    bytes arrive from ``source`` (an ec.gather.StripedGatherSource over
    the first k survivors), and each rebuilt slab is appended to the
    missing shard files as the decode drains, so no survivor copy is
    ever materialized. With a device codec the stripes flow through
    PipelinedMatmul and the fused decode plan: one device dispatch per
    stripe regenerates every missing shard.

    ``present``/``missing`` describe the shard state (the decode plan),
    not local files. On ANY failure the partially written missing-shard
    files are removed: callers get complete rebuilt shards or nothing.
    ``stats`` gets the dispatch-counter deltas, the gather snapshot
    (``gather_*``, ``peak_gather_buffer``), survivor/rebuilt bytes,
    stream_s, backend, phases and the overlap of gather and compute
    (``gather_busy_s``, ``compute_busy_s``, ``overlap_frac``)."""
    return _rebuild_flat_stream(base_name, present, missing, source, codec,
                                slab, pipelined, stats, crossover=False)


def _rebuild_flat_stream(base_name, present, missing, source, codec, slab,
                         pipelined, stats, crossover: bool) -> List[int]:
    """The flat streaming rebuild. Sync, each stripe is one
    ``codec._matmul``, or with ``crossover`` one
    ``codec.crossover_matmul`` (host_matmul below small_dispatch_bytes,
    counted as a host_fallback)."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    k, total = codec.k, codec.total
    if pipelined is None:
        pipelined = codec.backend in ("cuda", "mesh")
    if not missing:
        return []
    if sum(present) < k:
        raise ValueError(
            f"cannot rebuild: only {sum(present)} of {total} shards")
    before = STATS.snapshot()
    timer = StageTimer()
    t_stream = time.perf_counter()
    coeffs = _rebuild_coeffs(codec, present, missing)
    timer.add("plan", time.perf_counter() - t_stream)
    if pipelined:
        pm = PipelinedMatmul(coeffs, codec=codec, max_width=slab,
                             timer=timer, pieces=True)
        stream = pm.stream(source.slabs())
    else:
        multiply = codec.crossover_matmul if crossover else codec._matmul
        stream = _sync_stream(
            source.slabs(), lambda data: [(0, multiply(coeffs, data))],
            timer)
    rebuilt_bytes = 0
    # closing: a consumer-side failure must stop the producer and the pull
    # pool now, not when the traceback lets the generator go
    with _shard_outputs(base_name, missing) as outs, \
            contextlib.closing(stream):
        for _, _, parts in stream:
            t0 = time.perf_counter()
            for _, piece in parts:
                for r, i in enumerate(missing):
                    outs[i].write(piece[r].tobytes())
                    rebuilt_bytes += piece[r].nbytes
            timer.add("shard_write", time.perf_counter() - t0)
    stream_s = time.perf_counter() - t_stream
    phases = _phases(timer, pipelined, stream_s)
    # the local rebuild is the JAX package's sync rebuild (no streaming
    # tag); the others its streaming one
    _record_phase_spans(phases, "ec.rebuild", backend=codec.backend,
                        **({} if crossover else {"streaming": True}))
    if stats is not None:
        gs = source.stats
        stats.update(delta(before))
        stats.update(gs.snapshot())
        stats["survivor_bytes"] = source.shard_size * k
        stats["rebuilt_bytes"] = rebuilt_bytes
        stats["stream_s"] = round(stream_s, 6)
        stats["backend"] = codec.backend
        stats["phases"] = phases
        stats.update(_transport_stats(gs, stream_s,
                                      stats["phases"]["gather"]))
    return list(missing)


def _rebuild_coeffs(codec: ReedSolomonCodec, present: List[bool],
                    missing: List[int]) -> np.ndarray:
    """(len(missing), k) GF coefficients so that
    missing_rows = coeffs @ stack(first k surviving shards).

    ``missing`` may be a subset of the shards absent from ``present``
    (survivors masked out without wanting them rebuilt), so only the
    requested rows are sliced from the codec's fused decode plan."""
    _, plan_missing, coeffs = codec.decode_plan(tuple(bool(p)
                                                      for p in present))
    if plan_missing == list(missing):
        return coeffs
    rows = [plan_missing.index(i) for i in missing]
    return np.ascontiguousarray(coeffs[rows])


def rebuild_ec_files_streaming_piggyback(base_name: str,
                                         present: List[bool],
                                         missing: List[int],
                                         source,
                                         layout,
                                         codec: Optional[
                                             ReedSolomonCodec] = None,
                                         stats: Optional[dict] = None
                                         ) -> List[int]:
    """Streaming full decode for a piggyback volume: ``source`` yields
    survivor stripes whose ROWS ARE THE DECODE PLAN'S src ORDER (every
    surviving data shard, then the plan's parity picks: build the readers
    from piggyback_decode_plan's src list, not first-k). Each stripe is
    window-split, pushed through the fused coupled decode, merged, and
    appended to the missing shard files, one slab at a time as in the JAX
    package; the source's slab must be whole windows. Failure removes
    partial outputs, as for the flat streaming rebuild; ``stats`` adds
    pb_host_s (split/merge seconds)."""
    return _rebuild_piggyback_stream(base_name, present, missing, source,
                                     layout, codec, stats, streaming=True)


def _rebuild_piggyback_stream(base_name, present, missing, source, layout,
                              codec, stats, streaming: bool) -> List[int]:
    """The piggyback rebuild; ``streaming`` only picks its spans' tags
    (the JAX package's sync or streaming piggyback rebuild)."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    if not missing:
        return []
    alpha, window = layout.alpha, layout.window
    if source.shard_size % window or source.slab % window:
        raise ValueError(
            f"piggyback shard size {source.shard_size} or slab "
            f"{source.slab} not window-aligned ({window}); sidecar "
            f"geometry is wrong for these shards")
    before = STATS.snapshot()
    timer = StageTimer()
    split, merge = _pb_transforms(timer, alpha, window)
    t_stream = time.perf_counter()
    src, plan_missing, coeffs = piggyback_decode_plan(
        codec.k, codec.m, tuple(bool(p) for p in present),
        matrix_kind=codec.matrix_kind, matrix=codec.matrix,
        pairs=layout.pairs)
    rows = [plan_missing.index(i) for i in missing]
    timer.add("plan", time.perf_counter() - t_stream)
    stream = _sync_stream(
        source.slabs(),
        lambda block: merge(codec._matmul(coeffs, split(block))), timer)
    rebuilt_bytes = 0
    with _shard_outputs(base_name, missing) as outs, \
            contextlib.closing(stream):
        for _, _, merged in stream:
            t0 = time.perf_counter()
            for r, i in zip(rows, missing):
                outs[i].write(merged[r].tobytes())
                rebuilt_bytes += merged.shape[1]
            timer.add("shard_write", time.perf_counter() - t0)
    stream_s = time.perf_counter() - t_stream
    phases = _phases(timer, False, stream_s)
    _record_phase_spans(phases, "ec.rebuild", backend=codec.backend,
                        **({"streaming": True} if streaming else {}),
                        layout="piggyback")
    if stats is not None:
        gs = source.stats
        stats.update(delta(before))
        stats.update(gs.snapshot())
        stats["survivor_bytes"] = source.shard_size * len(src)
        stats["rebuilt_bytes"] = rebuilt_bytes
        stats["stream_s"] = round(stream_s, 6)
        stats["backend"] = codec.backend
        stats["layout"] = "piggyback"
        stats["phases"] = phases
        stats["pb_host_s"] = _pb_host_s(timer)
        stats["gather_mbps"] = round(gs.mbps(), 1)
        stats["gather_remote_shards"] = gs.remote_shards
    return list(missing)


def ec_shard_base_size(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                       small_block: int = SMALL_BLOCK_SIZE,
                       data_shards: int = DATA_SHARDS) -> int:
    """Size every shard file will have for a given .dat size."""
    large_row = large_block * data_shards
    n_large = 0
    remaining = dat_size
    while remaining > large_row:
        n_large += 1
        remaining -= large_row
    small_row = small_block * data_shards
    n_small = (remaining + small_row - 1) // small_row
    return n_large * large_block + n_small * small_block
