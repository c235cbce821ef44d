"""EC shard files -> volume (.ec00-09 -> .dat, .ecx+.ecj -> .idx), plus
the rebuilder side of single-lost-shard repair: the trace-repair combine
and the piggyback plane repair.

Reference ec_decoder.go: decoding back to a volume is a pure interleave
copy (no GF math: data shards hold the original bytes); the .idx is the
.ecx stream plus tombstone entries replayed from the .ecj journal; the
.dat size is inferred from the maximum ecx entry end. The repairs feed
the codec's GF(2^8) product (the Hopper kernel on the card) through
ops/pipeline.PipelinedMatmul, one dispatch per stripe.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np

from ..ops.codec import combine_planes_to_bytes, get_codec, pb_merge
from ..ops.pipeline import PipelinedMatmul
from ..ops.telemetry import STATS, delta
from ..storage.needle import get_actual_size
from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from ..storage.types import (NEEDLE_ID_SIZE, TOMBSTONE_FILE_SIZE,
                             bytes_to_entry, bytes_to_needle_id, entry_size,
                             entry_to_bytes)
from ..util import tracing
from ..util.profiling import StageTimer
from .constants import (DATA_SHARDS, LARGE_BLOCK_SIZE, PARITY_SHARDS,
                        SMALL_BLOCK_SIZE, to_ext)
from .encoder import (_phases, _record_phase_spans, _shard_outputs,
                      _sync_stream, _transport_stats)
from .layout import ecx_record_bytes


def iterate_ecx_file(base_name: str, offset_width: int = 4):
    rec_size = entry_size(offset_width)
    with open(base_name + ".ecx", "rb") as f:
        while True:
            rec = f.read(rec_size)
            if len(rec) < rec_size:
                break
            yield bytes_to_entry(rec)


def iterate_ecj_file(base_name: str):
    path = base_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            rec = f.read(NEEDLE_ID_SIZE)
            if len(rec) < NEEDLE_ID_SIZE:
                break
            yield bytes_to_needle_id(rec)


def write_idx_file_from_ec_index(base_name: str):
    """.ecx + .ecj -> .idx (reference WriteIdxFileFromEcIndex).

    Only the record-aligned prefix of the .ecx is copied: a piggyback
    volume's index carries a trailing layout byte (ec/layout), and copying
    it would misalign every tombstone record appended below."""
    width = read_ec_volume_superblock(base_name).offset_width
    aligned = ecx_record_bytes(base_name + ".ecx", entry_size(width))
    with open(base_name + ".ecx", "rb") as src, \
            open(base_name + ".idx", "wb") as idx:
        left = aligned
        while left > 0:
            chunk = src.read(min(8 << 20, left))
            if not chunk:
                break
            idx.write(chunk)
            left -= len(chunk)
        for nid in iterate_ecj_file(base_name):
            idx.write(entry_to_bytes(nid, 0, TOMBSTONE_FILE_SIZE, width))


def read_ec_volume_superblock(base_name: str) -> SuperBlock:
    """The volume superblock rides at the start of .ec00 (data shards
    carry the original bytes verbatim): version and flags (offset
    width)."""
    with open(base_name + to_ext(0), "rb") as f:
        return SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))


def find_dat_file_size(base_name: str) -> int:
    sb = read_ec_volume_superblock(base_name)
    dat_size = 0
    for _, offset, size in iterate_ecx_file(base_name, sb.offset_width):
        if size == TOMBSTONE_FILE_SIZE:
            continue
        dat_size = max(dat_size, offset + get_actual_size(size, sb.version))
    return dat_size


def write_dat_file(base_name: str, dat_size: int,
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   buf_size: int = 8 << 20):
    """Interleave-copy .ec00-09 back into a .dat of dat_size bytes."""
    with tracing.span("write", op="ec.to_volume", bytes=int(dat_size)):
        _write_dat_file(base_name, dat_size, large_block, small_block,
                        buf_size)


def _write_dat_file(base_name, dat_size, large_block, small_block,
                    buf_size):
    ins = [open(base_name + to_ext(i), "rb") for i in range(DATA_SHARDS)]
    try:
        with open(base_name + ".dat", "wb") as dat:
            remaining = dat_size
            large_row = large_block * DATA_SHARDS
            block_row = 0
            while remaining > large_row:
                for i in range(DATA_SHARDS):
                    _copy_block(ins[i], block_row * large_block, large_block,
                                dat, buf_size)
                remaining -= large_row
                block_row += 1
            large_rows = block_row
            small_row_idx = 0
            while remaining > 0:
                for i in range(DATA_SHARDS):
                    want = min(remaining, small_block)
                    if want <= 0:
                        break
                    _copy_block(
                        ins[i],
                        large_rows * large_block + small_row_idx * small_block,
                        want, dat, buf_size)
                    remaining -= want
                small_row_idx += 1
    finally:
        for f in ins:
            f.close()


def _copy_block(src, offset: int, length: int, dst, buf_size: int):
    src.seek(offset)
    left = length
    while left > 0:
        chunk = src.read(min(buf_size, left))
        if not chunk:
            dst.write(b"\x00" * left)
            return
        dst.write(chunk)
        left -= len(chunk)


# ---------------------------------------------------------------------------
# Single-lost-shard repair: the rebuilder side (ops/codec.repair_plan and
# piggyback_repair_plan have the scheme math).
# ---------------------------------------------------------------------------

def _repair_stream(codec, matrix, source, max_width, pipelined,
                   timer: StageTimer):
    """(meta, stacked, product) per stripe of ``source``, one K1 dispatch
    each: pipelined through the card, or one ``_matmul`` per stripe."""
    if pipelined:
        pm = PipelinedMatmul(matrix, codec=codec, max_width=max_width,
                             timer=timer)
        return pm.stream(source.slabs())
    return _sync_stream(source.slabs(),
                        lambda rows: codec._matmul(matrix, rows), timer)


def _repair_file(base_name, lost_sid, stream, to_bytes, timer):
    """Append each stripe's rebuilt bytes to the lost shard; all or
    nothing: any failure removes the partial file. Returns bytes
    written."""
    rebuilt_bytes = 0
    with _shard_outputs(base_name, [lost_sid]) as outs, \
            contextlib.closing(stream):
        for (_, _, w), _, product in stream:
            t0 = time.perf_counter()
            outs[lost_sid].write(
                to_bytes(np.asarray(product, dtype=np.uint8), w))
            rebuilt_bytes += w
            timer.add("shard_write", time.perf_counter() - t0, w)
    return rebuilt_bytes


def _repair_stats(stats, before, source, codec, timer, pipelined, stream_s,
                  rebuilt_bytes, mode, n_helpers, k) -> dict:
    gs = source.stats
    baseline = k * source.shard_size
    stats.update(delta(before))
    stats.update(gs.snapshot())
    stats["rebuilt_bytes"] = rebuilt_bytes
    stats["stream_s"] = round(stream_s, 6)
    stats["backend"] = codec.backend
    stats["phases"] = _phases(timer, pipelined, stream_s)
    stats.update(_transport_stats(gs, stream_s, stats["phases"]["gather"]))
    # the repair story: bytes moved vs the k*shard baseline the full
    # gather would have pulled for the same rebuild
    stats["repair_mode"] = mode
    stats["repair_helpers"] = n_helpers
    stats["repair_bytes"] = gs.bytes
    stats["repair_remote_bytes"] = gs.remote_bytes
    stats["repair_baseline_bytes"] = baseline
    stats["repair_bytes_frac"] = round(
        gs.bytes / baseline, 4) if baseline else 0.0
    stats["repair_mbps"] = round(gs.mbps(), 1)
    return stats


def rebuild_ec_file_repair(base_name: str, lost_sid: int, source, plan,
                           codec=None, slab: int = 8 << 20,
                           pipelined: Optional[bool] = None,
                           stats: Optional[dict] = None) -> List[int]:
    """Rebuild ONE lost shard from the trace-repair symbol stream.

    ``source`` is an ec.gather.RepairGatherSource: each stripe arrives as
    the concatenated packed symbol planes of every helper,
    ``(plan.total_bits, ceil(w/8))`` uint8. The combine matrix
    ``plan.combine`` has {0,1} coefficients, and in GF(2^8) multiplying
    by 1 is the identity while addition is XOR, so the combine IS a
    GF(2^8) matmul: the codec's kernel runs it unchanged, one dispatch per
    stripe, its width the byte stride ceil(w/8). The 8 output planes are
    interleaved back into shard bytes on the host and appended to the
    lost shard file.

    ``codec=None`` is the default codec on the card. All or nothing: any
    failure removes the partial shard file before propagating."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    if pipelined is None:
        pipelined = codec.backend in ("cuda", "mesh")
    if lost_sid != plan.lost:
        raise ValueError(f"plan repairs shard {plan.lost}, not {lost_sid}")
    before = STATS.snapshot()
    timer = StageTimer()
    t_stream = time.perf_counter()
    # plane widths are byte strides: an 8 MB slab arrives as
    # total_bits x 1 MB planes, so the pipeline buckets on the stride
    stream = _repair_stream(codec, plan.combine, source,
                            (max(1, int(slab)) + 7) // 8, pipelined, timer)
    rebuilt_bytes = _repair_file(
        base_name, lost_sid, stream,
        lambda planes, w: combine_planes_to_bytes(planes, w).tobytes(),
        timer)
    stream_s = time.perf_counter() - t_stream
    _record_phase_spans(_phases(timer, pipelined, stream_s), "ec.rebuild",
                        backend=codec.backend, repair="trace")
    if stats is not None:
        _repair_stats(stats, before, source, codec, timer, pipelined,
                      stream_s, rebuilt_bytes, "trace", len(plan.helpers),
                      plan.k)
        stats["repair_total_bits"] = plan.total_bits
        stats["repair_bits"] = {int(s): plan.bits_for(s)
                                for s in plan.helpers}
    return [lost_sid]


def rebuild_ec_file_piggyback(base_name: str, lost_sid: int, source,
                              rplan, window: int, codec=None,
                              slab: int = 8 << 20,
                              pipelined: Optional[bool] = None,
                              stats: Optional[dict] = None) -> List[int]:
    """Rebuild ONE coupled data shard from half-plane helper streams.

    ``source`` is an ec.gather.PlaneGatherSource: each stripe arrives as
    the restacked plane rows of every helper (k-1 data shards plus 2
    parities), ((k+1)*alpha/2, w/alpha) uint8 for a w-byte shard range.
    ``rplan.matrix`` (ops/codec.piggyback_repair_plan) turns that stack
    into the lost shard's alpha sub-chunk rows in one GF(2^8) matmul on
    the codec's kernel, and pb_merge interleaves the rows back into shard
    bytes. Download is (k+1)/(2k) of the k*shard full-gather baseline:
    0.55 for RS(10,4).

    ``codec=None`` is the default codec on the card. All or nothing: any
    failure removes the partial shard file before propagating."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    if pipelined is None:
        pipelined = codec.backend in ("cuda", "mesh")
    if lost_sid != rplan.lost:
        raise ValueError(f"plan repairs shard {rplan.lost}, not {lost_sid}")
    alpha = rplan.alpha
    before = STATS.snapshot()
    timer = StageTimer()
    t_stream = time.perf_counter()
    # stripe columns are w/alpha wide for a w-byte shard range
    stream = _repair_stream(codec, rplan.matrix, source,
                            max(1, int(slab)) // alpha + 1, pipelined, timer)
    rebuilt_bytes = _repair_file(
        base_name, lost_sid, stream,
        lambda sub, w: pb_merge(sub, alpha, window)[0].tobytes(), timer)
    stream_s = time.perf_counter() - t_stream
    _record_phase_spans(_phases(timer, pipelined, stream_s), "ec.rebuild",
                        backend=codec.backend, repair="piggyback")
    if stats is not None:
        _repair_stats(stats, before, source, codec, timer, pipelined,
                      stream_s, rebuilt_bytes, "piggyback",
                      len(rplan.helpers), rplan.k)
        stats["layout"] = "piggyback"
    return [lost_sid]
