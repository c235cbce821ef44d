"""Volume -> EC shard files (.dat -> .ec00..ec13), sorted index, rebuild.

Behavior-compatible with reference ec_encoder.go, on the flat layout:
  * write_sorted_file_from_idx: .idx append log -> .ecx (same 16B entries,
    sorted by needle id)
  * write_ec_files: two-level striping — while MORE than one large row
    (k x 1GB) remains, emit a large row; tail as small rows (k x 1MB),
    zero-padded
  * rebuild_ec_files: regenerate missing .ecNN from >= k survivors

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

from ..ops.codec import ReedSolomonCodec, get_codec
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
                   stats: Optional[dict] = None):
    """Encode base_name.dat into base_name.ec00 .. .ec{k+m-1}.

    pipelined: None = auto (pipeline when the codec is device-backed);
    True/False forces. Both paths produce byte-identical shard files.
    ``stats``, when given, is filled with the dispatch-counter deltas of
    this encode, stream_s, backend and the per-phase wall times."""
    codec = codec or get_codec(DATA_SHARDS, PARITY_SHARDS)
    k, m = codec.k, codec.m
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
        if pipelined:
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
        stats["phases"] = _phases(timer, pipelined, stream_s)


def rebuild_ec_files(base_name: str,
                     codec: Optional[ReedSolomonCodec] = None,
                     slab: int = DEFAULT_SLAB,
                     pipelined: Optional[bool] = None,
                     stats: Optional[dict] = None) -> List[int]:
    """Regenerate missing shard files from survivors. Returns the list of
    rebuilt shard ids. Raises if fewer than k survive.

    The "cuda" codec streams survivor slabs through PipelinedMatmul with
    the fused decode plan: one device dispatch per slab regenerates
    every missing shard (data + parity rows stacked). ``stats``, when
    given, is filled with the dispatch-counter deltas of this rebuild
    (dispatches / bitmat_uploads / device_bytes / host_fallbacks),
    survivor_bytes, rebuilt_bytes, stream_s, backend and phases."""
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
