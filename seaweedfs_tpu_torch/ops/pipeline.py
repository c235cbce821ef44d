"""Pipelined host <-> device streaming for the EC path.

The reference's encode loop is a synchronous read -> GF -> write cycle per
batch. Here four stages overlap:

    disk read (reader thread) -> h2d (copy stream) -> kernel (current
    stream) -> d2h (copy stream, drained by a small thread pool) ->
    shard-file write (the consumer)

Each slab is staged into pinned host memory and copied to the card with
``non_blocking=True`` on a dedicated h2d stream; the kernel waits for that
copy through a CUDA event and runs on the current stream; the result is
copied back on a dedicated d2h stream into pinned memory, and a drain-pool
thread waits on the copy's event. Up to ``depth`` slabs are in flight, so
the card works on slab t+1..t+depth while the host writes slab t.

PipelinedMatmul computes ``coeffs @ data`` over GF(2^8) for a stream of
slabs with a fixed coefficient matrix — encode (coeffs = parity rows) and
rebuild (coeffs = fused decode-plan rows vs survivors) both reduce to
this. The codec (ops/rs_torch.LaneCodec) splits each slab into lanes,
column slices each at a position's device: one lane on TorchCodec's
device, one per 'data' position of a MeshCodec. Each lane is staged into
its own pinned buffer and copied on its own h2d and d2h streams (keyed
by position, so two positions on one card share neither a buffer nor an
event); ``codec.launch`` runs the kernel of every lane on its device's
current stream. On the CPU the same loop runs with no streams and no
pinning, through the kernel's plain version.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from .telemetry import STATS
from ..util.profiling import StageTimer

_SENTINEL = object()
_DRAIN_THREADS = 2  # d2h waits in flight at once


class PipelinedMatmul:
    """Streams (meta, data (k, w) uint8) slabs through a device GF matmul.

    stream() yields (meta, data, out (r, w)) in input order with up to
    ``depth`` slabs in flight on the device and ``prefetch`` slabs of
    read-ahead in the reader queue. With ``pieces=True`` it yields
    (meta, data, [(col_off, piece)]) instead, the form the streaming
    rebuild appends from: one piece per lane (``codec.drain_pieces``).
    """

    def __init__(self, coeffs: np.ndarray, *, codec,
                 max_width: int = 32 << 20, depth: int = 4,
                 prefetch: int = 3, timer: StageTimer,
                 pieces: bool = False):
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        self.r, self.k = coeffs.shape
        self.codec = codec
        self.max_width = int(max_width)
        self.depth = int(depth)
        self.prefetch = int(prefetch)
        self.timer = timer  # per-stage breakdown
        self.pieces = bool(pieces)
        self._coeffs = coeffs

    def stream(self, slabs: Iterable[Tuple[object, np.ndarray]]
               ) -> Iterator[Tuple[object, np.ndarray, object]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: list = []
        stop = threading.Event()

        def produce():
            try:
                for item in slabs:
                    if stop.is_set():
                        break
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 - relay to consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        reader = threading.Thread(target=produce, daemon=True,
                                  name="pipeline-producer")
        reader.start()
        drain_pool = ThreadPoolExecutor(max_workers=_DRAIN_THREADS,
                                        thread_name_prefix="pipeline-drain")
        pending: deque = deque()
        timer = self.timer
        copy_streams = {}  # position -> (h2d, d2h) on its card

        def streams_of(label, dev):
            got = copy_streams.get(label)
            if got is None:
                got = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
                copy_streams[label] = got
            return got

        def fetch(outs, nbytes: int, w: int):
            t = time.perf_counter()
            for _, _, done in outs:
                if done is not None:
                    done.synchronize()  # kernel + d2h of this lane complete
            result = self.codec.drain_pieces(
                [(lo, h) for lo, h, _ in outs], w)
            if not self.pieces:
                result = result[0][1] if len(result) == 1 else \
                    np.concatenate([p for _, p in result], axis=1)
            timer.add("d2h+mxu", time.perf_counter() - t, nbytes)
            return result

        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                timer.add("read_wait", time.perf_counter() - t0)
                if item is _SENTINEL:
                    break
                meta, data = item
                w = data.shape[1]
                if w > self.max_width:
                    raise ValueError(
                        f"slab width {w} exceeds max_width {self.max_width}")
                bucket = self.codec.pipeline_width_bucket(w, self.max_width)
                lanes = self.codec.lanes(self.k, bucket)
                t0 = time.perf_counter()
                xs = []
                for label, dev, lo, hi in lanes:
                    cuda = dev.type == "cuda"
                    # stage (and zero-pad) into this lane's pinned buffer:
                    # the one host copy the original pad step already paid
                    staged = torch.empty((self.k, hi - lo), dtype=torch.uint8,
                                         pin_memory=cuda)
                    view = staged.numpy()
                    end = max(lo, min(hi, w))
                    view[:, : end - lo] = data[:, lo:end]
                    view[:, end - lo:] = 0
                    if cuda:
                        h2d, _ = streams_of(label, dev)
                        with torch.cuda.stream(h2d):
                            x = torch.empty((self.k, hi - lo),
                                            dtype=torch.uint8, device=dev)
                            x.copy_(staged, non_blocking=True)
                        compute = torch.cuda.current_stream(dev)
                        compute.wait_stream(h2d)
                        x.record_stream(compute)
                    else:
                        x = staged
                    xs.append(x)
                timer.add("h2d", time.perf_counter() - t0, self.k * bucket)
                STATS.add("dispatches")
                STATS.add("device_bytes", data.nbytes)
                # launches on each lane's device's current stream
                outs = self.codec.launch(self._coeffs, bucket, xs)
                staged_outs = []
                for (lo, out), (label, dev, _, _) in zip(outs, lanes):
                    if dev.type == "cuda":
                        _, d2h = streams_of(label, dev)
                        d2h.wait_stream(torch.cuda.current_stream(dev))
                        with torch.cuda.stream(d2h):
                            host = out.to("cpu", non_blocking=True)
                            done = torch.cuda.Event()
                            done.record()
                        out.record_stream(d2h)
                    else:
                        host, done = out, None
                    staged_outs.append((lo, host, done))
                fut = drain_pool.submit(fetch, staged_outs,
                                        self.r * bucket, w)
                pending.append((meta, data, fut))
                if len(pending) >= self.depth:
                    yield self._drain(pending.popleft())
            while pending:
                yield self._drain(pending.popleft())
            if err:
                raise err[0]
        finally:
            drain_pool.shutdown(wait=False)
            # stop the reader (at most one more in-flight slab) and
            # unblock it if the consumer bailed early
            stop.set()
            while reader.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            reader.join(timeout=10)

    def _drain(self, entry):
        meta, data, fut = entry
        t0 = time.perf_counter()
        host = fut.result()  # blocks until kernel + d2h complete
        self.timer.add("drain_wait", time.perf_counter() - t0)
        return meta, data, host
