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
this. The kernel, its device-resident constant and the device come from
``codec.device_fn()``. On device="cpu" the same loop runs with no
streams and no pinning, through the kernel's plain version.
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
    rebuild appends from; on one card that is always [(0, out)].
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
        device = self.codec.device
        cuda = device.type == "cuda"
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
        if cuda:
            compute = torch.cuda.current_stream(device)
            h2d_stream = torch.cuda.Stream(device)
            d2h_stream = torch.cuda.Stream(device)

        def fetch(host: torch.Tensor, done, nbytes: int, w: int):
            t = time.perf_counter()
            if done is not None:
                done.synchronize()  # kernel + d2h of this slab complete
            arr = host.numpy()
            if arr.shape[1] > w:
                arr = arr[:, :w]
            timer.add("d2h+mxu", time.perf_counter() - t, nbytes)
            return arr

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
                fn, const, _ = self.codec.device_fn(self._coeffs, bucket)
                t0 = time.perf_counter()
                # stage (and zero-pad) into pinned memory: the one host
                # copy the original pad step already paid
                staged = torch.empty((self.k, bucket), dtype=torch.uint8,
                                     pin_memory=cuda)
                view = staged.numpy()
                view[:, :w] = data
                view[:, w:] = 0
                if cuda:
                    with torch.cuda.stream(h2d_stream):
                        x = torch.empty((self.k, bucket), dtype=torch.uint8,
                                        device=device)
                        x.copy_(staged, non_blocking=True)
                    compute.wait_stream(h2d_stream)
                    x.record_stream(compute)
                else:
                    x = staged
                timer.add("h2d", time.perf_counter() - t0, staged.nbytes)
                STATS.add("dispatches")
                STATS.add("device_bytes", data.nbytes)
                out = fn(const, x)  # launches on the current stream
                if cuda:
                    d2h_stream.wait_stream(compute)
                    with torch.cuda.stream(d2h_stream):
                        host = out.to("cpu", non_blocking=True)
                        done = torch.cuda.Event()
                        done.record()
                    out.record_stream(d2h_stream)
                else:
                    host, done = out, None
                fut = drain_pool.submit(fetch, host, done,
                                        self.r * bucket, w)
                pending.append((meta, data, fut, w))
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
        meta, data, fut, w = entry
        t0 = time.perf_counter()
        host = fut.result()  # blocks until kernel + d2h complete
        self.timer.add("drain_wait", time.perf_counter() - t0)
        return meta, data, [(0, host)] if self.pieces else host
