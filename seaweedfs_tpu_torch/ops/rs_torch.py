"""PyTorch Reed-Solomon backend: GF(2^8) coding through the Hopper kernel.

The counterpart of seaweedfs_tpu/ops/rs_tpu.TpuCodec. Every product runs
through ops/rs_hopper.gf_matmul: the hand-written kernel when the codec's
device is the card, its plain PyTorch version when the caller asked for
device="cpu" (as the tests do). A codec built for the card on a machine
without one raises; it never carries on quietly on the CPU.

Chunking: payloads wider than ``chunk_bytes`` per row stream through in
fixed-width chunks, every chunk launched before any is copied back, so
the card computes chunk t+1 while chunk t drains. Narrower payloads pad
to a power-of-two width bucket (zero columns are exact under GF
linearity) so varied widths reuse one set of buffer sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .codec import (SMALL_DISPATCH_BYTES, ReedSolomonCodec, _ConstCache,
                    width_bucket)
from .gf_plan import make_plan
from .rs_hopper import gf_matmul
from .telemetry import STATS


def resolve_device(device) -> torch.device:
    """torch.device for a codec; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch version on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchCodec(ReedSolomonCodec):
    """GF(2^8) codec on a torch device ("cuda" by default)."""

    backend = "cuda"

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde",
                 chunk_bytes: int = 32 << 20,
                 small_dispatch_bytes: Optional[int] = None,
                 device="cuda",
                 matrix: Optional[np.ndarray] = None):
        super().__init__(data_shards, parity_shards, matrix_kind, matrix)
        self.device = resolve_device(device)
        self.chunk_bytes = int(chunk_bytes)
        self.small_dispatch_bytes = (
            SMALL_DISPATCH_BYTES if small_dispatch_bytes is None
            else int(small_dispatch_bytes))
        self._consts = _ConstCache()

    def put(self, host: np.ndarray) -> torch.Tensor:
        """Host uint8 array -> tensor on the codec's device."""
        host = np.require(host, dtype=np.uint8, requirements=["C", "W"])
        return torch.from_numpy(host).to(self.device)

    def device_fn(self, coeffs: np.ndarray, width: int):
        """(gf_matmul, device-resident tile plan, put). The plan is built
        on the host and uploads once per matrix (one bitmat_upload), then
        stays resident across slabs; ``width`` needs no specialisation."""
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        const = self._consts.get(
            (coeffs.shape, coeffs.tobytes()),
            lambda: make_plan(coeffs, self._consts.owner).to(self.device))
        return gf_matmul, const, self.put

    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        r, k = coeffs.shape
        n = data.shape[1]
        if n == 0:
            return np.zeros((r, 0), dtype=np.uint8)
        if n <= self.chunk_bytes:
            bucket = width_bucket(n, self.chunk_bytes)
            fn, const, put = self.device_fn(coeffs, bucket)
            STATS.add("dispatches")
            STATS.add("device_bytes", data.nbytes)
            if n < bucket:
                pad = np.zeros((k, bucket), dtype=np.uint8)
                pad[:, :n] = data
                data = pad
            return fn(const, put(data)).cpu().numpy()[:, :n]
        out = np.empty((r, n), dtype=np.uint8)
        fn, const, put = self.device_fn(coeffs, self.chunk_bytes)
        # launch every chunk before draining any: the copy back of
        # chunk t overlaps the kernel of chunk t+1
        pending = []
        for off in range(0, n, self.chunk_bytes):
            end = min(off + self.chunk_bytes, n)
            chunk = data[:, off:end]
            STATS.add("dispatches")
            STATS.add("device_bytes", chunk.nbytes)
            if end - off < self.chunk_bytes:
                pad = np.zeros((k, self.chunk_bytes), dtype=np.uint8)
                pad[:, : end - off] = chunk
                chunk = pad
            pending.append((off, end, fn(const, put(chunk))))
        for off, end, dev in pending:
            out[:, off:end] = dev.cpu().numpy()[:, : end - off]
        return out
