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

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..util import tracing
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


#: A slab's column slice at one position: (position label, device,
#: first column, end column).
Lane = Tuple[str, torch.device, int, int]


class LaneCodec(ReedSolomonCodec):
    """A codec whose products run on K1 in column slices ("lanes"), each
    at a position (a device). TorchCodec has one lane on its device;
    parallel/mesh_codec.MeshCodec one per 'data' position of a mesh.

    Subclasses give ``lanes(k, width)`` and ``launch(coeffs, width,
    xs)``, which runs K1 on every lane's tensor before any is drained
    and returns [(col_off, out)]. The chunk loop of ``_matmul`` and the
    drain live here, and ops/pipeline.PipelinedMatmul streams slabs
    through the same three methods. With ``trace_phases`` (MeshCodec, as
    the JAX MeshCodec) the launches and the drain of ``_matmul`` are
    ``dispatch`` and ``drain`` spans."""

    trace_phases = False

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde",
                 matrix: Optional[np.ndarray] = None,
                 chunk_bytes: int = 32 << 20,
                 small_dispatch_bytes: Optional[int] = None):
        super().__init__(data_shards, parity_shards, matrix_kind, matrix)
        self.chunk_bytes = int(chunk_bytes)
        self.small_dispatch_bytes = (
            SMALL_DISPATCH_BYTES if small_dispatch_bytes is None
            else int(small_dispatch_bytes))
        self._consts = _ConstCache()

    def lanes(self, k: int, width: int) -> List[Lane]:
        raise NotImplementedError

    def launch(self, coeffs: np.ndarray, width: int,
               xs: List[torch.Tensor]) -> List[Tuple[int, torch.Tensor]]:
        raise NotImplementedError

    def drain_pieces(self, out, w: int) -> List[Tuple[int, np.ndarray]]:
        """Host pieces of ``launch``'s output in width order: one
        (col_offset, (r, piece_w) array) per lane, clipped at ``w`` (the
        tail pad dropped), so consumers start on the first lane's
        stripes without staging the slab whole."""
        pieces = []
        for lo, t in out:
            if lo >= w:
                continue
            piece = t.cpu().numpy()
            if lo + piece.shape[1] > w:
                piece = piece[:, : w - lo]
            pieces.append((lo, piece))
        return pieces

    def column_multiple(self) -> int:
        """What every width bucket is a multiple of (the lanes' count)."""
        return 1

    def pipeline_width_bucket(self, n: int, cap: int) -> int:
        bucket = width_bucket(n, cap)
        return bucket + (-bucket) % self.column_multiple()

    def _width_bucket(self, n: int) -> int:
        """A power-of-two bucket (at least 512, at most chunk_bytes but
        never below n), padded to a multiple of column_multiple()."""
        bucket = min(max(512, 1 << (n - 1).bit_length()), self.chunk_bytes)
        bucket = max(bucket, n)
        return bucket + (-bucket) % self.column_multiple()

    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        r, k = coeffs.shape
        n = data.shape[1]
        if n == 0:
            return np.zeros((r, 0), dtype=np.uint8)
        out = np.empty((r, n), dtype=np.uint8)

        def phase(name, nbytes):
            return tracing.span(name, backend=self.backend, bytes=nbytes) \
                if self.trace_phases else contextlib.nullcontext()

        # launch every chunk before draining any: the copy back of
        # chunk t overlaps the kernels of the chunks after it
        pending = []
        with phase("dispatch", int(n * k)):
            for off in range(0, n, self.chunk_bytes):
                end = min(off + self.chunk_bytes, n)
                w = end - off
                bucket = self._width_bucket(w)
                if w < bucket:  # zero columns: exact under GF linearity
                    padded = np.zeros((k, bucket), dtype=np.uint8)
                    padded[:, :w] = data[:, off:end]
                else:
                    padded = data[:, off:end]
                xs = [torch.from_numpy(np.require(
                    padded[:, lo:hi], requirements=["C", "W"])).to(dev)
                    for _, dev, lo, hi in self.lanes(k, bucket)]
                STATS.add("dispatches")
                STATS.add("device_bytes", w * k)
                pending.append((off, w, self.launch(coeffs, bucket, xs)))
        with phase("drain", int(n * r)):
            for off, w, dev_out in pending:
                for lo, piece in self.drain_pieces(dev_out, w):
                    out[:, off + lo: off + lo + piece.shape[1]] = piece
        return out


class TorchCodec(LaneCodec):
    """GF(2^8) codec on a torch device ("cuda" by default): one lane."""

    backend = "cuda"

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde",
                 chunk_bytes: int = 32 << 20,
                 small_dispatch_bytes: Optional[int] = None,
                 device="cuda",
                 matrix: Optional[np.ndarray] = None):
        super().__init__(data_shards, parity_shards, matrix_kind, matrix,
                         chunk_bytes, small_dispatch_bytes)
        self.device = resolve_device(device)

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

    def lanes(self, k: int, width: int) -> List[Lane]:
        return [("", self.device, 0, width)]

    def launch(self, coeffs, width, xs):
        fn, const, _ = self.device_fn(coeffs, width)
        return [(0, fn(const, xs[0]))]
