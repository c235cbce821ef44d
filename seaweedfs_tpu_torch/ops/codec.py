"""Reed-Solomon codec API + backend registry.

Semantics mirror the reference dependency's Encode/Reconstruct
(klauspost/reedsolomon): shards are equal-length byte rows, data rows
are stored verbatim (systematic code), missing shards are None and are
regenerated in place.

Backends:
    get_codec(k, m, backend="cuda" | "numpy", device=...)
"cuda" is the hand-written Hopper kernel behind ops/rs_torch.TorchCodec
(its plain PyTorch version when the caller asks for device="cpu");
"numpy" is the conformance oracle. There is no automatic choice: a
missing card raises instead of quietly running on the CPU. All
backends produce bit-identical output.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

from . import gf256
from .telemetry import STATS

#: Width (bytes) below which device codecs answer reconstruct() on the
#: host: a kilobyte needle range costs less as a LUT walk than as a
#: device round-trip.
SMALL_DISPATCH_BYTES = 256 << 10


def host_matmul(coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The pure-numpy GF(2^8) matmul: one 256-entry LUT gather + XOR per
    (output row, input row) pair. The conformance oracle, and the
    small-payload path device codecs delegate kilobyte reads to."""
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    r = coeffs.shape[0]
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    mt = gf256.MUL_TABLE
    for i in range(r):
        acc = out[i]
        for j in range(coeffs.shape[1]):
            c = coeffs[i, j]
            if c == 0:
                continue
            if c == 1:
                acc ^= data[j]
            else:
                acc ^= mt[c][data[j]]
    return out


def width_bucket(n: int, cap: int) -> int:
    """Pad widths up to power-of-two buckets (at least 512, capped) so
    varied payload widths reuse the same launch geometry and buffers."""
    return min(max(512, 1 << (n - 1).bit_length()), cap)


class _ConstCache:
    """Bounded LRU of device-resident coefficient constants, keyed by
    the coefficient bytes. A rebuild uploads its constant once, not once
    per slab — every make() call counts as a bitmat_upload in
    ops/telemetry, so a run can assert exactly that."""

    def __init__(self, maxsize: int = 32):
        self._entries: OrderedDict = OrderedDict()
        self._maxsize = maxsize

    def get(self, key, make):
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            return hit
        val = make()
        STATS.add("bitmat_uploads")
        self._entries[key] = val
        if len(self._entries) > self._maxsize:
            self._entries.popitem(last=False)
        return val


class ReedSolomonCodec:
    """Base class: matrix construction + reconstruction planning.

    Subclasses implement _matmul(coeffs, data) — the GF(2^8) matrix
    product over byte rows — which is the only compute-heavy primitive.
    Device-backed subclasses additionally expose device_fn() so
    ops/pipeline.PipelinedMatmul can stream slabs through their kernel.
    """

    backend = "abstract"
    # 0 = never delegate; device codecs override with SMALL_DISPATCH_BYTES
    small_dispatch_bytes = 0

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde",
                 matrix: Optional[np.ndarray] = None):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("data_shards and parity_shards must be > 0")
        if data_shards + parity_shards > 256:
            raise ValueError("k + m must be <= 256 in GF(2^8)")
        self.k = data_shards
        self.m = parity_shards
        self.total = data_shards + parity_shards
        self.matrix_kind = matrix_kind
        if matrix is None:
            matrix = gf256.build_matrix(self.k, self.total, matrix_kind)
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if self.matrix.shape != (self.total, self.k):
            raise ValueError(f"matrix shape {self.matrix.shape} is not "
                             f"({self.total}, {self.k})")
        self._decode_cache: dict = {}
        self._plan_cache: dict = {}
        self._syndrome_rows: Optional[np.ndarray] = None

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, **kwargs):
        """A codec over an existing (k+m, k) encode matrix — e.g. another
        codec's ``.matrix`` — so two implementations run on literally
        the same coefficients."""
        total, k = np.shape(matrix)
        return cls(k, total - k, matrix=matrix, **kwargs)

    # -- primitive ---------------------------------------------------------
    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- device streaming hooks (ops/pipeline.PipelinedMatmul) -------------
    def device_fn(self, coeffs: np.ndarray, width: int):
        """Device-backed codecs return (fn, device-resident constant,
        put) for `width`-wide slabs: ``fn(constant, put(slab))`` launches
        on the device and the constant stays resident across slabs. Host
        codecs return None (no pipeline)."""
        return None

    def pipeline_width_bucket(self, n: int, cap: int) -> int:
        return width_bucket(n, cap)

    # -- public API --------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k, n) uint8 -> parity (m, n) uint8."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data rows, got {data.shape[0]}")
        return self._matmul(self.matrix[self.k:], data)

    def encode_to_all(self, data: np.ndarray) -> np.ndarray:
        """data (k, n) -> all shards (total, n); data rows verbatim."""
        parity = self.encode(data)
        return np.concatenate([np.asarray(data, dtype=np.uint8), parity], axis=0)

    def _decode_coeffs(self, present: tuple) -> tuple:
        """For a presence tuple, return (src_rows, inv_matrix) where
        data = inv_matrix @ shards[src_rows]."""
        hit = self._decode_cache.get(present)
        if hit is not None:
            return hit
        src = [i for i, p in enumerate(present) if p][: self.k]
        if len(src) < self.k:
            raise ValueError(
                f"too few shards: have {sum(present)}, need {self.k}")
        inv = gf256.mat_inv(self.matrix[src, :])
        self._decode_cache[present] = (src, inv)
        return src, inv

    def decode_plan(self, present: tuple, data_only: bool = False) -> tuple:
        """Fused decode plan for a presence pattern: (src_rows, missing,
        coeffs) with coeffs (len(missing), k) such that ALL missing rows
        — data and parity stacked — come from ONE matmul against the
        first k survivors. Cached per (present, data_only)."""
        key = (tuple(present), bool(data_only))
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        src, inv = self._decode_coeffs(key[0])
        limit = self.k if data_only else self.total
        missing = [i for i in range(limit) if not present[i]]
        coeffs = gf256.decode_coeff_rows(self.matrix, self.k, src,
                                         missing, inv=inv)
        plan = (src, missing, coeffs)
        self._plan_cache[key] = plan
        return plan

    def lost_row_coeffs(self, present: tuple, sid: int) -> tuple:
        """Single-shard slice of the fused decode plan: (src_rows,
        coeffs) with coeffs (1, k) such that shard[sid] = coeffs @
        shards[src_rows]."""
        src, missing, coeffs = self.decode_plan(tuple(present))
        if sid not in missing:
            raise ValueError(f"shard {sid} is not missing in {present}")
        r = missing.index(sid)
        return src, np.ascontiguousarray(coeffs[r:r + 1])

    def reconstruct(self, shards: Sequence[Optional[np.ndarray]],
                    data_only: bool = False) -> List[np.ndarray]:
        """Fill in missing (None) shards. Returns the full shard list
        (data-only mode leaves missing parity as None).

        All missing rows are regenerated by a single fused matmul
        (decode_plan), and device codecs answer sub-small_dispatch_bytes
        widths on the host."""
        shards = list(shards)
        if len(shards) != self.total:
            raise ValueError(f"expected {self.total} shards, got {len(shards)}")
        present = tuple(s is not None for s in shards)
        if all(present):
            return shards
        lens = {s.shape[-1] for s in shards if s is not None}
        if len(lens) != 1:
            raise ValueError("surviving shards have differing lengths")
        src, missing, coeffs = self.decode_plan(present, data_only)
        if not missing:
            return shards
        survivors = np.stack([np.asarray(shards[i], dtype=np.uint8)
                              for i in src], axis=0)
        if self.small_dispatch_bytes and \
                survivors.shape[1] < self.small_dispatch_bytes:
            STATS.add("host_fallbacks")
            out = host_matmul(coeffs, survivors)
        else:
            out = self._matmul(coeffs, survivors)
        for r, i in enumerate(missing):
            shards[i] = out[r]
        return shards

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        """True iff parity rows match the data rows."""
        data = np.stack([np.asarray(s, dtype=np.uint8)
                         for s in shards[: self.k]], axis=0)
        parity = self.encode(data)
        for i in range(self.m):
            if not np.array_equal(parity[i],
                                  np.asarray(shards[self.k + i], dtype=np.uint8)):
                return False
        return True

    def syndrome_plan(self) -> np.ndarray:
        """Parity-check rows H = [P | I_m], shape (m, k+m): for a
        consistent codeword column x, H @ x = P @ data XOR parity = 0."""
        if self._syndrome_rows is None:
            h = np.zeros((self.m, self.total), dtype=np.uint8)
            h[:, : self.k] = self.matrix[self.k:]
            h[:, self.k:] = np.eye(self.m, dtype=np.uint8)
            self._syndrome_rows = np.ascontiguousarray(h)
        return self._syndrome_rows


class NumpyCodec(ReedSolomonCodec):
    """Pure-numpy reference backend — the conformance oracle."""

    backend = "numpy"

    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        return host_matmul(coeffs, data)


def get_codec(data_shards: int, parity_shards: int,
              backend: str = "cuda",
              matrix_kind: str = "vandermonde",
              device: str = "cuda") -> ReedSolomonCodec:
    if backend == "numpy":
        return NumpyCodec(data_shards, parity_shards, matrix_kind)
    if backend == "cuda":
        from .rs_torch import TorchCodec
        return TorchCodec(data_shards, parity_shards, matrix_kind,
                          device=device)
    raise ValueError(f"unknown backend {backend!r}")
