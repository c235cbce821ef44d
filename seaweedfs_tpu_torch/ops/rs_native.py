"""The native CPU codec: ``get_codec(k, m, "native")``.

The JAX package's ``ops/rs_native.py``: ``csrc/seaweed_ec.cc`` (the
nibble-split AVX2 ``_mm256_shuffle_epi8`` product, a scalar loop where
the build host lacks AVX2) compiled with the host C++ compiler into
``seaweedfs_tpu_torch/build/libseaweed_ec.so`` at first use, with the
flags of the JAX package's ``ops/native/build.sh``, and called through
ctypes (the call releases the GIL). It is the host's denominator of the
card's codec, the stand-in for the reference's klauspost/reedsolomon.

A library that does not build or load raises RuntimeError naming the
compiler's output; nothing falls back to numpy here (``get_codec``'s
``auto`` alone chooses numpy when the native codec cannot be had).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..util.host_build import compile_host, stale
from ..util.locks import make_lock
from .codec import ReedSolomonCodec

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "seaweed_ec.cc"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libseaweed_ec.so"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = make_lock("torch.rs_native._lib_lock")


def compile_library() -> str:
    """Compile csrc/seaweed_ec.cc into build/libseaweed_ec.so; returns the
    compiler's diagnostics. Raises RuntimeError if the build fails."""
    return compile_host(SOURCE, LIBRARY, CXX_FLAGS)


def _library() -> ctypes.CDLL:
    """The loaded library, compiled first if missing or older than its
    source."""
    global _lib
    with _lib_lock:
        if _lib is None:
            if stale(LIBRARY, SOURCE):
                compile_library()
            try:
                lib = ctypes.CDLL(str(LIBRARY))
            except OSError as e:
                raise RuntimeError(f"native EC library {LIBRARY} does not "
                                   f"load: {e}") from e
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.sw_ec_matmul.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         u8p, ctypes.c_longlong, u8p]
            lib.sw_ec_matmul.restype = None
            lib.sw_ec_matmul_mt.argtypes = \
                lib.sw_ec_matmul.argtypes + [ctypes.c_int]
            lib.sw_ec_matmul_mt.restype = None
            _lib = lib
    return _lib


def native_available() -> bool:
    """True when the library builds (or is built) and loads here."""
    try:
        _library()
    except RuntimeError:
        return False
    return True


class NativeCodec(ReedSolomonCodec):
    """The host codec. ``threads``: 0 = the hardware's concurrency (the
    reference dependency's default of a goroutine per core), 1 = one
    thread, n = exactly n. Host-only: ``small_dispatch_bytes`` stays 0
    and no device dispatch is counted."""

    backend = "native"

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde", threads: int = 0):
        super().__init__(data_shards, parity_shards, matrix_kind)
        self._lib = _library()
        self.threads = threads

    def _matmul(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        r, k = coeffs.shape
        if data.ndim != 2 or data.shape[0] != k:
            raise ValueError(f"data {data.shape} does not match the "
                             f"({r},{k}) coefficients")
        n = data.shape[1]
        out = np.zeros((r, n), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        args = (coeffs.ctypes.data_as(u8p), r, k, data.ctypes.data_as(u8p),
                n, out.ctypes.data_as(u8p))
        if self.threads == 1:
            self._lib.sw_ec_matmul(*args)
        else:
            self._lib.sw_ec_matmul_mt(*args, self.threads)
        return out
