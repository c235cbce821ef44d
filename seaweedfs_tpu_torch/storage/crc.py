"""CRC32-C (Castagnoli) needle checksums.

Needle payloads are checksummed with Castagnoli CRC32, stored "masked"
((crc >> 15 | crc << 17) + 0xa282ead8, reference
weed/storage/needle/crc.go:25).

``crc32c`` runs csrc/crc32c.cc, compiled with the host C++ compiler into
``seaweedfs_tpu_torch/build/libcrc32c.so`` at first use and called
through ctypes (the call releases the GIL): the SSE4.2 ``crc32``
instruction where the CPU has it, else slicing-by-8. A library that does
not build raises RuntimeError; nothing falls back to ``crc32c_plain``,
the byte-at-a-time table loop kept as the plain version for the tests
and the smoke's check.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..util.host_build import compile_host, stale
from ..util.locks import make_lock

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "crc32c.cc"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libcrc32c.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_POLY = 0x82F63B78


def _build_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _build_table()
_lib = None
_lib_lock = make_lock("torch.crc._lib_lock")


def crc32c_plain(data: bytes, crc: int = 0) -> int:
    """The plain version: one table lookup per byte, in Python."""
    c = crc ^ 0xFFFFFFFF
    t = _TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def compile_library() -> str:
    """Compile csrc/crc32c.cc into build/libcrc32c.so; returns the
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
            lib = ctypes.CDLL(str(LIBRARY))
            for fn in (lib.crc32c, lib.crc32c_sw):
                # c_char_p hands Python bytes over without a copy
                fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_longlong]
                fn.restype = ctypes.c_uint32
            lib.crc32c_hw_path.restype = ctypes.c_int
            _lib = lib
    return _lib


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32-C of ``data`` continuing from ``crc`` (0 to start)."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return _library().crc32c(crc, data, len(data))


def crc32c_sliced(data: bytes, crc: int = 0) -> int:
    """The library's slicing-by-8 path, whatever the CPU offers."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return _library().crc32c_sw(crc, data, len(data))


def hardware_path() -> bool:
    """True when ``crc32c`` runs the SSE4.2 instruction."""
    return bool(_library().crc32c_hw_path())


def masked_value(crc: int) -> int:
    """The value stored on disk (reference crc.go:25)."""
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def needle_checksum(data: bytes) -> int:
    return masked_value(crc32c(data))
