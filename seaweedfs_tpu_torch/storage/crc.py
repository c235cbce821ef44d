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
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
_lib_lock = threading.Lock()


def crc32c_plain(data: bytes, crc: int = 0) -> int:
    """The plain version: one table lookup per byte, in Python."""
    c = crc ^ 0xFFFFFFFF
    t = _TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the CRC32-C "
                       "library cannot be built")


def compile_library() -> str:
    """Compile csrc/crc32c.cc into build/libcrc32c.so; returns the
    compiler's diagnostics. Raises RuntimeError if the build fails."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CRC32-C library build failed "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    """The loaded library, compiled first if missing or older than its
    source."""
    global _lib
    with _lib_lock:
        if _lib is None:
            if not LIBRARY.exists() or \
                    LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
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
