"""Host C++ builds of the port's native code (csrc/*.cc) into
``seaweedfs_tpu_torch/build/``: the CRC32-C library, the native plane
and its load generator, and the native EC codec, each built at first use
by the module that loads it."""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path


def compile_host(source: Path, target: Path, flags) -> str:
    """The host compiler (g++, else c++) with ``flags`` on ``source``
    into ``target``, under a temporary name renamed into place, so
    concurrent builders (xdist workers) race safely. Returns the
    compiler's diagnostics; raises RuntimeError naming its output when
    the build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) on PATH: "
                           f"{source.name} cannot be built")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{source.name} build failed ({proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return proc.stdout + proc.stderr


def stale(target: Path, source: Path) -> bool:
    """True when ``target`` is missing or older than ``source``."""
    return not target.exists() or \
        target.stat().st_mtime < source.stat().st_mtime
