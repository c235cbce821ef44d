"""GF(2^8) matrix product: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces seaweedfs_tpu/ops/rs_pallas.py::_fused_fn, the Pallas TPU kernel
under EC encode and rebuild. Both compute

    out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8), poly 0x11D

for every geometry the system sends: parity rows on encode, fused
decode-plan rows on rebuild, the piggyback layout's (128, 320) block
matrices, any n >= 1 with no host padding.

Kernel: csrc/gf_matmul.cu, CUDA C++ for sm_90a, built with nvcc into
``seaweedfs_tpu_torch/build/`` at first use and loaded with ctypes. It
runs from a tile plan built once per matrix on the host
(ops/gf_plan.make_plan): output rows sorted by support and tiled by 4,
each tile's list of input rows with a non-zero coefficient, and per
(tile, input row) 32 packed words, so one shared-memory lookup per nibble
gives a payload byte's products with all 4 rows of the tile and zero
coefficients cost nothing.

Bound: memory -- (k + r) * n bytes at 3.35 TB/s (H100 SXM), 35 us for the
RS(10,4) encode of an 8 MiB slab and for the piggyback (128, 320) matrix
at 262,144 columns. The kernel's own work, two shared-memory lookups and
about 4 integer ops per column and pair, scales with the plan's pairs (10
per column at (4,10), 480 for the piggyback encode matrix) and weighs as
much as the memory at (128, 320); the header of csrc/gf_matmul.cu counts
it.

``gf_matmul`` takes a plan (what ``TorchCodec.device_fn`` caches; checks
and tests build theirs with ``make_plan``). It runs the plain version for
a tensor on the CPU and launches the kernel for a tensor on the card; it
never falls back from one to the other. Each call is one dispatch of
``ops/device_stats.K1``; a kernel launch that returns without error is
also one of its launches (a call on the CPU is none). Each nvcc build is
one compile.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
import torch

from .device_stats import K1, dispatch, timed_build
from .gf256 import MUL_TABLE
from .gf_plan import GfPlan

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gf_matmul.cu"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libgf_matmul.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernel is built on a "
                       "machine with the CUDA toolkit")


def build_library(source: Path, library: Path,
                  ptxas_verbose: bool = False, defines=()) -> str:
    """Compile one CUDA source into a shared library under build/ (with
    ``-D`` for each of ``defines``); returns the compiler's diagnostics
    (ptxas register/shared-memory report when ``ptxas_verbose``). Raises
    RuntimeError if nvcc fails. Counted as a compile of
    ``nvcc:<library>`` in ``ops/device_stats``."""
    return timed_build(f"nvcc:{library.name}", tuple(defines),
                       lambda: _nvcc_build(source, library, ptxas_verbose,
                                           defines), owner=str(library))


def _nvcc_build(source: Path, library: Path, ptxas_verbose: bool,
                defines) -> str:
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           *(f"-D{d}" for d in defines), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr


def load_library(source: Path, library: Path) -> ctypes.CDLL:
    """ctypes handle on a kernel library, compiled first if missing or
    older than its source."""
    if not library.exists() or \
            library.stat().st_mtime < source.stat().st_mtime:
        build_library(source, library)
    return ctypes.CDLL(str(library))


def compile_kernel(ptxas_verbose: bool = False) -> str:
    """Compile csrc/gf_matmul.cu into build/libgf_matmul.so."""
    return build_library(SOURCE, LIBRARY, ptxas_verbose)


def _library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if missing or stale."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_library(SOURCE, LIBRARY)
            lib.gf_matmul_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p]
            lib.gf_matmul_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(coeffs: torch.Tensor, data: torch.Tensor):
    for name, t in (("coeffs", coeffs), ("data", data)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D uint8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if coeffs.shape[1] != data.shape[0]:
        raise ValueError(f"coeffs {tuple(coeffs.shape)} do not match data "
                         f"{tuple(data.shape)}")
    if coeffs.device != data.device:
        raise ValueError(f"coeffs on {coeffs.device}, data on {data.device}")


def gf_matmul_plain(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: out[i] = XOR_j MUL[c_ij][data[j]],
    gathered from the full 256x256 product table (a formulation
    independent of the kernel's nibble tables)."""
    _check(coeffs, data)
    r, k = coeffs.shape
    mul = torch.from_numpy(MUL_TABLE).to(data.device)
    # indexing with a uint8 tensor would be a boolean mask: cast to int64
    c = coeffs.to(torch.int64)
    out = torch.zeros((r, data.shape[1]), dtype=torch.uint8,
                      device=data.device)
    for j in range(k):
        out ^= mul[c[:, j]][:, data[j].to(torch.int64)]
    return out


def gf_matmul(plan: GfPlan, data: torch.Tensor) -> torch.Tensor:
    """plan (of coeffs (r, k)) x data (k, n) uint8 -> (r, n) uint8 over
    GF(2^8), both on one device: the plain version on the CPU, the Hopper
    kernel on the card."""
    if not isinstance(plan, GfPlan):
        raise TypeError(f"gf_matmul takes a GfPlan (gf_plan.make_plan), "
                        f"got {type(plan).__name__}")
    coeffs = plan.coeffs
    _check(coeffs, data)
    if data.device.type == "cpu":
        return dispatch(K1, data.device,
                        lambda: gf_matmul_plain(coeffs, data))
    if data.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cpu or cuda, not {data.device}")
    r, k = coeffs.shape
    n = data.shape[1]
    if r == 0 or n == 0 or k == 0:
        return torch.zeros((r, n), dtype=torch.uint8, device=data.device)
    # the plan's tensors were checked when it was made; _check matched
    # its device to the data's
    data = data.contiguous()
    lib = _library()
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)

    def launch():
        rc = lib.gf_matmul_launch(
            plan.tile_ptr.data_ptr(), plan.pair_rows.data_ptr(),
            plan.tables.data_ptr(), plan.row_map.data_ptr(), plan.tiles, r,
            data.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gf_matmul kernel launch failed: CUDA error "
                               f"{rc} at r={r} k={k} n={n}")
        return out

    with torch.cuda.device(data.device):
        return dispatch(K1, data.device, launch)
