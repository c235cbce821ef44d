"""GF(2^8) matrix product in bit-plane form: the hand-written Hopper
tensor-core kernel and its plain PyTorch version.

Replaces the Pallas TPU kernels of tools/kernel_exp.py, the experiment that
asks which mapping of the GF(2) product onto the matrix unit is fastest:

* K6a, ``make_fn`` (pallas_call at tools/kernel_exp.py:44): the lift
  (8r, 8k) times the payload's 8k bit-planes, with the dot's operand type
  int8, bf16 or f32 -> here ``bitplane_matmul(..., dtype=)`` with "int8"
  (s8 -> s32), "bf16" (bf16 -> f32) or "tf32" (tf32 -> f32);
* K6b, ``make_fn_batched`` (pallas_call at tools/kernel_exp.py:97): u column
  tiles stacked along the contraction against a block-diagonal
  (u*8r, u*8k) lift (``block_diag_bitmat``) -> ``bitplane_matmul_batched``.

Both compute out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8) when the
lift is ``fuse_bitmat(coeffs)`` (block-diagonal for K6b), byte-identical in
every operand type: the operands are 0/1 and the sums are at most
u*8k <= 20480, exact in s32 and f32.

Kernel: csrc/gf_bitplane.cu, CUDA C++ for sm_90a (wmma fragments), built
with nvcc into ``seaweedfs_tpu_torch/build/`` at first use and loaded with
ctypes. The wrapper takes the JAX package's plane-major lift; the device
constant is that lift permuted once to byte-major rows and columns
(``bitmat_from_reference``), zero-padded and cast to the operand type, and
kept in a small cache by the lift tensor it came from.

Bounds (H100 SXM): the larger of (k + r) * n bytes at 3.35 TB/s and
u * 2 * 8r * 8k * n operations at 1,979 T int8, 989 T bf16 or 495 T tf32.
RS(10,4) at 8 MiB: 0.0351 ms, bytes. The piggyback (128, 320) encode
matrix at 262,144 columns: 0.694 ms int8, 1.390 ms bf16, 2.777 ms tf32,
operations (times u for K6b).

A tensor on the CPU runs the plain version; a tensor on the card launches
the kernel or raises. ``bitplane_matmul.launches`` and
``bitplane_matmul_batched.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import gf256
from .codec import _ConstCache
from .rs_hopper import (BUILD_DIR, NVCC_FLAGS,  # noqa: F401
                        build_library, load_library)

_PKG = BUILD_DIR.parent
SOURCE = _PKG / "csrc" / "gf_bitplane.cu"
LIBRARY = BUILD_DIR / "libgf_bitplane.so"

#: operand type -> (code the kernel takes, torch type of the constant)
DTYPES = {"int8": (0, torch.int8), "bf16": (1, torch.bfloat16),
          "tf32": (2, torch.float32)}
#: stacked column tiles K6b takes
BATCH_UNITS = (2, 4)
#: columns per stacked tile in the kernel (its block width), which the
#: plain version's grouping matches
TILE = 128
_BM, _KPAD = 64, 16  # the kernel's row tile and contraction padding

_lib = None
_lib_lock = threading.Lock()


def variant_name(u: int, dtype: str) -> str:
    """K6a int8 -> "gf_bitplane_int8"; K6b u=2 bf16 -> "gf_bitplane_u2_bf16"."""
    return f"gf_bitplane_{dtype}" if u == 1 else f"gf_bitplane_u{u}_{dtype}"


def compile_kernel(ptxas_verbose: bool = False) -> str:
    """Compile csrc/gf_bitplane.cu into build/libgf_bitplane.so."""
    return build_library(SOURCE, LIBRARY, ptxas_verbose)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_library(SOURCE, LIBRARY)
            lib.gf_bitplane_launch.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.gf_bitplane_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


# -- the lift ----------------------------------------------------------------

def fuse_bitmat(coeffs: np.ndarray) -> np.ndarray:
    """(r, k) GF(2^8) byte matrix -> (8r, 8k) int8 plane-major GF(2) lift:
    row b*r+i is bit b of output byte i, column l*k+j is bit l of input
    byte j (the JAX package's rs_pallas.fuse_bitmat, byte for byte)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
    r, k = coeffs.shape
    b0 = gf256.bit_matrix(coeffs)  # (k*8, r*8): in row j*8+l, out col i*8+b
    return np.ascontiguousarray(
        b0.reshape(k, 8, r, 8).transpose(3, 2, 1, 0).reshape(8 * r, 8 * k)
    ).astype(np.int8)


def block_diag_bitmat(bm: np.ndarray, u: int) -> np.ndarray:
    """u copies of a lift on the diagonal of a (u*rows, u*cols) matrix."""
    rows, cols = bm.shape
    big = np.zeros((u * rows, u * cols), dtype=bm.dtype)
    for j in range(u):
        big[j * rows:(j + 1) * rows, j * cols:(j + 1) * cols] = bm
    return big


def bitmat_from_reference(fused: np.ndarray, u: int = 1) -> np.ndarray:
    """The JAX package's plane-major lift (u*8r, u*8k), as numpy -> the
    int8 constant the kernel uploads: within each of the u x u blocks,
    rows reordered byte-major (i*8+b) and columns byte-major (j*8+l), so
    a 64-row tile holds whole output bytes and one payload byte's 8 bits
    are adjacent contraction rows. Before padding and the type cast."""
    fused = np.asarray(fused)
    rows, cols = fused.shape
    if rows % (8 * u) or cols % (8 * u):
        raise ValueError(f"lift {fused.shape} is not (u*8r, u*8k) for u={u}")
    r, k = rows // (8 * u), cols // (8 * u)
    x = fused.reshape(u, 8, r, u, 8, k).transpose(0, 2, 1, 3, 5, 4)
    return np.ascontiguousarray(x.reshape(rows, cols)).astype(np.int8)


def _device_const(lift: torch.Tensor, u: int, dtype: str) -> torch.Tensor:
    """The kernel's constant for a lift: byte-major, padded to the row
    tile and the contraction depth, in the operand type, on the lift's
    device."""
    bm = bitmat_from_reference(lift.detach().cpu().numpy(), u)
    rows, cols = bm.shape
    padded = np.zeros((-(-rows // _BM) * _BM, -(-cols // _KPAD) * _KPAD),
                      dtype=np.int8)
    padded[:rows, :cols] = bm
    return torch.from_numpy(padded).to(lift.device).to(DTYPES[dtype][1])


#: device constants by lift tensor, keyed on its id and version counter
#: (an in-place change rebuilds): keying on a device lift's bytes would
#: copy it to the host on every launch (2.6 MB at (128,320), 42 MB for
#: its u=4 lift). Each entry holds its lift, so the id is not reused
#: while the entry lives.
_CONSTS = _ConstCache(maxsize=16)


# -- plain version and kernel ------------------------------------------------

def _check(lift: torch.Tensor, data: torch.Tensor, r: int, u: int,
           dtype: str):
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be a 2-D uint8 tensor, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if lift.dtype != torch.int8 or lift.dim() != 2:
        raise ValueError(f"the lift must be a 2-D int8 tensor, got "
                         f"{lift.dtype} {tuple(lift.shape)}")
    k = data.shape[0]
    if r < 1 or tuple(lift.shape) != (u * 8 * r, u * 8 * k):
        raise ValueError(f"lift {tuple(lift.shape)} does not match r={r}, "
                         f"k={k}, u={u}")
    if lift.device != data.device:
        raise ValueError(f"lift on {lift.device}, data on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bit-plane products run on cpu or cuda, not "
                         f"{data.device}")


def bitplane_plain(lift: torch.Tensor, data: torch.Tensor, r: int,
                   u: int = 1) -> torch.Tensor:
    """The plain PyTorch version, in the JAX layout: columns grouped into
    u stacked tiles of TILE; each payload byte shifted and masked into
    plane-major 0/1 rows (l*k + j, tile j at rows j*8k); a float32 product
    with the lift in full precision (exact: 0/1 operands, sums <= 20480);
    & 1; the plane-major rows (b*r + i) packed into bytes."""
    k, n = data.shape
    groups = -(-n // (u * TILE))
    x = torch.zeros((k, groups * u * TILE), dtype=torch.uint8,
                    device=data.device)
    x[:, :n] = data
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=data.device).view(8, 1, 1, 1, 1)
    bits = (x.view(1, k, groups, u, TILE) >> shifts) & 1   # l, j, g, tile, c
    planes = bits.permute(2, 3, 0, 1, 4).reshape(groups, u * 8 * k, TILE)
    y = torch.matmul(lift.to(torch.float32), planes.to(torch.float32))
    ybits = (y.to(torch.int32) & 1).view(groups, u, 8, r, TILE)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=data.device)
               ).view(1, 1, 8, 1, 1)
    packed = (ybits * weights).sum(dim=2, dtype=torch.int32)  # g, tile, i, c
    return packed.permute(2, 0, 1, 3).reshape(r, groups * u * TILE)[:, :n] \
        .to(torch.uint8).contiguous()


def _launch(lift: torch.Tensor, data: torch.Tensor, r: int, u: int,
            dtype: str) -> torch.Tensor:
    data = data.contiguous()
    k, n = data.shape
    if n == 0:
        return torch.zeros((r, 0), dtype=torch.uint8, device=data.device)
    const = _CONSTS.get((id(lift), lift._version, u, dtype),
                        lambda: (lift, _device_const(lift, u, dtype)))[1]
    lib = _library()
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    with torch.cuda.device(data.device):
        rc = lib.gf_bitplane_launch(
            DTYPES[dtype][0], u, const.data_ptr(), data.data_ptr(),
            out.data_ptr(), r, k, n, const.shape[0], const.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gf_bitplane kernel launch failed: CUDA error "
                           f"{rc} at u={u} {dtype} r={r} k={k} n={n}")
    return out


def bitplane_matmul(bitmat: torch.Tensor, data: torch.Tensor, r: int,
                    dtype: str = "int8") -> torch.Tensor:
    """K6a: plane-major lift (8r, 8k) int8 x data (k, n) uint8 -> (r, n)
    uint8, both on one device: the plain version on the CPU, the Hopper
    kernel with ``dtype`` operands on the card."""
    _check(bitmat, data, r, 1, dtype)
    if data.device.type == "cpu":
        return bitplane_plain(bitmat, data, r)
    out = _launch(bitmat, data, r, 1, dtype)
    bitplane_matmul.launches += 1
    return out


def bitplane_matmul_batched(bigmat: torch.Tensor, data: torch.Tensor, r: int,
                            u: int, dtype: str = "int8") -> torch.Tensor:
    """K6b: block-diagonal lift (u*8r, u*8k) int8 x data (k, n) uint8 ->
    (r, n) uint8, u column tiles stacked along the contraction; the plain
    version on the CPU, the Hopper kernel on the card."""
    if u not in BATCH_UNITS:
        raise ValueError(f"u must be one of {BATCH_UNITS}, got {u}")
    _check(bigmat, data, r, u, dtype)
    if data.device.type == "cpu":
        return bitplane_plain(bigmat, data, r, u)
    out = _launch(bigmat, data, r, u, dtype)
    bitplane_matmul_batched.launches += 1
    return out


bitplane_matmul.launches = 0
bitplane_matmul_batched.launches = 0
