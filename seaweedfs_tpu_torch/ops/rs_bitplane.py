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

Kernel: csrc/gf_bitplane.cu, CUDA C++ for sm_90a (warpgroup MMA with A
from registers, lift tiles streamed by TMA through an mbarrier ring),
built with nvcc into ``seaweedfs_tpu_torch/build/`` at first use and
loaded with ctypes. The wrapper takes the JAX package's plane-major lift;
the kernel runs from a tile list built once per (lift, u, operand type)
on the host (``make_tile_plan``) and cached on the device by the lift
tensor it came from: output bytes sorted by their non-zero pattern, the
lift cut into 32 x 32 or 256 x 64 tiles (``tile_rows``, ``tile_depth``),
only the tiles that hold a one kept, each
tile's rows and columns permuted into the order the kernel's register
fragments want (``n_order``, ``k_order``).

Bounds (H100 SXM, tools/kernel_exp.bound): the function's own is the
larger of (k + r) * n bytes at 3.35 TB/s and a multiply-add per one of
the lift per column at 1,979 T int8, 989 T bf16 or 495 T tf32
(``TilePlan.least_ops_per_column``). It is the bytes, 0.0351 ms, at
RS(10,4) x 8 MiB and at the piggyback (128, 320) encode matrix x 262,144
for int8 and bf16; tf32's ones take 0.0415 and 0.0631 ms there. Two
bounds count more work: the dense bound counts the whole lift the TPU
kernel multiplies, u * 2 * 8r * 8k * n operations (0.694 ms int8 at
(128, 320), times u for K6b), and the tile bound counts the lift tiles
this kernel keeps, zeros inside them included (``ops_per_column``, 0.208
ms int8 there).

A tensor on the CPU runs the plain version; a tensor on the card launches
the kernel or raises. Each call is one dispatch of ``ops/device_stats``'s
``K6A`` or ``K6B``; a kernel launch that returns without error is also one
of its launches (a call on the CPU is none).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import gf256
from .codec import _ConstCache
from .device_stats import K6A, K6B, dispatch
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
#: columns per stacked tile in the kernel: its block step, two consumer
#: warpgroups of 64 columns (the wgmma M); the plain version's grouping
#: matches it
TILE = 128
#: the kernel's lift tile heights (the wgmma N), in output bit-rows
TILE_ROWS = (32, 256)

_lib = None
_lib_lock = threading.Lock()


def variant_name(u: int, dtype: str) -> str:
    """K6a int8 -> "gf_bitplane_int8"; K6b u=2 bf16 -> "gf_bitplane_u2_bf16"."""
    return f"gf_bitplane_{dtype}" if u == 1 else f"gf_bitplane_u{u}_{dtype}"


def compile_kernel(ptxas_verbose: bool = False) -> str:
    """Compile csrc/gf_bitplane.cu into build/libgf_bitplane.so."""
    return build_library(SOURCE, LIBRARY, ptxas_verbose)


def bind(path) -> ctypes.CDLL:
    """A built bit-plane library, its C interface typed."""
    lib = ctypes.CDLL(str(path))
    lib.gf_bitplane_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.gf_bitplane_launch.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            load_library(SOURCE, LIBRARY)  # compiled first if stale
            _lib = bind(LIBRARY)
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


# -- the kernel's tile list --------------------------------------------------

def tile_rows(r: int) -> int:
    """The kernel's lift tile height (wgmma N) for r output rows per
    block: 32 when 8r fits (RS(10,4) needs no padding), else 256."""
    return TILE_ROWS[0] if 8 * r <= TILE_ROWS[0] else TILE_ROWS[1]


def tile_depth(nt: int) -> int:
    """Contraction rows per lift tile: 32 (4 payload bytes) under a 32-row
    tile, whose small wgmmas cost about the same whatever their depth, so
    none is spent on padding (RS(10,4)'s 10 bytes take 3 chunks, not 2 of
    8); 64 (8 bytes) under a 256-row tile."""
    return 32 if nt == TILE_ROWS[0] else 64


def n_order(nt: int) -> np.ndarray:
    """Row order inside a lift tile: position p -> slot * 8 + bit. The
    accumulator fragment gives thread tq of each quad the N columns
    8v + 2tq and 8v + 2tq + 1; with p = 32B + 8a + 2tq + v0 holding bit
    2a + v0 of slot 4B + tq, a thread's 8 values of each 32 columns are the
    8 bits of one output byte."""
    p = np.arange(nt)
    slot = 4 * (p // 32) + (p % 8) // 2
    bit = 2 * ((p % 32) // 8) + p % 2
    return (slot * 8 + bit).astype(np.int64)


def k_order(dtype: str, kc: int = 64) -> np.ndarray:
    """Contraction order inside a kc-deep chunk (kc = 32 or 64): position
    kk -> payload byte q * 8 + bit. A wgmma step (k32 s8, k16 bf16, k8
    tf32) gives thread tq the A fragment's k slots 4tq..4tq+3 and 16+4tq..
    (s8), 2tq, 2tq+1, 8+2tq, 9+2tq (bf16) or tq, tq+4 (tf32); the order
    makes them bits of payload byte 4h + tq (h: first or second 32 of the
    chunk): its low and high nibble (s8), a nibble per step (bf16), two
    bits per step (tf32)."""
    kk = np.arange(kc)
    if dtype == "int8":        # steps of 32
        s, w = kk // 32, kk % 32
        q, bit = 4 * s + (w % 16) // 4, 4 * (w // 16) + w % 4
    elif dtype == "bf16":      # steps of 16
        s, w = kk // 16, kk % 16
        q = 4 * (s // 2) + (w % 8) // 2
        bit = 4 * (s % 2) + 2 * (w // 8) + w % 2
    elif dtype == "tf32":      # steps of 8
        s, w = kk // 8, kk % 8
        q, bit = 4 * (s // 4) + w % 4, 2 * (s % 4) + w // 4
    else:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    return (q * 8 + bit).astype(np.int64)


@dataclass(frozen=True, eq=False)
class TilePlan:
    """The kernel's constant for one lift, u and operand type, in numpy.

    Lift tiles are nt output bit-rows by kc contraction rows (``kc =
    tile_depth(nt)``, kc / 8 payload bytes). Contraction chunk c covers
    payload rows kc/8 * (c % chunks_per_block) onward of stacked column
    tile c // chunks_per_block (each block's 8k padded to a multiple of
    kc). N tile t covers output-byte slots t * nt / 8 onward; each stacked
    tile j's r bytes, sorted by their non-zero pattern, fill whole N tiles
    of their own (padded), and ``row_map`` gives each slot's stacked output
    byte j * r + i (-1: padding). ``tiles[e * nt:(e + 1) * nt]`` is kept
    tile e (of chunk ``tile_chunk[e]``), rows in ``n_order``, columns in
    ``k_order``; N tile t owns kept tiles ``ntile_ptr[t]:ntile_ptr[t+1]``.
    """

    r: int
    k: int
    u: int
    nt: int
    dtype: str
    tiles: np.ndarray       # (kept * nt, kc) int8, 0/1
    tile_chunk: np.ndarray  # (kept,) int32
    ntile_ptr: np.ndarray   # (n_tiles + 1,) int32
    row_map: np.ndarray     # (n_tiles * nt // 8,) int32

    @property
    def kc(self) -> int:
        return tile_depth(self.nt)

    @property
    def chunks_per_block(self) -> int:
        return -(-8 * self.k // self.kc)

    @property
    def n_tiles(self) -> int:
        return self.ntile_ptr.shape[0] - 1

    @property
    def kept(self) -> int:
        return self.tile_chunk.shape[0]

    @property
    def dense(self) -> int:
        """Tiles of the whole padded (u*8r, u*8k) lift."""
        return self.n_tiles * self.u * self.chunks_per_block

    @property
    def ops_per_column(self) -> int:
        """Operations the kernel's wgmmas do per stacked column: 2 * nt *
        kc for each kept tile."""
        return 2 * self.nt * self.kc * self.kept

    @property
    def ones(self) -> int:
        """The lift's ones (each lies in a kept tile)."""
        return int(np.count_nonzero(self.tiles))

    @property
    def least_ops_per_column(self) -> int:
        """Operations the function needs per stacked column: one
        multiply-add for each one of the lift, none for its zeros."""
        return 2 * self.ones


def make_tile_plan(lift, u: int, dtype: str) -> TilePlan:
    """The tile list of a plane-major (u*8r, u*8k) lift (numpy or a CPU
    tensor) for operand type ``dtype``."""
    if isinstance(lift, torch.Tensor):
        lift = lift.detach().cpu().numpy()
    bm = bitmat_from_reference(lift, u)
    rows, cols = bm.shape
    r, k = rows // (8 * u), cols // (8 * u)
    nt = tile_rows(r)
    kc = tile_depth(nt)
    cpb = -(-8 * k // kc)
    chunks = u * cpb
    # [stacked byte j*r+i, bit, block j', payload byte, bit l], K padded
    x = np.zeros((u * r, 8, u, cpb * kc // 8, 8), dtype=np.int8)
    x[:, :, :, :k, :] = bm.reshape(u * r, 8, u, k, 8)
    x = x.reshape(u * r, 8, chunks, kc)
    nz = x.any(axis=(1, 3))                                  # (u*r, chunks)
    slots = nt // 8
    per_block = -(-r // slots)      # N tiles never mix stacked tiles' rows
    n_tiles = u * per_block
    row_map = np.full(n_tiles * slots, -1, dtype=np.int32)
    for j in range(u):
        # stable: bytes with equal patterns keep their order
        order = sorted(range(j * r, (j + 1) * r),
                       key=lambda b: nz[b].tobytes())
        row_map[j * per_block * slots:j * per_block * slots + r] = order
    y = np.zeros((n_tiles * slots, 8, chunks, kc), dtype=np.int8)
    y[row_map >= 0] = x[row_map[row_map >= 0]]
    y = y.reshape(n_tiles, nt, chunks, kc)        # rows slot*8 + bit
    kept = y.any(axis=(1, 3))                               # (n_tiles, chunks)
    ntile_ptr = np.zeros(n_tiles + 1, dtype=np.int32)
    ntile_ptr[1:] = np.cumsum(kept.sum(axis=1))
    tile_n, tile_chunk = np.nonzero(kept)         # N-tile-major, chunks up
    tiles = y[tile_n, :, tile_chunk, :]                    # (kept, nt, kc)
    tiles = tiles[:, n_order(nt)][:, :, k_order(dtype, kc)]
    return TilePlan(r=r, k=k, u=u, nt=nt, dtype=dtype,
                    tiles=np.ascontiguousarray(tiles.reshape(-1, kc)),
                    tile_chunk=tile_chunk.astype(np.int32),
                    ntile_ptr=ntile_ptr, row_map=row_map)


@dataclass(frozen=True, eq=False)
class DeviceTiles:
    """A TilePlan's tensors on the card, the tiles in the operand type."""

    plan: TilePlan
    tiles: torch.Tensor
    tile_chunk: torch.Tensor
    ntile_ptr: torch.Tensor
    row_map: torch.Tensor


def _device_const(lift: torch.Tensor, u: int, dtype: str) -> DeviceTiles:
    """The kernel's constant for a lift, on the lift's device. A lift with
    no non-zero tile uploads one zero tile, so the TMA map has a tensor."""
    plan = make_tile_plan(lift, u, dtype)
    tiles = plan.tiles if plan.kept else \
        np.zeros((plan.nt, plan.kc), dtype=np.int8)
    dev = lift.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return DeviceTiles(plan=plan, tiles=up(tiles).to(DTYPES[dtype][1]),
                       tile_chunk=up(plan.tile_chunk),
                       ntile_ptr=up(plan.ntile_ptr), row_map=up(plan.row_map))


def device_tiles(lift: torch.Tensor, u: int, dtype: str) -> DeviceTiles:
    """The cached constant the kernel runs from (built at first use)."""
    return _CONSTS.get((id(lift), lift._version, u, dtype),
                       lambda: (lift, _device_const(lift, u, dtype)))[1]


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
            dtype: str, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """One launch of the kernel in ``lib`` (default: the port's own
    build)."""
    data = data.contiguous()
    k, n = data.shape
    if n == 0:
        return torch.zeros((r, 0), dtype=torch.uint8, device=data.device)
    const = device_tiles(lift, u, dtype)
    plan = const.plan
    lib = lib or _library()
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    with torch.cuda.device(data.device):
        rc = lib.gf_bitplane_launch(
            DTYPES[dtype][0], plan.nt, const.tiles.data_ptr(),
            const.tiles.shape[0] // plan.nt,
            const.tile_chunk.data_ptr(), const.ntile_ptr.data_ptr(),
            const.row_map.data_ptr(), plan.n_tiles, r, k, u,
            data.data_ptr(), out.data_ptr(), n,
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
        return dispatch(K6A, data.device,
                        lambda: bitplane_plain(bitmat, data, r))
    return dispatch(K6A, data.device,
                    lambda: _launch(bitmat, data, r, 1, dtype))


def bitplane_matmul_batched(bigmat: torch.Tensor, data: torch.Tensor, r: int,
                            u: int, dtype: str = "int8") -> torch.Tensor:
    """K6b: block-diagonal lift (u*8r, u*8k) int8 x data (k, n) uint8 ->
    (r, n) uint8, u column tiles stacked along the contraction; the plain
    version on the CPU, the Hopper kernel on the card."""
    if u not in BATCH_UNITS:
        raise ValueError(f"u must be one of {BATCH_UNITS}, got {u}")
    _check(bigmat, data, r, u, dtype)
    if data.device.type == "cpu":
        return dispatch(K6B, data.device,
                        lambda: bitplane_plain(bigmat, data, r, u))
    return dispatch(K6B, data.device,
                    lambda: _launch(bigmat, data, r, u, dtype))
