"""Multi-device erasure coding: the GF(2^8) products split over a mesh.

The counterpart of seaweedfs_tpu/parallel/sharded_ec.py. Two splits
compose, as there:

  * encode — byte columns are independent, so the payload's columns
    split over 'data' (no communication), and the parity rows over
    'shard' when it divides them (else every 'shard' position computes
    all rows of its columns, the JAX package's replicated output).

  * rebuild — the contraction splits over 'shard'. The JAX program pads
    the k*8 *bit* rows of the survivors to a multiple of the axis, takes
    an int32 partial dot at each position, psums the partials and keeps
    the low bit. Here the survivors' *byte* rows split over the 'shard'
    positions (zero rows pad them to a multiple), each position runs K1
    on its (out, k_s) block of the decode coefficients, and the partial
    products are XOR-folded: GF(2^8) is linear, so the bytes are the
    same. In one process the fold is ``torch.bitwise_xor`` on the
    output's device; a 'shard' group that spans processes all-gathers
    its partials first (parallel/multihost), which gloo and NCCL both
    run, where ReduceOp.BXOR is gloo's alone.

Every position runs K1 (ops/rs_hopper.gf_matmul): the kernel on a card,
its plain version on a CPU position. The JAX programs are XLA, not
Pallas; their product is K1's product, so no other kernel is involved.
All arithmetic is exact; results are byte-identical to the single-device
codec and to the numpy oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import device_stats, gf256
from ..ops.codec import _ConstCache
from ..ops.gf_plan import make_plan
from ..ops.rs_hopper import gf_matmul

#: An axis spec: (rows axis, columns axis), each a mesh axis name or None
#: (the JAX package's PartitionSpec of a 2-D array).
Spec = Tuple[Optional[str], Optional[str]]


def _pad_rows(mat: np.ndarray, mult: int) -> np.ndarray:
    rows = mat.shape[0]
    pad = (-rows) % mult
    if pad == 0:
        return mat
    return np.concatenate(
        [mat, np.zeros((pad, mat.shape[1]), dtype=mat.dtype)], axis=0)


def encode_in_specs(mesh, m: int) -> Tuple[Spec, Spec]:
    """The JAX package's specs of sharded_encode_fn's inputs (bitmat,
    data): the lift's output-bit columns over 'shard' when it divides
    them, the payload's columns over 'data'."""
    bm_cols = "shard" if (m * 8) % mesh.shape["shard"] == 0 else None
    return (None, bm_cols), (None, "data")


def rebuild_in_specs(mesh) -> Tuple[Spec, Spec]:
    """The JAX package's specs of sharded_rebuild_fn's (bitmat_dec,
    survivors)."""
    return ("shard", None), (None, "data")


#: The port's sharded_rebuild_fn splits the (padded) survivors' byte rows
#: over 'shard' and their columns over 'data'.
survivor_spec: Spec = ("shard", "data")


@dataclass
class Shard:
    """One position's block of a ShardedArray."""

    index: Tuple[int, int]   # the position in the mesh
    rows: slice
    cols: slice
    data: torch.Tensor       # on the position's device


class ShardedArray:
    """A (rows, cols) uint8 array held in blocks at mesh positions:
    ``shards`` are the blocks of the positions this process holds (the
    JAX array's addressable shards). ``numpy()`` assembles it when this
    process holds all of it."""

    def __init__(self, shape: Tuple[int, int], shards: List[Shard]):
        self.shape = tuple(shape)
        self.shards = shards

    def numpy(self) -> np.ndarray:
        out = np.empty(self.shape, dtype=np.uint8)
        blocks = {}
        for s in self.shards:
            key = (s.rows.start, s.rows.stop, s.cols.start, s.cols.stop)
            if key not in blocks:
                blocks[key] = s
                out[s.rows, s.cols] = s.data.cpu().numpy()
        covered = sum((r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in blocks)
        if covered != self.shape[0] * self.shape[1]:
            raise ValueError("this process does not hold the whole array")
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def _block(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"{n} does not split evenly over {parts} positions")
    step = n // parts
    return slice(i * step, (i + 1) * step)


def _axis_slice(mesh, axis: Optional[str], n: int,
                index: Tuple[int, int]) -> slice:
    if axis is None:
        return slice(0, n)
    return _block(n, mesh.shape[axis], index[mesh.axis_names.index(axis)])


def _local_positions(mesh):
    return [idx for idx in np.ndindex(mesh.devices.shape)
            if mesh.is_local(idx)]


def place(mesh, spec: Spec, value: np.ndarray) -> ShardedArray:
    """The blocks of host ``value`` that ``spec`` gives this process's
    positions, each copied to its position's device: every process holds
    the same host value and takes its own slices of it."""
    value = np.asarray(value, dtype=np.uint8)
    rows_n, cols_n = value.shape
    shards = []
    for idx in _local_positions(mesh):
        rs = _axis_slice(mesh, spec[0], rows_n, idx)
        cs = _axis_slice(mesh, spec[1], cols_n, idx)
        host = torch.from_numpy(np.ascontiguousarray(value[rs, cs]))
        shards.append(Shard(idx, rs, cs, host.to(mesh.device(idx))))
    return ShardedArray(value.shape, shards)


class _Plans:
    """K1's plans of the coefficient blocks a program multiplies by, one
    per (block, device), built the first time they are needed and kept
    in an ops/codec._ConstCache: one bitmat_upload each, its hits and
    occupancy in ops/device_stats, and the cache's owner on each build,
    so a plan built twice for one key is seen as a recompile."""

    def __init__(self):
        self._consts = _ConstCache()

    def get(self, coeffs: np.ndarray, device: torch.device):
        key = (coeffs.shape, coeffs.tobytes(), str(device))
        return self._consts.get(key, lambda: make_plan(
            coeffs, (self._consts.owner, str(device))).to(device))


def _devices(x: ShardedArray):
    return [s.data.device for s in x.shards]


def sharded_encode_fn(mesh, k: int, m: int, n: int):
    """Returns (fn, coeffs) for the distributed encode: fn(coeffs (m, k)
    uint8, data (k, n) uint8, host or placed) -> parity ShardedArray
    (m, n), columns over 'data', rows over 'shard' when it divides m.
    ``coeffs`` is RS(k, m)'s parity rows."""
    if n % mesh.shape["data"]:
        raise ValueError(f"width {n} does not split over "
                         f"{mesh.shape['data']} data positions")
    out_rows = "shard" if m % mesh.shape["shard"] == 0 else None
    plans = _Plans()

    def fn(coeffs, data) -> ShardedArray:
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        x = data if isinstance(data, ShardedArray) else \
            place(mesh, (None, "data"), data)

        def run():
            shards = []
            for s in x.shards:
                rs = _axis_slice(mesh, out_rows, m, s.index)
                plan = plans.get(np.ascontiguousarray(coeffs[rs]),
                                 s.data.device)
                shards.append(Shard(s.index, rs, s.cols,
                                    gf_matmul(plan, s.data)))
            return ShardedArray((m, n), shards)

        return device_stats.program(device_stats.SHARDED_ENCODE,
                                    _devices(x), run)

    return fn, gf256.build_matrix(k, k + m)[k:]


def sharded_rebuild_fn(mesh, k: int, n_out_shards: int, n: int):
    """Returns fn for the distributed reconstruct: fn(coeffs (out, k)
    uint8, survivors (k, n) uint8, host or placed with
    ``survivor_spec``) -> ShardedArray (out, n), columns over 'data',
    every 'shard' position holding its columns whole.

    The survivors' rows are zero-padded to a multiple of the 'shard'
    axis (zero rows add nothing to the XOR); each position multiplies
    its row block by the matching columns of ``coeffs`` on K1, and the
    partials of one column block are XOR-folded."""
    shard_ax = mesh.shape["shard"]
    data_ax = mesh.shape["data"]
    if n % data_ax:
        raise ValueError(f"width {n} does not split over {data_ax} data "
                         f"positions")
    kp = k + (-k) % shard_ax
    ks = kp // shard_ax
    # the column blocks whose 'shard' positions lie in more than one
    # process fold through a collective (the same list on every rank)
    spanning = [i for i in range(data_ax)
                if len(set(mesh.ranks[i, :].tolist())) > 1]
    plans = _Plans()
    width = n // data_ax

    def fn(coeffs, survivors) -> ShardedArray:
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        padded = np.zeros((n_out_shards, kp), dtype=np.uint8)
        padded[:, :k] = coeffs
        x = survivors if isinstance(survivors, ShardedArray) else \
            place(mesh, survivor_spec, _pad_rows(
                np.asarray(survivors, dtype=np.uint8), shard_ax))

        def run():
            partials: Dict[int, List[torch.Tensor]] = {}
            for s in x.shards:
                j = s.index[1]
                plan = plans.get(
                    np.ascontiguousarray(padded[:, j * ks:(j + 1) * ks]),
                    s.data.device)
                partials.setdefault(s.index[0], []).append(
                    gf_matmul(plan, s.data))
            folded = {i: _xor_fold(parts) for i, parts in partials.items()}
            if spanning:
                from .multihost import xor_all_gather
                folded.update(xor_all_gather(folded, spanning,
                                             (n_out_shards, width)))
            rows = slice(0, n_out_shards)
            return ShardedArray((n_out_shards, n), [
                Shard(s.index, rows, s.cols,
                      folded[s.index[0]].to(s.data.device))
                for s in x.shards])

        return device_stats.program(device_stats.SHARDED_REBUILD,
                                    _devices(x), run)

    return fn


def _xor_fold(parts: List[torch.Tensor]) -> torch.Tensor:
    """XOR of equal-shaped partial products, on the first one's device."""
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.bitwise_xor(acc, p.to(acc.device))
    return acc


def decode_coeffs(k: int, m: int, survivor_rows,
                  missing_rows) -> np.ndarray:
    """(len(missing), k) decode coefficients restoring missing_rows from
    the first k survivor_rows: the port's fused decode plan
    (gf256.decode_coeff_rows), the rows K1 multiplies by."""
    matrix = gf256.build_matrix(k, k + m)
    return gf256.decode_coeff_rows(matrix, k, survivor_rows, missing_rows)


def decode_bitmat(k: int, m: int, survivor_rows, missing_rows,
                  pad_to_mult: int = 1) -> np.ndarray:
    """The GF(2) lift of decode_coeffs, zero-padded on the contraction
    axis to pad_to_mult: the JAX program's constant, byte for byte. K1
    multiplies by the coefficient rows themselves."""
    bm = gf256.bit_matrix(decode_coeffs(k, m, survivor_rows,
                                        missing_rows)).astype(np.int8)
    return _pad_rows(bm, pad_to_mult)


def distributed_ec_step(mesh, k: int = 10, m: int = 4,
                        n_per_device: int = 2048):
    """One distributed EC step: encode a seeded payload split over the
    mesh, drop the last m data shards, rebuild them with the XOR-folded
    split contraction, and return (parity, rebuilt, max_abs_diff) as
    host arrays."""
    n = n_per_device * mesh.shape["data"]
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)

    enc_fn, coeffs = sharded_encode_fn(mesh, k, m, n)
    parity = np.asarray(enc_fn(coeffs, data))

    # the first k survivors: k-m data shards and the m parity shards
    survivors = list(range(k - m)) + list(range(k, k + m))
    missing = list(range(k - m, k))
    reb_fn = sharded_rebuild_fn(mesh, k, len(missing), n)
    surv = np.concatenate([data[: k - m], parity], axis=0)
    rebuilt = np.asarray(reb_fn(decode_coeffs(k, m, survivors, missing),
                                surv))
    diff = int(np.abs(rebuilt.astype(np.int32)
                      - data[k - m: k].astype(np.int32)).max())
    return parity, rebuilt, diff
