"""Which mapping of the GF(2^8) product onto the card is fastest, and is
it exact? K1's nibble-table kernel (ops/rs_hopper.gf_matmul, run from a
tile plan built beforehand) against the tensor-core bit-plane kernels
(ops/rs_bitplane): K6a with int8, bf16 and tf32 operands, and K6b with
u = 2 and 4 column tiles stacked against a block-diagonal lift.

    python3 -m seaweedfs_tpu_torch.tools.kernel_exp

runs RS(10,4) encode rows over an 8 MiB slab (seed 7) on the card and
prints, for each kernel, its time per launch, its payload rate and r^2
from a chained fit, its bound on the card, and whether it equals the
numpy oracle; K1's plan is built before any timed window, and its build
time, pairs per column and table bytes print on a line of their own.
A bit-plane row's bound is the function's own: the bytes, or a
multiply-add for each one of the lift if that takes longer. Beside it
stand two bounds of more work: the dense bound, the whole lift the TPU
kernel multiplies (K6b's block-diagonal zeros included), and the tile
bound, the lift tiles the Hopper kernel keeps (those that hold a one,
zeros inside them included), with how many of the dense lift's tiles it
kept.

Every timed window starts behind a ``torch.cuda._sleep`` that holds the
stream for about 10 ms (``HOLD_CYCLES``), so the host has enqueued the
window's launches before the first one runs: K1 takes about as long on the
card as its Python wrapper takes to launch it, and without the hold the
window would time the host.

Chained timing (``chained_rate``): chains of 5, 15 and 25 back-to-back
launches on one stream, each feeding one output byte back into the next
input so the launches are serially dependent, timed with CUDA events and
no host synchronisation inside a chain; the slope of a line fitted to
time against chain length is the time per launch.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import gf256
from ..ops.codec import host_matmul
from ..ops.device_stats import DEVICE_STATS, K1, K6A, K6B
from ..ops.gf_plan import make_plan
from ..ops.rs_bitplane import (BATCH_UNITS, DTYPES, bitplane_matmul,
                               bitplane_matmul_batched, bitplane_plain,
                               block_diag_bitmat, device_tiles, fuse_bitmat,
                               variant_name)
from ..ops.rs_hopper import gf_matmul, gf_matmul_plain
from ..ops.rs_torch import resolve_device

K, M = 10, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
#: dense tensor-core peaks of one H100 SXM at its full 700 W limit
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12}
#: the JAX tool's dot dtypes -> the kernel's operand types
_TORCH_DTYPES = {torch.int8: "int8", torch.bfloat16: "bf16",
                 torch.float32: "tf32"}
#: card clock cycles the stream is held before a timed window
HOLD_CYCLES = 20_000_000


def _dtype(dot_dtype) -> str:
    """A torch dtype as the JAX tool passes, or an operand type name."""
    if dot_dtype in DTYPES:
        return dot_dtype
    if dot_dtype in _TORCH_DTYPES:
        return _TORCH_DTYPES[dot_dtype]
    raise ValueError(f"unsupported dot dtype {dot_dtype!r}")


def _check_shape(data: torch.Tensor, k: int, n: int):
    if tuple(data.shape) != (k, n):
        raise ValueError(f"data {tuple(data.shape)} is not ({k}, {n})")


def make_fn(k: int, r: int, n: int, tile: int, dot_dtype):
    """K6a: fn(bitmat (8r, 8k) int8, data (k, n) uint8) -> (r, n) uint8
    with the dot's operands in ``dot_dtype`` (torch.int8, torch.bfloat16
    or torch.float32, which runs as tf32). ``tile`` is the TPU kernel's
    column tile; the Hopper kernel's is fixed (rs_bitplane.TILE, its
    block's 128 columns), and columns are independent, so the result does
    not depend on it."""
    dtype = _dtype(dot_dtype)

    def fn(bitmat, data):
        _check_shape(data, k, n)
        return bitplane_matmul(bitmat, data, r, dtype)
    return fn


def make_fn_batched(k: int, r: int, n: int, tile: int, u: int, dot_dtype):
    """K6b: fn(bigmat (u*8r, u*8k) int8, data (k, n) uint8) -> (r, n)
    uint8, u column tiles stacked along the contraction against the
    block-diagonal lift (``block_diag_bitmat``)."""
    dtype = _dtype(dot_dtype)
    if u not in BATCH_UNITS:
        raise ValueError(f"u must be one of {BATCH_UNITS}, got {u}")

    def fn(bigmat, data):
        _check_shape(data, k, n)
        return bitplane_matmul_batched(bigmat, data, r, u, dtype)
    return fn


def per_launch_ms(fn, const, data, reps: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of ``reps`` back-to-back launches over ``reps``."""
    for _ in range(warmup):
        fn(const, data)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn(const, data)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def chained_rate(fn, bitmat, slabs, lengths=(5, 15, 25), reps: int = 3):
    """(payload MB/s, r^2): k*n payload bytes per launch over the slope of
    a line fitted to the best-of-``reps`` time of each chain length."""
    k, n = slabs[0].shape
    times = {}
    for length in lengths:
        best = float("inf")
        for rep in range(reps):
            x = slabs[rep % len(slabs)].clone()
            fn(bitmat, x)  # warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            for _ in range(length):
                y = fn(bitmat, x)
                # feed an output byte back: the launches are serially
                # dependent and nothing can be reused
                x[0, :1].copy_(y[0, :1])
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        times[length] = best
    xs = np.array(sorted(times), dtype=np.float64)
    ys = np.array([times[i] for i in sorted(times)])
    slope, icept = np.polyfit(xs, ys, 1)
    fit = slope * xs + icept
    ss_res = float(((ys - fit) ** 2).sum())
    ss_tot = float(((ys - ys.mean()) ** 2).sum())
    r2 = 1 - ss_res / ss_tot if ss_tot else 1.0
    return k * n / slope / 1e6, r2


def bound(r: int, k: int, n: int, u: int = 1, dtype=None,
          ops_per_column=None):
    """(least ms on one H100 SXM, what binds it): the larger of the
    (k + r) * n bytes at 3.35 TB/s and, for a bit-plane kernel,
    ops_per_column * n / u operations (n / u stacked columns) at the
    type's dense peak. Per stacked column of a TilePlan: the function's
    own, ``least_ops_per_column`` (a multiply-add per one of the lift:
    the bound reported as ``bound_ms``); the kernel's tile list,
    ``ops_per_column`` (the tile bound); by default the dense lift the TPU
    kernel multiplies, 2 * (u * 8r) * (u * 8k) (the dense bound)."""
    bytes_ms = (k + r) * n / HBM_BYTES_PER_S * 1e3
    if dtype is None:
        return bytes_ms, "bytes"
    if ops_per_column is None:
        ops_per_column = 2 * (u * 8 * r) * (u * 8 * k)
    ops_ms = ops_per_column * n / u / PEAK_OPS[dtype] * 1e3
    return (ops_ms, f"{dtype} ops") if ops_ms > bytes_ms else \
        (bytes_ms, "bytes")


def _plain_planned(plan, data):
    return gf_matmul_plain(plan.coeffs, data)


def _kernels(coeffs: np.ndarray, plan, n: int, device):
    """(name, dtype, u, fn, constant, plain fn, the ``device_stats``
    entry that counts its launches) for K1 (its constant the tile plan)
    and every variant."""
    r, k = coeffs.shape
    bm_np = fuse_bitmat(coeffs)
    out = [("gf_matmul", None, 1, gf_matmul, plan, _plain_planned, K1)]
    bm = torch.from_numpy(bm_np).to(device)
    for dtype in ("int8", "bf16", "tf32"):
        out.append((variant_name(1, dtype), dtype, 1,
                    make_fn(k, r, n, 0, dtype), bm,
                    lambda lift, x: bitplane_plain(lift, x, r), K6A))
    for u in BATCH_UNITS:
        big = torch.from_numpy(block_diag_bitmat(bm_np, u)).to(device)
        for dtype in ("int8", "bf16"):
            out.append((variant_name(u, dtype), dtype, u,
                        make_fn_batched(k, r, n, 0, u, dtype), big,
                        lambda lift, x, u=u: bitplane_plain(lift, x, r, u),
                        K6B))
    return out


def run_table(coeffs: np.ndarray, n: int, seed: int = 7, device="cuda",
              label: str = ""):
    """Times K1 and every bit-plane variant at coeffs (r, k) x n on the
    card and prints one line each; returns the rows as dicts. A row's
    ``launches`` counts its kernel's launches in this call, read from its
    ``device_stats`` entry."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_exp times kernels on the card; it has no "
                           "CPU mode")
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
    r, k = coeffs.shape
    rng = np.random.default_rng(seed)
    host = [rng.integers(0, 256, (k, n), dtype=np.uint8) for _ in range(3)]
    slabs = [torch.from_numpy(h).to(dev) for h in host]
    oracle = host_matmul(coeffs, host[0])
    t0 = time.perf_counter()
    plan = make_plan(coeffs).to(dev)
    torch.cuda.synchronize(dev)
    print(f"{label}gf_matmul plan ({r},{k}): built and uploaded in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, {plan.pairs} pairs "
          f"per column, {plan.table_bytes} table bytes, payload read "
          f"{plan.summary()['payload_reads']:.2f} times over")
    rows = []
    for name, dtype, u, fn, const, plain, entry in _kernels(coeffs, plan,
                                                              n, dev):
        start = DEVICE_STATS.launch_count(entry)
        exact = bool(np.array_equal(fn(const, slabs[0]).cpu().numpy(),
                                    oracle))
        ms = per_launch_ms(fn, const, slabs[0])
        mb_s, r2 = chained_rate(fn, const, slabs)
        launches = DEVICE_STATS.launch_count(entry) - start
        plain_ms = per_launch_ms(plain, const, slabs[0], reps=3, warmup=1)
        row = {"name": name, "dtype": dtype, "u": u,
               "shape": f"({r},{k})x{n}", "ms": ms,
               "plain_ms": plain_ms, "mb_s": mb_s, "r2": r2,
               "launches": launches, "exact": exact}
        others = ""
        if dtype is None:
            row["bound_ms"], row["bound_by"] = bound(r, k, n)
        else:
            plan = device_tiles(const, u, dtype).plan
            row["bound_ms"], row["bound_by"] = bound(
                r, k, n, u, dtype, plan.least_ops_per_column)
            row["dense_bound_ms"], row["dense_bound_by"] = bound(
                r, k, n, u, dtype)
            row["tile_bound_ms"], row["tile_bound_by"] = bound(
                r, k, n, u, dtype, plan.ops_per_column)
            row["lift_ones"] = plan.ones
            row["tiles_kept"], row["tiles_dense"] = plan.kept, plan.dense
            others = "".join(
                f"; {what} bound {row[key + '_ms']:.4f} ms "
                f"{row[key + '_by']} ({ms / row[key + '_ms']:.2f}x)"
                for what, key in (("dense", "dense_bound"),
                                  ("tile", "tile_bound"))) + \
                f"; {plan.kept} of {plan.dense} tiles kept"
        rows.append(row)
        print(f"{label}{name} ({r},{k})x{n}: {ms:.4f} ms/launch "
              f"({ms / row['bound_ms']:.2f}x the bound "
              f"{row['bound_ms']:.4f} ms, {row['bound_by']}{others}), plain "
              f"{plain_ms:.4f} ms, chained {mb_s:,.0f} MB/s (r2 {r2:.4f}), "
              f"{launches} launches, exact={exact}")
    return rows


def main() -> int:
    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}")
    matrix = gf256.build_matrix(K, K + M, "vandermonde")
    rows = run_table(matrix[K:], 8 << 20, 7, dev)
    return 0 if all(row["exact"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
