#!/usr/bin/env python3
"""Smoke run of seaweedfs_tpu_torch on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N]

1. Builds the Hopper kernel (csrc/gf_matmul.cu) from this checkout with
   nvcc and prints the build time and ptxas report.
2. Holds the kernel byte-identical to its plain PyTorch version on the
   card over encode matrices for RS(10,4), (6,3), (20,4) (vandermonde
   and cauchy), 4-loss decode plans for (10,4) and (20,4), a (1,10)
   single-row plan and a (128,640) matrix, at widths 1, 129, 4407,
   8 MiB and 8 MiB + 1 (plus a misaligned base pointer); then times the
   kernel and the plain version with CUDA events at the main-path shape
   (4,10) x 8 MiB, beside the memory bound.
3. Drives the main path through the port's entry points: writes a
   seeded 1 GiB volume (.dat with a real superblock, plus a matching
   .idx), builds the .ecx with write_sorted_file_from_idx, encodes it
   with write_ec_files on the default codec (cuda, pipelined), deletes
   data shards 0-3 and rebuilds, then deletes a seeded 4 of the 14 and
   rebuilds again; every shard must come back sha256-identical, parity
   must agree with the numpy oracle on sampled columns, and the kernel's
   launch counter and the dispatch counters must show the path ran on
   the kernel.
4. Traces one more encode and one more rebuild of the same volume with
   torch.profiler and reports the card's busy share of their wall time
   (the union of kernel, copy and memset intervals on the device) and
   the kernel's time per launch as it ran inside the pipeline.

Prints the card line (nvidia-smi name, power limit), then a JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}. Exits non-zero,
printing no result, if any phase fails or no CUDA device is present.
Working files live under seaweedfs_tpu_torch/build/smoke/ and are removed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
VOLUME_BYTES = 1 << 30      # BASELINE.json config 1 (30 GB default cut)
MAIN_N = 8 << 20            # main-path slab width (encoder DEFAULT_SLAB)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
WIDTHS = (1, 129, 4407, MAIN_N, MAIN_N + 1)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def build_kernel(rs_hopper) -> float:
    t0 = time.perf_counter()
    log = rs_hopper.compile_kernel(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    print(f"build: nvcc {' '.join(rs_hopper.NVCC_FLAGS)} -> "
          f"{os.path.relpath(rs_hopper.LIBRARY, ROOT)} in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    return secs


def geometries(np, gf256, NumpyCodec, seed):
    """(label, coeffs (r,k) uint8, widths) for the kernel-vs-plain phase."""
    out = []
    for k, m in ((10, 4), (6, 3), (20, 4)):
        for kind in ("vandermonde", "cauchy"):
            mat = gf256.build_matrix(k, k + m, kind)
            out.append((f"encode RS({k},{m}) {kind}", mat[k:], WIDTHS))
    for k, m, lost in ((10, 4, (0, 3, 11, 13)), (20, 4, (2, 9, 19, 21))):
        present = tuple(i not in lost for i in range(k + m))
        _, _, coeffs = NumpyCodec(k, m).decode_plan(present)
        out.append((f"decode RS({k},{m}) lost {lost}", coeffs, WIDTHS))
    present = tuple(i != 4 for i in range(14))
    _, row = NumpyCodec(10, 4).lost_row_coeffs(present, 4)
    out.append(("single row (1,10)", row, WIDTHS))
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (128, 640), dtype=np.uint8)
    out.append(("random (128,640)", big, (1, 129, 4407, (1 << 20) + 3)))
    return out


def check_kernel(torch, np, rs_hopper, gf256, NumpyCodec, dev, seed):
    """Kernel vs plain, byte for byte, on the card. Returns max |err|."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    worst = 0
    cases = 0
    for label, coeffs, widths in geometries(np, gf256, NumpyCodec, seed):
        c = torch.from_numpy(np.ascontiguousarray(coeffs)).to(dev)
        k = c.shape[1]
        for n in widths:
            d = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                              generator=gen)
            got = rs_hopper.gf_matmul(c, d)
            want = rs_hopper.gf_matmul_plain(c, d)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max().item())
            worst = max(worst, err)
            cases += 1
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain: {label} n={n}, "
                                     f"max |err| {err}")
    # a base pointer off 16-byte alignment takes the byte path at full width
    c = torch.from_numpy(gf256.build_matrix(10, 14)[10:]).to(dev)
    flat = torch.randint(0, 256, (10 * MAIN_N + 1,), dtype=torch.uint8,
                         device=dev, generator=gen)
    d = flat[1:].view(10, MAIN_N)
    got, want = rs_hopper.gf_matmul(c, d), rs_hopper.gf_matmul_plain(c, d)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("kernel != plain on a misaligned base pointer")
    print(f"kernel vs plain: {cases + 1} cases byte-identical (tolerance: "
          f"exact, GF(2^8) arithmetic; max |err| {worst})")
    return worst


def time_kernel(torch, rs_hopper, gf256, dev, seed):
    """CUDA-event times of kernel and plain at (4,10) x 8 MiB."""
    r, k, n = 4, 10, MAIN_N
    c = torch.from_numpy(gf256.build_matrix(k, k + r)[k:]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    d = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                      generator=gen)

    def per_call_ms(fn, reps):
        for _ in range(3):
            fn(c, d)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(c, d)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    ms = per_call_ms(rs_hopper.gf_matmul, 50)
    plain_ms = per_call_ms(rs_hopper.gf_matmul_plain, 5)
    bound_ms = (k + r) * n / HBM_BYTES_PER_S * 1e3
    print(f"gf_matmul ({r},{k}) x {n}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: "
          f"{(k + r) * n} at 3.35 TB/s), {ms / bound_ms:.2f}x the bound")
    return ms, plain_ms, bound_ms


def write_volume(np, SuperBlock, entry_to_bytes, base, nbytes, seed):
    """A seeded volume: superblock + payload in .dat, and a .idx of
    needles every 1 MiB with overwrites and tombstones. Returns the .ecx
    bytes the sorted index must hold."""
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(SuperBlock().to_bytes())
        left = nbytes - 8
        while left:
            step = min(left, 64 << 20)
            f.write(rng.bytes(step))
            left -= step
    live = {}
    with open(base + ".idx", "wb") as f:
        for i in range(nbytes >> 20):
            nid = int(rng.integers(1, 1 << 40))
            entry = (8 + (i << 20), (1 << 20) - 64)
            f.write(entry_to_bytes(nid, *entry))
            live[nid] = entry
            if i % 7 == 3:  # delete an earlier needle
                victim = next(iter(live))
                f.write(entry_to_bytes(victim, 0, 0xFFFFFFFF))
                live.pop(victim)
    return b"".join(entry_to_bytes(nid, *live[nid]) for nid in sorted(live))


def main_path(torch, np, port, dev, base, nbytes, seed):
    """Encode + two rebuilds of one volume on the port's entry points.
    Returns the numbers to report."""
    ec, ops, storage = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    total = k + m
    t0 = time.perf_counter()
    want_ecx = write_volume(np, storage.SuperBlock, storage.entry_to_bytes,
                            base, nbytes, seed)
    print(f"volume: {nbytes} bytes written in "
          f"{time.perf_counter() - t0:.2f} s")

    ec.write_sorted_file_from_idx(base)
    with open(base + ".ecx", "rb") as f:
        if f.read() != want_ecx:
            raise AssertionError(".ecx differs from the sorted live index")

    slab = ec.encoder.DEFAULT_SLAB
    enc = {}
    t0 = time.perf_counter()
    ec.write_ec_files(base, codec=ops.get_codec(k, m, device=dev),
                      stats=enc)
    enc_s = time.perf_counter() - t0
    shard_size = os.path.getsize(base + ec.to_ext(0))
    n_slabs = math.ceil(shard_size / slab)
    if enc["dispatches"] != n_slabs or enc["bitmat_uploads"] != 1:
        raise AssertionError(f"encode counters {enc}, want {n_slabs} "
                             f"dispatches and 1 upload")
    shas = [_sha(base + ec.to_ext(i)) for i in range(total)]
    check_parity(np, ops, ec, base, k, m, shard_size, nbytes)
    enc_launches = ops.gf_matmul.launches
    print(f"encode: {nbytes / enc_s / 1e6:.1f} MB/s ({enc_s:.2f} s, shard "
          f"{shard_size} B, {enc['dispatches']} dispatches, phases "
          f"{enc['phases']})")

    rng = np.random.default_rng(seed + 7)
    random4 = tuple(sorted(rng.choice(total, 4, replace=False).tolist()))
    rebuilds = []
    for lost in ((0, 1, 2, 3), random4):
        for sid in lost:
            os.remove(base + ec.to_ext(sid))
        st = {}
        before = ops.gf_matmul.launches
        t0 = time.perf_counter()
        got = ec.rebuild_ec_files(base, codec=ops.get_codec(k, m, device=dev),
                                  stats=st)
        secs = time.perf_counter() - t0
        if sorted(got) != list(lost):
            raise AssertionError(f"rebuilt {got}, lost {lost}")
        for sid in range(total):
            if _sha(base + ec.to_ext(sid)) != shas[sid]:
                raise AssertionError(f"shard {sid} differs after rebuilding "
                                     f"{lost}")
        if st["dispatches"] != n_slabs or st["bitmat_uploads"] != 1:
            raise AssertionError(f"rebuild counters {st}, want {n_slabs} "
                                 f"dispatches and 1 upload")
        rebuilds.append((lost, secs, st, ops.gf_matmul.launches - before))
        print(f"rebuild {lost}: {st['survivor_bytes'] / secs / 1e6:.1f} MB/s "
              f"of survivors ({secs:.2f} s, {st['dispatches']} dispatches, "
              f"phases {st['phases']}) — shards sha256-identical")
    return {"encode_s": enc_s, "encode_launches": enc_launches,
            "n_slabs": n_slabs, "shard_size": shard_size,
            "rebuilds": rebuilds, "shas": shas}


def check_parity(np, ops, ec, base, k, m, shard_size, nbytes):
    """The numpy oracle re-encodes sampled columns of the written shards,
    and data shard 0 starts with the .dat's own bytes."""
    oracle = ops.NumpyCodec(k, m)
    for off in (0, shard_size // 2, shard_size - 4096):
        rows = []
        for sid in range(k + m):
            with open(base + ec.to_ext(sid), "rb") as f:
                f.seek(off)
                rows.append(np.frombuffer(f.read(4096), dtype=np.uint8))
        rows = np.stack(rows)
        if not np.array_equal(oracle.encode(rows[:k]), rows[k:]):
            raise AssertionError(f"parity at column {off} != numpy oracle")
    with open(base + ".dat", "rb") as a, open(base + ec.to_ext(0), "rb") as b:
        if a.read(1 << 20) != b.read(1 << 20):
            raise AssertionError("data shard 0 does not hold the .dat's "
                                 "first block")


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced(torch, label, fn, trace_path):
    """Runs fn under torch.profiler and prints the card's busy share of
    fn's wall: the union of the device's kernel, copy and memset
    intervals in the trace, over the host's wall time of fn. Returns
    the numbers, or None when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    os.remove(trace_path)
    if not events:
        print(f"traced {label}: not measured (the trace holds no device "
              f"events), wall {wall:.3f} s")
        return None
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_cat = {c: sum(e["dur"] for e in events if e["cat"] == c) / 1e3
              for c in DEVICE_CATS}
    kernel = [e["dur"] / 1e3 for e in events
              if e["cat"] == "kernel" and "gf_matmul" in e.get("name", "")]
    res = {"wall_s": wall, "busy_s": busy_us / 1e6,
           "busy_share": busy_us / 1e6 / wall, "ms_by_cat": by_cat,
           "kernel_launches": len(kernel),
           "kernel_ms_mean": sum(kernel) / len(kernel) if kernel else None}
    print(f"traced {label}: card busy {res['busy_s']:.4f} s of {wall:.3f} s "
          f"wall = {res['busy_share']:.2%} (idle {1 - res['busy_share']:.2%}"
          f"); device ms by kind {json.dumps(by_cat)}; gf_matmul "
          f"{len(kernel)} launches, mean {res['kernel_ms_mean']} ms in the "
          f"pipeline")
    return res


def trace_main_path(torch, port, dev, base, shas):
    """One more encode and one more rebuild (shards 0-3) of the volume,
    each traced; every shard must still be sha256-identical."""
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    trace_path = base + ".trace.json"
    out = {"encode": traced(torch, "encode", lambda: ec.write_ec_files(
        base, codec=ops.get_codec(k, m, device=dev)), trace_path)}
    for sid in range(4):
        os.remove(base + ec.to_ext(sid))
    out["rebuild"] = traced(torch, "rebuild (0, 1, 2, 3)",
                            lambda: ec.rebuild_ec_files(
                                base, codec=ops.get_codec(k, m, device=dev)),
                            trace_path)
    for sid in range(k + m):
        if _sha(base + ec.to_ext(sid)) != shas[sid]:
            raise AssertionError(f"shard {sid} differs after the traced "
                                 f"encode and rebuild")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from seaweedfs_tpu_torch import ec, ops, storage
    from seaweedfs_tpu_torch.ops import gf256, rs_hopper, telemetry
    from seaweedfs_tpu_torch.ops.codec import NumpyCodec

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    build_s = build_kernel(rs_hopper)
    max_err = check_kernel(torch, np, rs_hopper, gf256, NumpyCodec, dev,
                           args.seed)
    ms, plain_ms, bound_ms = time_kernel(torch, rs_hopper, gf256, dev,
                                         args.seed)

    work = os.path.join(str(rs_hopper.BUILD_DIR), "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    base = os.path.join(work, "1")
    try:
        rs_hopper.gf_matmul.launches = 0  # count the main path only
        before = telemetry.STATS.snapshot()
        res = main_path(torch, np, (ec, ops, storage), dev, base,
                        VOLUME_BYTES, args.seed)
        launches = rs_hopper.gf_matmul.launches
        moved = telemetry.delta(before)
        trace_main_path(torch, (ec, ops, storage), dev, base, res["shas"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if res["encode_launches"] < 1 or \
            any(r[3] < 1 for r in res["rebuilds"]):
        raise AssertionError("the kernel was not launched on every leg of "
                             "the main path")
    if launches != moved["dispatches"]:
        raise AssertionError(f"{launches} launches for "
                             f"{moved['dispatches']} dispatches")
    print(f"main path: {launches} kernel launches = {moved['dispatches']} "
          f"dispatches; build {build_s:.2f} s")

    card = card_line()
    kernels = {"kernels": [{
        "name": "gf_matmul", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:82",
        "replaces_function": "seaweedfs_tpu/ops/rs_pallas.py::_fused_fn",
        "launches": launches, "matches_plain": True,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "shape": f"(4,10)x{MAIN_N}",
    }]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        return run(args)
    except Exception:  # noqa: BLE001 - report and fail the smoke
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
