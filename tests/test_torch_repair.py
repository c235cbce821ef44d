"""The port's single-lost-shard repairs (trace repair and piggyback plane
repair: plans, holder transforms, gather sources, rebuilders) against the
JAX package's, byte for byte. Geometries of test_trace_repair.py and
test_piggyback.py; slab 7,001 (divides neither a shard nor a byte
boundary) and a gather window of 2. The JAX side runs NumpyCodec, as its
own tests run it; the port runs TorchCodec(device="cpu"), the kernel's
plain version, sync and pipelined. Exact: GF(2^8) arithmetic."""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import to_ext as ref_to_ext
from seaweedfs_tpu.ec import write_ec_files as ref_write_ec_files
from seaweedfs_tpu.ec import decoder as ref_decoder
from seaweedfs_tpu.ec import gather as ref_gather
from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu_torch.ec import decoder, gather, to_ext
from seaweedfs_tpu_torch.ops import codec
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec

GEOMETRIES = [(10, 4), (6, 3), (20, 4)]
SLAB, WINDOW = 7_001, 2
LB, SB = 4096, 512  # piggyback: the window 512 divides by alpha 32


def _pick_lost(k, m):
    """The seeded lost shard of test_trace_repair.py."""
    return int(np.random.default_rng(k * 31 + m).integers(0, k + m))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _seed(dirpath, k, m, nbytes, layout="flat", seed=11):
    """Shard files of volume 1 written by the JAX package (NumpyCodec);
    returns (base, shard bytes)."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    base = os.path.join(str(dirpath), "1")
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    kw = (dict(large_block=64 << 10, small_block=8 << 10, slab=32 << 10)
          if layout == "flat" else
          dict(large_block=LB, small_block=SB, slab=3000))
    ref_write_ec_files(base, codec=RefNumpyCodec(k, m), pipelined=False,
                       layout=layout, **kw)
    os.remove(base + ".dat")
    return base, [_read(base + ref_to_ext(i)) for i in range(k + m)]


def _copy_shards(src_base, dst_dir, n):
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(str(dst_dir), "1")
    for i in range(n):
        shutil.copy(src_base + to_ext(i), dst + to_ext(i))
    return dst


def _pull_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("ec-pull", "pipeline-"))]


def _no_pull_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _pull_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    return not _pull_threads()


# -- trace-repair plans ------------------------------------------------------

PLAN_CASES = [(10, 4, sid) for sid in range(14)] + \
    [(6, 3, _pick_lost(6, 3)), (20, 4, _pick_lost(20, 4))]


@pytest.mark.parametrize("k,m,lost", PLAN_CASES)
def test_repair_plan_matches_jax(k, m, lost):
    port = codec.repair_plan(k, m, lost)
    ref = ref_codec.repair_plan(k, m, lost)
    for name in ("k", "m", "lost", "helpers", "masks", "matrix_kind",
                 "total_bits", "frac"):
        assert getattr(port, name) == getattr(ref, name), name
    assert np.array_equal(port.combine, ref.combine)
    assert port.combine.shape == (8, port.total_bits)
    assert set(np.unique(port.combine)) <= {0, 1}
    assert [port.bits_for(s) for s in port.helpers] == \
        [ref.bits_for(s) for s in ref.helpers]
    assert port.wire_bytes(1009) == ref.wire_bytes(1009)
    assert codec.repair_gain(port) == ref_codec.repair_gain(ref) > 0
    assert codec.repair_plan(k, m, lost) is port  # cached


@pytest.mark.parametrize("lost,survivors", [
    (3, [i for i in range(14) if i not in (3, 5, 12)]),
    (11, [i for i in range(14) if i not in (0, 11)]),
])
def test_repair_plan_restricted_survivors(lost, survivors):
    port = codec.repair_plan(10, 4, lost, survivors=survivors)
    ref = ref_codec.repair_plan(10, 4, lost, survivors=survivors)
    assert port.helpers == ref.helpers and port.masks == ref.masks
    assert np.array_equal(port.combine, ref.combine)
    assert not set(port.helpers) - set(survivors)


def test_repair_plan_rejects_too_few_survivors():
    for plan_fn in (codec.repair_plan, ref_codec.repair_plan):
        with pytest.raises(ValueError, match="too few survivors"):
            plan_fn(10, 4, 0, survivors=range(4, 13))
        with pytest.raises(ValueError, match="outside"):
            plan_fn(10, 4, 14)


def test_project_and_combine_match_jax():
    k, m, w = 10, 4, 1009
    rng = np.random.default_rng(5)
    shards = RefNumpyCodec(k, m).encode_to_all(
        rng.integers(0, 256, (k, w), dtype=np.uint8))
    lost = _pick_lost(k, m)
    plan = codec.repair_plan(k, m, lost)
    planes = []
    for sid in plan.helpers:
        got = codec.project_slab(shards[sid], plan.masks[sid])
        assert np.array_equal(
            got, ref_codec.project_slab(shards[sid], plan.masks[sid]))
        assert got.shape == (plan.bits_for(sid), (w + 7) // 8)
        planes.append(got)
    planes = np.concatenate(planes, axis=0)
    combined = TorchCodec(k, m, device="cpu")._matmul(plan.combine, planes)
    out = codec.combine_planes_to_bytes(combined, w)
    assert np.array_equal(out, ref_codec.combine_planes_to_bytes(combined, w))
    assert np.array_equal(out, shards[lost])


# -- piggyback plane-repair plans and transforms -----------------------------

@pytest.mark.parametrize("k,m,lost,parities,pairs", [
    *[(10, 4, lost, None, None) for lost in range(10)],
    (10, 4, 3, (11, 13), None), (10, 4, 2, None, 2), (6, 3, 5, (7, 8), None),
])
def test_piggyback_repair_plan_matches_jax(k, m, lost, parities, pairs):
    port = codec.piggyback_repair_plan(k, m, lost, parity_sids=parities,
                                       pairs=pairs)
    ref = ref_codec.piggyback_repair_plan(k, m, lost, parity_sids=parities,
                                          pairs=pairs)
    for name in ("k", "m", "lost", "alpha", "plane_bit", "plane_side",
                 "data_helpers", "parity_sids", "helpers", "matrix_kind",
                 "frac"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.plane() == ref.plane()
    assert port.wire_bytes(4096) == ref.wire_bytes(4096)
    assert np.array_equal(port.matrix, ref.matrix)
    assert port.matrix.shape == (port.alpha,
                                 len(port.helpers) * port.alpha // 2)
    assert codec.piggyback_repair_plan(
        k, m, lost, parity_sids=parities, pairs=pairs) is port


def test_piggyback_repair_plan_rejects():
    for plan_fn in (codec.piggyback_repair_plan,
                    ref_codec.piggyback_repair_plan):
        with pytest.raises(ValueError, match="not a coupled data shard"):
            plan_fn(10, 4, 10)
        with pytest.raises(ValueError, match="two parity"):
            plan_fn(10, 4, 1, parity_sids=(10,))
    codec.piggyback_repair_plan(10, 4, 0)
    assert codec.plan_cache_stats()["entries"]["piggyback_repair"] >= 1


@pytest.mark.parametrize("alpha,window", [(32, 512), (4, 64)])
def test_plane_slice_and_rows_match_jax(alpha, window):
    shard = np.random.default_rng(alpha).integers(0, 256, 3 * window,
                                                  dtype=np.uint8)
    for bit in range(alpha.bit_length() - 1):
        for side in (0, 1):
            got = codec.pb_plane_slice(shard, alpha, window, bit, side)
            assert np.array_equal(got, ref_codec.pb_plane_slice(
                shard, alpha, window, bit, side))
            assert got.shape == (3 * window // 2,)
            rows = codec.pb_plane_rows(got, alpha, window)
            assert np.array_equal(rows, ref_codec.pb_plane_rows(
                got, alpha, window))
            assert rows.shape == (alpha // 2, 3 * window // alpha)


# -- rebuilders --------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_trace_repair_matches_jax(tmp_path, k, m, pipelined):
    base, want = _seed(tmp_path / "ref", k, m, k * 24_000 + 53, seed=k * m)
    port_base = _copy_shards(base, tmp_path / "port", k + m)
    shard_size = len(want[0])
    lost = _pick_lost(k, m)
    plan = codec.repair_plan(k, m, lost)
    rplan = ref_codec.repair_plan(k, m, lost)
    for b in (base, port_base):
        os.remove(b + to_ext(lost))

    ref_gs = ref_gather.GatherStats()
    ref_source = ref_gather.RepairGatherSource(
        [ref_gather.LocalRepairReader(base + to_ext(i), rplan.masks[i],
                                      ref_gs) for i in rplan.helpers],
        shard_size, rplan, slab=SLAB, window=WINDOW, stats=ref_gs)
    ref_stats = {}
    ref_decoder.rebuild_ec_file_repair(base, lost, ref_source, rplan,
                                       codec=RefNumpyCodec(k, m), slab=SLAB,
                                       stats=ref_stats)

    gs = gather.GatherStats()
    source = gather.RepairGatherSource(
        [gather.LocalRepairReader(port_base + to_ext(i), plan.masks[i], gs)
         for i in plan.helpers],
        shard_size, plan, slab=SLAB, window=WINDOW, stats=gs)
    stats = {}
    assert decoder.rebuild_ec_file_repair(
        port_base, lost, source, plan,
        codec=TorchCodec(k, m, device="cpu"), slab=SLAB,
        pipelined=pipelined, stats=stats) == [lost]
    got = _read(port_base + to_ext(lost))
    assert got == want[lost] == _read(base + to_ext(lost))

    stripes = -(-shard_size // SLAB)
    symbol_bytes = plan.total_bits * sum(
        (min(SLAB, shard_size - off) + 7) // 8
        for off in range(0, shard_size, SLAB))
    assert {key for key in stats if key.startswith("repair_")} == \
        {key for key in ref_stats if key.startswith("repair_")}
    for key in ("repair_mode", "repair_helpers", "repair_total_bits",
                "repair_bits", "repair_bytes", "repair_remote_bytes",
                "repair_baseline_bytes", "repair_bytes_frac",
                "rebuilt_bytes", "gather_bytes", "gather_stripes",
                "gather_fetches", "peak_gather_buffer"):
        assert stats[key] == ref_stats[key], key
    assert stats["repair_bytes"] == symbol_bytes
    assert stats["repair_bytes_frac"] == round(
        symbol_bytes / (k * shard_size), 4)
    assert stats["dispatches"] == stripes and stats["bitmat_uploads"] == 1
    assert stats["backend"] == "cuda"
    assert stats["peak_gather_buffer"] <= \
        WINDOW * plan.total_bits * ((SLAB + 7) // 8)
    assert 0.0 <= stats["overlap_frac"] <= 1.0
    assert sum(stats["phases"].values()) == pytest.approx(stats["stream_s"],
                                                          abs=1e-5)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("lost", [0, 7])
def test_plane_repair_matches_jax(tmp_path, lost, pipelined):
    k, m = 10, 4
    base, want = _seed(tmp_path / "ref", k, m, 77_003, layout="piggyback")
    port_base = _copy_shards(base, tmp_path / "port", k + m)
    shard_size = len(want[0])
    rplan = codec.piggyback_repair_plan(k, m, lost)
    ref_rplan = ref_codec.piggyback_repair_plan(k, m, lost)
    for b in (base, port_base):
        os.remove(b + to_ext(lost))

    ref_gs = ref_gather.GatherStats()
    ref_source = ref_gather.PlaneGatherSource(
        [ref_gather.LocalPlaneReader(base + to_ext(h), 32, SB,
                                     ref_rplan.plane_bit,
                                     ref_rplan.plane_side, ref_gs)
         for h in ref_rplan.helpers],
        shard_size, ref_rplan, SB, slab=SLAB, gather_window=WINDOW,
        stats=ref_gs)
    ref_stats = {}
    ref_decoder.rebuild_ec_file_piggyback(
        base, lost, ref_source, ref_rplan, SB, codec=RefNumpyCodec(k, m),
        slab=ref_source.slab, stats=ref_stats)

    gs = gather.GatherStats()
    source = gather.PlaneGatherSource(
        [gather.LocalPlaneReader(port_base + to_ext(h), rplan.alpha, SB,
                                 rplan.plane_bit, rplan.plane_side, gs)
         for h in rplan.helpers],
        shard_size, rplan, SB, slab=SLAB, gather_window=WINDOW, stats=gs)
    assert source.slab == SLAB - SLAB % SB == ref_source.slab
    stats = {}
    assert decoder.rebuild_ec_file_piggyback(
        port_base, lost, source, rplan, SB,
        codec=TorchCodec(k, m, device="cpu"), slab=source.slab,
        pipelined=pipelined, stats=stats) == [lost]
    assert _read(port_base + to_ext(lost)) == want[lost] == \
        _read(base + to_ext(lost))
    for key in ("repair_mode", "repair_helpers", "repair_bytes",
                "repair_baseline_bytes", "repair_bytes_frac", "layout",
                "rebuilt_bytes", "gather_stripes", "peak_gather_buffer"):
        assert stats[key] == ref_stats[key], key
    assert stats["repair_bytes_frac"] == 0.55
    assert stats["dispatches"] == -(-shard_size // source.slab)
    assert stats["bitmat_uploads"] == 1


class _FailingReader:
    """Serves stripe 0, then fails: the rebuild must leave nothing."""

    def __init__(self, inner):
        self.inner = inner
        self.stats = inner.stats

    def read(self, off, n, stripe_idx=0):
        if off:
            raise IOError("holder went away")
        return self.inner.read(off, n, stripe_idx)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("kind", ["trace", "plane"])
def test_repair_failure_removes_partial(tmp_path, kind, pipelined):
    k, m = 10, 4
    c = TorchCodec(k, m, device="cpu")
    if kind == "trace":
        base, _ = _seed(tmp_path, k, m, 240_053)
        lost = 5
        plan = codec.repair_plan(k, m, lost)
        readers = [_FailingReader(gather.LocalRepairReader(
            base + to_ext(i), plan.masks[i])) for i in plan.helpers]
        source = gather.RepairGatherSource(
            readers, os.path.getsize(base + to_ext(0)), plan, slab=SLAB,
            window=WINDOW)
        run = lambda: decoder.rebuild_ec_file_repair(  # noqa: E731
            base, lost, source, plan, codec=c, slab=SLAB,
            pipelined=pipelined)
    else:
        base, _ = _seed(tmp_path, k, m, 77_003, layout="piggyback")
        lost = 2
        plan = codec.piggyback_repair_plan(k, m, lost)
        readers = [_FailingReader(gather.LocalPlaneReader(
            base + to_ext(h), plan.alpha, SB, plan.plane_bit,
            plan.plane_side)) for h in plan.helpers]
        source = gather.PlaneGatherSource(
            readers, os.path.getsize(base + to_ext(0)), plan, SB, slab=2048,
            gather_window=WINDOW)
        run = lambda: decoder.rebuild_ec_file_piggyback(  # noqa: E731
            base, lost, source, plan, SB, codec=c, slab=source.slab,
            pipelined=pipelined)
    os.remove(base + to_ext(lost))
    with pytest.raises(IOError, match="holder went away"):
        run()
    assert not os.path.exists(base + to_ext(lost))
    assert _no_pull_threads(), _pull_threads()


def test_repair_default_codec_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract is not testable")
    base, _ = _seed(tmp_path, 10, 4, 240_053)
    lost = 5
    plan = codec.repair_plan(10, 4, lost)
    os.remove(base + to_ext(lost))
    source = gather.RepairGatherSource(
        [gather.LocalRepairReader(base + to_ext(i), plan.masks[i])
         for i in plan.helpers], os.path.getsize(base + to_ext(0)), plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.rebuild_ec_file_repair(base, lost, source, plan)
    rplan = codec.piggyback_repair_plan(10, 4, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.rebuild_ec_file_piggyback(base, 0, source, rplan, SB)
    assert not os.path.exists(base + to_ext(lost))


def test_plan_mismatch_raises(tmp_path):
    plan = codec.repair_plan(10, 4, 3)
    c = TorchCodec(10, 4, device="cpu")
    with pytest.raises(ValueError, match="plan repairs shard 3"):
        decoder.rebuild_ec_file_repair(str(tmp_path / "1"), 4, None, plan,
                                       codec=c)
    with pytest.raises(ValueError, match="need one reader per helper"):
        gather.RepairGatherSource([], 100, plan)
