"""``ops/device_stats`` of the port against the JAX package's, on the CPU.

- ``dispatches`` moves by one for each call of K1 (``gf_matmul``, the
  plain version on the CPU), through the codec and by hand, and of K6a
  and K6b; ``launches``, the one launch counter (the wrappers keep none),
  moves only for a launch on the card that returned: never on the CPU,
  never for a launch that raised.
- A codec's constant cache that builds a plan a second time for the
  same matrix (after an eviction) latches the recompile sentinel, names
  the offender, and counts the cache's hits, misses and evictions; plans
  made by hand are compiles but never recompiles.
- With timing off the hot path reads no clock (``_perf_counter``
  monkeypatched, as the JAX test does); with it on, every Nth call is
  sampled.
- The constant cache's occupancy is its entries and their tensors'
  bytes.
- ``admin_snapshot()`` has the JAX package's keys; ``delta`` moves as the
  JAX one; the inventory touches no CUDA unless forced.
- ``util/profiling``: ``maybe_trace`` writes a ``torch.profiler`` trace
  that holds an ``annotate`` region, and does nothing without a
  directory.

Tolerances: none; counts are exact."""

import json
import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import device_stats
from seaweedfs_tpu_torch.ops.codec import _ConstCache
from seaweedfs_tpu_torch.ops.device_stats import (K1, K6A, K6B, PLAN_ENTRY,
                                                  DeviceStats)
from seaweedfs_tpu_torch.ops.gf_plan import make_plan
from seaweedfs_tpu_torch.ops.rs_hopper import gf_matmul
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec


@pytest.fixture
def stats(monkeypatch):
    """A fresh DeviceStats in place of the process's."""
    fresh = DeviceStats()
    monkeypatch.setattr(device_stats, "DEVICE_STATS", fresh)
    return fresh


def _data(k, n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


def test_dispatches_move_once_per_kernel_call(stats):
    from seaweedfs_tpu_torch.ops.rs_bitplane import (
        bitplane_matmul, bitplane_matmul_batched, block_diag_bitmat,
        fuse_bitmat)
    codec = TorchCodec(10, 4, device="cpu", small_dispatch_bytes=0)
    data = _data(10, 3000)
    codec.encode(data)
    assert stats.snapshot()["dispatches"] == {K1: 1}
    shards = list(np.concatenate([data, codec.encode(data)]))
    for i in (0, 3, 11):
        shards[i] = None
    codec.reconstruct(shards)
    assert stats.snapshot()["dispatches"] == {K1: 3}
    plan = make_plan(codec.matrix[10:])
    for _ in range(4):
        gf_matmul(plan, torch.from_numpy(data))
    assert stats.snapshot()["dispatches"] == {K1: 7}
    assert not hasattr(gf_matmul, "launches")
    bm = fuse_bitmat(codec.matrix[10:])
    x = torch.from_numpy(data[:, :300])
    bitplane_matmul(torch.from_numpy(bm), x, 4, "int8")
    bitplane_matmul_batched(torch.from_numpy(block_diag_bitmat(bm, 2)), x,
                            4, 2, "int8")
    snap = stats.snapshot()
    assert snap["dispatches"] == {K1: 7, K6A: 1, K6B: 1}
    assert snap["launches"] == {}    # the CPU launches no kernel
    stats.reset_counts()
    assert stats.snapshot()["dispatches"] == {}


def test_launches_count_only_card_launches_that_return(stats):
    """A launch on the card counts once it has returned; one that raises
    is a dispatch and no launch; a call on the CPU is no launch."""
    card = torch.device("cuda")
    assert device_stats.dispatch(K1, card, lambda: "out") == "out"

    def failed():
        raise RuntimeError("gf_matmul kernel launch failed: CUDA error 1")

    with pytest.raises(RuntimeError):
        device_stats.dispatch(K1, card, failed)
    device_stats.dispatch(K1, torch.device("cpu"), lambda: None)
    device_stats.dispatch(K6A, card, lambda: None)
    snap = stats.snapshot()
    assert snap["dispatches"] == {K1: 3, K6A: 1}
    assert snap["launches"] == {K1: 1, K6A: 1}
    assert (stats.launch_count(K1), stats.launch_count(K6B)) == (1, 0)
    assert device_stats.delta({}, snap)["launches_total"] == 2
    stats.reset_counts()
    assert stats.snapshot()["launches"] == {}


def test_second_plan_for_one_matrix_latches_the_sentinel(stats):
    codec = TorchCodec(10, 4, device="cpu", small_dispatch_bytes=0)
    codec._consts = _ConstCache(maxsize=1)
    data = _data(10, 1000, 1)
    codec.encode(data)                 # plan of the parity rows
    codec.encode(data)                 # a hit
    snap = stats.snapshot()
    assert snap["compiles"] == {PLAN_ENTRY: 1} and not snap["sentinel"]
    assert snap["const_cache"] == {"hits": 1, "misses": 1, "evictions": 0}
    shards = list(np.concatenate([data, codec.encode(data)]))
    shards[2] = None
    codec.reconstruct(shards)          # a decode plan evicts the parity's
    codec.encode(data)                 # the parity rows' plan again
    snap = stats.snapshot()
    assert snap["compiles"] == {PLAN_ENTRY: 3}
    assert snap["recompiles"] == {PLAN_ENTRY: 1} and snap["sentinel"]
    assert len(snap["offenders"]) == 1
    assert snap["offenders"][0].startswith(f"{PLAN_ENTRY}:((4, 10), ")
    assert snap["const_cache"] == {"hits": 2, "misses": 3, "evictions": 2}
    # plans made by hand are compiles, never recompiles
    other = DeviceStats()
    device_stats.DEVICE_STATS = other
    make_plan(codec.matrix[10:])
    make_plan(codec.matrix[10:])
    snap = other.snapshot()
    assert snap["compiles"] == {PLAN_ENTRY: 2} and not snap["sentinel"]


def test_timing_off_path_is_clock_free(stats, monkeypatch):
    plan = make_plan(np.eye(4, 10, dtype=np.uint8))
    x = torch.from_numpy(_data(10, 512))
    calls = {"n": 0}
    real = device_stats._perf_counter

    def probe():
        calls["n"] += 1
        return real()

    monkeypatch.setattr(device_stats, "_perf_counter", probe)
    codec = TorchCodec(10, 4, device="cpu", small_dispatch_bytes=0)
    codec.encode(_data(10, 512))       # warm-up: the plan build reads it
    calls["n"] = 0
    for _ in range(16):
        gf_matmul(plan, x)
        codec.encode(_data(10, 512))
    assert calls["n"] == 0, "the timing-off hot path read the clock"
    assert stats.snapshot()["dispatches"] == {K1: 33}
    # timing on: the same probe fires, every second call
    stats.configure(timing=True, sample_every=2)
    for _ in range(4):
        gf_matmul(plan, x)
    assert calls["n"] == 4
    snap = stats.snapshot()
    assert snap["device_samples"] == {K1: 2}
    assert snap["device_seconds"][K1] > 0
    assert snap["timing_enabled"] and snap["sample_every"] == 2


def test_const_cache_occupancy(stats):
    codec = TorchCodec(10, 4, device="cpu", small_dispatch_bytes=0)
    assert stats.const_cache_occupancy() == {"entries": 0, "bytes": 0}
    codec.encode(_data(10, 800))
    plan = make_plan(codec.matrix[10:])
    want = sum(t.element_size() * t.numel() for t in (
        plan.coeffs, plan.row_map, plan.tile_ptr, plan.pair_rows,
        plan.tables))
    assert stats.const_cache_occupancy() == {"entries": 1, "bytes": want}
    shards = list(np.concatenate([_data(10, 800), codec.encode(
        _data(10, 800))]))
    shards[0] = shards[13] = None
    codec.reconstruct(shards)
    occ = stats.const_cache_occupancy()
    assert occ["entries"] == 2 and occ["bytes"] > want
    del codec
    import gc
    gc.collect()
    assert stats.const_cache_occupancy() == {"entries": 0, "bytes": 0}


def test_admin_snapshot_has_the_jax_keys(stats):
    from seaweedfs_tpu.ops import device_stats as ref
    gf_matmul(make_plan(np.eye(2, dtype=np.uint8)),
              torch.from_numpy(_data(2, 64)))
    mine = device_stats.admin_snapshot()
    theirs = ref.admin_snapshot()
    assert set(mine) == set(theirs)
    # and the card's own launches beside the dispatches
    assert set(mine["stats"]) == set(theirs["stats"]) | {"launches"}
    assert set(mine["stats"]["const_cache"]) == \
        set(theirs["stats"]["const_cache"])
    assert set(mine["inventory"]) == set(theirs["inventory"]) - {"error"}
    assert set(mine["inventory"]["devices"][0]) == \
        set(theirs["inventory"]["devices"][0])
    for info in mine["jit_factories"].values():
        assert set(info) == {"hits", "misses", "maxsize", "currsize",
                             "evictions"}
    assert mine["inventory"]["platform"] == "cpu"
    assert mine["inventory"]["device_kinds"] == {"cpu": 1}
    json.dumps(mine)


def test_delta_moves_as_the_jax_one(stats):
    from seaweedfs_tpu.ops import device_stats as ref
    before = stats.snapshot()
    codec = TorchCodec(10, 4, device="cpu", small_dispatch_bytes=0)
    codec.encode(_data(10, 100))
    codec.encode(_data(10, 100))
    moved = device_stats.delta(before)
    assert set(moved) == set(ref.delta(ref.DEVICE_STATS.snapshot())) | {
        "launches", "launches_total"}
    assert moved["dispatches"] == {K1: 2} and moved["dispatches_total"] == 2
    assert moved["launches"] == {} and moved["launches_total"] == 0
    assert moved["compiles"] == {PLAN_ENTRY: 1}
    assert moved["recompiles_total"] == 0 and moved["offenders"] == []


def test_inventory_touches_no_cuda_unless_forced():
    assert not torch.cuda.is_initialized()
    inv = device_stats.device_inventory()
    assert inv == {"initialized": False, "platform": None,
                   "device_kinds": {}, "devices": []}
    assert device_stats.device_inventory(force=True)["initialized"]


def test_maybe_trace_and_annotate(tmp_path):
    from seaweedfs_tpu_torch.util.profiling import annotate, maybe_trace
    plan = make_plan(np.eye(3, dtype=np.uint8))
    x = torch.from_numpy(_data(3, 256))
    with maybe_trace("none", None):
        with annotate("no trace"):
            gf_matmul(plan, x)
    assert os.listdir(tmp_path) == []
    with maybe_trace("leg", str(tmp_path)):
        with annotate("sw.k1"):
            gf_matmul(plan, x)
    with open(tmp_path / "leg" / "trace.json") as f:
        trace = json.load(f)
    assert any(ev.get("name") == "sw.k1" for ev in trace["traceEvents"])
