"""The port's pull transport and streaming rebuilds (ec/transport.py,
ec/gather.py, encoder.rebuild_ec_files_streaming(_piggyback)) against
the JAX package's, byte for byte: strict stripe order, the bounded
in-flight window, the flat streaming rebuild (pipelined and sync) and
the piggyback one, all-or-nothing failure, StageTimer's busy time, and
the pipeline's pieces form. The JAX side runs NumpyCodec (and TpuCodec
for one pipelined case, as test_streaming_gather.py does); the port runs
TorchCodec(device="cpu"), the kernel's plain version. Exact: GF(2^8)
arithmetic."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import gather as ref_gather
from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ec import write_ec_files as ref_write_ec_files
from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.util.profiling import StageTimer as RefStageTimer
from seaweedfs_tpu_torch.ec import encoder, gather, layout, to_ext
from seaweedfs_tpu_torch.ec.transport import DEFAULT_WINDOW
from seaweedfs_tpu_torch.ops import codec
from seaweedfs_tpu_torch.ops.pipeline import PipelinedMatmul
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
from seaweedfs_tpu_torch.util.profiling import StageTimer

SLAB = 16 << 10
LB, SB = 4096, 512


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _seed(dirpath, k, m, nbytes, layout_name="flat", seed=11):
    """Shard files of volume 1 written by the JAX package; returns (base,
    shard bytes)."""
    os.makedirs(dirpath, exist_ok=True)
    base = os.path.join(str(dirpath), "1")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    kw = (dict(large_block=64 << 10, small_block=8 << 10, slab=32 << 10)
          if layout_name == "flat" else
          dict(large_block=LB, small_block=SB, slab=3000))
    ref_write_ec_files(base, codec=RefNumpyCodec(k, m), pipelined=False,
                       layout=layout_name, **kw)
    os.remove(base + ".dat")
    return base, [_read(base + to_ext(i)) for i in range(k + m)]


def _copy(src_base, dst_dir, n):
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(str(dst_dir), "1")
    for i in range(n):
        shutil.copy(src_base + to_ext(i), dst + to_ext(i))
    return dst


def _pull_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("ec-pull", "pipeline-"))]


@pytest.mark.parametrize("size", [0, 1 << 20, (2 << 20) + 1, 5 << 20,
                                  40 << 20, 103 << 20])
def test_auto_slab_matches_jax(size):
    got = gather.auto_slab(size)
    assert got == ref_gather.auto_slab(size)
    assert (1 << 20) <= got <= (8 << 20)


def test_gather_window_default():
    assert gather.gather_window() == DEFAULT_WINDOW == 4 == \
        ref_gather.DEFAULT_WINDOW


def _slow_source(module, k, slab, window, n_stripes):
    stats = module.GatherStats()

    class SlowReader:
        remote = False

        def __init__(self):
            self.stats = stats

        def read(self, off, n, *_):
            time.sleep(0.002)
            t = time.perf_counter()
            self.stats.add_fetch(n, t - 0.002, t)
            return bytes([(off // slab) & 0xFF]) * n

    return module.StripedGatherSource(
        [SlowReader() for _ in range(k)], slab * n_stripes, slab=slab,
        window=window, stats=stats), stats


def test_strict_order_and_window_bound():
    """A slow consumer must not let the prefetch run ahead: in-flight and
    buffered stripes never exceed the window, on either package."""
    k, slab, window, n_stripes = 4, 8 << 10, 2, 12
    for module in (gather, ref_gather):
        source, stats = _slow_source(module, k, slab, window, n_stripes)
        order = []
        for (idx, off, w), data in source.slabs():
            assert data.shape == (k, w) and off == idx * slab
            assert bool((data == (idx & 0xFF)).all())
            order.append(idx)
            time.sleep(0.005)
        assert order == list(range(n_stripes))
        assert stats.stripes == n_stripes
        assert 0 < stats.peak_buffered <= window * k * slab
        assert stats.fetches == k * n_stripes
        assert stats.busy_s() > 0


def test_local_shard_reader_short_read(tmp_path):
    path = str(tmp_path / "x")
    with open(path, "wb") as f:
        f.write(bytes(100))
    reader = gather.LocalShardReader(path)
    assert reader.read(90, 10) == bytes(10)
    with pytest.raises(IOError, match="short read"):
        reader.read(95, 10)
    assert reader.stats.bytes == 10 and reader.stats.fetches == 1


@pytest.mark.parametrize("k,m,lost,pipelined", [
    (6, 3, (1, 4, 7), True), (6, 3, (1, 4, 7), False),
    (10, 4, (0, 3, 11, 13), True), (10, 4, (2, 12), False),
])
def test_streaming_rebuild_matches_jax(tmp_path, k, m, lost, pipelined):
    base, want = _seed(tmp_path / "ref", k, m, 150_053)
    port_base = _copy(base, tmp_path / "port", k + m)
    shard_size = len(want[0])
    present = [i not in lost for i in range(k + m)]
    src = [i for i in range(k + m) if present[i]][:k]
    for b in (base, port_base):
        for sid in lost:
            os.remove(b + to_ext(sid))

    ref_stats_ = ref_gather.GatherStats()
    ref_source = ref_gather.StripedGatherSource(
        [ref_gather.LocalShardReader(base + to_ext(i), ref_stats_)
         for i in src], shard_size, slab=SLAB, window=2, stats=ref_stats_)
    if pipelined and k == 6:
        from seaweedfs_tpu.ops.rs_tpu import TpuCodec
        ref_c = TpuCodec(k, m)
    else:
        ref_c = RefNumpyCodec(k, m)
    ref_out = {}
    ref_encoder.rebuild_ec_files_streaming(base, present, list(lost),
                                           ref_source, codec=ref_c,
                                           slab=SLAB, stats=ref_out)

    gs = gather.GatherStats()
    source = gather.StripedGatherSource(
        [gather.LocalShardReader(port_base + to_ext(i), gs) for i in src],
        shard_size, slab=SLAB, window=2, stats=gs)
    stats = {}
    assert encoder.rebuild_ec_files_streaming(
        port_base, present, list(lost), source,
        codec=TorchCodec(k, m, device="cpu"), slab=SLAB,
        pipelined=pipelined, stats=stats) == list(lost)
    for sid in lost:
        assert _read(port_base + to_ext(sid)) == want[sid] == \
            _read(base + to_ext(sid)), sid
    stripes = -(-shard_size // SLAB)
    for key in ("gather_bytes", "gather_stripes", "gather_fetches",
                "peak_gather_buffer", "survivor_bytes", "rebuilt_bytes"):
        assert stats[key] == ref_out[key], key
    assert stats["gather_stripes"] == stripes
    assert stats["gather_bytes"] == shard_size * k
    assert stats["peak_gather_buffer"] <= 2 * k * SLAB
    assert stats["dispatches"] == stripes and stats["bitmat_uploads"] == 1
    assert 0.0 <= stats["overlap_frac"] <= 1.0
    assert {"gather_busy_s", "compute_busy_s", "overlap_frac",
            "gather_mbps"} <= set(stats)
    assert sum(stats["phases"].values()) == pytest.approx(stats["stream_s"],
                                                          abs=1e-5)
    assert sorted(f for f in os.listdir(tmp_path / "port")) == \
        sorted(f"1{to_ext(i)}" for i in range(k + m))


@pytest.mark.parametrize("lost", [(0, 7, 11, 12), (10, 11, 12, 13), (5,)])
def test_streaming_piggyback_matches_jax(tmp_path, lost):
    k, m = 10, 4
    base, want = _seed(tmp_path / "ref", k, m, 77_003, layout_name="piggyback")
    port_base = _copy(base, tmp_path / "port", k + m)
    shard_size = len(want[0])
    present = [i not in lost for i in range(k + m)]
    src, _, _ = codec.piggyback_decode_plan(k, m, tuple(present))
    assert list(src) == list(ref_codec.piggyback_decode_plan(
        k, m, tuple(present))[0])
    for b in (base, port_base):
        for sid in lost:
            os.remove(b + to_ext(sid))
    slab = 6 * SB

    ref_gs = ref_gather.GatherStats()
    ref_source = ref_gather.StripedGatherSource(
        [ref_gather.LocalShardReader(base + to_ext(i), ref_gs) for i in src],
        shard_size, slab=slab, window=2, stats=ref_gs)
    ref_out = {}
    ref_encoder.rebuild_ec_files_streaming_piggyback(
        base, present, list(lost), ref_source,
        ref_layout.LayoutInfo("piggyback", SB, 5), codec=RefNumpyCodec(k, m),
        slab=slab, stats=ref_out)

    gs = gather.GatherStats()
    source = gather.StripedGatherSource(
        [gather.LocalShardReader(port_base + to_ext(i), gs) for i in src],
        shard_size, slab=slab, window=2, stats=gs)
    stats = {}
    assert encoder.rebuild_ec_files_streaming_piggyback(
        port_base, present, list(lost), source,
        layout.LayoutInfo(layout.LAYOUT_PIGGYBACK, SB, 5),
        codec=TorchCodec(k, m, device="cpu"), stats=stats) == list(lost)
    for sid in lost:
        assert _read(port_base + to_ext(sid)) == want[sid] == \
            _read(base + to_ext(sid)), sid
    for key in ("survivor_bytes", "rebuilt_bytes", "gather_bytes",
                "gather_stripes", "peak_gather_buffer", "layout"):
        assert stats[key] == ref_out[key], key
    assert set(stats["pb_host_s"]) == {"split", "merge"}
    assert stats["dispatches"] == -(-shard_size // slab)
    assert stats["bitmat_uploads"] == 1
    assert sum(stats["phases"].values()) == pytest.approx(stats["stream_s"],
                                                          abs=1e-5)


class _FlakyReader:
    def __init__(self, path):
        self.path = path
        self.stats = None

    def read(self, off, n, stripe_idx=0):
        if off:  # serves stripe 0, then fails
            raise IOError("holder went away")
        with open(self.path, "rb") as f:
            f.seek(off)
            return f.read(n)


@pytest.mark.parametrize("kind", ["pipelined", "sync", "piggyback"])
def test_streaming_failure_leaves_no_partials(tmp_path, kind):
    k, m, lost = 10, 4, (1, 7, 12)
    base, _ = _seed(tmp_path, k, m, 120_000,
                    layout_name="piggyback" if kind == "piggyback"
                    else "flat")
    present = [i not in lost for i in range(k + m)]
    if kind == "piggyback":
        src = codec.piggyback_decode_plan(k, m, tuple(present))[0]
    else:
        src = [i for i in range(k + m) if present[i]][:k]
    for sid in lost:
        os.remove(base + to_ext(sid))
    source = gather.StripedGatherSource(
        [_FlakyReader(base + to_ext(i)) for i in src],
        os.path.getsize(base + to_ext(0)), slab=4 * SB, window=2)
    c = TorchCodec(k, m, device="cpu")
    with pytest.raises(IOError, match="holder went away"):
        if kind == "piggyback":
            encoder.rebuild_ec_files_streaming_piggyback(
                base, present, list(lost), source,
                layout.LayoutInfo(layout.LAYOUT_PIGGYBACK, SB, 5), codec=c)
        else:
            encoder.rebuild_ec_files_streaming(
                base, present, list(lost), source, codec=c, slab=4 * SB,
                pipelined=kind == "pipelined")
    for sid in lost:
        assert not os.path.exists(base + to_ext(sid))
    deadline = time.monotonic() + 5
    while _pull_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _pull_threads()


@pytest.mark.parametrize("kind", ["pipelined", "sync", "piggyback"])
def test_local_rebuild_failure_leaves_no_partials(tmp_path, monkeypatch,
                                                  kind):
    """rebuild_ec_files pulls the local survivors through the streaming
    rebuild, so a failing read leaves no partial shard and no thread."""
    k, m, lost = 10, 4, (1, 7, 12)
    piggyback = kind == "piggyback"
    base, want = _seed(tmp_path, k, m, 120_000,
                       layout_name="piggyback" if piggyback else "flat")
    for sid in lost:
        os.remove(base + to_ext(sid))
    read = gather.LocalShardReader.read

    def flaky(self, off, n, stripe_idx=0):
        if off:
            raise IOError("disk went away")
        return read(self, off, n, stripe_idx)

    monkeypatch.setattr(gather.LocalShardReader, "read", flaky)
    info = layout.LayoutInfo(layout.LAYOUT_PIGGYBACK, SB, 5) \
        if piggyback else None
    c = TorchCodec(k, m, device="cpu")
    with pytest.raises(IOError, match="disk went away"):
        encoder.rebuild_ec_files(base, codec=c, slab=4 * SB,
                                 pipelined=kind == "pipelined", layout=info)
    for sid in lost:
        assert not os.path.exists(base + to_ext(sid))
    deadline = time.monotonic() + 5
    while _pull_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _pull_threads()
    monkeypatch.setattr(gather.LocalShardReader, "read", read)
    stats = {}
    assert encoder.rebuild_ec_files(base, codec=c, slab=4 * SB,
                                    pipelined=kind == "pipelined",
                                    layout=info, stats=stats) == list(lost)
    for sid in lost:
        assert _read(base + to_ext(sid)) == want[sid]
    assert stats["gather_stripes"] == -(-len(want[0]) // (4 * SB))


def test_stripe_assembly_counts_as_gather_busy():
    """Stripe assembly is NOT gather busy time, in the port as in the JAX
    package: quiet readers (which record no fetch) run through both
    packages' StripedGatherSource, and neither records a gather interval,
    so both report gather_busy_s 0.0. The gather's busy time is the union
    of the readers' fetch intervals only."""
    k, slab, n_stripes = 3, 1024, 5

    class Quiet:
        def read(self, off, n, stripe_idx=0):
            return bytes(n)

    for mod in (gather, ref_gather):
        stats = mod.GatherStats()
        source = mod.StripedGatherSource([Quiet() for _ in range(k)],
                                         slab * n_stripes, slab=slab,
                                         window=2, stats=stats)
        blocks = [block for _, block in source.slabs()]
        assert len(blocks) == n_stripes
        assert all(b.shape == (k, slab) and not b.any() for b in blocks)
        assert stats.timer.intervals.get("gather", []) == []
        assert stats.fetches == 0 and stats.busy_s() == 0.0
        assert stats.snapshot()["gather_stripes"] == n_stripes


def test_streaming_needs_k_survivors(tmp_path):
    present = [i >= 5 for i in range(14)]
    with pytest.raises(ValueError, match="only 9 of 14"):
        encoder.rebuild_ec_files_streaming(
            str(tmp_path / "1"), present, [0, 1, 2, 3, 4], None,
            codec=TorchCodec(10, 4, device="cpu"))
    assert encoder.rebuild_ec_files_streaming(
        str(tmp_path / "1"), [True] * 14, [], None,
        codec=TorchCodec(10, 4, device="cpu")) == []


def test_stage_timer_busy_time_matches_jax():
    rng = np.random.default_rng(3)
    starts = np.sort(rng.uniform(0, 10, 40))
    ivs = [(float(s), float(s + d))
           for s, d in zip(starts, rng.uniform(0.01, 1.5, 40))]
    port, ref = StageTimer(), RefStageTimer()
    for t in (port, ref):
        for i, (s, e) in enumerate(ivs):
            t.add("gather", e - s, 1000 + i, interval=(s, e))
        t.add("other", 0.5, 10)
    assert port.busy_time("gather") == pytest.approx(ref.busy_time("gather"),
                                                     abs=1e-12)
    assert port.busy_time("gather") < port.totals["gather"]
    for use_busy in (False, True):
        assert port.rate_mbps("gather", use_busy) == pytest.approx(
            ref.rate_mbps("gather", use_busy), rel=1e-12)
    assert port.busy_time("other") == ref.busy_time("other") == 0.0
    assert port.rate_mbps("missing") == 0.0
    with port.stage("s", nbytes=5):
        pass
    assert port.bytes["s"] == 5 and len(port.intervals["s"]) == 1


def test_pipeline_pieces_form():
    c = TorchCodec(10, 4, device="cpu")
    rng = np.random.default_rng(0)
    slabs = [(i, rng.integers(0, 256, (10, w), dtype=np.uint8))
             for i, w in enumerate((700, 1024, 33))]
    coeffs = c.matrix[10:]
    plain = list(PipelinedMatmul(coeffs, codec=c, max_width=1024,
                                 timer=StageTimer()).stream(iter(slabs)))
    pieces = list(PipelinedMatmul(coeffs, codec=c, max_width=1024,
                                  timer=StageTimer(),
                                  pieces=True).stream(iter(slabs)))
    for (meta, data, out), (pmeta, pdata, parts) in zip(plain, pieces):
        assert meta == pmeta and data is pdata
        assert len(parts) == 1 and parts[0][0] == 0
        assert np.array_equal(parts[0][1], out)
        assert np.array_equal(out, c.encode(data))
