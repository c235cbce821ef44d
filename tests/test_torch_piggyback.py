"""The port's piggyback layout (plans, window transforms, encode, coupled
rebuild, sidecars) against the JAX package's, byte for byte. Geometry of
test_piggyback.py: LB=4096, SB=512, slab=3000, a 77,003-byte .dat, so the
window-padded tail and the window re-chunking both run. The port runs
TorchCodec(device="cpu"), sync and pipelined; the JAX side runs NumpyCodec
(sync) and TpuCodec (pipelined). Exact: GF(2^8) arithmetic."""

import json
import os

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import layout as ref_layout
from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.ops.rs_tpu import TpuCodec
from seaweedfs_tpu_torch.ec import layout, rebuild_ec_files, to_ext
from seaweedfs_tpu_torch.ec import write_ec_files
from seaweedfs_tpu_torch.ops import codec
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec

LB, SB, SLAB = 4096, 512, 3000
NBYTES = 77_003


def _write_dat(base, seed=11):
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, NBYTES, dtype=np.uint8).tobytes())


def _shards(base, total):
    out = []
    for i in range(total):
        with open(base + to_ext(i), "rb") as f:
            out.append(f.read())
    return out


def _jax_encode(base, k, m, pipelined=False, layout_name="piggyback"):
    _write_dat(base)
    jax_codec = TpuCodec(k, m) if pipelined else RefNumpyCodec(k, m)
    ref_encoder.write_ec_files(base, codec=jax_codec, large_block=LB,
                               small_block=SB, slab=SLAB, pipelined=pipelined,
                               layout=layout_name)
    return _shards(base, k + m)


def _port_encode(base, k, m, pipelined=False, layout_name="piggyback",
                 stats=None):
    _write_dat(base)
    write_ec_files(base, codec=TorchCodec(k, m, device="cpu"),
                   large_block=LB, small_block=SB, slab=SLAB,
                   pipelined=pipelined, layout=layout_name, stats=stats)
    return _shards(base, k + m)


# -- plan layer --------------------------------------------------------------

@pytest.mark.parametrize("k,m,pairs", [(10, 4, None), (6, 3, None),
                                       (20, 4, None), (10, 4, 2)])
def test_plan_fields_match_jax(k, m, pairs):
    port = codec.piggyback_plan(k, m, pairs=pairs)
    ref = ref_codec.piggyback_plan(k, m, pairs=pairs)
    for name in ("k", "m", "npairs", "alpha", "theta_seed", "matrix_kind",
                 "coupled", "repair_frac"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("amat", "cmat", "emat"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert np.array_equal(port.syndrome_rows(), ref.syndrome_rows())
    assert port.emat.shape == (m * port.alpha, k * port.alpha)


@pytest.mark.parametrize("lost", [(0, 3), (10, 13), (0, 7, 12),
                                  (0, 7, 11, 12), (10, 11, 12, 13), (5,)])
def test_decode_plan_matches_jax(lost):
    k, m = 10, 4
    present = tuple(i not in lost for i in range(k + m))
    src, missing, coeffs = codec.piggyback_decode_plan(k, m, present)
    rsrc, rmissing, rcoeffs = ref_codec.piggyback_decode_plan(k, m, present)
    assert list(src) == list(rsrc) and list(missing) == list(rmissing)
    assert np.array_equal(coeffs, rcoeffs)
    assert missing == list(lost)
    assert coeffs.shape == (len(lost) * 32, len(src) * 32)


def test_decode_plan_needs_k_shards():
    present = tuple(i not in (0, 1, 2, 3, 4) for i in range(14))
    with pytest.raises(ValueError, match="too few shards"):
        codec.piggyback_decode_plan(10, 4, present)


@pytest.mark.parametrize("alpha,window", [(32, 512), (8, 512), (4, 64)])
def test_split_merge_match_jax_and_invert(alpha, window):
    rows = np.random.default_rng(alpha).integers(0, 256, (5, 3 * window),
                                                 dtype=np.uint8)
    sub = codec.pb_split(rows, alpha, window)
    assert np.array_equal(sub, ref_codec.pb_split(rows, alpha, window))
    assert sub.shape == (5 * alpha, 3 * window // alpha)
    back = codec.pb_merge(sub, alpha, window)
    assert np.array_equal(back, ref_codec.pb_merge(sub, alpha, window))
    assert np.array_equal(back, rows)
    with pytest.raises(ValueError, match="not aligned"):
        codec.pb_split(rows[:, :window + 1], alpha, window)


def test_supported_and_window_checks():
    for k, m in ((10, 4), (2, 2), (10, 1), (1, 4), (250, 7)):
        assert codec.piggyback_supported(k, m) == \
            ref_codec.piggyback_supported(k, m)
    with pytest.raises(ValueError):
        codec.piggyback_plan(10, 1)
    assert codec.pb_window(SB, 32) == ref_codec.pb_window(SB, 32) == SB
    with pytest.raises(ValueError, match="not divisible by alpha"):
        codec.pb_window(100, 32)


def test_plan_cache_hits_counted():
    before = codec.plan_cache_stats()
    first = codec.piggyback_plan(10, 4)
    assert codec.piggyback_plan(10, 4) is first
    present = tuple(i != 3 for i in range(14))
    plan = codec.piggyback_decode_plan(10, 4, present)
    assert codec.piggyback_decode_plan(10, 4, present) is plan
    after = codec.plan_cache_stats()
    assert after["events"]["hits"] >= before["events"]["hits"] + 2
    assert after["entries"]["piggyback"] >= 1
    assert after["entries"]["piggyback_decode"] >= 1


def test_plan_lru_evicts():
    lru = codec._PlanLRU("t", maxsize=2)
    before = codec.plan_cache_stats()["events"]["evictions"]
    for i in range(3):
        assert lru.get(i, lambda i=i: [i]) == [i]
    assert len(lru) == 2
    assert codec.plan_cache_stats()["events"]["evictions"] == before + 1


# -- encode ------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("k,m", [(10, 4), (6, 3)])
def test_encode_matches_jax(tmp_path, k, m, pipelined):
    want = _jax_encode(str(tmp_path / "ref"), k, m, pipelined=pipelined)
    stats = {}
    got = _port_encode(str(tmp_path / "port"), k, m, pipelined=pipelined,
                       stats=stats)
    assert got == want
    assert stats["layout"] == "piggyback" and stats["backend"] == "cuda"
    assert stats["bitmat_uploads"] == 1 and stats["dispatches"] > 0
    assert sum(stats["phases"].values()) == pytest.approx(stats["stream_s"],
                                                          abs=1e-5)
    assert set(stats["pb_host_s"]) == {"split", "merge"}
    # the sync JAX path agrees with the pipelined one
    if pipelined:
        assert got == _jax_encode(str(tmp_path / "ref_sync"), k, m)


def test_data_shards_equal_flat(tmp_path):
    k, m = 10, 4
    flat = _port_encode(str(tmp_path / "flat"), k, m, layout_name="flat")
    pb = _port_encode(str(tmp_path / "pb"), k, m)
    assert flat[:k] == pb[:k]
    assert all(flat[i] != pb[i] for i in range(k, k + m))


def test_window_not_dividing_large_block_raises(tmp_path):
    base = str(tmp_path / "1")
    _write_dat(base)
    kw = dict(large_block=LB + 256, small_block=SB, slab=SLAB,
              layout="piggyback")
    with pytest.raises(ValueError, match="not divisible"):
        ref_encoder.write_ec_files(base, codec=RefNumpyCodec(10, 4), **kw)
    with pytest.raises(ValueError, match="not divisible"):
        write_ec_files(base, codec=TorchCodec(10, 4, device="cpu"), **kw)


def test_unknown_layout_raises(tmp_path):
    base = str(tmp_path / "1")
    _write_dat(base)
    with pytest.raises(ValueError, match="unknown EC layout"):
        write_ec_files(base, codec=TorchCodec(10, 4, device="cpu"),
                       layout="striped")


# -- coupled rebuild ---------------------------------------------------------

@pytest.mark.parametrize("lost", [(0, 7, 12), (0, 7, 11, 12),
                                  (10, 11, 12, 13)])
def test_coupled_rebuild_matches(tmp_path, lost):
    k, m = 10, 4
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    want = _jax_encode(ref, k, m)
    assert _port_encode(port, k, m) == want
    info = layout.LayoutInfo(layout.LAYOUT_PIGGYBACK, SB, 5)
    for base in (ref, port):
        for sid in lost:
            os.remove(base + to_ext(sid))
    stats = {}
    assert rebuild_ec_files(port, codec=TorchCodec(k, m, device="cpu"),
                            layout=info, stats=stats) == list(lost)
    assert ref_encoder.rebuild_ec_files(
        ref, codec=RefNumpyCodec(k, m),
        layout=ref_layout.LayoutInfo("piggyback", SB, 5)) == list(lost)
    assert _shards(port, k + m) == want
    assert _shards(ref, k + m) == want
    shard = len(want[0])
    assert stats["layout"] == "piggyback"
    n_src = len(codec.piggyback_decode_plan(
        k, m, tuple(i not in lost for i in range(k + m)))[0])
    assert stats["survivor_bytes"] == n_src * shard
    assert stats["rebuilt_bytes"] == len(lost) * shard
    assert stats["dispatches"] == -(-shard // codec_slab())
    assert stats["bitmat_uploads"] == 1
    assert set(stats["phases"]) == {"gather", "plan", "dispatch", "drain",
                                    "write"}
    assert sum(stats["phases"].values()) == pytest.approx(stats["stream_s"],
                                                          abs=1e-5)


def codec_slab():
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_SLAB, _pb_slab
    return _pb_slab(DEFAULT_SLAB, SB)


def test_rebuild_through_sidecars_pairs_pinned(tmp_path):
    """A volume encoded with pairs=2 rebuilds through its own sidecar
    geometry, not the default pair cap."""
    k, m = 10, 4
    base = str(tmp_path / "1")
    _write_dat(base)
    pplan = codec.piggyback_plan(k, m, pairs=2)
    c = TorchCodec(k, m, device="cpu")
    # encode by hand with the pinned plan: split, emat, merge per window
    data = np.frombuffer(open(base + ".dat", "rb").read(), dtype=np.uint8)
    cols = -(-len(data) // (k * SB)) * SB
    padded = np.zeros(k * cols, dtype=np.uint8)
    padded[:len(data)] = data
    rows = padded.reshape(-1, k, SB).transpose(1, 0, 2).reshape(k, cols)
    sub = codec.pb_split(rows, pplan.alpha, SB)
    parity = codec.pb_merge(c._matmul(pplan.emat, sub), pplan.alpha, SB)
    for i, row in enumerate(np.concatenate([rows, parity])):
        with open(base + to_ext(i), "wb") as f:
            f.write(row.tobytes())
    with open(base + ".ecx", "wb") as f:
        f.write(bytes(32))
    layout.write_layout_sidecars(base, "piggyback", SB, 2)
    info = layout.volume_layout(base, k)
    assert (info.window, info.pairs, info.alpha) == (SB, 2, 4)
    want = _shards(base, k + m)
    for sid in (1, 4, 13):
        os.remove(base + to_ext(sid))
    rebuild_ec_files(base, codec=c, layout=info)
    assert _shards(base, k + m) == want


# -- sidecars ----------------------------------------------------------------

def _touch_ecx(base, records=3):
    with open(base + ".ecx", "wb") as f:
        f.write(bytes(range(16 * records)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecars_match_and_cross_read(tmp_path, writer):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    for base in (port, ref):
        _touch_ecx(base)
    extra = dict(version=3, offset_width=4)
    layout.write_layout_sidecars(port, "piggyback", SB, 5, **extra)
    ref_layout.write_layout_sidecars(ref, "piggyback", SB, 5, **extra)
    for ext in (".vif", ".ecx"):
        with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), ext
    base = port if writer == "port" else ref
    for resolve in (layout.volume_layout, ref_layout.volume_layout):
        info = resolve(base, 10)
        assert (info.layout, info.window, info.pairs) == ("piggyback", SB, 5)
    assert layout.read_ecx_tag(base) == "piggyback"
    assert layout.ecx_record_bytes(base + ".ecx", 16) == 48
    assert os.path.getsize(base + ".ecx") == 49
    # marking flat truncates the tag on both sides, byte for byte
    layout.write_layout_sidecars(port, "flat", **extra)
    ref_layout.write_layout_sidecars(ref, "flat", **extra)
    for ext in (".vif", ".ecx"):
        with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), ext
    assert os.path.getsize(port + ".ecx") == 48
    assert layout.volume_layout(port, 10).layout == "flat"
    with open(port + ".vif") as f:
        assert json.load(f) == {"version": 3, "offset_width": 4,
                                "ec_layout": "flat"}


def test_bare_ecx_tag_takes_default_geometry(tmp_path):
    base = str(tmp_path / "1")
    _touch_ecx(base)
    layout.write_ecx_tag(base, "piggyback")
    for resolve in (layout.volume_layout, ref_layout.volume_layout):
        info = resolve(base, 10)
        assert (info.layout, info.window, info.pairs) == \
            ("piggyback", 1 << 20, 5)
    assert layout.volume_layout(str(tmp_path / "none"), 10).layout == "flat"
