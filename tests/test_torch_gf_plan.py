"""The tile plan behind the port's GF(2^8) kernel (ops/gf_plan.make_plan,
csrc/gf_matmul.cu). A plain PyTorch emulation of what the kernel computes
from a plan -- packed 4-row nibble tables, the listed input rows of each
tile, the 4x4 byte transposes of its epilogue and the row map -- is held
against the TPU kernel it replaces (rs_pallas.fused_matmul in interpret
mode, at narrow widths) and against the numpy oracle, over the geometries
the system sends. Also the plan's structure, and the codec's constant.
The tolerance is exact: all arithmetic is in GF(2^8)."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.ops.codec import host_matmul
from seaweedfs_tpu.ops.rs_pallas import fused_matmul
from seaweedfs_tpu_torch.ops import gf_plan, rs_hopper, telemetry
from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K1
from seaweedfs_tpu_torch.ops.gf_plan import GfPlan, make_plan
from seaweedfs_tpu_torch.ops.rs_hopper import gf_matmul
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec


@pytest.fixture(autouse=True)
def jax_device_stats(monkeypatch):
    """The JAX programs compiled here at many shapes count their compiles
    and recompiles in a DeviceStats of their own: the process-wide one is
    read by the JAX package's own tests (its recompile sentinel must not
    have latched), which may run later in this process."""
    from seaweedfs_tpu.ops import device_stats as ref_device_stats
    monkeypatch.setattr(ref_device_stats, "DEVICE_STATS",
                        ref_device_stats.DeviceStats())


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on int64 tensors holding uint32 words: byte i
    of the result is byte (sel >> 4i) & 7 of the 8-byte value y:x."""
    out = torch.zeros_like(x)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        src = x if s < 4 else y
        out |= ((src >> (8 * (s & 3))) & 0xFF) << (8 * i)
    return out


def _xor_rows(x):
    """XOR of the rows of a 2-D int64 tensor."""
    while x.shape[0] > 1:
        if x.shape[0] & 1:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = x[0::2] ^ x[1::2]
    return x[0]


def gf_matmul_planned_reference(plan: GfPlan, data: torch.Tensor):
    """What csrc/gf_matmul.cu computes from a plan, in plain PyTorch: per
    tile, its pairs staged 128 at a time (128 bytes each, as in shared
    memory); every payload byte b looked up as lo[b & 15] ^ hi[b >> 4] at
    the byte offsets the kernel builds (tagged nibble offsets spliced onto
    the pair's segment with __byte_perm) and XORed into one packed 4-row
    accumulator word per column; then the kernel's 4x4 transposes (the same
    __byte_perm selectors) and the row map."""
    r, n = plan.r, data.shape[1]
    npad = -(-n // 4) * 4
    d = torch.zeros((plan.k, npad), dtype=torch.int64)
    d[:, :n] = data.to(torch.int64)
    # the payload as the kernel reads it: 4 column bytes per word
    w = (d.view(plan.k, -1, 4) << torch.arange(0, 32, 8)).sum(dim=2)
    tables = plan.tables.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros((r, npad), dtype=torch.uint8)
    for t in range(plan.tiles):
        acc = torch.zeros((npad // 4, 4), dtype=torch.int64)
        p0, p1 = int(plan.tile_ptr[t]), int(plan.tile_ptr[t + 1])
        for c0 in range(p0, p1, 128):
            cn = min(128, p1 - c0)
            smem = tables[c0:c0 + cn].reshape(-1)
            q = torch.arange(cn)[:, None]  # staged pair index
            tag = torch.where(q & 1 == 1, 0x80808080, 0)
            seg = ((q >> 1) << 8).expand(cn, w.shape[1])
            wq = w[plan.pair_rows[c0:c0 + cn].long()]
            lo = ((wq << 2) & 0x3C3C3C3C) | tag
            hi = ((wq >> 2) & 0x3C3C3C3C) | tag | 0x40404040
            for b in range(4):
                sel = 0x7650 + b
                acc[:, b] ^= _xor_rows(smem[_byte_perm(lo, seg, sel) >> 2] ^
                                       smem[_byte_perm(hi, seg, sel) >> 2])
        a0, a1, a2, a3 = acc.unbind(1)
        t01, t23 = _byte_perm(a0, a1, 0x5140), _byte_perm(a2, a3, 0x5140)
        u01, u23 = _byte_perm(a0, a1, 0x7362), _byte_perm(a2, a3, 0x7362)
        rows = (_byte_perm(t01, t23, 0x5410), _byte_perm(t01, t23, 0x7632),
                _byte_perm(u01, u23, 0x5410), _byte_perm(u01, u23, 0x7632))
        for i, word in enumerate(rows):
            slot = 4 * t + i
            if slot < r:
                cols = torch.stack([(word >> (8 * c)) & 0xFF
                                    for c in range(4)], dim=1)
                out[int(plan.row_map[slot])] = cols.reshape(-1).to(
                    torch.uint8)
    return out[:, :n]


def _random_sparse():
    """(130, 300) with an all-zero row, an all-zero 4-row tile (rows
    sharing one pattern: all zero) and an all-zero input column."""
    rng = np.random.default_rng(5)
    c = rng.integers(0, 256, (130, 300), dtype=np.uint8)
    c[rng.random((130, 300)) < 0.6] = 0
    c[17] = 0
    c[40:44] = 0
    c[:, 123] = 0
    c[90, :5] = 1
    return c


def _geometry(name):
    if name.startswith("encode"):
        _, k, m, kind = name.split("_")
        k, m = int(k), int(m)
        return ref_gf256.build_matrix(k, k + m, kind)[k:]
    if name == "decode_10_4_lost_0_3_11_13":
        lost = (0, 3, 11, 13)
        return RefNumpyCodec(10, 4).decode_plan(
            tuple(i not in lost for i in range(14)))[2]
    if name == "row_1_10":
        present = tuple(i != 4 for i in range(14))
        return RefNumpyCodec(10, 4).lost_row_coeffs(present, 4)[1]
    if name.startswith("pb_emat"):
        k = int(name.split("_")[2])
        return ref_codec.piggyback_plan(k, 4, pairs=5).emat
    if name.startswith("pb_decode"):
        lost = tuple(int(s) for s in name.split("_")[2:])
        return ref_codec.piggyback_decode_plan(
            10, 4, tuple(i not in lost for i in range(14)), pairs=5)[2]
    if name == "random_5_12":  # r = 5: one full tile and a 1-row tail
        c = np.random.default_rng(9).integers(0, 256, (5, 12),
                                              dtype=np.uint8)
        c[2, 3:] = 0
        return c
    if name == "random_130_300":
        return _random_sparse()
    raise KeyError(name)


GEOMETRIES = (
    [f"encode_{k}_{m}_{kind}" for k, m in ((10, 4), (6, 3), (20, 4))
     for kind in ("vandermonde", "cauchy")]
    + ["decode_10_4_lost_0_3_11_13", "row_1_10", "pb_emat_10", "pb_emat_20",
       "pb_decode_0_7_11_12", "pb_decode_1_6_10_11", "pb_decode_0_1_2_3",
       "pb_decode_10_11_12_13", "random_5_12", "random_130_300"])
WIDTHS = (1, 127, 129, 4407)


def _data(k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", GEOMETRIES)
def test_emulation_matches_oracle(name, n):
    coeffs = _geometry(name)
    data = _data(coeffs.shape[1], n, n + len(name))
    got = gf_matmul_planned_reference(make_plan(coeffs),
                                      torch.from_numpy(data)).numpy()
    assert np.array_equal(got, host_matmul(coeffs, data))


@pytest.mark.parametrize("name", GEOMETRIES)
def test_emulation_matches_pallas(name):
    """Against the TPU kernel in interpret mode, at a narrow ragged width
    (and at width 1 for the flat shapes)."""
    coeffs = _geometry(name)
    for n in (129,) if coeffs.shape[0] > 8 else (1, 129):
        data = _data(coeffs.shape[1], n, 3 * n)
        got = gf_matmul_planned_reference(make_plan(coeffs),
                                          torch.from_numpy(data)).numpy()
        pallas = np.asarray(fused_matmul(coeffs, data, interpret=True))
        assert np.array_equal(got, pallas), n


@pytest.mark.parametrize("name", GEOMETRIES)
def test_plan_structure(name):
    coeffs = _geometry(name)
    plan = make_plan(coeffs)
    r, k = coeffs.shape
    assert (plan.r, plan.k) == (r, k)
    assert plan.tiles == -(-r // 4) and 1 <= plan.last_rows <= 4
    row_map = plan.row_map.numpy()
    assert sorted(row_map.tolist()) == list(range(r))  # a permutation
    # rows are sorted by pattern, stably
    keys = [(coeffs[i] != 0).tobytes() for i in row_map]
    assert keys == sorted(keys)
    assert all(row_map[p] < row_map[p + 1] for p in range(r - 1)
               if keys[p] == keys[p + 1])
    ptr = plan.tile_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == plan.pairs and np.all(np.diff(ptr) >= 0)
    pair_rows = plan.pair_rows.numpy()
    covered = np.zeros((r, k), dtype=np.int64)
    for t in range(plan.tiles):
        rows = row_map[4 * t:4 * t + 4]
        listed = pair_rows[ptr[t]:ptr[t + 1]]
        # exactly the input rows with a non-zero coefficient in the tile,
        # ascending, each once
        want = np.nonzero((coeffs[rows] != 0).any(axis=0))[0]
        assert np.array_equal(listed, want)
        for i in rows:
            covered[i, listed] += 1
    # every non-zero coefficient is covered once
    assert np.all(covered[coeffs != 0] == 1)
    assert plan.table_bytes == plan.pairs * 128


@pytest.mark.parametrize("name", ["encode_10_4_vandermonde", "pb_emat_10",
                                  "pb_decode_0_7_11_12", "random_5_12",
                                  "random_130_300"])
def test_table_words_are_products(name):
    """Word x of a pair packs c_i * x, word 16 + x packs c_i * (x << 4),
    slot i in byte i, zero bytes for a missing tail row: held against the
    JAX package's MUL_TABLE."""
    coeffs = _geometry(name)
    plan = make_plan(coeffs)
    tables = plan.tables.numpy().view(np.uint32)
    row_map, ptr = plan.row_map.numpy(), plan.tile_ptr.numpy()
    x = np.arange(16)
    for t in range(plan.tiles):
        rows = row_map[4 * t:4 * t + 4]
        for p in range(ptr[t], ptr[t + 1]):
            j = plan.pair_rows[p].item()
            for i in range(4):
                byte = (tables[p] >> np.uint32(8 * i)) & 0xFF
                if i < len(rows):
                    c = coeffs[rows[i], j]
                    want = np.concatenate([ref_gf256.MUL_TABLE[c, x],
                                           ref_gf256.MUL_TABLE[c, x << 4]])
                else:
                    want = np.zeros(32)
                assert np.array_equal(byte, want), (t, p, i)


@pytest.mark.parametrize("k", [10, 20])
def test_piggyback_emat_tiles_share_support(k):
    """The 4 parities of one sub-stripe share their input rows, so every
    tile of the emat lists exactly one row's non-zeros: 15 for RS(10,4),
    480 pairs in all, the payload read 1.5 times over."""
    emat = _geometry(f"pb_emat_{k}")
    plan = make_plan(emat)
    per_row = np.count_nonzero(emat, axis=1)
    assert np.all(per_row == per_row[0])
    counts = np.diff(plan.tile_ptr.numpy())
    assert np.all(counts == per_row[0])
    if k == 10:
        assert per_row[0] == 15
        assert plan.tiles == 32 and plan.pairs == 480
        assert plan.summary()["payload_reads"] == 1.5
        assert plan.table_bytes == 61_440


def test_zero_rows_and_empty_tiles():
    coeffs = _random_sparse()
    plan = make_plan(coeffs)
    counts = np.diff(plan.tile_ptr.numpy())
    assert counts.min() == 0  # the all-zero rows sort into an empty tile
    assert 123 not in plan.pair_rows.numpy()  # the all-zero input column
    data = _data(300, 129, 1)
    got = gf_matmul_planned_reference(plan, torch.from_numpy(data)).numpy()
    assert not got[17].any() and not got[40:44].any()
    assert np.array_equal(got, host_matmul(coeffs, data))


def test_plan_accepts_a_cpu_tensor_and_moves_whole():
    coeffs = _geometry("encode_6_3_cauchy")
    a, b = make_plan(coeffs), make_plan(torch.from_numpy(coeffs))
    for name in ("coeffs", "row_map", "tile_ptr", "pair_rows", "tables"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    moved = a.to("cpu")
    assert moved.device.type == "cpu" and moved.pairs == a.pairs
    with pytest.raises(ValueError):
        make_plan(np.zeros(4, dtype=np.uint8))


@pytest.mark.parametrize("field", ["row_map", "tile_ptr", "pair_rows",
                                   "tables"])
def test_plan_rejects_a_tensor_the_kernel_cannot_read(field):
    """A plan is checked once, when it is made: every tensor the kernel
    reads is contiguous int32 on the coefficients' device."""
    plan = make_plan(_geometry("pb_emat_10"))
    parts = {name: getattr(plan, name) for name in (
        "coeffs", "row_map", "tile_ptr", "pair_rows", "tables")}
    good = parts[field]
    for bad in (good.to(torch.int64), good.to("meta")):
        with pytest.raises(ValueError, match="plan tensors"):
            GfPlan(**(parts | {field: bad}))
    if good.dim() == 2:
        with pytest.raises(ValueError, match="plan tensors"):
            GfPlan(**(parts | {field: good.t()}))


def test_gf_matmul_takes_a_plan_on_the_cpu():
    """A CPU plan runs the plain version (with the plan's coefficients)
    and never loads or launches the kernel."""
    before = DEVICE_STATS.launch_count(K1)
    calls = DEVICE_STATS.snapshot()["dispatches"].get(K1, 0)
    coeffs = _geometry("pb_decode_0_7_11_12")
    data = _data(coeffs.shape[1], 300, 2)
    got = gf_matmul(make_plan(coeffs), torch.from_numpy(data)).numpy()
    assert np.array_equal(got, host_matmul(coeffs, data))
    assert DEVICE_STATS.launch_count(K1) == before == 0
    # one call, the plain one
    assert DEVICE_STATS.snapshot()["dispatches"][K1] == calls + 1
    assert rs_hopper._lib is None
    with pytest.raises(ValueError):  # k does not match
        gf_matmul(make_plan(coeffs), torch.zeros((3, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):  # plan on the CPU, data elsewhere
        gf_matmul(make_plan(coeffs),
                  torch.zeros((320, 8), dtype=torch.uint8, device="meta"))


def test_codec_caches_one_plan_per_matrix():
    codec = TorchCodec(10, 4, device="cpu", chunk_bytes=1024,
                       small_dispatch_bytes=0)
    parity = codec.matrix[10:]
    fn, plan, _ = codec.device_fn(parity, 4096)
    assert fn is gf_matmul and isinstance(plan, gf_plan.GfPlan)
    assert plan.device.type == "cpu"
    assert np.array_equal(plan.coeffs.numpy(), parity)
    assert codec.device_fn(parity, 512)[1] is plan  # any width, one plan
    data = _data(10, 5000, 4)
    before = telemetry.STATS.snapshot()
    got = codec.encode(data)  # 5 chunked slabs
    moved = telemetry.delta(before)
    assert np.array_equal(got, RefNumpyCodec(10, 4).encode(data))
    assert moved["dispatches"] == 5 and moved["bitmat_uploads"] == 0
    # a fresh codec: one upload across repeated slabs of one matrix, one
    # more for a second matrix
    fresh = TorchCodec(10, 4, device="cpu", chunk_bytes=1024,
                       small_dispatch_bytes=0)
    shards = list(RefNumpyCodec(10, 4).encode_to_all(data))
    shards[2] = None
    before = telemetry.STATS.snapshot()
    fresh.encode(data)
    fresh.encode(data)
    assert telemetry.delta(before)["bitmat_uploads"] == 1
    got = fresh.reconstruct(list(shards))
    fresh.reconstruct(list(shards))
    assert np.array_equal(got[2], data[2])
    moved = telemetry.delta(before)
    assert moved["bitmat_uploads"] == 2 and moved["dispatches"] == 20
    assert rs_hopper._lib is None
