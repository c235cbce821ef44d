"""The port's bit-plane GF(2^8) product (seaweedfs_tpu_torch/ops/rs_bitplane.py,
K6a/K6b) held against the TPU kernels it replaces, tools/kernel_exp.make_fn
and make_fn_batched run in Pallas interpret mode, and against the numpy
oracle gf256.mat_mul. Exact: 0/1 operands and integer sums. Tensors here
lie on the CPU, so the wrappers run their plain version; the Hopper kernel
itself is held against that plain version on the card by chip_smoke.py.
This file also checks the byte-major lift (bitmat_from_reference) the
kernel's tile list is cut from, and the device constant built from it;
test_torch_bitplane_plan.py emulates the kernel's walk of that list."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops.rs_pallas import fuse_bitmat as ref_fuse_bitmat
from seaweedfs_tpu.ops.rs_pallas import pick_tile
from seaweedfs_tpu_torch.ops import rs_bitplane
from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K6A, K6B
from seaweedfs_tpu_torch.ops.rs_bitplane import (bitmat_from_reference,
                                                 bitplane_matmul,
                                                 bitplane_matmul_batched,
                                                 block_diag_bitmat,
                                                 fuse_bitmat)
from seaweedfs_tpu_torch.tools import kernel_exp
from tools import kernel_exp as ref_kernel_exp


def _geometry(name):
    """(r, k) coefficient matrices: RS encode rows, a single decode row,
    and the piggyback encode matrix."""
    if name == "pb_emat":
        return ref_codec.piggyback_plan(10, 4).emat
    if name == "row_1x10":
        present = tuple(i != 4 for i in range(14))
        return ref_codec.NumpyCodec(10, 4).lost_row_coeffs(present, 4)[1]
    k, m = {"rs_10_4": (10, 4), "rs_6_3": (6, 3), "rs_20_4": (20, 4)}[name]
    return ref_gf256.build_matrix(k, k + m)[k:]


GEOMETRIES = ["rs_10_4", "rs_6_3", "rs_20_4", "row_1x10", "pb_emat"]
WIDTHS = {"pb_emat": (256, 200)}  # the (128,320) lift at small n


@pytest.fixture
def interpret_pallas(monkeypatch):
    """kernel_exp hard-codes interpret=False; on the CPU the Pallas
    interpreter gives the TPU kernel's semantics."""
    from jax.experimental import pallas as pl
    real = pl.pallas_call

    def pallas_call(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)
    monkeypatch.setattr(pl, "pallas_call", pallas_call)


def _data(k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


def _cases():
    for geo in GEOMETRIES:
        for n in WIDTHS.get(geo, (1024, 1000)):
            yield geo, n


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_fuse_bitmat_matches_pallas(geo):
    coeffs = _geometry(geo)
    assert np.array_equal(fuse_bitmat(coeffs), ref_fuse_bitmat(coeffs))
    assert fuse_bitmat(coeffs).dtype == np.int8


@pytest.mark.parametrize("u", [2, 4])
def test_block_diag_matches_kernel_exp(u):
    bm = fuse_bitmat(_geometry("rs_10_4"))
    assert np.array_equal(block_diag_bitmat(bm, u),
                          ref_kernel_exp.block_diag_bitmat(bm, u))


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("geo,n", list(_cases()))
def test_k6a_matches_make_fn(interpret_pallas, geo, n, dtype):
    import jax.numpy as jnp
    coeffs = _geometry(geo)
    r, k = coeffs.shape
    data = _data(k, n, r * 1000 + n)
    want = ref_gf256.mat_mul(coeffs, data)
    bm = ref_fuse_bitmat(coeffs)
    jdtype = {"int8": jnp.int8, "bf16": jnp.bfloat16,
              "f32": jnp.float32}[dtype]
    fn = ref_kernel_exp.make_fn(k, r, n, pick_tile(k, r, n), jdtype)
    jax_out = np.asarray(fn(jnp.asarray(bm), jnp.asarray(data)))
    port_fn = kernel_exp.make_fn(k, r, n, pick_tile(k, r, n), {
        "int8": torch.int8, "bf16": torch.bfloat16,
        "f32": torch.float32}[dtype])
    got = port_fn(torch.from_numpy(bm), torch.from_numpy(data)).numpy()
    assert np.array_equal(jax_out, want)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("u", [2, 4])
@pytest.mark.parametrize("geo,n", list(_cases()))
def test_k6b_matches_make_fn_batched(interpret_pallas, geo, n, u, dtype):
    import jax.numpy as jnp
    coeffs = _geometry(geo)
    r, k = coeffs.shape
    data = _data(k, n, r * 1000 + n + u)
    want = ref_gf256.mat_mul(coeffs, data)
    big = ref_kernel_exp.block_diag_bitmat(ref_fuse_bitmat(coeffs), u)
    jdtype = {"int8": jnp.int8, "bf16": jnp.bfloat16}[dtype]
    tile = max(256, (pick_tile(k, r, n) // u // 256) * 256)
    fn = ref_kernel_exp.make_fn_batched(k, r, n, tile, u, jdtype)
    jax_out = np.asarray(fn(jnp.asarray(big), jnp.asarray(data)))
    got = kernel_exp.make_fn_batched(k, r, n, tile, u, dtype)(
        torch.from_numpy(big), torch.from_numpy(data)).numpy()
    assert np.array_equal(jax_out, want)
    assert np.array_equal(got, want)


def _emulate_kernel(const, data, r, u, tile=rs_bitplane.TILE):
    """The product in the byte-major order of bitmat_from_reference (rows
    i*8+b, columns j*8+l inside each of the u blocks; zero-padded to 64
    rows and 16 columns), which make_tile_plan sorts and cuts into tiles:
    stacked payload byte g = j*k + jb of column c in tile j, bits spread
    along 8 adjacent contraction rows, & 1, 8 adjacent rows packed into a
    byte."""
    k, n = data.shape
    mp, kp = -(-const.shape[0] // 64) * 64, -(-const.shape[1] // 16) * 16
    a = np.zeros((mp, kp), dtype=np.float64)  # 0/1, sums exact
    a[:const.shape[0], :const.shape[1]] = const
    out = np.zeros((r, n), dtype=np.uint8)
    for col0 in range(0, n, u * tile):
        b = np.zeros((kp, tile), dtype=np.float64)
        for g in range(u * k):
            j, jb = divmod(g, k)
            cols = np.arange(col0 + j * tile, col0 + (j + 1) * tile)
            byte = np.where(cols < n, data[jb, np.minimum(cols, n - 1)], 0)
            for l in range(8):
                b[g * 8 + l] = (byte >> l) & 1
        y = (a @ b).astype(np.int64) & 1
        for rr in range(u * r):
            j, i = divmod(rr, r)
            packed = sum(y[rr * 8 + bit] << bit for bit in range(8))
            cols = np.arange(col0 + j * tile, col0 + (j + 1) * tile)
            keep = cols < n
            out[i, cols[keep]] = packed[keep]
    return out


@pytest.mark.parametrize("geo,n,u", [
    (geo, n, u) for geo, n in (("rs_10_4", 1000), ("rs_6_3", 300),
                               ("row_1x10", 129)) for u in (1, 2, 4)]
    + [("pb_emat", 260, 1)])
def test_bitmat_from_reference_gives_the_product(geo, n, u):
    coeffs = _geometry(geo)
    r, k = coeffs.shape
    data = _data(k, n, n + u)
    lift = ref_fuse_bitmat(coeffs)
    if u > 1:
        lift = ref_kernel_exp.block_diag_bitmat(lift, u)
    const = bitmat_from_reference(lift, u)
    assert const.shape == lift.shape and const.dtype == np.int8
    assert np.array_equal(_emulate_kernel(const, data, r, u),
                          ref_gf256.mat_mul(coeffs, data))
    # the plain version computes the same from the JAX layout
    plain = rs_bitplane.bitplane_plain(torch.from_numpy(lift),
                                       torch.from_numpy(data), r, u).numpy()
    assert np.array_equal(plain, ref_gf256.mat_mul(coeffs, data))


def test_bitmat_from_reference_rejects_bad_shapes():
    with pytest.raises(ValueError):
        bitmat_from_reference(np.zeros((30, 80), dtype=np.int8))
    with pytest.raises(ValueError):
        bitmat_from_reference(np.zeros((32, 80), dtype=np.int8), u=4)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "tf32"])
@pytest.mark.parametrize("u", [1, 2])
def test_device_const_is_padded_byte_major(dtype, u):
    """The constant the kernel uploads: the tile list of
    bitmat_from_reference's byte-major lift (make_tile_plan), its kept
    tiles in the operand type, (kept * nt, depth) and zero past 8k; int32
    chunk, range and row-map tensors on the lift's device."""
    bm = fuse_bitmat(_geometry("rs_6_3"))
    lift = bm if u == 1 else block_diag_bitmat(bm, u)
    const = rs_bitplane._device_const(torch.from_numpy(lift), u, dtype)
    plan = const.plan
    want = rs_bitplane.make_tile_plan(lift, u, dtype)
    assert const.tiles.dtype == rs_bitplane.DTYPES[dtype][1]
    assert tuple(const.tiles.shape) == (plan.kept * plan.nt, plan.kc)
    assert np.array_equal(const.tiles.to(torch.int8).numpy(), want.tiles)
    # r = 3: one 32-row tile per block, 32 deep; 6 payload bytes, 2 chunks
    assert (plan.nt, plan.kc, plan.n_tiles) == (32, 32, u)
    assert plan.chunks_per_block == 2 and plan.kept == 2 * u
    for name in ("tile_chunk", "ntile_ptr", "row_map"):
        t = getattr(const, name)
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert np.array_equal(t.numpy(), getattr(want, name))
    # the second chunk holds bytes 4, 5 and 2 bytes of padding
    q = rs_bitplane.k_order(dtype, plan.kc) // 8
    last = want.tile_chunk % plan.chunks_per_block == 1
    tiles = want.tiles.reshape(-1, plan.nt, plan.kc)
    assert not tiles[last][:, :, q >= 2].any()
    assert tiles[last][:, :, q < 2].any()


def test_cpu_tensors_never_launch():
    before = (DEVICE_STATS.launch_count(K6A),
              DEVICE_STATS.launch_count(K6B))
    calls = DEVICE_STATS.snapshot()["dispatches"]
    coeffs = _geometry("rs_10_4")
    bm = fuse_bitmat(coeffs)
    data = torch.from_numpy(_data(10, 500, 1))
    for dtype in ("int8", "bf16", "tf32"):
        bitplane_matmul(torch.from_numpy(bm), data, 4, dtype)
    for u in (2, 4):
        bitplane_matmul_batched(torch.from_numpy(block_diag_bitmat(bm, u)),
                                data, 4, u, "bf16")
    assert (DEVICE_STATS.launch_count(K6A),
            DEVICE_STATS.launch_count(K6B)) == before == (0, 0)
    # each call one dispatch of its entry, the plain version
    now = DEVICE_STATS.snapshot()["dispatches"]
    assert (now[K6A] - calls.get(K6A, 0), now[K6B] - calls.get(K6B, 0)) \
        == (3, 2)
    assert rs_bitplane._lib is None  # nothing was built or loaded


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract is not testable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_exp.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_exp.run_table(_geometry("rs_10_4"), 1024)
    with pytest.raises(RuntimeError, match="no CPU mode"):
        kernel_exp.run_table(_geometry("rs_10_4"), 1024, device="cpu")


def test_wrapper_rejects_bad_inputs():
    bm = torch.from_numpy(fuse_bitmat(_geometry("rs_10_4")))
    data = torch.zeros((10, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        bitplane_matmul(bm, data, 3)                      # r does not fit
    with pytest.raises(ValueError):
        bitplane_matmul(bm, data, 4, "fp8")               # unknown type
    with pytest.raises(ValueError):
        bitplane_matmul(bm.to(torch.uint8), data, 4)      # lift type
    with pytest.raises(ValueError):
        bitplane_matmul(bm, data.to(torch.int32), 4)      # payload type
    with pytest.raises(ValueError):
        bitplane_matmul_batched(bm, data, 4, 3)           # u not 2 or 4
    with pytest.raises(ValueError):
        bitplane_matmul_batched(bm, data, 4, 2)           # not block-sized
    with pytest.raises(ValueError):
        bitplane_matmul(bm.to("meta"), data.to("meta"), 4)
    with pytest.raises(ValueError):
        kernel_exp.make_fn(10, 4, 16, 128, torch.float16)
    with pytest.raises(ValueError):
        kernel_exp.make_fn(10, 4, 32, 128, "int8")(bm, data)  # n differs


def test_ragged_and_empty_widths():
    coeffs = _geometry("rs_6_3")
    bm = torch.from_numpy(fuse_bitmat(coeffs))
    for n in (1, 127, 128, 129, 257):
        data = _data(6, n, n)
        got = bitplane_matmul(bm, torch.from_numpy(data), 3).numpy()
        assert np.array_equal(got, ref_gf256.mat_mul(coeffs, data))
    empty = bitplane_matmul(bm, torch.zeros((6, 0), dtype=torch.uint8), 3)
    assert tuple(empty.shape) == (3, 0)


@pytest.mark.parametrize("shape,u,dtype,want_ms,want_by", [
    ((4, 10, 8 << 20), 1, None, 0.0351, "bytes"),
    ((4, 10, 8 << 20), 1, "int8", 0.0351, "bytes"),
    ((4, 10, 8 << 20), 1, "bf16", 0.0434, "bf16 ops"),
    ((4, 10, 8 << 20), 1, "tf32", 0.0868, "tf32 ops"),
    ((128, 320, 262_144), 1, "int8", 0.694, "int8 ops"),
    ((128, 320, 262_144), 1, "bf16", 1.390, "bf16 ops"),
    ((128, 320, 262_144), 1, "tf32", 2.777, "tf32 ops"),
    ((128, 320, 262_144), 4, "int8", 2.778, "int8 ops"),
])
def test_bounds(shape, u, dtype, want_ms, want_by):
    """The bounds chip_smoke.py reports: the larger of bytes at 3.35 TB/s
    and u * 2 * 8r * 8k * n operations at the type's dense peak."""
    ms, by = kernel_exp.bound(*shape, u=u, dtype=dtype)
    assert ms == pytest.approx(want_ms, abs=6e-4)
    assert by == want_by


@pytest.mark.parametrize("geo,shape,u,dtype,want_ms,want_by", [
    # (4,10): 3 tiles of 32 rows by 32 (10 payload bytes in chunks of 4)
    ("rs_10_4", (4, 10, 8 << 20), 1, "int8", 0.0351, "bytes"),
    ("rs_10_4", (4, 10, 8 << 20), 1, "bf16", 0.0521, "bf16 ops"),
    ("rs_10_4", (4, 10, 8 << 20), 1, "tf32", 0.1041, "tf32 ops"),
    ("rs_10_4", (4, 10, 8 << 20), 4, "int8", 0.0351, "bytes"),
    # the piggyback emat: 48 of 160 tiles of 256 rows by 64
    ("pb_emat", (128, 320, 262_144), 1, "int8", 0.2084, "int8 ops"),
    ("pb_emat", (128, 320, 262_144), 1, "bf16", 0.4169, "bf16 ops"),
    ("pb_emat", (128, 320, 262_144), 1, "tf32", 0.8330, "tf32 ops"),
    ("pb_emat", (128, 320, 262_144), 2, "bf16", 0.4169, "bf16 ops"),
    ("pb_emat", (128, 320, 262_144), 4, "int8", 0.2084, "int8 ops"),
])
def test_tile_bounds(geo, shape, u, dtype, want_ms, want_by):
    """The tile bound: the operations of the kept lift tiles
    (TilePlan.ops_per_column per stacked column, n / u of them) at the
    type's dense peak, or the bytes; K6b's equals K6a's."""
    lift = fuse_bitmat(_geometry(geo))
    if u > 1:
        lift = block_diag_bitmat(lift, u)
    plan = rs_bitplane.make_tile_plan(lift, u, dtype)
    ms, by = kernel_exp.bound(*shape, u=u, dtype=dtype,
                              ops_per_column=plan.ops_per_column)
    assert ms == pytest.approx(want_ms, abs=6e-4)
    assert by == want_by


@pytest.mark.parametrize("geo,shape,u,dtype,want_ms,want_by", [
    # (4,10): 1224 ones of 2560
    ("rs_10_4", (4, 10, 8 << 20), 1, "int8", 0.0351, "bytes"),
    ("rs_10_4", (4, 10, 8 << 20), 1, "bf16", 0.0351, "bytes"),
    ("rs_10_4", (4, 10, 8 << 20), 1, "tf32", 0.0415, "tf32 ops"),
    ("rs_10_4", (4, 10, 8 << 20), 4, "bf16", 0.0351, "bytes"),
    # the piggyback emat: 59,568 ones of 2,621,440
    ("pb_emat", (128, 320, 262_144), 1, "int8", 0.0351, "bytes"),
    ("pb_emat", (128, 320, 262_144), 1, "bf16", 0.0351, "bytes"),
    ("pb_emat", (128, 320, 262_144), 1, "tf32", 0.0631, "tf32 ops"),
    ("pb_emat", (128, 320, 262_144), 2, "int8", 0.0351, "bytes"),
    ("pb_emat", (128, 320, 262_144), 4, "bf16", 0.0351, "bytes"),
])
def test_function_bounds(geo, shape, u, dtype, want_ms, want_by):
    """The bound reported as bound_ms: the function's own, a multiply-add
    per one of the lift (TilePlan.least_ops_per_column) at the type's
    peak, or the bytes; the same for every u, since K6b's block-diagonal
    lift holds u times the ones over n / u stacked columns."""
    lift = fuse_bitmat(_geometry(geo))
    ones = int(np.count_nonzero(lift))
    if u > 1:
        lift = block_diag_bitmat(lift, u)
    plan = rs_bitplane.make_tile_plan(lift, u, dtype)
    assert plan.ones == u * ones
    ms, by = kernel_exp.bound(*shape, u=u, dtype=dtype,
                              ops_per_column=plan.least_ops_per_column)
    assert ms == pytest.approx(want_ms, abs=6e-4)
    assert by == want_by
    # it never exceeds the tile bound, which never exceeds the dense one
    tile_ms, _ = kernel_exp.bound(*shape, u=u, dtype=dtype,
                                  ops_per_column=plan.ops_per_column)
    dense_ms, _ = kernel_exp.bound(*shape, u=u, dtype=dtype)
    assert ms <= tile_ms
    assert tile_ms <= dense_ms or geo == "rs_10_4"  # 32-deep tiles pad 10 B


def test_parts_tool_shapes_and_masks():
    """tools/bitplane_parts times the kernel_exp shapes, and its masks
    use only the three bits gf_bitplane.cu reads (GF_BP_SKIP), mask 0
    (the port's own build) among them."""
    from seaweedfs_tpu_torch.tools import bitplane_parts
    assert 0 in bitplane_parts.SKIPS
    assert all(0 <= mask <= 7 for mask in bitplane_parts.SKIPS)
    source = rs_bitplane.SOURCE.read_text()
    for bit in (1, 2, 4):
        assert f"GF_BP_SKIP & {bit}" in source
    got = {label: (c.shape, n) for label, c, n in bitplane_parts.shapes()}
    pb = ref_codec.piggyback_plan(10, 4).emat
    assert got == {"(4,10)x8MiB": ((4, 10), 8 << 20),
                   "(128,320)x262144": (pb.shape, 262_144)}
    flat = dict((label, c) for label, c, _ in bitplane_parts.shapes())
    assert np.array_equal(flat["(4,10)x8MiB"],
                          ref_gf256.build_matrix(10, 14)[10:])
    assert np.array_equal(flat["(128,320)x262144"], pb)
