"""The bit-plane kernel's tile list (seaweedfs_tpu_torch/ops/rs_bitplane.py,
make_tile_plan) and a PyTorch emulation of what csrc/gf_bitplane.cu
computes from it, held against the TPU kernels it replaces
(tools/kernel_exp.make_fn / make_fn_batched, in Pallas interpret mode) and
against the numpy oracle (codec.host_matmul). Exact: 0/1 operands and
integer sums.

The emulation walks the kernel's loops: column tiles of u * 128 columns;
per contraction chunk the kc / 8 raw payload bytes of each column (kc =
32 under 32-row tiles, 64 under 256-row ones); per thread the A fragment
built from 2 or 4 of those bytes as the kernel's Op::frag does, placed by
CuTe's register layouts of wgmma's A operand (ALayout_64x32 s8, 64x16
bf16, 64x8 tf32); only the kept lift tiles; the accumulator read through
the 64xN C layout and packed with shifts and ORs; slots written through
the row map."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec as ref_codec
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops.rs_pallas import fuse_bitmat as ref_fuse_bitmat
from seaweedfs_tpu.ops.rs_pallas import pick_tile
from seaweedfs_tpu_torch.ops import rs_bitplane
from seaweedfs_tpu_torch.ops.codec import host_matmul
from seaweedfs_tpu_torch.ops.rs_bitplane import (TILE, bitmat_from_reference,
                                                 block_diag_bitmat, k_order,
                                                 make_tile_plan, n_order)
from tools import kernel_exp as ref_kernel_exp

ONE_BF16, ONE_F32 = 0x3F80, 0x3F800000
#: contraction rows per wgmma step: k32 s8, k16 bf16, k8 tf32
STEP_K = {"int8": 32, "bf16": 16, "tf32": 8}


def _geometry(name):
    if name == "pb_emat":
        return ref_codec.piggyback_plan(10, 4).emat
    if name.startswith("pb_dec"):
        lost = tuple(int(x) for x in name.split("_")[2:])
        return ref_codec.piggyback_decode_plan(
            10, 4, tuple(i not in lost for i in range(14)))[2]
    k, m = {"rs_10_4": (10, 4), "rs_6_3": (6, 3), "rs_20_4": (20, 4)}[name]
    return ref_gf256.build_matrix(k, k + m)[k:]


GEOMETRIES = ["rs_10_4", "rs_6_3", "rs_20_4", "pb_emat", "pb_dec_0_7_11_12",
              "pb_dec_1_6_10_11"]
VARIANTS = [(1, "int8"), (1, "bf16"), (1, "tf32"), (2, "int8"), (2, "bf16"),
            (4, "int8"), (4, "bf16")]
WIDTHS = (1, 129, 4407)


def _lift(coeffs, u):
    bm = rs_bitplane.fuse_bitmat(coeffs)
    return bm if u == 1 else block_diag_bitmat(bm, u)


def _data(k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


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


# -- the emulation ---------------------------------------------------------

def _threads():
    """(wg, warp, g, tq) of the 256 consumer threads, and each thread's
    first column in the block (the kernel's mcol)."""
    tid = torch.arange(256)
    wg, warp, lane = tid // 128, (tid % 128) // 32, tid % 32
    g, tq = lane // 4, lane % 4
    return wg, warp, g, tq, wg * 64 + warp * 16 + g


def _frag(dtype, sub, x, y):
    """The kernel's Op::frag: the 4 A registers of one step from payload
    byte x (row g) and y (row g + 8), as uint32 values in int64."""
    if dtype == "int8":
        def spread4(nib):
            return (nib * 0x00204081) & 0x01010101
        return [spread4(x & 15), spread4(y & 15), spread4(x >> 4),
                spread4(y >> 4)]
    if dtype == "bf16":
        def pair(v):
            return ((v & 1) | ((v & 2) << 15)) * ONE_BF16
        h = 4 * sub
        return [pair(x >> h), pair(y >> h), pair(x >> (h + 2)),
                pair(y >> (h + 2))]
    l = 2 * sub
    return [((x >> l) & 1) * ONE_F32, ((y >> l) & 1) * ONE_F32,
            ((x >> (l + 1)) & 1) * ONE_F32, ((y >> (l + 1)) & 1) * ONE_F32]


def _a_layout(dtype, warp, g, tq, reg, elem):
    """CuTe's ALayout_64x32 / 64x16 / 64x8: value v of a thread (v = reg *
    elems + elem) -> (row m within the 64, k within the step)."""
    if dtype == "int8":
        v = 4 * reg + elem
        v0, v1, v2 = v % 4, (v // 4) % 2, v // 8
        return 16 * warp + g + 8 * v1, 4 * tq + v0 + 16 * v2
    if dtype == "bf16":
        v = 2 * reg + elem
        v0, v1, v2 = v % 2, (v // 2) % 2, v // 4
        return 16 * warp + g + 8 * v1, 2 * tq + v0 + 8 * v2
    v0, v1 = reg % 2, reg // 2
    return 16 * warp + g + 8 * v0, tq + 4 * v1


def _decode(dtype, regval, elem):
    """One element of a register as 0/1; anything else is a fault."""
    if dtype == "int8":
        val = (regval >> (8 * elem)) & 0xFF
        one = 1
    elif dtype == "bf16":
        val = (regval >> (16 * elem)) & 0xFFFF
        one = ONE_BF16
    else:
        val, one = regval, ONE_F32
    assert bool(((val == 0) | (val == one)).all())
    return (val == one).to(torch.float32)


def emulate(plan, data: np.ndarray) -> np.ndarray:
    """What the kernel writes for ``data`` (k, n) from ``plan``."""
    k, n = data.shape
    u, r, nt, dtype, kc = plan.u, plan.r, plan.nt, plan.dtype, plan.kc
    cpb, width = plan.chunks_per_block, STEP_K[dtype]
    rows = kc // 8                      # payload bytes per chunk
    per = u * TILE
    cts = -(-n // per)
    padded = torch.zeros((cpb * rows, cts * per), dtype=torch.int64)
    padded[:k, :n] = torch.from_numpy(data.astype(np.int64))
    # pay[ct, chunk, q, m]: chunk = block * cpb + c, rows rows*c + q of
    # column tile ct's block-th 128 columns, as the producer lands them
    pay = padded.view(cpb, rows, cts, u, TILE).permute(2, 3, 0, 1, 4) \
        .reshape(cts, u * cpb, rows, TILE)
    wg, warp, g, tq, mcol = _threads()
    x0, y0 = pay[:, :, tq, mcol], pay[:, :, tq, mcol + 8]
    if kc == 64:
        x1, y1 = pay[:, :, 4 + tq, mcol], pay[:, :, 4 + tq, mcol + 8]
    a = torch.zeros((cts, u * cpb, TILE, kc), dtype=torch.float32)
    elems = {"int8": 4, "bf16": 2, "tf32": 1}[dtype]
    half = 32 // width                  # steps per 32 contraction rows
    for s in range(kc // width):
        regs = _frag(dtype, s % half, *((x0, y0) if s < half else (x1, y1)))
        for reg in range(4):
            for elem in range(elems):
                m, kk = _a_layout(dtype, warp, g, tq, reg, elem)
                a[:, :, wg * 64 + m, s * width + kk] = \
                    _decode(dtype, regs[reg], elem)
    out = np.zeros((r, n), dtype=np.uint8)
    tiles = torch.from_numpy(plan.tiles.astype(np.float32)).view(-1, nt, kc)
    slots = nt // 8
    for t in range(plan.n_tiles):
        acc = torch.zeros((cts, TILE, nt), dtype=torch.float32)
        for e in range(plan.ntile_ptr[t], plan.ntile_ptr[t + 1]):
            acc += a[:, plan.tile_chunk[e]] @ tiles[e].T
        bits = acc.to(torch.int64) & 1
        # C layout: value 4*v2 + 2*v1 + v0 at (m = 16w + g + 8v1,
        # n = 8v2 + 2tq + v0); bits 2a + v0 of slot 4B + tq from v2 = 4B+a
        for b4 in range(nt // 32):
            for v1 in range(2):
                byte = torch.zeros((cts, 256), dtype=torch.int64)
                for a2 in range(4):
                    for v0 in range(2):
                        col_n = 8 * (4 * b4 + a2) + 2 * tq + v0
                        byte |= bits[:, mcol + 8 * v1, col_n] << (2 * a2 + v0)
                rr = torch.from_numpy(plan.row_map[t * slots:(t + 1) * slots]
                                      .astype(np.int64))[4 * b4 + tq]
                j, i = rr // r, rr % r
                col = (torch.arange(cts)[:, None] * per + j * TILE + mcol
                       + 8 * v1)
                keep = (rr >= 0) & (col < n)
                out[i.expand_as(col)[keep].numpy(), col[keep].numpy()] = \
                    byte[keep].numpy()
    return out


# -- the emulation against the TPU kernel and the oracle ---------------------

_PALLAS = {}


def _pallas(geo, data, u):
    """make_fn (u = 1) or make_fn_batched in interpret mode, int8 dots,
    once per geometry, width and u: every dot type gives the same bytes
    (test_torch_bitplane.py holds each type against the oracle)."""
    key = (geo, data.shape[1], u)
    if key not in _PALLAS:
        _PALLAS[key] = _run_pallas(_geometry(geo), data, u)
    return _PALLAS[key]


def _run_pallas(coeffs, data, u):
    import jax.numpy as jnp
    r, k = coeffs.shape
    n = data.shape[1]
    jdtype = jnp.int8
    bm = ref_fuse_bitmat(coeffs)
    if u == 1:
        fn = ref_kernel_exp.make_fn(k, r, n, pick_tile(k, r, n), jdtype)
        return np.asarray(fn(jnp.asarray(bm), jnp.asarray(data)))
    tile = max(256, (pick_tile(k, r, n) // u // 256) * 256)
    fn = ref_kernel_exp.make_fn_batched(k, r, n, tile, u, jdtype)
    big = ref_kernel_exp.block_diag_bitmat(bm, u)
    return np.asarray(fn(jnp.asarray(big), jnp.asarray(data)))


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("u,dtype", VARIANTS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_emulation_matches_pallas_and_oracle(interpret_pallas, geo, u,
                                             dtype, n):
    coeffs = _geometry(geo)
    r, k = coeffs.shape
    data = _data(k, n, 1000 * u + n)
    plan = make_tile_plan(_lift(coeffs, u), u, dtype)
    got = emulate(plan, data)
    assert np.array_equal(got, host_matmul(coeffs, data))
    assert np.array_equal(got, _pallas(geo, data, u))


# -- the tile list's structure ----------------------------------------------

def _dense_from_plan(plan):
    """The plan's kept tiles put back into the byte-major lift (u*8r,
    u*8k): rows through n_order and the row map, columns through k_order
    and each tile's chunk. Dropped tiles come back as zeros."""
    r, k, u, nt, kc = plan.r, plan.k, plan.u, plan.nt, plan.kc
    cpb = plan.chunks_per_block
    slots = nt // 8
    full = np.zeros((u * r, 8, u, cpb * kc // 8, 8), dtype=np.int8)
    rows = n_order(nt)
    cols = k_order(plan.dtype, kc)
    tiles = plan.tiles.reshape(-1, nt, kc)
    for t in range(plan.n_tiles):
        for e in range(plan.ntile_ptr[t], plan.ntile_ptr[t + 1]):
            blk, c = divmod(int(plan.tile_chunk[e]), cpb)
            for p in range(nt):
                slot, bit = divmod(int(rows[p]), 8)
                rr = int(plan.row_map[t * slots + slot])
                if rr < 0:
                    assert not tiles[e, p].any()
                    continue
                q, l = np.divmod(cols, 8)
                full[rr, bit, blk, kc // 8 * c + q, l] = tiles[e, p]
    assert not full[:, :, :, k:, :].any()
    return full[:, :, :, :k, :].reshape(u * 8 * r, u * 8 * k)


@pytest.mark.parametrize("u,dtype", VARIANTS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_kept_tiles_hold_every_one(geo, u, dtype):
    """Every non-zero lift element lies in a kept tile (the kept tiles,
    put back, give the whole lift), and every kept tile holds a one."""
    lift = _lift(_geometry(geo), u)
    plan = make_tile_plan(lift, u, dtype)
    assert np.array_equal(_dense_from_plan(plan),
                          bitmat_from_reference(lift, u))
    assert plan.tiles.reshape(plan.kept, -1).any(axis=1).all()


@pytest.mark.parametrize("u", [1, 2, 4])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_dropped_tiles_are_all_zero(geo, u):
    """Cut the sorted lift into (nt, 64) tiles independently of the plan:
    a tile is in the list if and only if it holds a one."""
    coeffs = _geometry(geo)
    r, k = coeffs.shape
    plan = make_tile_plan(_lift(coeffs, u), u, "int8")
    bm = bitmat_from_reference(_lift(coeffs, u), u)
    cpb, kc = plan.chunks_per_block, plan.kc
    x = np.zeros((u * r, 8, u, cpb * kc // 8, 8), dtype=np.int8)
    x[:, :, :, :k, :] = bm.reshape(u * r, 8, u, k, 8)
    x = x.reshape(u * r * 8, u * cpb * kc)
    slots = plan.nt // 8
    listed = {(t, int(c)) for t in range(plan.n_tiles)
              for c in plan.tile_chunk[plan.ntile_ptr[t]:
                                       plan.ntile_ptr[t + 1]]}
    for t in range(plan.n_tiles):
        rows = [8 * int(rr) + b for rr in plan.row_map[t * slots:
                                                       (t + 1) * slots]
                if rr >= 0 for b in range(8)]
        held = x[rows].reshape(len(rows), u * cpb, kc).any(axis=(0, 2))
        for c in range(u * cpb):
            assert held[c] == ((t, c) in listed)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_block_diagonal_lifts_keep_one_in_u(geo):
    """K6b's off-diagonal blocks are never kept: u = 2 and 4 keep u times
    the tiles of u = 1, so they do the same work per column."""
    coeffs = _geometry(geo)
    plans = {u: make_tile_plan(_lift(coeffs, u), u, "bf16")
             for u in (1, 2, 4)}
    for u in (2, 4):
        assert plans[u].kept == u * plans[1].kept
        assert plans[u].ops_per_column == u * plans[1].ops_per_column


@pytest.mark.parametrize("dtype", ["int8", "bf16", "tf32"])
def test_orders_are_permutations(dtype):
    """k_order permutes a chunk's payload bits (its first 32 positions are
    the first 4 bytes, so a 32-deep chunk is the first half of a 64-deep
    one); n_order permutes a tile's slot bits."""
    assert sorted(k_order(dtype, 64)) == list(range(64))
    assert sorted(k_order(dtype, 32)) == list(range(32))
    assert np.array_equal(k_order(dtype, 32), k_order(dtype, 64)[:32])
    for nt in rs_bitplane.TILE_ROWS:
        assert sorted(n_order(nt)) == list(range(nt))
        assert rs_bitplane.tile_depth(nt) in (32, 64)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_row_map_covers_every_output_byte_once(geo):
    coeffs = _geometry(geo)
    for u in (1, 2, 4):
        plan = make_tile_plan(_lift(coeffs, u), u, "int8")
        r = coeffs.shape[0]
        assert plan.nt == (32 if 8 * r <= 32 else 256)
        real = plan.row_map[plan.row_map >= 0]
        assert sorted(real) == list(range(u * r))
        assert plan.row_map.shape[0] == plan.n_tiles * plan.nt // 8


@pytest.mark.parametrize("geo,kept,dense", [
    ("rs_10_4", 3, 3), ("pb_emat", 48, 160), ("pb_dec_0_7_11_12", 68, 160),
    ("pb_dec_1_6_10_11", 68, 160)])
def test_tile_counts(geo, kept, dense):
    """The kept share of the timed shapes' lifts (the emat keeps 30%;
    RS(10,4)'s 10 payload bytes are 3 chunks of 4)."""
    plan = make_tile_plan(_lift(_geometry(geo), 1), 1, "int8")
    assert (plan.kept, plan.dense) == (kept, dense)


def test_zero_lift_keeps_no_tile():
    coeffs = np.zeros((4, 10), dtype=np.uint8)
    plan = make_tile_plan(_lift(coeffs, 1), 1, "int8")
    assert plan.kept == 0 and plan.ops_per_column == 0
    assert not emulate(plan, _data(10, 300, 3)).any()
