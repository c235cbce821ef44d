"""GF(2^8) arithmetic over the polynomial x^8+x^4+x^3+x^2+1 (0x11D).

The field of the reference's Reed-Solomon dependency
(klauspost/reedsolomon): generator element 2, field polynomial 0x11D.
Tables are built once at import with numpy.

Matrix builders:
  * vandermonde_systematic(k, total) — a (total x k) Vandermonde matrix
    right-multiplied by the inverse of its top square, so the top k rows
    are the identity (data shards stored verbatim, parity rows below).
  * cauchy(k, total) — identity on top, parity rows m[r][c] = 1/(r ^ c);
    any geometry with k + m <= 256.

Also the field trace and the GF(2) linear algebra trace repair plans
with (TRACE_MUL, gf_nullspace, gf2_*).

This module is a numpy copy of what the encode/rebuild/repair paths
need; it must stay byte-identical to the field the shard files were
written in.
"""

from __future__ import annotations

import numpy as np

FIELD_POLY = 0x11D
GENERATOR = 2


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= FIELD_POLY
    # duplicate so exp[(log a + log b)] needs no mod
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = -1  # sentinel; never indexed on the hot path
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def _build_mul_table():
    # 256x256 full multiplication table: MUL_TABLE[c][d] = c * d
    a = np.arange(256, dtype=np.int32)
    t = EXP_TABLE[(LOG_TABLE[a][:, None] + LOG_TABLE[a][None, :]) % 255]
    t = t.astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


MUL_TABLE = _build_mul_table()
INV_TABLE = np.zeros(256, dtype=np.uint8)
INV_TABLE[1:] = EXP_TABLE[255 - LOG_TABLE[np.arange(1, 256)]]


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(2^8). 0**0 == 1 (matches the reference dependency)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


# ---------------------------------------------------------------------------
# Matrix algebra over GF(2^8) (small matrices: k+m <= 256)
# ---------------------------------------------------------------------------

def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(r x n) @ (n x c) over GF(2^8)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    r, n = a.shape
    if b.shape[0] != n:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    out = np.zeros((r, b.shape[1]), dtype=np.uint8)
    for i in range(r):
        for j in range(n):
            out[i] ^= MUL_TABLE[a[i, j]][b[j]]
    return out


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8). Raises ValueError if singular."""
    m = np.array(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not a square matrix: {m.shape}")
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        nz = np.flatnonzero(aug[col:, col])
        if nz.size == 0:
            raise ValueError("singular matrix over GF(2^8)")
        piv = col + int(nz[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = MUL_TABLE[INV_TABLE[aug[col, col]]][aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= MUL_TABLE[aug[row, col]][aug[col]]
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf_pow(r, c)
    return v


def vandermonde_systematic(data_shards: int, total_shards: int) -> np.ndarray:
    """The reference dependency's default encode matrix (systematic form)."""
    vm = vandermonde(total_shards, data_shards)
    return mat_mul(vm, mat_inv(vm[:data_shards, :]))


def cauchy(data_shards: int, total_shards: int) -> np.ndarray:
    m = np.zeros((total_shards, data_shards), dtype=np.uint8)
    m[:data_shards] = np.eye(data_shards, dtype=np.uint8)
    for r in range(data_shards, total_shards):
        for c in range(data_shards):
            m[r, c] = INV_TABLE[r ^ c]
    return m


def build_matrix(data_shards: int, total_shards: int,
                 kind: str = "vandermonde") -> np.ndarray:
    if not (0 < data_shards < total_shards <= 256):
        raise ValueError(f"bad geometry k={data_shards} total={total_shards}")
    if kind == "vandermonde":
        return vandermonde_systematic(data_shards, total_shards)
    if kind == "cauchy":
        return cauchy(data_shards, total_shards)
    raise ValueError(f"unknown matrix kind {kind!r}")


# ---------------------------------------------------------------------------
# GF(2) bit-plane lift. Multiplication by a constant c is linear over
# GF(2)^8, so a (rows x cols) byte matrix lifts to a (8cols x 8rows)
# binary matrix. The Hopper kernel does not use it (it multiplies with
# nibble tables); it is kept so the field's linear structure stays
# checkable against the reference lift.
# ---------------------------------------------------------------------------

def bit_matrix(coeff_rows: np.ndarray) -> np.ndarray:
    """Lift a (rows x cols) GF(2^8) coefficient matrix to GF(2).

    Returns B of shape (cols*8, rows*8), uint8 in {0,1}, such that for input
    bits x (n, cols*8) (bit l of input byte j at column j*8+l, LSB-first) the
    output bits are (x @ B) % 2 with output byte i's bit b at column i*8+b.
    """
    coeff_rows = np.asarray(coeff_rows, dtype=np.uint8)
    rows, cols = coeff_rows.shape
    # prod[i, j, l] = c_ij * x^l; its bit b is B[j*8+l, i*8+b]
    prod = MUL_TABLE[coeff_rows[:, :, None],
                     (1 << np.arange(8, dtype=np.uint8))[None, None, :]]
    bits = (prod[..., None] >> np.arange(8, dtype=np.uint8)) & 1  # i,j,l,b
    return np.ascontiguousarray(
        bits.transpose(1, 2, 0, 3).reshape(cols * 8, rows * 8))


def pack_bit_matrix(coeff_rows: np.ndarray) -> np.ndarray:
    """bit_matrix with the input-bit axis packed into uint32 words.

    Returns P of shape (ceil(cols*8/32), rows*8) uint32 where bit
    (j % 32) of P[j // 32, o] is bit_matrix[j, o].
    """
    bm = bit_matrix(coeff_rows)
    k8, r8 = bm.shape
    packed = np.zeros(((k8 + 31) // 32, r8), dtype=np.uint32)
    for j in range(k8):
        packed[j // 32] |= bm[j].astype(np.uint32) << np.uint32(j % 32)
    return packed


# ---------------------------------------------------------------------------
# Field trace and GF(2) linear algebra — the substrate of trace repair.
#
# Tr(x) = x + x^2 + ... + x^128 maps GF(2^8) onto GF(2), and Tr(a*x) is
# GF(2)-linear in x for any fixed a. A lost RS symbol can therefore be
# rebuilt from *bits* Tr(mask * c_i) collected from the survivors instead
# of their full bytes (arxiv 2205.11015); the masks come from dual
# codewords, found below via gf_nullspace.
# ---------------------------------------------------------------------------

def _build_trace_table():
    x = np.arange(256, dtype=np.uint8)
    acc = x.copy()
    cur = x.copy()
    for _ in range(7):
        cur = MUL_TABLE[cur, cur]
        acc ^= cur
    if not set(np.unique(acc)) <= {0, 1}:
        raise ValueError("field trace is not {0, 1}-valued")
    return acc


TRACE_TABLE = _build_trace_table()
# TRACE_MUL[a, b] = Tr(a*b) in {0,1}: the survivor-side projection is a
# single row-gather of this table followed by packbits.
TRACE_MUL = TRACE_TABLE[MUL_TABLE]


def gf_trace(a: int) -> int:
    return int(TRACE_TABLE[a])


def gf_nullspace(a: np.ndarray):
    """One nullspace vector of an (r x c, r < c) matrix over GF(2^8), or
    None if the map is injective. ops/codec.repair_plan uses it for dual
    codewords vanishing on a chosen position subset."""
    a = np.array(a, dtype=np.uint8)
    r, c = a.shape
    piv_of_col = {}
    row = 0
    for col in range(c):
        piv = None
        for rr in range(row, r):
            if a[rr, col]:
                piv = rr
                break
        if piv is None:
            continue
        if piv != row:
            a[[row, piv]] = a[[piv, row]]
        inv = INV_TABLE[a[row, col]]
        a[row] = MUL_TABLE[inv][a[row]]
        for rr in range(r):
            if rr != row and a[rr, col]:
                a[rr] ^= MUL_TABLE[a[rr, col]][a[row]]
        piv_of_col[col] = row
        row += 1
        if row == r:
            break
    free = [col for col in range(c) if col not in piv_of_col]
    if not free:
        return None
    f = free[0]
    x = np.zeros(c, dtype=np.uint8)
    x[f] = 1
    for col, rr in piv_of_col.items():
        x[col] = a[rr, f]  # char 2: -v == v
    return x


def gf2_reduce(vals: np.ndarray, basis) -> np.ndarray:
    """Reduce uint8 values by a reduced GF(2) basis of field elements
    (distinct leading bits, descending). Vectorized over vals."""
    v = vals.copy()
    for b in basis:
        lead = b.bit_length() - 1
        mask = ((v >> lead) & 1).astype(bool)
        v[mask] ^= b
    return v


def gf2_insert(basis: list, val: int) -> bool:
    """Insert val into a reduced GF(2) basis in place; True if the span
    grew."""
    for b in basis:
        lead = b.bit_length() - 1
        if (val >> lead) & 1:
            val ^= b
    if val:
        basis.append(int(val))
        basis.sort(reverse=True)
        return True
    return False


def gf2_decompose(val: int, basis) -> list:
    """Coordinates of val over a reduced GF(2) basis (same order as
    basis). Raises ValueError when val is outside the span."""
    coords = [0] * len(basis)
    for i, b in enumerate(basis):
        lead = b.bit_length() - 1
        if (val >> lead) & 1:
            val ^= b
            coords[i] = 1
    if val:
        raise ValueError("value outside GF(2) span")
    return coords


def gf2_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a {0,1} matrix over GF(2). Raises
    ValueError if singular."""
    m = np.array(m, dtype=np.uint8) & 1
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not a square matrix: {m.shape}")
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = -1
        for row in range(col, n):
            if aug[row, col]:
                piv = row
                break
        if piv < 0:
            raise ValueError("singular matrix over GF(2)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= aug[col]
    return aug[:, n:].copy()


def decode_coeff_rows(matrix: np.ndarray, k: int, survivor_rows,
                      missing_rows, inv: np.ndarray = None) -> np.ndarray:
    """Fused decode plan: (len(missing_rows), k) GF coefficients C such
    that missing = C @ stack(first k surviving shards).

    Data rows come from the inverse of the first-k-survivors submatrix,
    parity rows from matrix[row] @ that inverse."""
    src = list(survivor_rows)[:k]
    if inv is None:
        inv = mat_inv(matrix[src, :])
    rows = []
    for r in missing_rows:
        if r < k:
            rows.append(inv[r])
        else:
            rows.append(mat_mul(matrix[r:r + 1, :], inv)[0])
    if not rows:
        return np.zeros((0, k), dtype=np.uint8)
    return np.stack(rows, axis=0)
