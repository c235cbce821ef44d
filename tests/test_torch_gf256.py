"""The port's GF(2^8) copy (seaweedfs_tpu_torch/ops/gf256.py) against the
JAX package's, byte for byte: tables, encode matrices, the GF(2) lift,
inverses and fused decode plans."""

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf256 as ref
from seaweedfs_tpu_torch.ops import gf256 as port

GEOMETRIES = [(10, 4), (6, 3), (20, 4), (3, 2)]


def test_tables_match():
    assert np.array_equal(port.EXP_TABLE, ref.EXP_TABLE)
    assert np.array_equal(port.LOG_TABLE, ref.LOG_TABLE)
    assert np.array_equal(port.MUL_TABLE, ref.MUL_TABLE)
    assert np.array_equal(port.INV_TABLE, ref.INV_TABLE)


@pytest.mark.parametrize("kind", ["vandermonde", "cauchy"])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_build_matrix_and_lifts_match(k, m, kind):
    mat = port.build_matrix(k, k + m, kind)
    assert np.array_equal(mat, ref.build_matrix(k, k + m, kind))
    assert np.array_equal(port.bit_matrix(mat[k:]), ref.bit_matrix(mat[k:]))
    assert np.array_equal(port.pack_bit_matrix(mat[k:]),
                          ref.pack_bit_matrix(mat[k:]))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_mat_inv_and_decode_rows_match(k, m):
    rng = np.random.default_rng(k * 100 + m)
    mat = ref.build_matrix(k, k + m, "vandermonde")
    lost = sorted(rng.choice(k + m, size=m, replace=False).tolist())
    survivors = [i for i in range(k + m) if i not in lost]
    sub = mat[survivors[:k]]
    inv = port.mat_inv(sub)
    assert np.array_equal(inv, ref.mat_inv(sub))
    assert np.array_equal(port.mat_mul(inv, sub), np.eye(k, dtype=np.uint8))
    got = port.decode_coeff_rows(mat, k, survivors, lost)
    assert np.array_equal(got, ref.decode_coeff_rows(mat, k, survivors, lost))


def test_mat_inv_singular_raises():
    with pytest.raises(ValueError):
        port.mat_inv(np.array([[1, 2], [1, 2]], dtype=np.uint8))


def test_bad_geometry_raises():
    with pytest.raises(ValueError):
        port.build_matrix(4, 4)
    with pytest.raises(ValueError):
        port.build_matrix(4, 6, "bogus")
