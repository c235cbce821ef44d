"""The port's multi-device programs (seaweedfs_tpu_torch/parallel/mesh.py
and sharded_ec.py) against the JAX package's (seaweedfs_tpu/parallel),
on the CPU.

The JAX side runs on the eight virtual CPU devices tests/conftest.py
gives it; the port's meshes are positions on ``cpu`` (eight, or as many
as the JAX mesh has), every position running K1's plain version. The
same seeded numpy inputs go to both: mesh shapes and the default layout,
the axis specs, the padded decode lift, the sharded encode and the
XOR-folded rebuild on meshes (4,2), (2,2), (3,1) and (1,2) at RS(10,4)
and RS(6,3), an odd width per position (333), and the whole
distributed step. Tolerance: none, every output is compared byte for
byte."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from seaweedfs_tpu.parallel import distributed_ec_step as ref_step
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh
from seaweedfs_tpu.parallel import sharded_encode_fn as ref_encode_fn
from seaweedfs_tpu.parallel.sharded_ec import decode_bitmat as ref_bitmat
from seaweedfs_tpu.parallel.sharded_ec import \
    encode_in_specs as ref_encode_specs
from seaweedfs_tpu.parallel.sharded_ec import \
    rebuild_in_specs as ref_rebuild_specs
from seaweedfs_tpu.parallel.sharded_ec import \
    sharded_rebuild_fn as ref_rebuild_fn
from seaweedfs_tpu_torch.ops import device_stats
from seaweedfs_tpu_torch.ops.codec import NumpyCodec
from seaweedfs_tpu_torch.parallel import (distributed_ec_step, make_mesh,
                                          sharded_encode_fn,
                                          sharded_rebuild_fn)
from seaweedfs_tpu_torch.parallel.mesh import make_codec_mesh
from seaweedfs_tpu_torch.parallel.sharded_ec import (decode_bitmat,
                                                     decode_coeffs,
                                                     encode_in_specs,
                                                     rebuild_in_specs)

SHAPES = [(4, 2), (2, 2), (3, 1), (1, 2)]
LOSSES = [((0, 1, 2, 3, 4, 5, 10, 11, 12, 13), (6, 7, 8, 9)),
          ((1, 2, 3, 5, 6, 7, 8, 9, 10, 13), (0, 4, 11, 12)),
          ((0, 2, 4, 6, 8, 9, 10, 11, 12, 13), (1, 3, 5, 7))]


@pytest.fixture(autouse=True)
def jax_device_stats(monkeypatch):
    """The JAX programs compiled here at many shapes count their compiles
    and recompiles in a DeviceStats of their own: the process-wide one is
    read by the JAX package's own tests (its recompile sentinel must not
    have latched), which may run later in this process."""
    from seaweedfs_tpu.ops import device_stats as ref_device_stats
    monkeypatch.setattr(ref_device_stats, "DEVICE_STATS",
                        ref_device_stats.DeviceStats())


@pytest.fixture(autouse=True)
def torch_one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(shape):
    n = int(np.prod(shape))
    return (ref_make_mesh(shape=shape, devices=jax.devices()[:n]),
            make_mesh(shape, devices=["cpu"] * n))


@pytest.mark.parametrize("n", [8, 4, 3, 2])
def test_mesh_shapes_match_jax(n):
    ref = ref_make_mesh(devices=jax.devices()[:n])
    mine = make_mesh(devices=["cpu"] * n)
    assert mine.shape == dict(ref.shape)
    assert mine.axis_names == tuple(ref.axis_names)
    codec_mesh = make_codec_mesh(["cpu"] * n, width_devices=2)
    assert codec_mesh.shape == {"data": 2, "shard": 1}
    assert make_codec_mesh(["cpu"] * n).shape == {"data": n, "shard": 1}
    # positions share the CPU, and are still told apart
    assert len({mine.label(i) for i in np.ndindex(mine.devices.shape)}) == n


def test_mesh_size_mismatch_raises_like_jax():
    with pytest.raises(ValueError, match="!= 4 devices"):
        ref_make_mesh(shape=(3, 2), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="!= 4 devices"):
        make_mesh((3, 2), devices=["cpu"] * 4)


def test_default_mesh_is_the_cards():
    """With no devices a mesh is every card; without one it raises,
    never a CPU mesh built quietly."""
    import torch
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh().devices.flat)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_codec_mesh()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m", [4, 3])
def test_in_specs_match_jax(shape, m):
    ref, mine = _meshes(shape)
    assert [tuple(s) for s in ref_encode_specs(ref, m)] == \
        list(encode_in_specs(mine, m))
    assert [tuple(s) for s in ref_rebuild_specs(ref)] == \
        list(rebuild_in_specs(mine))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("pad", [1, 2, 3])
def test_decode_bitmat_matches_jax(loss, pad):
    survivors, missing = loss
    got = decode_bitmat(10, 4, survivors, missing, pad_to_mult=pad)
    want = ref_bitmat(10, 4, survivors, missing, pad_to_mult=pad)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape[0] % pad == 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k,m", [(10, 4), (6, 3)])
def test_sharded_encode_and_rebuild_match_jax(shape, k, m):
    """Both programs on the same mesh shape and inputs: parity and the
    rebuilt rows byte-equal to JAX's and to the numpy oracle."""
    ref, mine = _meshes(shape)
    n = 256 * mine.shape["data"]
    rng = np.random.default_rng(k * 10 + m)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    ref_fn, bitmat = ref_encode_fn(ref, k, m, n)
    want = np.asarray(ref_fn(jnp.asarray(bitmat), jnp.asarray(data)))
    fn, coeffs = sharded_encode_fn(mine, k, m, n)
    parity = np.asarray(fn(coeffs, data))
    assert np.array_equal(parity, want)
    assert np.array_equal(parity, NumpyCodec(k, m).encode(data))

    survivors = list(range(k - m)) + list(range(k, k + m))
    missing = list(range(k - m, k))
    surv = np.concatenate([data[: k - m], parity], axis=0)
    shard = mine.shape["shard"]
    ref_reb = ref_rebuild_fn(ref, k, m, n)
    want = np.asarray(ref_reb(jnp.asarray(ref_bitmat(
        k, m, survivors, missing, pad_to_mult=shard)), jnp.asarray(surv)))
    reb = sharded_rebuild_fn(mine, k, m, n)
    got = np.asarray(reb(decode_coeffs(k, m, survivors, missing), surv))
    assert np.array_equal(got, want)
    assert np.array_equal(got, data[k - m: k])


@pytest.mark.parametrize("k,m,n_per_device", [(10, 4, 1024), (6, 3, 512),
                                              (10, 4, 333)])
def test_distributed_ec_step_matches_jax(k, m, n_per_device):
    ref, mine = _meshes((4, 2))
    parity, rebuilt, diff = distributed_ec_step(mine, k, m, n_per_device)
    ref_parity, ref_rebuilt, ref_diff = ref_step(ref, k, m, n_per_device)
    assert diff == 0 == ref_diff
    assert parity.shape == (m, n_per_device * 4)
    assert np.array_equal(parity, ref_parity)
    assert np.array_equal(rebuilt, ref_rebuilt)
    data = np.random.default_rng(0).integers(
        0, 256, (k, n_per_device * 4), dtype=np.uint8)
    assert np.array_equal(parity, NumpyCodec(k, m).encode(data))


@pytest.mark.parametrize("shape", [(2, 2), (3, 1)])
def test_distributed_step_counts_k1_at_every_position(shape, monkeypatch):
    """One dispatch of each program a call, and one K1 call per mesh
    position in each; a CPU position launches nothing on a card."""
    stats = device_stats.DeviceStats()
    monkeypatch.setattr(device_stats, "DEVICE_STATS", stats)
    _, mine = _meshes(shape)
    assert distributed_ec_step(mine, 6, 3, 128)[2] == 0
    got = stats.snapshot()
    positions = int(np.prod(shape))
    assert got["dispatches"][device_stats.SHARDED_ENCODE] == 1
    assert got["dispatches"][device_stats.SHARDED_REBUILD] == 1
    assert got["dispatches"][device_stats.K1] == 2 * positions
    assert got["launches"] == {}
