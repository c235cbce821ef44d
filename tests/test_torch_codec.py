"""TorchCodec(device="cpu") against the JAX TpuCodec (the packed XLA path
under JAX_PLATFORMS=cpu) and the numpy oracle: encode, reconstruct with
1-4 losses, the chunked branch, the host path below
small_dispatch_bytes, and from_matrix. Exact: GF(2^8) arithmetic."""

import numpy as np
import pytest

from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu.ops.rs_tpu import TpuCodec
from seaweedfs_tpu_torch.ops import telemetry
from seaweedfs_tpu_torch.ops.codec import NumpyCodec, get_codec
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec


def _data(k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


@pytest.mark.parametrize("kind", ["vandermonde", "cauchy"])
@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (20, 4)])
def test_encode_matches_jax_and_oracle(k, m, kind):
    data = _data(k, 3000, k + m)
    port = TorchCodec(k, m, kind, device="cpu")
    want = RefNumpyCodec(k, m, kind).encode(data)
    assert np.array_equal(port.encode(data), want)
    assert np.array_equal(TpuCodec(k, m, kind).encode(data), want)
    assert np.array_equal(NumpyCodec(k, m, kind).encode(data), want)


@pytest.mark.parametrize("lost", [(3,), (0, 12), (1, 5, 9), (0, 3, 11, 13)])
@pytest.mark.parametrize("threshold", [0, None])
def test_reconstruct_matches(lost, threshold):
    """threshold 0 forces every reconstruct through the device path;
    None keeps the 256 KiB default, so these widths stay on the host."""
    k, m = 10, 4
    data = _data(k, 3000, len(lost))
    full = RefNumpyCodec(k, m).encode_to_all(data)
    port = TorchCodec(k, m, device="cpu", small_dispatch_bytes=threshold)
    jax_codec = TpuCodec(k, m, small_dispatch_bytes=0)
    shards = [None if i in lost else full[i] for i in range(k + m)]
    before = telemetry.STATS.snapshot()
    got = port.reconstruct(shards)
    moved = telemetry.delta(before)
    ref = jax_codec.reconstruct(list(shards))
    for sid in range(k + m):
        assert np.array_equal(got[sid], full[sid]), sid
        assert np.array_equal(got[sid], ref[sid]), sid
    if threshold == 0:
        assert moved["dispatches"] == 1 and moved["host_fallbacks"] == 0
    else:
        assert moved["dispatches"] == 0 and moved["host_fallbacks"] == 1


def test_reconstruct_data_only_and_too_few():
    k, m = 6, 3
    data = _data(k, 500, 9)
    full = RefNumpyCodec(k, m).encode_to_all(data)
    port = TorchCodec(k, m, device="cpu", small_dispatch_bytes=0)
    shards = [None if i in (1, 7) else full[i] for i in range(k + m)]
    got = port.reconstruct(shards, data_only=True)
    assert np.array_equal(got[1], full[1]) and got[7] is None
    with pytest.raises(ValueError):
        port.reconstruct([None] * 4 + list(full[4:]))


def test_chunked_branch_matches():
    """Payloads wider than chunk_bytes launch every chunk before any is
    drained; the ragged last chunk pads and clips exactly."""
    k, m = 10, 4
    data = _data(k, 5000, 2)
    port = TorchCodec(k, m, device="cpu", chunk_bytes=1024)
    jax_codec = TpuCodec(k, m, chunk_bytes=1024)
    before = telemetry.STATS.snapshot()
    got = port.encode(data)
    moved = telemetry.delta(before)
    assert np.array_equal(got, jax_codec.encode(data))
    assert moved["dispatches"] == 5  # ceil(5000 / 1024)
    assert moved["device_bytes"] == data.nbytes
    assert moved["bitmat_uploads"] == 1
    before = telemetry.STATS.snapshot()
    port.encode(data)
    assert telemetry.delta(before)["bitmat_uploads"] == 0  # resident


def test_from_matrix_runs_jax_coefficients():
    k, m = 6, 3
    jax_codec = TpuCodec(k, m, "cauchy")
    port = TorchCodec.from_matrix(jax_codec.matrix, device="cpu",
                                  small_dispatch_bytes=0)
    oracle = NumpyCodec.from_matrix(jax_codec.matrix)
    assert (port.k, port.m) == (k, m)
    assert np.array_equal(port.matrix, jax_codec.matrix)
    data = _data(k, 1500, 4)
    want = jax_codec.encode(data)
    assert np.array_equal(port.encode(data), want)
    assert np.array_equal(oracle.encode(data), want)
    present = tuple(i not in (0, 8) for i in range(k + m))
    for a, b in zip(port.decode_plan(present),
                    jax_codec.decode_plan(present)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        TorchCodec.from_matrix(jax_codec.matrix[:4], device="cpu")


def test_plans_verify_and_syndrome_match():
    k, m = 10, 4
    port = TorchCodec(k, m, device="cpu")
    ref = RefNumpyCodec(k, m)
    assert np.array_equal(port.syndrome_plan(), ref.syndrome_plan())
    present = tuple(i not in (2, 12) for i in range(k + m))
    src, coeffs = port.lost_row_coeffs(present, 12)
    rsrc, rcoeffs = ref.lost_row_coeffs(present, 12)
    assert src == rsrc and np.array_equal(coeffs, rcoeffs)
    full = ref.encode_to_all(_data(k, 256, 5))
    assert port.verify(list(full))
    full[k][7] ^= 1
    assert not port.verify(list(full))


def test_get_codec_backends():
    assert isinstance(get_codec(10, 4, backend="numpy"), NumpyCodec)
    codec = get_codec(6, 3, backend="cuda", device="cpu")
    assert isinstance(codec, TorchCodec) and codec.backend == "cuda"
    with pytest.raises(ValueError):
        get_codec(10, 4, backend="tpu")
