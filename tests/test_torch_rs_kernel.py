"""The port's GF(2^8) product (seaweedfs_tpu_torch/ops/rs_hopper.py) held
against the TPU kernel it replaces, rs_pallas.fused_matmul in interpret
mode, and the numpy oracle. The tolerance is exact: all arithmetic is in
GF(2^8). Tensors here lie on the CPU, so gf_matmul runs its plain
version; the Hopper kernel itself is held against that plain version on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.codec import NumpyCodec, host_matmul
from seaweedfs_tpu.ops.rs_pallas import fused_matmul
from seaweedfs_tpu_torch.ops import rs_hopper
from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K1
from seaweedfs_tpu_torch.ops.gf_plan import make_plan
from seaweedfs_tpu_torch.ops.rs_hopper import gf_matmul, gf_matmul_plain
from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec, resolve_device
from seaweedfs_tpu_torch.ops.codec import get_codec


@pytest.fixture(autouse=True)
def jax_device_stats(monkeypatch):
    """The JAX programs compiled here at many shapes count their compiles
    and recompiles in a DeviceStats of their own: the process-wide one is
    read by the JAX package's own tests (its recompile sentinel must not
    have latched), which may run later in this process."""
    from seaweedfs_tpu.ops import device_stats as ref_device_stats
    monkeypatch.setattr(ref_device_stats, "DEVICE_STATS",
                        ref_device_stats.DeviceStats())


def _port(coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
    out = gf_matmul(make_plan(coeffs),
                    torch.from_numpy(np.ascontiguousarray(data)))
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (20, 4), (3, 2), (1, 1)])
def test_encode_matches_pallas_and_oracle(k, m):
    rng = np.random.default_rng(k * 10 + m)
    data = rng.integers(0, 256, (k, 2048), dtype=np.uint8)
    oracle = NumpyCodec(k, m)
    coeffs = oracle.matrix[k:]
    got = _port(coeffs, data)
    assert np.array_equal(got, oracle.encode(data))
    pallas = np.asarray(fused_matmul(coeffs, data, interpret=True))
    assert np.array_equal(got, pallas)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4096 + 311])
def test_ragged_widths(n):
    k, m = 10, 4
    data = np.random.default_rng(n).integers(0, 256, (k, n), dtype=np.uint8)
    oracle = NumpyCodec(k, m)
    got = _port(oracle.matrix[k:], data)
    assert got.shape == (m, n)
    assert np.array_equal(got, oracle.encode(data))
    pallas = np.asarray(fused_matmul(oracle.matrix[k:], data,
                                     interpret=True))
    assert np.array_equal(got, pallas)


@pytest.mark.parametrize("k,m,lost", [(6, 3, (1, 7)),
                                      (10, 4, (0, 3, 11, 13))])
def test_decode_rows_match(k, m, lost):
    """Rebuild sends decode-plan rows, not the encode matrix: the fused
    plan and a single (1, k) row both regenerate the lost shards."""
    rng = np.random.default_rng(k)
    oracle = NumpyCodec(k, m)
    data = rng.integers(0, 256, (k, 777), dtype=np.uint8)
    shards = oracle.encode_to_all(data)
    present = tuple(i not in lost for i in range(k + m))
    src, missing, coeffs = oracle.decode_plan(present)
    survivors = shards[list(src)]
    got = _port(coeffs, survivors)
    for r, sid in enumerate(missing):
        assert np.array_equal(got[r], shards[sid]), sid
    pallas = np.asarray(fused_matmul(coeffs, survivors, interpret=True))
    assert np.array_equal(got, pallas)
    one = _port(coeffs[:1], survivors)
    assert np.array_equal(one[0], shards[missing[0]])


def test_large_matrix_matches_oracle():
    """A matrix taller than several 4-row tiles and wider than a 128-row
    table chunk — the piggyback-sized geometry class — on random
    coefficients (zeros and ones included)."""
    rng = np.random.default_rng(3)
    coeffs = rng.integers(0, 256, (130, 300), dtype=np.uint8)
    coeffs[0, :7] = 0
    coeffs[1, :7] = 1
    data = rng.integers(0, 256, (300, 45), dtype=np.uint8)
    assert np.array_equal(_port(coeffs, data), host_matmul(coeffs, data))


def test_cpu_never_launches_the_kernel():
    before = DEVICE_STATS.launch_count(K1)
    calls = DEVICE_STATS.snapshot()["dispatches"].get(K1, 0)
    k, m = 10, 4
    data = np.random.default_rng(1).integers(0, 256, (k, 300),
                                             dtype=np.uint8)
    _port(NumpyCodec(k, m).matrix[k:], data)
    codec = TorchCodec(k, m, device="cpu", small_dispatch_bytes=0)
    codec.encode(data)
    assert DEVICE_STATS.launch_count(K1) == before == 0
    # two calls of the entry, each the plain version
    assert DEVICE_STATS.snapshot()["dispatches"][K1] == calls + 2
    assert rs_hopper._lib is None  # nothing was built or loaded


def test_plain_version_indexes_with_int64():
    """uint8 index tensors would be boolean masks: byte values >= 2 must
    still select table entries."""
    coeffs = torch.tensor([[2, 3]], dtype=torch.uint8)
    data = torch.tensor([[255, 2, 1], [7, 0, 128]], dtype=torch.uint8)
    want = host_matmul(coeffs.numpy(), data.numpy())
    assert np.array_equal(gf_matmul_plain(coeffs, data).numpy(), want)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract is not testable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        TorchCodec(10, 4)
    with pytest.raises(RuntimeError):
        get_codec(10, 4)


def test_wrapper_rejects_bad_inputs():
    c = make_plan(np.zeros((4, 10), dtype=np.uint8))
    with pytest.raises(TypeError, match="GfPlan"):  # no raw coefficients
        gf_matmul(c.coeffs, torch.zeros((10, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf_matmul(c, torch.zeros((9, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf_matmul(c, torch.zeros((10, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        gf_matmul(c, torch.zeros((10, 16), dtype=torch.uint8, device="meta"))
