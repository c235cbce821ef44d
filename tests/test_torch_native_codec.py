"""The port's native CPU codec (ops/rs_native, csrc/seaweed_ec.cc) against
the JAX package's ``NativeCodec`` and ``NumpyCodec``.

The JAX library is built from ``seaweedfs_tpu/ops/native/seaweed_ec.cc``
into a temporary directory (the flags of its ``build.sh``), and the JAX
module is pointed at it by monkeypatch, so nothing is written under
``seaweedfs_tpu/``. The port's library builds into its own ``build/``.

- The product, byte for byte, at one thread and at the hardware's
  concurrency: the parity rows of RS(10,4), RS(6,3) and RS(20,4) and a
  4-loss decode plan of RS(10,4), at widths 1, 31, 32, 33 (the AVX2
  loop's edge) and 1 MiB + 7 (the threaded split's).
- ``write_ec_files`` and ``rebuild_ec_files`` on the native codec: the
  shards equal the JAX package's native encode's.
- ``get_codec(k, m, "auto")`` without a card is native; a library that
  does not build raises with the compiler's output (no quiet numpy), and
  only ``auto`` then falls back to numpy.
- ``volume -ec.backend native`` starts a port volume server whose store
  encodes on the native codec with torch.cuda never touched.
- ``ops.codec.resolve_backend`` is the one resolver of ``-ec.backend``:
  ``cli._volume_codec`` and the volume server's own ``main`` give its
  answer for every name, ``auto`` included, with and without a card.

Tolerances: none (bytes compared exactly).
"""

import os
import subprocess

import numpy as np
import pytest

from seaweedfs_tpu.ops import rs_native as ref_native
from seaweedfs_tpu.ops.codec import NumpyCodec as RefNumpyCodec
from seaweedfs_tpu_torch.ops import codec as ops_codec
from seaweedfs_tpu_torch.ops import rs_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(ROOT, "seaweedfs_tpu", "ops", "native",
                          "seaweed_ec.cc")
WIDTHS = (1, 31, 32, 33, (1 << 20) + 7)
BLOCKS = dict(large_block=64 << 10, small_block=8 << 10)
SLAB = 32 << 10


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX NativeCodec class, its library built into a temporary
    directory."""
    lib = tmp_path_factory.mktemp("jax_native") / "libseaweed_ec.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                    "-pthread", "-o", str(lib), JAX_SOURCE], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_native, "_LIB_PATH", str(lib))
        mp.setattr(ref_native, "_lib", None)
        mp.setattr(ref_native, "_load_failed", False)
        assert ref_native.native_available()
        yield ref_native.NativeCodec


def _coeffs(name):
    if name == "decode (10,4) lost 0,3,7,12":
        codec = ops_codec.NumpyCodec(10, 4)
        present = tuple(i not in (0, 3, 7, 12) for i in range(14))
        return codec.decode_plan(present)[2], 10, 4
    k, m = {"RS(10,4)": (10, 4), "RS(6,3)": (6, 3),
            "RS(20,4)": (20, 4)}[name]
    return ops_codec.NumpyCodec(k, m).matrix[k:], k, m


@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("name", ["RS(10,4)", "RS(6,3)", "RS(20,4)",
                                  "decode (10,4) lost 0,3,7,12"])
def test_product_matches_jax_and_numpy(jax_native, name, threads):
    coeffs, k, m = _coeffs(name)
    port = rs_native.NativeCodec(k, m, threads=threads)
    ref = jax_native(k, m, threads=threads)
    oracle = RefNumpyCodec(k, m)
    rng = np.random.default_rng(len(name) + threads)
    for n in WIDTHS:
        data = rng.integers(0, 256, (coeffs.shape[1], n), dtype=np.uint8)
        want = oracle._matmul(coeffs, data)
        got = port._matmul(coeffs, data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (name, n)
        assert np.array_equal(ref._matmul(coeffs, data), want), (name, n)
    assert port.small_dispatch_bytes == 0
    assert ops_codec.dispatch_threshold(port) == 0


def test_encode_and_rebuild_files_match_jax(tmp_path, jax_native):
    from seaweedfs_tpu.ec import encoder as ref_encoder
    from seaweedfs_tpu_torch.ec import (rebuild_ec_files, to_ext,
                                        write_ec_files)
    from seaweedfs_tpu_torch.ops import telemetry
    nbytes = int(1.5 * 10 * BLOCKS["large_block"]) + 4321
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    data = np.random.default_rng(3).integers(0, 256, nbytes,
                                             dtype=np.uint8).tobytes()
    for base in (ref, port):
        with open(base + ".dat", "wb") as f:
            f.write(data)
    ref_encoder.write_ec_files(ref, codec=jax_native(10, 4), slab=SLAB,
                               **BLOCKS)
    before = telemetry.STATS.snapshot()
    codec = ops_codec.get_codec(10, 4, "native")
    assert isinstance(codec, rs_native.NativeCodec)
    write_ec_files(port, codec=codec, slab=SLAB, **BLOCKS)

    def shards(base):
        out = []
        for sid in range(14):
            with open(base + to_ext(sid), "rb") as f:
                out.append(f.read())
        return out
    want = shards(ref)
    assert shards(port) == want
    for sid in (0, 4, 11, 13):
        os.remove(port + to_ext(sid))
    assert sorted(rebuild_ec_files(port, codec=codec, slab=SLAB)) == \
        [0, 4, 11, 13]
    assert shards(port) == want
    # a host codec: no device dispatch
    assert telemetry.delta(before)["dispatches"] == 0


def test_auto_without_a_card_is_native(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codec = ops_codec.get_codec(10, 4, "auto")
    assert type(codec) is rs_native.NativeCodec and codec.threads == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_codec.get_codec(10, 4)  # the default: the card, never the host
    monkeypatch.setattr(rs_native, "native_available", lambda: False)
    assert type(ops_codec.get_codec(10, 4, "auto")) is ops_codec.NumpyCodec


def test_failed_build_raises(tmp_path, monkeypatch):
    """A library that does not compile raises with the compiler's
    output; nothing falls back to numpy but ``auto``."""
    import torch
    bad = tmp_path / "seaweed_ec.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rs_native, "SOURCE", bad)
    monkeypatch.setattr(rs_native, "LIBRARY", tmp_path / "libseaweed_ec.so")
    monkeypatch.setattr(rs_native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed.*\n.*error"):
        rs_native.NativeCodec(10, 4)
    with pytest.raises(RuntimeError, match="build failed"):
        ops_codec.get_codec(10, 4, "native")
    assert not (tmp_path / "libseaweed_ec.so").exists()
    assert not list(tmp_path.glob("*.tmp"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert type(ops_codec.get_codec(10, 4, "auto")) is ops_codec.NumpyCodec


def test_volume_native_backend_never_touches_cuda(tmp_path, monkeypatch):
    """``volume -ec.backend native`` through the CLI: the store's codec is
    native, and an encode through it runs with every torch.cuda entry
    that would start CUDA raising."""
    import torch
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ec import to_ext, write_ec_files

    def touched(*_a, **_k):
        raise AssertionError("torch.cuda touched")
    for name in ("is_available", "init", "_lazy_init", "current_device",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, touched)
    started = []
    monkeypatch.setattr(cli, "_wait", lambda *servers: started.extend(
        servers))
    cli.main(["volume", "-ec.backend", "native", "-dir", str(tmp_path / "v"),
              "-port", "0", "-fastPort", "-1", "-mserver", "127.0.0.1:1",
              "-pulseSeconds", "60"])
    (vs,) = started
    try:
        codec = vs.store.codec
        assert type(codec) is rs_native.NativeCodec
        base = str(tmp_path / "1")
        with open(base + ".dat", "wb") as f:
            f.write(bytes(range(256)) * 700)
        write_ec_files(base, codec=codec, slab=SLAB, **BLOCKS)
        assert os.path.getsize(base + to_ext(13)) > 0
    finally:
        vs.stop()


def test_one_backend_resolver(monkeypatch, tmp_path):
    """``-ec.backend`` resolves in one place, ``ops.codec.resolve_backend``:
    ``volume``/``server`` (``cli._volume_codec``) and the volume server's
    own ``main`` take ``auto`` with its meaning, with and without a card."""
    import torch
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.server import volume_server

    class Started(Exception):
        pass
    seen = []

    def server(**kw):
        seen.append((kw["ec_backend"], kw["device"]))
        raise Started
    monkeypatch.setattr(volume_server, "VolumeServer", server)

    def main(*args):
        with pytest.raises(Started):
            volume_server.main(["--dir", str(tmp_path), *args])
        return seen[-1]
    for card, auto in ((False, ("native", "cpu")), (True, ("cuda", "cuda"))):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
        for name in ("auto", "native", "numpy", "cuda"):
            if name == "cuda" and not card:
                continue
            want = auto if name == "auto" else \
                (name, "cuda" if name == "cuda" else "cpu")
            assert ops_codec.resolve_backend(name) == want
            assert cli._volume_codec(name) == want
            assert main("--ec.backend", name) == want
    assert main("--ec.backend", "mesh", "--device", "cpu") == ("mesh", "cpu")
